"""Model facade, decode path (counterpart of ``repro/models/model.py``).

This slice ports what serving needs for the ``dense`` and ``vlm`` (LM)
families: the layer layout, parameter init, the KV cache and
:meth:`Model.decode_step`.  A ``lax.scan`` over layers becomes a Python
loop over ``params["blocks"][name][l]``; cache writes happen in place.
Other families, and the training/prefill forward, raise
``NotImplementedError`` until their slices land (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RuntimeConfig
from repro_torch.models import blocks as B

_LM_FAMILIES = ("dense", "vlm")
_IMAX = torch.iinfo(torch.int32).max


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _need_lm_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in _LM_FAMILIES:
        raise NotImplementedError(
            f"{what} for family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, 'Other model families')")


# ---------------------------------------------------------------------------
# Layer layout (mask segments)
# ---------------------------------------------------------------------------

class Segment(NamedTuple):
    path: str      # top-level key in params
    count: int     # number of mask entries (stacked leading dim, or 1)


def layer_layout(cfg: ArchConfig) -> tuple[Segment, ...]:
    """Mask segments, in mask-index order. Total == cfg.n_selectable_layers()."""
    segs: list[Segment] = []
    if cfg.has_encoder:
        segs.append(Segment("enc_blocks", cfg.n_enc_layers))
    if cfg.first_dense:
        segs.append(Segment("dense0", cfg.first_dense))
    segs.append(Segment("blocks", cfg.n_layers - cfg.first_dense))
    if cfg.family == "hybrid":
        segs.append(Segment("shared_attn", 1))
    if sum(s.count for s in segs) != cfg.n_selectable_layers():
        raise ValueError(f"{cfg.name}: layer layout disagrees with "
                         f"n_selectable_layers()")
    return tuple(segs)


def supports_delta_decode(cfg: ArchConfig) -> bool:
    """Whether :meth:`Model.decode_step` accepts a per-slot delta overlay:
    the plain dense stack, whose projections go through
    ``ops.base_delta_matmul``."""
    return cfg.family in _LM_FAMILIES


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ArchConfig, kind: str) -> dict:
    """Per-layer parameter shapes for one block of the given kind."""
    if kind == "dense":
        return {**_prefixed("attn_", B.attn_param_shapes(cfg)),
                **_prefixed("mlp_", B.mlp_param_shapes(cfg))}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _prefixed(prefix: str, shapes: dict) -> dict:
    return {prefix + k: v for k, v in shapes.items()}


def _take(p: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the reference's paths, shapes, types and key
    order, drawn from ``gen`` (which lives on ``device``)."""
    _need_lm_family(cfg, "init_params")
    dtype = _torch_dtype(cfg.dtype)
    d = cfg.d_model

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    params: dict = {}
    embed: dict = {}
    if cfg.task == "lm" or cfg.family != "vlm" or cfg.vocab_size:
        embed["tok"] = normal((cfg.vocab_size, d))
    if cfg.family == "vlm":
        embed["patch_proj"] = normal((d, d))
    params["embed"] = embed
    params["blocks"] = B.init_stacked(gen, _block_shapes(cfg, "dense"),
                                      cfg.n_layers, dtype, device)
    params["final_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    if cfg.task == "classification":
        params["head"] = normal((d, cfg.n_classes))
    elif not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size))
    return params


def _dense_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                     positions, window, cache, cache_pos, delta=None,
                     delta_mode=None):
    # delta: (slots (C,), {leaf_name: (C, *shape)}) — this layer's row of
    # the per-slot serving overlay; leaf names are split by sub-block prefix
    dslots = dattn = dmlp = None
    if delta is not None:
        dslots, dleaves = delta
        dattn = _take(dleaves, "attn_") or None
        dmlp = _take(dleaves, "mlp_") or None
    x = x + B.attention_fwd(_take(p, "attn_"), x, cfg, positions=positions,
                            cache=cache, cache_pos=cache_pos, causal=True,
                            window=window, delta=dattn, delta_slots=dslots,
                            delta_mode=delta_mode)
    return x + B.mlp_fwd(_take(p, "mlp_"), x, cfg, delta=dmlp,
                         delta_slots=dslots, delta_mode=delta_mode)


class Model:
    """Facade over one architecture: init and decode on ``device``.

    ``delta_mode`` picks the delta projection's implementation: ``None``
    follows the tensors' device (the kernel on the card), ``"torch"``
    forces the plain version, which is how the kernel is held against it
    end to end.
    """

    def __init__(self, cfg: ArchConfig, runtime: RuntimeConfig = RuntimeConfig(),
                 *, device="cuda", delta_mode: Optional[str] = None):
        cfg.validate()
        self.cfg = cfg
        self.runtime = runtime
        self.device = resolve_device(device)
        self.delta_mode = delta_mode

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.cfg, gen, self.device)

    # -- embedding / head --------------------------------------------------
    def _embed_tokens(self, params, tokens):
        cfg = self.cfg
        x = params["embed"]["tok"][tokens.long()]
        if cfg.rope_theta == 0.0:
            S = tokens.shape[1]
            pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
            x = x + B.sinusoid_positions(pos, cfg.d_model).to(x.dtype)
        return x * (cfg.d_model ** 0.5
                    if cfg.name.startswith(("gemma", "paligemma")) else 1.0)

    def _head(self, params, h):
        cfg = self.cfg
        h = B.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if cfg.task == "classification":
            return h @ params["head"]
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]
        return B.softcap(h @ w, cfg.logit_softcap)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, *, window: int = 0,
                   per_slot: bool = False) -> dict:
        """KV caches for decode; ``window`` caps the cache length.

        ``per_slot=True`` is the serving layout: ``pos`` is (L, B, W)
        instead of (L, W), so every slot tracks its own position.
        """
        cfg = self.cfg
        _need_lm_family(cfg, "init_cache")
        dt = _torch_dtype(cfg.dtype)
        W = min(window or max_seq, max_seq)
        L, Kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        shp = (L, batch, W, Kh, hd)
        pos_shape = (L, batch, W) if per_slot else (L, W)
        return {"blocks": {
            "k": torch.zeros(shp, dtype=dt, device=self.device),
            "v": torch.zeros(shp, dtype=dt, device=self.device),
            "pos": torch.full(pos_shape, _IMAX, dtype=torch.int32,
                              device=self.device)}}

    def reset_slot(self, cache: dict, slot: int, *,
                   stacked: bool = False) -> dict:
        """Invalidate one batch slot of a decode cache (request refill), in
        place: its position rows become int32-max ("empty"); k/v stay,
        unreachable until overwritten.  ``stacked`` addresses the dense
        baseline's per-slot layout (slot axis first)."""
        pos = cache["blocks"]["pos"]
        if stacked:
            pos[slot] = _IMAX
        else:
            pos[:, slot] = _IMAX
        return cache

    @torch.inference_mode()
    def decode_step(self, params: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: dict, *, window: int = 0,
                    delta: Optional[dict] = None):
        """One decode step. tokens: (B,) int; pos: 0-d int32, or a (B,)
        per-slot position vector over a ``per_slot`` cache.

        ``delta``: the serving overlay ``{"slots": (L, C) int32 owner ids
        (-1 = empty), "leaves": {name: (L, C, *shape) f32}}``.

        Returns (logits (B, V), cache) — the cache updated in place.
        """
        cfg = self.cfg
        _need_lm_family(cfg, "decode_step")
        per_slot = pos.dim() == 1
        x = self._embed_tokens(params, tokens[:, None])
        if cfg.rope_theta == 0.0:
            # sinusoidal position of the *current* slot
            sp = (B.sinusoid_positions(pos[:, None], cfg.d_model) if per_slot
                  else B.sinusoid_positions(pos[None], cfg.d_model)[None])
            x = params["embed"]["tok"][tokens[:, None].long()] + sp.to(x.dtype)
        positions = (pos[:, None] if per_slot else pos[None]).to(torch.int32)
        w = window or cfg.sliding_window
        blocks, kv = params["blocks"], cache["blocks"]
        for li in range(cfg.n_layers):
            p = {name: leaf[li] for name, leaf in blocks.items()}
            kv_l = {name: leaf[li] for name, leaf in kv.items()}
            dl = None
            if delta is not None:
                dl = (delta["slots"][li],
                      {name: leaf[li] for name, leaf in delta["leaves"].items()})
            x = _dense_block_fwd(p, x, cfg, positions=positions, window=w,
                                 cache=kv_l, cache_pos=pos, delta=dl,
                                 delta_mode=self.delta_mode)
        return self._head(params, x)[:, 0], cache
