"""Model facade (counterpart of ``repro/models/model.py``).

For the ``dense``, ``vlm``, ``ssm`` (Mamba2), ``hybrid`` (zamba2) and
``moe`` (deepseek-v2, grok-1) families: the layer layout and the mask
helpers of the mask-aware engine (``segment_prefix_cuts``,
``trainable_rows``, ``split_mask``, ``apply_layer_mask``), parameter init,
the sequence forward and losses of training (:meth:`Model.forward_seq`,
:meth:`Model.loss`), the KV or conv/state cache and
:meth:`Model.decode_step`.

The hybrid is a Mamba2 stack with ONE attention+MLP block whose weights
are shared, applied after every ``attn_every`` Mamba2 blocks; its leaves in
``params["shared_attn"]`` are unstacked (one mask entry), and every
application site has its own KV cache row.  Its mask order is not a
prefix of the compute graph, so it runs the dense program only
(``supports_prefix_cut``).

The moe family has two selectable segments: ``dense0`` (deepseek's
``first_dense`` leading blocks, attention and a plain MLP) and then
``blocks`` (attention and a routed MoE layer, ``models/moe.py``); the
attention is MLA (``models/mla.py``) when ``use_mla``, else the dense
family's GQA.  A prefix cut can fall in either segment; the routers'
load-balance loss is summed over the ``blocks`` rows into the loss.  Its
decode has no delta path: capacity dropping couples the slots of a batch.

The functions the streaming round path calls have names of the port's
own (``segment_prefix_cuts``, ``trainable_rows``, ``Model.hidden_seq``,
``Model.seq_loss``; the last three keep the reference's names as aliases
for other callers): the repo lint follows calls by bare name from
``RoundScheduler.run``, and a shared name would link the port's eager path
to the reference's jitted functions, whose static ``int(...)`` it would
then report (so the hybrid's functions are ``_hybrid_sites`` and
``_mamba_stack_decode``, not the reference's ``_zamba_*``).  A ``lax.scan``
over layers becomes a Python loop over the rows of a stacked segment,
carrying the hidden state and the aux loss; cache writes happen in place.
The ``audio`` family raises ``NotImplementedError`` until its slice lands
(ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RuntimeConfig
from repro_torch.models import blocks as B
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssd as SSD
from repro_torch.tree import tree_leaves, tree_map

_DENSE_FAMILIES = ("dense", "vlm")
_PORTED_FAMILIES = ("dense", "vlm", "ssm", "hybrid", "moe")
_IMAX = torch.iinfo(torch.int32).max


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _need_ported_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in _PORTED_FAMILIES:
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
    return cfg.family in _DENSE_FAMILIES


def supports_prefix_cut(cfg: ArchConfig) -> bool:
    """Whether the mask-aware engine can split this family's forward at a
    frozen-prefix layer index: the mask order must be a prefix of the
    compute graph, which zamba2's interleaved shared block breaks."""
    return cfg.family != "hybrid"


def segment_prefix_cuts(cut: int, cfg: ArchConfig) -> dict[str, int]:
    """Per-segment frozen-prefix lengths for a global mask-index ``cut``:
    segments below it are fully frozen (cut == count), the one containing
    it is split, the ones above are fully trainable (cut == 0)."""
    out, off = {}, 0
    for seg in layer_layout(cfg):
        out[seg.path] = min(max(int(cut) - off, 0), seg.count)  # repro: allow[host-sync] -- cut is a host Python int (the select stage's prefix cut)
        off += seg.count
    return out


def trainable_rows(params: dict, cut: int, cfg: ArchConfig) -> dict:
    """Rows ``[cut_k:]`` of every selectable segment with trainable layers,
    as views of ``params`` (the τ loop's first input; it must never be
    written in place).  Fully frozen segments are omitted."""
    cuts = segment_prefix_cuts(cut, cfg)
    out = {}
    for seg in layer_layout(cfg):
        c = cuts[seg.path]
        if c < seg.count:
            out[seg.path] = {k: a[c:] for k, a in params[seg.path].items()}
    return out


trainable_slice = trainable_rows


def split_mask(mask, cfg: ArchConfig) -> dict:
    """Split an (L,)-mask (tensor or array) into per-segment slices keyed
    by param path."""
    out, off = {}, 0
    for seg in layer_layout(cfg):
        out[seg.path] = mask[off:off + seg.count]
        off += seg.count
    return out


def split_mask_matrix(mask_matrix, cfg: ArchConfig) -> dict:
    """Split an (n, L) cohort mask/weight matrix into (n, count) segments."""
    out, off = {}, 0
    for seg in layer_layout(cfg):
        out[seg.path] = mask_matrix[:, off:off + seg.count]
        off += seg.count
    return out


def apply_layer_mask(tree: dict, mask: torch.Tensor, cfg: ArchConfig) -> dict:
    """Multiply per-layer subtrees of ``tree`` (grads/updates) by the (L,)
    mask; non-selectable groups (embed, head, norms) are zeroed (the paper
    freezes them).  The hybrid's unstacked shared leaves take their one
    entry by broadcasting."""
    parts = split_mask(mask, cfg)
    out = {}
    for key, sub in tree.items():
        if key in parts:
            m = parts[key]
            out[key] = tree_map(lambda x, m=m: x * m.to(x.dtype).reshape(
                (m.shape[0],) + (1,) * (x.dim() - 1)), sub)
        else:
            out[key] = tree_map(torch.zeros_like, sub)
    return out


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ArchConfig, kind: str) -> dict:
    """Per-layer parameter shapes for one block of the given kind."""
    if kind in ("dense", "attn_mlp_shared"):   # the latter: zamba2's shared
        return {**_prefixed("attn_", B.attn_param_shapes(cfg)),
                **_prefixed("mlp_", B.mlp_param_shapes(cfg))}
    if kind == "ssm":
        return _prefixed("ssm_", SSD.mamba2_param_shapes(cfg))
    if kind in ("moe", "moe_dense0"):
        attn = (MLA.mla_param_shapes(cfg) if cfg.use_mla
                else B.attn_param_shapes(cfg))
        if kind == "moe":
            return {**_prefixed("attn_", attn),
                    **_prefixed("moe_", MOE.moe_param_shapes(cfg))}
        # deepseek's leading dense block: an MLP as wide as the active
        # experts together
        ff = cfg.d_ff * max(cfg.top_k + cfg.n_shared_experts, 1)
        return {**_prefixed("attn_", attn),
                **_prefixed("mlp_", B.mlp_param_shapes(cfg, d_ff=ff))}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _prefixed(prefix: str, shapes: dict) -> dict:
    return {prefix + k: v for k, v in shapes.items()}


def _take(p: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the reference's paths, shapes, types and key
    order, drawn from ``gen`` (which lives on ``device``)."""
    _need_ported_family(cfg, "init_params")
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
    if cfg.family == "moe":
        if cfg.first_dense:
            params["dense0"] = B.init_stacked(
                gen, _block_shapes(cfg, "moe_dense0"), cfg.first_dense,
                dtype, device)
        params["blocks"] = B.init_stacked(
            gen, _block_shapes(cfg, "moe"), cfg.n_layers - cfg.first_dense,
            dtype, device)
    else:
        kind = "ssm" if cfg.family in ("ssm", "hybrid") else "dense"
        params["blocks"] = B.init_stacked(gen, _block_shapes(cfg, kind),
                                          cfg.n_layers, dtype, device)
    if cfg.family == "hybrid":          # the shared block: unstacked leaves
        params["shared_attn"] = B.init_stacked(
            gen, _block_shapes(cfg, "attn_mlp_shared"), 0, dtype, device)
    params["final_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    if cfg.task == "classification":
        params["head"] = normal((d, cfg.n_classes))
    elif not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size))
    return params


def count_params(params: dict) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(params))


def count_active_params(cfg: ArchConfig, params: dict) -> int:
    """Active parameters per token (moe: top_k of n_experts routed)."""
    total = count_params(params)
    if not cfg.n_experts:
        return total
    blocks = params.get("blocks", {})
    routed = sum(blocks[name].numel() for name in ("moe_wi_e", "moe_wo_e")
                 if name in blocks)
    return int(total - routed + routed * (cfg.top_k / cfg.n_experts))


def _dense_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                     positions, window, cache=None, cache_pos=None,
                     causal=True, prefix_len=0, seq_chunk=1024,
                     remat_chunk=False, delta=None, kernel_mode=None):
    # delta: (slots (C,), {leaf_name: (C, *shape)}) — this layer's row of
    # the per-slot serving overlay; leaf names are split by sub-block prefix
    dslots = dattn = dmlp = None
    if delta is not None:
        dslots, dleaves = delta
        dattn = _take(dleaves, "attn_") or None
        dmlp = _take(dleaves, "mlp_") or None
    x = x + B.attention_fwd(_take(p, "attn_"), x, cfg, positions=positions,
                            cache=cache, cache_pos=cache_pos, causal=causal,
                            window=window, prefix_len=prefix_len,
                            seq_chunk=seq_chunk, remat_chunk=remat_chunk,
                            delta=dattn, delta_slots=dslots,
                            kernel_mode=kernel_mode)
    return x + B.mlp_fwd(_take(p, "mlp_"), x, cfg, delta=dmlp,
                         delta_slots=dslots, delta_mode=kernel_mode)


def _moe_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *, positions,
                   window, seq_chunk, cache=None, cache_pos=None,
                   remat_chunk=False, kernel_mode=None) -> torch.Tensor:
    """The moe family's (causal) attention sub-block: MLA when
    ``cfg.use_mla``, else the dense family's GQA (grok-1)."""
    if cfg.use_mla:
        return MLA.mla_fwd(p, x, cfg, positions=positions, cache=cache,
                           cache_pos=cache_pos, window=window,
                           seq_chunk=seq_chunk)
    return B.attention_fwd(p, x, cfg, positions=positions, cache=cache,
                           cache_pos=cache_pos, causal=True, window=window,
                           seq_chunk=seq_chunk, remat_chunk=remat_chunk,
                           kernel_mode=kernel_mode)


def _moe_dense0_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    **attn) -> torch.Tensor:
    """One of deepseek's leading dense blocks: attention, then a plain
    MLP."""
    x = x + _moe_attention(_take(p, "attn_"), x, cfg, **attn)
    return x + B.mlp_fwd(_take(p, "mlp_"), x, cfg)


def _moe_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   moe_local: bool = False, **attn):
    """One moe block: attention, then the routed MoE layer.  Returns the
    new hidden state and the router's aux loss."""
    x = x + _moe_attention(_take(p, "attn_"), x, cfg, **attn)
    out, stats = MOE.moe_fwd(_take(p, "moe_"), x, cfg,
                             local_dispatch=moe_local)
    return x + out, stats.aux_loss


def _rows(stack: dict) -> dict:
    """Per-layer views of a stacked segment, one ``unbind`` per leaf (its
    backward writes each leaf's gradient once, where indexing row by row
    would write a full-size zero tensor per row)."""
    return {name: leaf.unbind(0) for name, leaf in stack.items()}


class Model:
    """Facade over one architecture: init, loss and decode on ``device``.

    ``kernel_mode`` picks the kernels' implementation: ``None`` follows the
    tensors' device (the Hopper kernels on the card), ``"torch"`` forces
    the plain versions, which is how the kernels are held against them end
    to end.
    """

    def __init__(self, cfg: ArchConfig, runtime: RuntimeConfig = RuntimeConfig(),
                 *, device="cuda", kernel_mode: Optional[str] = None):
        cfg.validate()
        self.cfg = cfg
        self.runtime = runtime
        self.device = resolve_device(device)
        self.kernel_mode = kernel_mode

    @property
    def n_selectable(self) -> int:
        return self.cfg.n_selectable_layers()

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

    # -- sequence forward (train / prefill) ---------------------------------
    def _run_stack(self, layer_fn, x, full: dict, trainable: Optional[dict],
                   cut: int, after_row=None):
        """Apply ``layer_fn(x, layer_params)`` over a stacked segment, split at
        the frozen-prefix ``cut``; ``x`` is the carry, (hidden, aux loss).

        Dense path (``trainable is None``): every row from ``full``, each
        followed by ``after_row(i, x)`` when given (the hybrid's shared
        block).
        Mask-aware path: rows ``[:cut]`` from ``full`` under
        ``torch.no_grad()`` (the reference's ``lax.stop_gradient``: no
        graph, no saved activations, no backward) and the rest from
        ``trainable``, the slice the caller differentiates.
        ``runtime.remat`` recomputes each differentiated block in the
        backward instead of keeping its activations.
        """
        if trainable is None:
            rows = _rows(full)
            for i in range(next(iter(full.values())).shape[0]):
                x = self._remat(layer_fn, x,
                                {n: r[i] for n, r in rows.items()})
                if after_row is not None:
                    x = after_row(i, x)
            return x
        if cut > 0:
            with torch.no_grad():
                rows = _rows({n: a[:cut] for n, a in full.items()})
                for i in range(cut):
                    x = layer_fn(x, {n: r[i] for n, r in rows.items()})
        if trainable:
            rows = _rows(trainable)
            for i in range(next(iter(trainable.values())).shape[0]):
                x = self._remat(layer_fn, x,
                                {n: r[i] for n, r in rows.items()})
        return x

    def _remat(self, layer_fn, h, p):
        """``layer_fn(h, p)``, recomputed in the backward instead of keeping
        its activations when ``runtime.remat`` is set and a graph is
        built."""
        if self.runtime.remat and torch.is_grad_enabled():
            return checkpoint(layer_fn, h, p, use_reentrant=False)
        return layer_fn(h, p)

    def _mamba_layer(self, carry, p):
        """One residual Mamba2 block of the sequence forward."""
        h, aux = carry
        out, _ = SSD.mamba2_fwd(_take(p, "ssm_"), h, self.cfg,
                                mode=self.kernel_mode)
        return h + out, aux

    def _hybrid_sites(self, shared: dict, positions: torch.Tensor):
        """The zamba2 hook of the Mamba2 row loop (ref
        ``Model._zamba_seq``): after every ``attn_every`` residual Mamba2
        blocks, the shared attention+MLP block (causal,
        ``cfg.sliding_window``); the ``n_layers % attn_every`` tail runs
        without it.  The shared block is not rematerialized, as in the
        reference."""
        cfg, rt = self.cfg, self.runtime

        def after_row(i: int, carry):
            if (i + 1) % cfg.attn_every:
                return carry
            h, aux = carry
            return _dense_block_fwd(shared, h, cfg, positions=positions,
                                    causal=True, window=cfg.sliding_window,
                                    seq_chunk=rt.seq_chunk,
                                    remat_chunk=rt.remat_scores,
                                    kernel_mode=self.kernel_mode), aux
        return after_row

    def _seq_segments(self, params: dict, positions: torch.Tensor,
                      causal: bool, prefix_len: int) -> list:
        """The sequence forward's stacked segments in order, as (path,
        ``layer_fn(carry, row_params)``, ``after_row``); the carry is
        (hidden, aux loss), which only the moe rows add to."""
        cfg, rt, km = self.cfg, self.runtime, self.kernel_mode
        if cfg.family in ("ssm", "hybrid"):
            after_row = (self._hybrid_sites(params["shared_attn"], positions)
                         if cfg.family == "hybrid" else None)
            return [("blocks", self._mamba_layer, after_row)]
        if cfg.family == "moe":
            attn = dict(positions=positions, window=cfg.sliding_window,
                        seq_chunk=rt.seq_chunk, remat_chunk=rt.remat_scores,
                        kernel_mode=km)

            def dense0_row(carry, p):
                return _moe_dense0_fwd(p, carry[0], cfg, **attn), carry[1]

            def moe_row(carry, p):
                h, aux = _moe_block_fwd(p, carry[0], cfg,
                                        moe_local=rt.moe_local_dispatch,
                                        **attn)
                return h, carry[1] + aux
            return ([("dense0", dense0_row, None)] if cfg.first_dense
                    else []) + [("blocks", moe_row, None)]

        def dense_row(carry, p):
            return _dense_block_fwd(p, carry[0], cfg, positions=positions,
                                    causal=causal, window=cfg.sliding_window,
                                    prefix_len=prefix_len,
                                    seq_chunk=rt.seq_chunk,
                                    remat_chunk=rt.remat_scores,
                                    kernel_mode=km), carry[1]
        return [("blocks", dense_row, None)]

    def hidden_seq(self, params: dict, batch: dict, *,
                   trainable: Optional[dict] = None, cut: int = 0):
        """Full-sequence forward.  Returns (hidden, aux_loss, prefix_len).

        ``trainable``/``cut`` select the mask-aware path: each selectable
        segment is split at its own cut from :func:`segment_prefix_cuts`;
        rows below it come from ``params`` (frozen), rows at or above it
        from ``trainable`` (the :func:`trainable_rows` dict the caller
        differentiates; a fully frozen segment is absent from it).  The
        aux loss is the moe routers' load-balance loss summed over the
        ``blocks`` rows, frozen ones included (zero for other families).
        """
        cfg = self.cfg
        _need_ported_family(cfg, "forward_seq")
        if trainable is not None and not supports_prefix_cut(cfg):
            raise ValueError(f"family {cfg.family!r} has no prefix-cut path")
        prefix_len = 0
        if cfg.family == "vlm":
            proj = params["embed"]["patch_proj"]
            px = batch["patches"].to(proj.dtype) @ proj
            prefix_len = px.shape[1]
            if cfg.task == "classification":
                x = px
            else:
                x = torch.cat([px, self._embed_tokens(params,
                                                      batch["tokens"])], 1)
        else:
            x = self._embed_tokens(params, batch["tokens"])
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        cuts = (segment_prefix_cuts(cut, cfg) if trainable is not None
                else {})
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
        for path, layer_fn, after_row in self._seq_segments(
                params, positions, cfg.task == "lm", prefix_len):
            carry = self._run_stack(
                layer_fn, carry, params[path],
                None if trainable is None else trainable.get(path, {}),
                cuts.get(path, 0), after_row)
        x, aux = carry
        return x, aux, prefix_len

    forward_seq = hidden_seq

    # -- losses --------------------------------------------------------------
    def seq_loss(self, params: dict, batch: dict, *,
                 trainable: Optional[dict] = None,
                 cut: int = 0) -> torch.Tensor:
        h, aux, prefix_len = self.hidden_seq(params, batch,
                                             trainable=trainable, cut=cut)
        return self.loss_from_hidden(params, h, aux, prefix_len, batch)

    loss = seq_loss

    def loss_from_hidden(self, params: dict, h: torch.Tensor,
                         aux: torch.Tensor, prefix_len: int,
                         batch: dict) -> torch.Tensor:
        """The loss tail on an already-computed hidden state, shared by
        :meth:`loss` and the single-forward eval (``core/client.py``)."""
        cfg = self.cfg
        if cfg.task == "classification":
            pooled = h.mean(1)
            logits = self._head(params, pooled[:, None])[:, 0].float()
            ce = -torch.log_softmax(logits, -1).gather(
                -1, batch["label"].long()[:, None])
            return ce.mean() + aux
        tokens = batch["tokens"]
        text_h = h[:, prefix_len:] if prefix_len else h
        return self._lm_ce(params, text_h[:, :-1], tokens[:, 1:]) + aux

    def _lm_ce(self, params: dict, h: torch.Tensor, targets: torch.Tensor,
               chunk: int = 1024) -> torch.Tensor:
        """Next-token cross-entropy, by chunks of ``chunk`` positions when
        the sequence is a longer multiple of it (never the whole (B,S,V)
        f32 logits at once)."""
        cfg = self.cfg
        h = B.rms_norm(h, params["final_norm"], cfg.norm_eps)
        w = params["embed"]["tok"].T if cfg.tie_embeddings \
            and cfg.task == "lm" else params["head"]

        def token_ce(hi, ti):
            logits = B.softcap(hi @ w, cfg.logit_softcap).float()
            gold = logits.gather(-1, ti.long()[..., None])[..., 0]
            return torch.logsumexp(logits, -1) - gold

        S = h.shape[1]
        if S <= chunk or S % chunk:
            return token_ce(h, targets).mean()
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(S // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            tot = tot + token_ce(h[:, sl], targets[:, sl]).sum()
        return tot / (targets.shape[0] * S)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, *, window: int = 0,
                   per_slot: bool = False) -> dict:
        """KV caches (ssm: conv and state caches; hybrid: both, one KV row
        per application of the shared block; moe: per segment, MLA's latent
        ``ckv`` and ``krope`` rows, or GQA's k/v) for decode, in
        ``cfg.dtype``; ``window`` caps the KV cache length.

        ``per_slot=True`` is the serving layout: ``pos`` is (L, B, W)
        instead of (L, W), so every slot tracks its own position (the ssm
        caches have no positions: every row is one slot already).
        """
        cfg = self.cfg
        _need_ported_family(cfg, "init_cache")
        dt = _torch_dtype(cfg.dtype)
        W = min(window or max_seq, max_seq)

        def pos(n: int) -> torch.Tensor:
            return torch.full((n, batch, W) if per_slot else (n, W), _IMAX,
                              dtype=torch.int32, device=self.device)

        def kv(n: int) -> dict:
            if cfg.use_mla:
                return {"ckv": torch.zeros((n, batch, W, cfg.kv_lora_rank),
                                           dtype=dt, device=self.device),
                        "krope": torch.zeros((n, batch, W, cfg.qk_rope_dim),
                                             dtype=dt, device=self.device),
                        "pos": pos(n)}
            shp = (n, batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
            return {"k": torch.zeros(shp, dtype=dt, device=self.device),
                    "v": torch.zeros(shp, dtype=dt, device=self.device),
                    "pos": pos(n)}

        if cfg.family == "moe":
            cache = {"blocks": kv(cfg.n_layers - cfg.first_dense)}
            if cfg.first_dense:
                cache["dense0"] = kv(cfg.first_dense)
            return cache
        if cfg.family not in ("ssm", "hybrid"):
            return {"blocks": kv(cfg.n_layers)}
        shp = SSD.mamba2_cache_shapes(cfg, batch)
        cache = {"blocks": {
            name: torch.zeros((cfg.n_layers,) + s, dtype=dt,
                              device=self.device)
            for name, s in shp.items()}}
        if cfg.family == "hybrid":
            cache["shared_attn"] = kv(cfg.n_layers // cfg.attn_every)
        return cache

    def reset_slot(self, cache: dict, slot: int, *,
                   stacked: bool = False) -> dict:
        """Invalidate one batch slot of a decode cache (request refill), in
        place: its position rows become int32-max ("empty") and ssm conv
        and state rows are zeroed, in every segment of the cache (the
        hybrid's ``shared_attn`` too); k/v stay, unreachable until
        overwritten.  ``stacked`` addresses the dense baseline's per-slot
        layout (slot axis first)."""
        fills = {"pos": _IMAX, "conv": 0, "state": 0}
        for segment in cache.values():
            for name, leaf in segment.items():
                if name not in fills:
                    continue
                if stacked:
                    leaf[slot] = fills[name]
                else:
                    leaf[:, slot] = fills[name]
        return cache

    def _mamba_stack_decode(self, params: dict, x: torch.Tensor,
                            positions: torch.Tensor, pos: torch.Tensor,
                            cache: dict, window: int) -> torch.Tensor:
        """One decode step through the Mamba2 rows (ssm and hybrid), their
        conv and state rows updated in place.  The hybrid (ref
        ``Model._zamba_decode``) runs the shared block after every
        ``attn_every`` rows, over its application site's KV row
        ``cache["shared_attn"][g]``, written in place."""
        cfg = self.cfg
        blocks, mc = params["blocks"], cache["blocks"]
        kv = cache.get("shared_attn")
        for li in range(cfg.n_layers):
            c = {name: leaf[li] for name, leaf in mc.items()}
            out, nc = SSD.mamba2_fwd(
                _take({name: leaf[li] for name, leaf in blocks.items()},
                      "ssm_"), x, cfg, cache=c)
            for name, t in nc.items():
                c[name].copy_(t)
            x = x + out
            if kv is not None and (li + 1) % cfg.attn_every == 0:
                g = li // cfg.attn_every
                x = _dense_block_fwd(params["shared_attn"], x, cfg,
                                     positions=positions, window=window,
                                     cache={name: leaf[g]
                                            for name, leaf in kv.items()},
                                     cache_pos=pos,
                                     kernel_mode=self.kernel_mode)
        return x

    def _moe_stack_decode(self, params: dict, x: torch.Tensor,
                          positions: torch.Tensor, pos: torch.Tensor,
                          cache: dict, window: int) -> torch.Tensor:
        """One decode step through ``dense0`` and then the moe ``blocks``,
        each row over its own cache row (MLA's latent rows or GQA's k/v),
        written in place.  The step's B tokens share the routers'
        capacity, as the reference's do."""
        cfg, rt = self.cfg, self.runtime
        attn = dict(positions=positions, window=window,
                    seq_chunk=rt.seq_chunk, cache_pos=pos,
                    kernel_mode=self.kernel_mode)
        for seg in layer_layout(cfg):
            stack, seg_cache = params[seg.path], cache[seg.path]
            for li in range(seg.count):
                p = {name: leaf[li] for name, leaf in stack.items()}
                c = {name: leaf[li] for name, leaf in seg_cache.items()}
                if seg.path == "dense0":
                    x = _moe_dense0_fwd(p, x, cfg, cache=c, **attn)
                else:
                    x, _ = _moe_block_fwd(p, x, cfg, cache=c,
                                          moe_local=rt.moe_local_dispatch,
                                          **attn)
        return x

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
        _need_ported_family(cfg, "decode_step")
        if delta is not None and not supports_delta_decode(cfg):
            raise ValueError(f"family {cfg.family!r} has no delta-decode path")
        per_slot = pos.dim() == 1
        x = self._embed_tokens(params, tokens[:, None])
        if cfg.rope_theta == 0.0:
            # sinusoidal position of the *current* slot
            sp = (B.sinusoid_positions(pos[:, None], cfg.d_model) if per_slot
                  else B.sinusoid_positions(pos[None], cfg.d_model)[None])
            x = params["embed"]["tok"][tokens[:, None].long()] + sp.to(x.dtype)
        positions = (pos[:, None] if per_slot else pos[None]).to(torch.int32)
        w = window or cfg.sliding_window
        if cfg.family in ("ssm", "hybrid"):
            x = self._mamba_stack_decode(params, x, positions, pos, cache, w)
            return self._head(params, x)[:, 0], cache
        if cfg.family == "moe":
            x = self._moe_stack_decode(params, x, positions, pos, cache, w)
            return self._head(params, x)[:, 0], cache
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
                                 kernel_mode=self.kernel_mode)
        return self._head(params, x)[:, 0], cache
