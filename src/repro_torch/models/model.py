"""Model facade (counterpart of ``repro/models/model.py``).

For every family of the reference, ``dense``, ``vlm``, ``ssm`` (Mamba2),
``hybrid`` (zamba2), ``moe`` (deepseek-v2, grok-1) and ``audio``
(whisper): the layer layout and the mask helpers of the mask-aware engine
(``segment_prefix_cuts``, ``trainable_rows``, ``split_mask``,
``apply_layer_mask``), parameter init, the sequence forward and losses of
training (:meth:`Model.forward_seq`, :meth:`Model.loss`), the prefill's
:meth:`Model.logits_seq`, the KV or conv/state cache and
:meth:`Model.decode_step`; each takes a ``layer_hook`` over the stacked
rows, through which the distributed step (``sharding/``) gathers and
grad-scales one layer at a time.

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

The audio family (whisper) is an encoder-decoder with two selectable
segments, ``enc_blocks`` (non-causal attention+MLP blocks over stub frame
embeddings) and then ``blocks`` (causal self-attention, cross-attention
over the encoder's output, MLP).  Its sequence forward
(:meth:`Model.hidden_seq`, the reference's ``_whisper_seq``) runs the
encoder (:meth:`Model.encode`) and then the decoder, each decoder row
building its cross k/v from its own ``xattn_`` leaves; a prefix cut can
fall in either segment, and gradients reach the encoder rows through the
cross k/v.  Its decode reads a cross cache the caller fills from the
encoder (``cache["cross_kv"]``, as the reference's own test fills it: the
reference has no encoder-prefill entry point) at one shared position;
per-slot positions and delta decode are refused, as they cannot run in
the reference either.

The functions the streaming round path calls have names of the port's
own (``segment_prefix_cuts``, ``trainable_rows``, ``Model.hidden_seq``,
``Model.seq_loss``; the last three keep the reference's names as aliases
for other callers): the repo lint follows calls by bare name from
``RoundScheduler.run``, and a shared name would link the port's eager path
to the reference's jitted functions, whose static ``int(...)`` it would
then report (so the hybrid's functions are ``_hybrid_sites`` and
``_mamba_stack_decode``, not the reference's ``_zamba_*``, and whisper's
encoder is ``encode``, not ``_whisper_seq``).  A ``lax.scan`` over layers
becomes a Python loop over the rows of a stacked segment, carrying the
hidden state and the aux loss; cache writes happen in place.
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
_FAMILIES = ("dense", "vlm", "ssm", "hybrid", "moe", "audio")
_IMAX = torch.iinfo(torch.int32).max


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _need_known_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


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
    if kind == "encdec":                      # whisper's decoder block
        return {**_prefixed("attn_", B.attn_param_shapes(cfg)),
                **_prefixed("xattn_", B.attn_param_shapes(cfg)),
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
        return {**_prefixed("attn_", attn), **_prefixed(
            "mlp_", B.mlp_param_shapes(cfg, d_ff=MOE.dense0_ff(cfg)))}
    raise ValueError(kind)


def _prefixed(prefix: str, shapes: dict) -> dict:
    return {prefix + k: v for k, v in shapes.items()}


def _take(p: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the reference's paths, shapes, types and key
    order, drawn from ``gen`` (which lives on ``device``)."""
    _need_known_family(cfg)
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
    if cfg.family == "audio":
        embed["frame_proj"] = normal((d, d))
    params["embed"] = embed
    if cfg.family == "audio":
        params["enc_blocks"] = B.init_stacked(
            gen, _block_shapes(cfg, "dense"), cfg.n_enc_layers, dtype, device)
        params["blocks"] = B.init_stacked(
            gen, _block_shapes(cfg, "encdec"), cfg.n_layers, dtype, device)
        params["enc_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    elif cfg.family == "moe":
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
    """Elements over every leaf: the selectable segments, the embeddings
    (whisper's ``frame_proj`` too), the norms (``enc_norm`` too) and any
    head."""
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
                     remat_chunk=False, delta=None, kernel_mode=None,
                     cross_kv=None, tp=None):
    # delta: (slots (C,), {leaf_name: (C, *shape)}) — this layer's row of
    # the per-slot serving overlay; leaf names are split by sub-block prefix.
    # cross_kv: whisper's decoder rows (an ``xattn_`` sub-block) attend over
    # the encoder's (k, v) after their self-attention.
    # tp: the parallel form (``sharding.tensor_parallel.ModelAxis``): each
    # sub-block returns this model coordinate's partial sum and
    # ``tp.reduce`` (Megatron's g) adds them up over ``model``.
    dslots = dattn = dmlp = None
    if delta is not None:
        dslots, dleaves = delta
        dattn = _take(dleaves, "attn_") or None
        dmlp = _take(dleaves, "mlp_") or None
    a = B.attention_fwd(_take(p, "attn_"), x, cfg, positions=positions,
                        cache=cache, cache_pos=cache_pos, causal=causal,
                        window=window, prefix_len=prefix_len,
                        seq_chunk=seq_chunk, remat_chunk=remat_chunk,
                        delta=dattn, delta_slots=dslots,
                        kernel_mode=kernel_mode, tp=tp)
    x = x + (tp.reduce(a) if tp is not None and tp.attn_split else a)
    if "xattn_ln" in p:
        a = B.attention_fwd(_take(p, "xattn_"), x, cfg, positions=positions,
                            cross_kv=cross_kv, causal=False,
                            seq_chunk=seq_chunk, tp=tp)
        x = x + (tp.reduce(a) if tp is not None and tp.attn_split else a)
    m = B.mlp_fwd(_take(p, "mlp_"), x, cfg, delta=dmlp, delta_slots=dslots,
                  delta_mode=kernel_mode, tp=tp)
    return x + (m if tp is None else tp.reduce(m))


def _moe_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *, positions,
                   window, seq_chunk, cache=None, cache_pos=None,
                   remat_chunk=False, kernel_mode=None,
                   tp=None) -> torch.Tensor:
    """The moe family's (causal) attention sub-block: MLA when
    ``cfg.use_mla``, else the dense family's GQA (grok-1).  ``tp``: the
    parallel form, its partial sums (MLA: the rank's heads over the whole
    latent; GQA: its query and kv heads) reduced over ``model`` here; a
    ``"replicated"`` attention runs whole on every rank."""
    if cfg.use_mla:
        a = MLA.mla_fwd(p, x, cfg, positions=positions, cache=cache,
                        cache_pos=cache_pos, window=window,
                        seq_chunk=seq_chunk, tp=tp)
    else:
        a = B.attention_fwd(p, x, cfg, positions=positions, cache=cache,
                            cache_pos=cache_pos, causal=True, window=window,
                            seq_chunk=seq_chunk, remat_chunk=remat_chunk,
                            kernel_mode=kernel_mode, tp=tp)
    return tp.reduce(a) if tp is not None and tp.attn_split else a


def _moe_dense0_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, tp=None,
                    **attn) -> torch.Tensor:
    """One of deepseek's leading dense blocks: attention, then a plain
    MLP (``tp``: split as the dense family's)."""
    x = x + _moe_attention(_take(p, "attn_"), x, cfg, tp=tp, **attn)
    m = B.mlp_fwd(_take(p, "mlp_"), x, cfg, tp=tp)
    return x + (m if tp is None else tp.reduce(m))


def _moe_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   moe_local: bool = False, tp=None, **attn):
    """One moe block: attention, then the routed MoE layer.  Returns the
    new hidden state and the router's aux loss.  ``tp``: the parallel
    form; one ``tp.reduce`` sums the routed and shared experts' partials
    over ``model``."""
    x = x + _moe_attention(_take(p, "attn_"), x, cfg, tp=tp, **attn)
    out, stats = MOE.moe_fwd(_take(p, "moe_"), x, cfg,
                             local_dispatch=moe_local, tp=tp)
    return x + (out if tp is None else tp.reduce(out)), stats.aux_loss


# Stacked segments whose rows pass through a ``layer_hook`` (the
# reference's ``forward_seq`` hooks its ``blocks`` and ``enc_blocks`` scans,
# not deepseek's ``dense0``): the distributed step gathers and grad-scales
# each of their rows there (``sharding/fl_step.py``).
HOOKED_SEGMENTS = ("blocks", "enc_blocks")


def _no_hook(p: dict, idx: int, segment: str) -> dict:
    return p


def _hooked(layer_fn, hook, idx: int, segment: str):
    """``layer_fn`` with its row's params passed through
    ``hook(row_params, idx, segment)`` first, so that under
    ``runtime.remat`` the hook runs inside the checkpointed function: a
    gathered row is recomputed in the backward, never saved for it."""
    def fn(carry, p):
        return layer_fn(carry, hook(p, idx, segment))
    return fn


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
        _need_known_family(cfg)
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
    @staticmethod
    def _token_rows(params, tokens, tp=None):
        """The rows of ``embed.tok`` at ``tokens``.  ``tp`` with
        ``tp.vocab_split``: vocab-parallel, ``tok`` holds this model
        coordinate's rows; ids outside them embed as zeros and
        ``tp.reduce`` sums the coordinates' rows (else ``tok`` is whole on
        every rank)."""
        tok = params["embed"]["tok"]
        if tp is None or not tp.vocab_split:
            return tok[tokens.long()]
        local = tokens.long() - tp.vocab_start
        mine = (local >= 0) & (local < tok.shape[0])
        return tp.reduce(torch.where(
            mine[..., None], tok[local.clamp(0, tok.shape[0] - 1)], 0))

    def _embed_tokens(self, params, tokens, tp=None):
        """Token embeddings (:meth:`_token_rows`), plus the sinusoid of
        positions ``arange(S)`` for a model without RoPE."""
        cfg = self.cfg
        x = self._token_rows(params, tokens, tp)
        if cfg.rope_theta == 0.0:
            S = tokens.shape[1]
            pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
            x = x + B.sinusoid_positions(pos, cfg.d_model).to(x.dtype)
        return x * (cfg.d_model ** 0.5
                    if cfg.name.startswith(("gemma", "paligemma")) else 1.0)

    def _head(self, params, h, tp=None):
        """Logits of ``h``.  ``tp`` with ``tp.vocab_split``:
        vocab-parallel, all-gathered over ``model`` (``tp.gather_last``),
        so every rank returns them whole (else computed whole)."""
        cfg = self.cfg
        h = B.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if cfg.task == "classification":
            return h @ params["head"]
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]
        if tp is not None and tp.vocab_split:
            return tp.gather_last(B.softcap(tp.copy(h) @ w,
                                            cfg.logit_softcap))
        return B.softcap(h @ w, cfg.logit_softcap)

    # -- sequence forward (train / prefill) ---------------------------------
    def _run_stack(self, layer_fn, x, full: dict, trainable: Optional[dict],
                   cut: int, after_row=None, hook=_no_hook,
                   segment: str = ""):
        """Apply ``layer_fn(x, layer_params)`` over a stacked segment, split at
        the frozen-prefix ``cut``; ``x`` is the carry, (hidden, aux loss).

        Dense path (``trainable is None``): every row from ``full``, each
        followed by ``after_row(i, x)`` when given (the hybrid's shared
        block); row ``i``'s params are ``hook(row_params, i, segment)``
        (the reference's ``layer_hook``), applied inside the
        rematerialised function.
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
                fn = (layer_fn if hook is _no_hook
                      else _hooked(layer_fn, hook, i, segment))
                x = self._remat(fn, x, {n: r[i] for n, r in rows.items()})
                if after_row is not None:
                    x = after_row(i, x)
            return x
        if hook is not _no_hook:
            raise ValueError("a layer_hook runs on the dense path only "
                             "(no trainable slice)")
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

    def _mamba_layer(self, carry, p, tp=None):
        """One residual Mamba2 block of the sequence forward (``tp``: its
        parallel form, the partial sums added up by ``tp.reduce``)."""
        h, aux = carry
        out, _ = SSD.mamba2_fwd(_take(p, "ssm_"), h, self.cfg,
                                mode=self.kernel_mode, tp=tp)
        return h + (out if tp is None else tp.reduce(out)), aux

    def _hybrid_sites(self, shared: dict, positions: torch.Tensor,
                      tp=None):
        """The zamba2 hook of the Mamba2 row loop (ref
        ``Model._zamba_seq``): after every ``attn_every`` residual Mamba2
        blocks, the shared attention+MLP block (causal,
        ``cfg.sliding_window``); the ``n_layers % attn_every`` tail runs
        without it.  The shared block is not rematerialized, as in the
        reference.  ``tp``: ``shared`` is this model coordinate's view of
        the block, made once a step by the caller."""
        cfg, rt = self.cfg, self.runtime

        def after_row(i: int, carry):
            if (i + 1) % cfg.attn_every:
                return carry
            h, aux = carry
            return _dense_block_fwd(shared, h, cfg, positions=positions,
                                    causal=True, window=cfg.sliding_window,
                                    seq_chunk=rt.seq_chunk,
                                    remat_chunk=rt.remat_scores,
                                    kernel_mode=self.kernel_mode, tp=tp), aux
        return after_row

    def encode(self, params: dict, frames: torch.Tensor, *,
               trainable: Optional[dict] = None, cut: int = 0,
               layer_hook=None, tp=None) -> torch.Tensor:
        """whisper's encoder (the first half of the reference's
        ``_whisper_seq``): the stub frame embeddings (B, enc_seq, d) cast
        to ``frame_proj``'s type and projected, plus sinusoid positions;
        the ``enc_blocks`` rows (attention over all frames, no window)
        through :meth:`_run_stack`, split at ``cut`` when ``trainable`` (the
        segment's trainable rows) is given, each row through ``layer_hook``
        (segment ``"enc_blocks"``); then ``enc_norm``.  Returns the
        encoder's output (B, enc_seq, d), from which every decoder row
        builds its cross k/v (:func:`blocks.make_cross_kv`).

        ``tp``: the parallel form, ``params`` this model coordinate's
        (``frame_proj`` whole, viewed once by the caller; the rows split
        as dense blocks, the output whole on every rank).  Where attention
        splits (``tp.attn_split``) only the rank's heads' cross k/v read
        the output, so it passes Megatron's f (``tp.copy``) here, once,
        ahead of every decoder row: the gradients of ``enc_norm``, the
        encoder rows and ``frame_proj`` are then whole on every rank, for
        one all-reduce a step rather than one a decoder row.  Under
        ``"replicated"`` attention every rank reads it whole: no f."""
        cfg, rt = self.cfg, self.runtime
        proj = params["embed"]["frame_proj"]
        e = frames.to(proj.dtype) @ proj
        pos = torch.arange(e.shape[1], dtype=torch.int32, device=e.device)
        e = e + B.sinusoid_positions(pos, cfg.d_model).to(e.dtype)

        def enc_row(carry, p):
            return _dense_block_fwd(p, carry[0], cfg, positions=pos,
                                    causal=False, window=0,
                                    seq_chunk=rt.seq_chunk,
                                    remat_chunk=rt.remat_scores,
                                    kernel_mode=self.kernel_mode,
                                    tp=tp), carry[1]
        zero = torch.zeros((), dtype=torch.float32, device=e.device)
        e, _ = self._run_stack(enc_row, (e, zero), params["enc_blocks"],
                               trainable, cut, hook=layer_hook or _no_hook,
                               segment="enc_blocks")
        e = B.rms_norm(e, params["enc_norm"], cfg.norm_eps)
        return tp.copy(e) if tp is not None and tp.attn_split else e

    def _seq_segments(self, params: dict, positions: torch.Tensor,
                      causal: bool, prefix_len: int,
                      enc_out: Optional[torch.Tensor] = None,
                      tp=None) -> list:
        """The sequence forward's stacked segments in order, as (path,
        ``layer_fn(carry, row_params)``, ``after_row``); the carry is
        (hidden, aux loss), which only the moe rows add to.  whisper's
        decoder rows (``enc_out`` given) each build their cross k/v from
        the encoder's output: under ``runtime.remat`` the recomputed row
        reads ``enc_out`` as a closed-over tensor, which non-reentrant
        checkpointing differentiates like an argument."""
        cfg, rt, km = self.cfg, self.runtime, self.kernel_mode
        if enc_out is not None:
            def encdec_row(carry, p):
                xkv = B.make_cross_kv(_take(p, "xattn_"), enc_out, cfg)
                return _dense_block_fwd(p, carry[0], cfg,
                                        positions=positions, causal=True,
                                        window=cfg.sliding_window,
                                        seq_chunk=rt.seq_chunk,
                                        remat_chunk=rt.remat_scores,
                                        kernel_mode=km, cross_kv=xkv,
                                        tp=tp), carry[1]
            return [("blocks", encdec_row, None)]
        if cfg.family in ("ssm", "hybrid"):
            after_row = (self._hybrid_sites(params["shared_attn"], positions,
                                            tp)
                         if cfg.family == "hybrid" else None)

            def mamba_row(carry, p):
                return self._mamba_layer(carry, p, tp)
            return [("blocks", mamba_row, after_row)]
        if cfg.family == "moe":
            attn = dict(positions=positions, window=cfg.sliding_window,
                        seq_chunk=rt.seq_chunk, remat_chunk=rt.remat_scores,
                        kernel_mode=km)

            def dense0_row(carry, p):
                return _moe_dense0_fwd(p, carry[0], cfg, tp=tp,
                                       **attn), carry[1]

            def moe_row(carry, p):
                h, aux = _moe_block_fwd(p, carry[0], cfg,
                                        moe_local=rt.moe_local_dispatch,
                                        tp=tp, **attn)
                return h, carry[1] + aux
            return ([("dense0", dense0_row, None)] if cfg.first_dense
                    else []) + [("blocks", moe_row, None)]

        def dense_row(carry, p):
            return _dense_block_fwd(p, carry[0], cfg, positions=positions,
                                    causal=causal, window=cfg.sliding_window,
                                    prefix_len=prefix_len,
                                    seq_chunk=rt.seq_chunk,
                                    remat_chunk=rt.remat_scores,
                                    kernel_mode=km, tp=tp), carry[1]
        return [("blocks", dense_row, None)]

    def hidden_seq(self, params: dict, batch: dict, *,
                   trainable: Optional[dict] = None, cut: int = 0,
                   layer_hook=None, tp=None):
        """Full-sequence forward.  Returns (hidden, aux_loss, prefix_len).

        ``layer_hook(row_params, idx, segment)`` (the reference's) is
        applied to every row of the ``blocks`` and ``enc_blocks`` segments
        (:data:`HOOKED_SEGMENTS`) before its block runs, inside the
        rematerialised function under ``runtime.remat``: the distributed
        step gathers each row's ZeRO-3 shards and applies the Eq.(7)
        gradient scale there, so one layer's full weights exist at a time.
        It runs on the dense path only (no ``trainable``).

        ``trainable``/``cut`` select the mask-aware path: each selectable
        segment is split at its own cut from :func:`segment_prefix_cuts`;
        rows below it come from ``params`` (frozen), rows at or above it
        from ``trainable`` (the :func:`trainable_rows` dict the caller
        differentiates; a fully frozen segment is absent from it).  The
        aux loss is the moe routers' load-balance loss summed over the
        ``blocks`` rows, frozen ones included (zero for other families).

        whisper (batch ``frames`` (B, enc_seq, d) and ``tokens``): the
        encoder (:meth:`encode`, at ``enc_blocks``' cut) and then the
        decoder's rows over the token embeddings; a fully frozen encoder
        (a cut at or past ``n_enc_layers``) runs without a graph.

        ``tp`` (``sharding.tensor_parallel.ModelAxis``, the language
        models of the dense, vlm, ssm, hybrid, moe and audio families):
        the parallel form over ``model``, ``params`` this model
        coordinate's (the hook's rows too, and the hybrid's shared block,
        deepseek's ``dense0`` and the embed group, viewed once by the
        caller: the vlm's ``patch_proj`` and whisper's ``frame_proj``
        whole, so the stub prefix or frames are projected whole on every
        rank, and the text tokens vocab-parallel where the vocabulary
        divides); whisper's encoder rows and decoder rows split as dense
        blocks, their cross-attention by heads over the rank's cross k/v
        (:meth:`encode` puts f on the encoder's output); the hidden state
        and the aux loss come out whole on every rank.
        """
        cfg = self.cfg
        if trainable is not None and not supports_prefix_cut(cfg):
            raise ValueError(f"family {cfg.family!r} has no prefix-cut path")
        cuts = (segment_prefix_cuts(cut, cfg) if trainable is not None
                else {})
        prefix_len, enc_out = 0, None
        if cfg.family == "audio":
            enc_out = self.encode(
                params, batch["frames"],
                trainable=(None if trainable is None
                           else trainable.get("enc_blocks", {})),
                cut=cuts.get("enc_blocks", 0), layer_hook=layer_hook,
                tp=tp)
            x = self._embed_tokens(params, batch["tokens"], tp)
        elif cfg.family == "vlm":
            proj = params["embed"]["patch_proj"]
            px = batch["patches"].to(proj.dtype) @ proj
            prefix_len = px.shape[1]
            if cfg.task == "classification":
                x = px
            else:
                x = torch.cat([px, self._embed_tokens(
                    params, batch["tokens"], tp)], 1)
        else:
            x = self._embed_tokens(params, batch["tokens"], tp)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
        for path, layer_fn, after_row in self._seq_segments(
                params, positions, cfg.task == "lm", prefix_len, enc_out,
                tp):
            carry = self._run_stack(
                layer_fn, carry, params[path],
                None if trainable is None else trainable.get(path, {}),
                cuts.get(path, 0), after_row,
                hook=(layer_hook or _no_hook) if path in HOOKED_SEGMENTS
                else _no_hook,
                segment=path)
        x, aux = carry
        return x, aux, prefix_len

    forward_seq = hidden_seq

    # -- losses --------------------------------------------------------------
    def seq_loss(self, params: dict, batch: dict, *,
                 trainable: Optional[dict] = None, cut: int = 0,
                 layer_hook=None, tp=None) -> torch.Tensor:
        h, aux, prefix_len = self.hidden_seq(
            params, batch, trainable=trainable, cut=cut,
            layer_hook=layer_hook, tp=tp)
        return self.loss_from_hidden(params, h, aux, prefix_len, batch,
                                     tp=tp)

    loss = seq_loss

    def logits_seq(self, params: dict, batch: dict, *,
                   layer_hook=None, tp=None) -> torch.Tensor:
        """Full-sequence logits at the last position, or of the pooled
        hidden state for a classifier (ref ``Model.logits_seq``; the mesh
        prefill calls it with its gathering ``layer_hook`` and, under
        tensor parallelism, ``tp``: the logits come out whole)."""
        h, _, _ = self.hidden_seq(params, batch, layer_hook=layer_hook,
                                  tp=tp)
        if self.cfg.task == "classification":
            return self._head(params, h.mean(1)[:, None])[:, 0]
        return self._head(params, h[:, -1:], tp)[:, 0]

    def loss_from_hidden(self, params: dict, h: torch.Tensor,
                         aux: torch.Tensor, prefix_len: int,
                         batch: dict, tp=None) -> torch.Tensor:
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
        return self._lm_ce(params, text_h[:, :-1], tokens[:, 1:],
                           tp=tp) + aux

    def _lm_ce(self, params: dict, h: torch.Tensor, targets: torch.Tensor,
               chunk: int = 1024, tp=None) -> torch.Tensor:
        """Next-token cross-entropy, by chunks of ``chunk`` positions when
        the sequence is a longer multiple of it (never the whole (B,S,V)
        f32 logits at once).  ``tp`` with ``tp.vocab_split``:
        vocab-parallel, each chunk's logits this model coordinate's
        columns: the max over ``model``
        (``tp.reduce_max``), then Σ exp and the gold logit (from the rank
        that owns it) summed over ``model`` in one ``tp.reduce``."""
        cfg = self.cfg
        h = B.rms_norm(h, params["final_norm"], cfg.norm_eps)
        w = params["embed"]["tok"].T if cfg.tie_embeddings \
            and cfg.task == "lm" else params["head"]

        def token_ce(hi, ti):
            if tp is not None and tp.vocab_split:
                return vocab_parallel_ce(hi, ti)
            logits = B.softcap(hi @ w, cfg.logit_softcap).float()
            gold = logits.gather(-1, ti.long()[..., None])[..., 0]
            return torch.logsumexp(logits, -1) - gold

        def vocab_parallel_ce(hi, ti):
            logits = B.softcap(tp.copy(hi) @ w, cfg.logit_softcap).float()
            top = tp.reduce_max(logits.detach().amax(-1))
            local = ti.long() - tp.vocab_start
            mine = (local >= 0) & (local < logits.shape[-1])
            gold = logits.gather(-1, local.clamp(
                0, logits.shape[-1] - 1)[..., None])[..., 0]
            se, gold = tp.reduce(torch.stack([
                torch.exp(logits - top[..., None]).sum(-1),
                torch.where(mine, gold, 0.0)]))
            return torch.log(se) + top - gold

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
        ``ckv`` and ``krope`` rows, or GQA's k/v; audio: the decoder's KV
        rows and ``cross_kv``, k and v (L, B, enc_seq, Kh, hd), which the
        caller fills from the encoder) for decode, in ``cfg.dtype``;
        ``window`` caps the KV cache length.

        ``per_slot=True`` is the serving layout: ``pos`` is (L, B, W)
        instead of (L, W), so every slot tracks its own position (the ssm
        caches have no positions: every row is one slot already).
        """
        cfg = self.cfg
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
        if cfg.family == "audio":
            shp = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
            return {"blocks": kv(cfg.n_layers), "cross_kv": {
                "k": torch.zeros(shp, dtype=dt, device=self.device),
                "v": torch.zeros(shp, dtype=dt, device=self.device)}}
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
        overwritten, and whisper's ``cross_kv`` (no positions) is left
        alone.  ``stacked`` addresses the dense baseline's per-slot
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
                            cache: dict, window: int,
                            hook=_no_hook, tp=None) -> torch.Tensor:
        """One decode step through the Mamba2 rows (ssm and hybrid), their
        conv and state rows updated in place.  The hybrid (ref
        ``Model._zamba_decode``) runs the shared block after every
        ``attn_every`` rows, over its application site's KV row
        ``cache["shared_attn"][g]``, written in place.  ``tp``: the
        parallel form, over the rank's cache rows."""
        cfg = self.cfg
        blocks, mc = params["blocks"], cache["blocks"]
        kv = cache.get("shared_attn")
        for li in range(cfg.n_layers):
            c = {name: leaf[li] for name, leaf in mc.items()}
            out, nc = SSD.mamba2_fwd(
                _take(hook({name: leaf[li] for name, leaf in blocks.items()},
                           li, "blocks"), "ssm_"), x, cfg, cache=c, tp=tp)
            for name, t in nc.items():
                c[name].copy_(t)
            x = x + (out if tp is None else tp.reduce(out))
            if kv is not None and (li + 1) % cfg.attn_every == 0:
                g = li // cfg.attn_every
                x = _dense_block_fwd(params["shared_attn"], x, cfg,
                                     positions=positions, window=window,
                                     cache={name: leaf[g]
                                            for name, leaf in kv.items()},
                                     cache_pos=pos,
                                     kernel_mode=self.kernel_mode, tp=tp)
        return x

    def _moe_stack_decode(self, params: dict, x: torch.Tensor,
                          positions: torch.Tensor, pos: torch.Tensor,
                          cache: dict, window: int,
                          hook=_no_hook, tp=None) -> torch.Tensor:
        """One decode step through ``dense0`` and then the moe ``blocks``,
        each row over its own cache row (MLA's latent rows or GQA's k/v),
        written in place.  The step's B tokens share the routers'
        capacity, as the reference's do.  ``tp``: the parallel form, over
        the rank's kv heads' cache rows (MLA's whole)."""
        cfg, rt = self.cfg, self.runtime
        attn = dict(positions=positions, window=window,
                    seq_chunk=rt.seq_chunk, cache_pos=pos,
                    kernel_mode=self.kernel_mode)
        for seg in layer_layout(cfg):
            stack, seg_cache = params[seg.path], cache[seg.path]
            for li in range(seg.count):
                p = {name: leaf[li] for name, leaf in stack.items()}
                if seg.path in HOOKED_SEGMENTS:
                    p = hook(p, li, seg.path)
                c = {name: leaf[li] for name, leaf in seg_cache.items()}
                if seg.path == "dense0":
                    x = _moe_dense0_fwd(p, x, cfg, tp=tp, cache=c, **attn)
                else:
                    x, _ = _moe_block_fwd(p, x, cfg, cache=c,
                                          moe_local=rt.moe_local_dispatch,
                                          tp=tp, **attn)
        return x

    @torch.inference_mode()
    def decode_step(self, params: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: dict, *, window: int = 0,
                    delta: Optional[dict] = None, layer_hook=None, tp=None):
        """One decode step. tokens: (B,) int; pos: 0-d int32, or a (B,)
        per-slot position vector over a ``per_slot`` cache.

        ``delta``: the serving overlay ``{"slots": (L, C) int32 owner ids
        (-1 = empty), "leaves": {name: (L, C, *shape) f32}}``.

        whisper: each decoder row's self-attention over its KV row, then
        its cross-attention over ``cache["cross_kv"]`` row ``li``, which
        the caller has filled from the encoder; one shared position only.
        A model without RoPE (whisper) embeds the token's row and adds the
        sinusoid of its position ``pos`` once (vocab-parallel under
        ``tp`` where the vocabulary divides).

        ``layer_hook(row_params, idx, "blocks")`` is applied to every
        ``blocks`` row before it runs (the mesh serve step gathers the
        row's ZeRO-3 shards there).

        ``tp``: the parallel form over ``model`` (the language models of
        the dense, vlm, ssm, hybrid, moe and audio families, no delta):
        this model coordinate's params, a cache of its kv heads (whisper's
        cross cache too) and Mamba2 channels and heads
        (``sharding.serve.shard_cache``; MLA's latent rows whole), the
        logits whole.

        Returns (logits (B, V), cache) — the cache updated in place.
        """
        cfg = self.cfg
        if tp is not None and delta is not None:
            raise ValueError("a tensor-parallel decode takes no delta "
                             "overlay")
        if delta is not None and not supports_delta_decode(cfg):
            raise ValueError(f"family {cfg.family!r} has no delta-decode path")
        per_slot = pos.dim() == 1
        if per_slot and cfg.family == "audio":
            raise ValueError(
                "family 'audio' decodes at one shared position only: the "
                "reference's cross-attention under per-slot positions does "
                "not run, and neither package fills a slot's cross cache "
                "from the encoder")
        if cfg.rope_theta == 0.0:
            # sinusoidal position of the *current* slot, added once
            sp = (B.sinusoid_positions(pos[:, None], cfg.d_model) if per_slot
                  else B.sinusoid_positions(pos[None], cfg.d_model)[None])
            x = self._token_rows(params, tokens[:, None], tp)
            x = x + sp.to(x.dtype)
        else:
            x = self._embed_tokens(params, tokens[:, None], tp)
        positions = (pos[:, None] if per_slot else pos[None]).to(torch.int32)
        w = window or cfg.sliding_window
        hook = layer_hook or _no_hook
        if cfg.family in ("ssm", "hybrid"):
            x = self._mamba_stack_decode(params, x, positions, pos, cache, w,
                                         hook, tp)
            return self._head(params, x, tp)[:, 0], cache
        if cfg.family == "moe":
            x = self._moe_stack_decode(params, x, positions, pos, cache, w,
                                       hook, tp)
            return self._head(params, x, tp)[:, 0], cache
        blocks, kv = params["blocks"], cache["blocks"]
        xkv = cache.get("cross_kv")
        for li in range(cfg.n_layers):
            p = hook({name: leaf[li] for name, leaf in blocks.items()}, li,
                     "blocks")
            kv_l = {name: leaf[li] for name, leaf in kv.items()}
            dl = None
            if delta is not None:
                dl = (delta["slots"][li],
                      {name: leaf[li] for name, leaf in delta["leaves"].items()})
            x = _dense_block_fwd(p, x, cfg, positions=positions, window=w,
                                 cache=kv_l, cache_pos=pos, delta=dl,
                                 kernel_mode=self.kernel_mode,
                                 cross_kv=None if xkv is None
                                 else (xkv["k"][li], xkv["v"][li]), tp=tp)
        return self._head(params, x, tp)[:, 0], cache
