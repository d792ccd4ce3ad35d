"""Transformer building blocks (counterpart of ``repro/models/blocks.py``).

Norms, RoPE, GQA attention and gated MLPs on plain tensors, with the
reference's parameter layout: stacked ``(L, …)`` leaves in the same key
order, consumed one layer at a time by a Python loop (``models/model.py``).

Decode writes its token into the KV cache **in place** (the reference
returns a new cache) and attends over it with :func:`attend_full`.  The
no-cache full-sequence self-attention (training, prefill) goes through
``kernels.ops.flash_attention``: the Hopper kernels on the card, their
plain blocked version on the CPU; it never materialises the (S, S) scores.
That is where the reference's docstring puts its Pallas kernel (it runs
plain jnp there); the kernel choice follows the tensor's device, never
``RuntimeConfig.use_pallas``.  Only the vlm prefix-LM (``prefix_len`` > 0),
which the kernel's mask lacks, keeps the reference's path: in one piece,
or query chunk by query chunk (:func:`attend_chunked`) when the sequence
is a multiple of ``seq_chunk`` longer than it.  Encoder-decoder
cross-attention (whisper) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as _kops

# Large-negative constant for masking (safe in bf16/f32).
NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "gelu_plain": _gelu_tanh}[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embedding at given integer positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[..., None] * freqs          # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd/2) (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(positions: torch.Tensor, d_model: int,
                       scale: float = 0.02) -> torch.Tensor:
    """Sinusoidal position encodings at the token-embedding init scale."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return scale * torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int, prefix_len: int = 0,
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask bias (Q, K) from positions (f32, 0 or NEG_INF).

    ``prefix_len``: positions < prefix_len see each other bidirectionally
    (PaliGemma prefix-LM).  ``window``: sliding window (0 = unlimited).
    ``k_valid``: optional bool (K,) marking populated cache slots.
    """
    q = q_pos[:, None]
    k = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        vis = k <= q
        if prefix_len:
            vis = vis | ((k < prefix_len) & (q < prefix_len))
        ok &= vis
    if window:
        ok &= (q - k) < window
    if k_valid is not None:
        ok &= k_valid[None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def _mask_bias_per_slot(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool, window: int,
                        k_valid: torch.Tensor) -> torch.Tensor:
    """Batched :func:`_mask_bias`: q_pos (B,Sq), k_pos/k_valid (B,Sk) →
    (B,Sq,Sk), every slot at its own position in its own cache row."""
    q = q_pos[:, :, None]
    k = k_pos[:, None, :]
    ok = k_valid[:, None, :].expand(-1, q_pos.shape[1], -1)
    if causal:
        ok = ok & (k <= q)
    if window:
        ok = ok & ((q - k) < window)
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Per-slot delta overlays (personalized-delta serving, DESIGN.md §9)
# ---------------------------------------------------------------------------

def per_slot_param(base: torch.Tensor, drows: torch.Tensor,
                   slots: torch.Tensor, B: int) -> torch.Tensor:
    """Effective small parameter (norm scale / bias) per slot.

    base: (*shape,); drows: (C, *shape); slots: (C,) int32, -1 = empty.
    Returns (B, 1, *shape) in base's type: base + the slot's delta rows.
    """
    safe = slots.clamp(min=0).long()
    m = (slots >= 0).float().reshape((-1,) + (1,) * base.dim())
    add = torch.zeros((B,) + tuple(base.shape), dtype=torch.float32,
                      device=base.device)
    add.index_add_(0, safe, m * drows.float())
    return (base.float()[None] + add)[:, None].to(base.dtype)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k/v: (B,Sk,K,hd)  bias: (Sq,Sk) shared, or
    (B,Sq,Sk) per slot.  GQA by reshape, f32 softmax, cast to v's type."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[2]
    g = H // Kh
    qg = q.reshape(B, Sq, Kh, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    logits = logits + (bias[:, None, None] if bias.dim() == 3
                       else bias[None, None, None])
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, k_positions: torch.Tensor,
                   causal: bool, window: int, prefix_len: int, chunk: int,
                   scale: float, remat_chunk: bool = False) -> torch.Tensor:
    """Query-chunked attention: peak memory O(chunk × Sk) per head.

    Each query chunk attends to the full key range with a position-derived
    mask; equal to :func:`attend_full`.  ``remat_chunk`` checkpoints each
    chunk, so the backward recomputes one chunk's scores at a time.
    """
    B, Sq, H, hd = q.shape
    if Sq % chunk:
        raise ValueError(f"seq {Sq} not divisible by chunk {chunk}")

    def attend_chunk(qi, pi):
        bias = _mask_bias(pi, k_positions, causal=causal, window=window,
                          prefix_len=prefix_len)
        return attend_full(qi, k, v, bias, scale)

    outs = []
    for c in range(Sq // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if remat_chunk and torch.is_grad_enabled():
            outs.append(checkpoint(attend_chunk, q[:, sl], q_positions[sl],
                                   use_reentrant=False))
        else:
            outs.append(attend_chunk(q[:, sl], q_positions[sl]))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Attention block (params + forward)
# ---------------------------------------------------------------------------

def attn_param_shapes(cfg: ArchConfig) -> dict:
    d, H, Kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {
        "ln": (d,),
        "wq": (d, H * hd),
        "wk": (d, Kh * hd),
        "wv": (d, Kh * hd),
        "wo": (H * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (H * hd,), "bk": (Kh * hd,), "bv": (Kh * hd,)})
    return shapes


def init_stacked(gen: torch.Generator, shapes: dict, n: int, dtype,
                 device, scale: float = 0.02) -> dict:
    """Initialise a stack of ``n`` layers of the given param shapes.

    Keys in ``sorted(shapes)`` order, as the reference builds them; leaves
    are drawn one after another from ``gen`` (the reference splits a JAX
    key, so the numbers differ, the rules do not).  Zeros for names that
    start with ``b``, are ``ln`` or end in ``_bias``; N(0, scale²) for the
    rest.  The reference also has rules for ``A_log`` (log U[1, 16)) and
    ``D`` (ones), but the ssm leaves reach it prefixed (``ssm_A_log``,
    ``ssm_D``), so those never fire: ``ssm_A_log``, ``ssm_D``, ``ssm_ln``,
    ``ssm_gate_ln`` and ``ssm_conv_b`` are N(0, 0.02) and only
    ``ssm_dt_bias`` is zeros, so A = −exp(A_log) ≈ −1.  The port keeps
    exactly those rules.

    A stacked leaf is drawn row by row into its ``dtype`` tensor, so the
    f32 transient is one row, not the whole stack (DeepSeek-V2-Lite's
    ``moe_wi_e`` is 369 M elements a row: 38.4 GB of f32 over 26 rows)."""
    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    params = {}
    for name, shp in sorted(shapes.items()):
        full = (n, *shp) if n else tuple(shp)
        if name.startswith("b") or name == "ln" or name.endswith("_bias"):
            params[name] = torch.zeros(full, dtype=dtype, device=device)
        elif n:
            params[name] = torch.empty(full, dtype=dtype, device=device)
            for i in range(n):
                params[name][i] = normal(tuple(shp))
        else:
            params[name] = normal(full)
    return params


def attention_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor, cache: Optional[dict] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  causal: bool = True, window: int = 0, prefix_len: int = 0,
                  cross_kv: Optional[tuple] = None, seq_chunk: int = 1024,
                  remat_chunk: bool = False,
                  delta: Optional[dict] = None,
                  delta_slots: Optional[torch.Tensor] = None,
                  kernel_mode: Optional[str] = None):
    """One attention sub-block (pre-norm, residual added by caller).

    Without a cache (training, prefill) the block attends over its own
    sequence through :func:`repro_torch.kernels.ops.flash_attention`
    (``kernel_mode`` as there: ``"torch"`` forces the plain version).  The
    kernel derives positions from indices, so this branch relies on
    ``positions`` being ``arange(S)``, as ``Model.forward_seq`` passes
    them.  It masks with −1e30 and zeroes the masked probabilities where
    :func:`attend_full` adds a −1e9 bias; with arange positions every
    causal or windowed row sees its own diagonal, so no row is fully masked
    and the two agree up to f32 rounding (and the bf16 cast of the softmax
    weights that :func:`attend_full` makes).  The vlm prefix-LM
    (``prefix_len`` > 0: the prefix attends bidirectionally, which the
    kernel's mask cannot say) keeps the reference's path: in one piece, or
    by query chunks of ``seq_chunk`` when the sequence is a longer multiple
    of it (``remat_chunk`` recomputes each chunk in the backward).
    ``cross_kv`` (whisper) is not ported.

    cache: {"k": (B,W,Kh,hd), "v": ..., "pos": (W,) int32} — decode writes
    the current token at ring index ``cache_pos % W`` (in place) and attends
    over the cache.  With a per-slot serving cache (``pos`` (B, W),
    ``cache_pos`` (B,)) every batch row sits at its own stream position.

    delta/delta_slots: this layer's capacity-C overlay entries
    ({leaf_name: (C, *shape)} + (C,) owner slots, -1 = empty); projections
    then go through :func:`repro_torch.kernels.ops.base_delta_matmul`
    (``kernel_mode`` likewise).
    """
    if cross_kv is not None:
        raise NotImplementedError(
            "encoder-decoder cross-attention (whisper) is not ported yet: "
            "ROADMAP.md Queue 1 item 10, 'Other model families'")
    B, S, d = x.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)

    def proj(h_, name):
        if delta is not None and name in delta:
            return _kops.base_delta_matmul(h_, p[name], delta[name],
                                           delta_slots, mode=kernel_mode)
        return h_ @ p[name]

    ln = p["ln"]
    if delta is not None and "ln" in delta:
        ln = per_slot_param(ln, delta["ln"], delta_slots, B)
    h = rms_norm(x, ln, cfg.norm_eps)
    q = proj(h, "wq").reshape(B, S, H, hd)
    k = proj(h, "wk").reshape(B, S, Kh, hd)
    v = proj(h, "wv").reshape(B, S, Kh, hd)
    if cfg.qkv_bias:
        def bias_term(name, nh):
            if delta is not None and name in delta:
                return per_slot_param(p[name], delta[name], delta_slots,
                                      B).reshape(B, 1, nh, hd)
            return p[name].reshape(nh, hd)
        q = q + bias_term("bq", H)
        k = k + bias_term("bk", Kh)
        v = v + bias_term("bv", Kh)

    if cfg.rope_theta:
        cos_q, sin_q = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_q, sin_q)

    if cache is None:
        if not prefix_len:
            out = _kops.flash_attention(q, k, v, causal=causal,
                                        window=window, mode=kernel_mode)
        elif S > seq_chunk and S % seq_chunk == 0:
            out = attend_chunked(q, k, v, q_positions=positions,
                                 k_positions=positions, causal=causal,
                                 window=window, prefix_len=prefix_len,
                                 chunk=seq_chunk, scale=scale,
                                 remat_chunk=remat_chunk)
        else:
            bias = _mask_bias(positions, positions, causal=causal,
                              window=window, prefix_len=prefix_len)
            out = attend_full(q, k, v, bias, scale)
        return proj(out.reshape(B, S, H * hd), "wo")
    W = cache["k"].shape[1]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    if cpos.dim() == 2:
        # Per-slot serving decode: S == 1, cache_pos (B,), pos rows (B, W).
        slot = (cache_pos % W).long()
        bidx = torch.arange(B, device=x.device)
        ck.index_put_((bidx, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((bidx, slot), v[:, 0].to(cv.dtype))
        cpos.index_put_((bidx, slot), cache_pos.to(torch.int32))
        k_valid = cpos <= cache_pos[:, None]
        bias = _mask_bias_per_slot(positions, cpos, causal=causal,
                                   window=window, k_valid=k_valid)
    else:
        # Decode at one shared position: write k/v at cache_pos % W.
        slot = (cache_pos % W).long().reshape(1)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        cpos.index_copy_(0, slot, cache_pos.reshape(1).to(torch.int32))
        k_valid = cpos <= cache_pos          # populated & not future
        bias = _mask_bias(positions, cpos, causal=causal, window=window,
                          k_valid=k_valid)
    out = attend_full(q, ck, cv, bias, scale)
    return proj(out.reshape(B, S, H * hd), "wo")


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def mlp_param_shapes(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    """``d_ff`` overrides the config's width (deepseek's leading dense
    block: ``d_ff · (top_k + n_shared_experts)``)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "gelu_plain":           # non-gated (whisper, vit, roberta)
        return {"ln": (d,), "wi": (d, ff), "wo": (ff, d)}
    return {"ln": (d,), "wi": (d, 2 * ff), "wo": (ff, d)}   # gated: [gate|up]


def mlp_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
            delta: Optional[dict] = None,
            delta_slots: Optional[torch.Tensor] = None,
            delta_mode: Optional[str] = None) -> torch.Tensor:
    def proj(h_, name):
        if delta is not None and name in delta:
            return _kops.base_delta_matmul(h_, p[name], delta[name],
                                           delta_slots, mode=delta_mode)
        return h_ @ p[name]

    ln = p["ln"]
    if delta is not None and "ln" in delta:
        ln = per_slot_param(ln, delta["ln"], delta_slots, x.shape[0])
    h = rms_norm(x, ln, cfg.norm_eps)
    act = act_fn(cfg.mlp_act)
    if cfg.mlp_act == "gelu_plain":
        return proj(act(proj(h, "wi")), "wo")
    ff = p["wi"].shape[-1] // 2
    gu = proj(h, "wi")
    gate, up = gu[..., :ff], gu[..., ff:]
    return proj(act(gate) * up, "wo")
