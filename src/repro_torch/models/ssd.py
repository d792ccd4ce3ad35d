"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060]
(counterpart of ``repro/models/ssd.py``).

Sequences are processed in chunks: inside a chunk the output is dense
matmuls, and only an (H, P, N) state crosses chunk boundaries.
:func:`ssd_chunked` is the differentiable model function in plain PyTorch;
:func:`mamba2_fwd`'s sequence branch runs the scan through
``kernels.ops.ssd`` (the ``ssd_scan`` Hopper kernel on the card, whose
backward recomputes through :func:`ssd_chunked`).

Shapes: x (B,S,H,P) — H SSD heads of headdim P; dt (B,S,H); A_log (H,);
B/C (B,S,G,N) — G groups of state size N (broadcast over H//G heads).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as _kops
from repro_torch.models.blocks import rms_norm


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i,j] = sum_{k=j+1..i} x[k]; -inf above diag."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(T, device=x.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor],
                chunk: int, initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD forward. Returns (y, final_state).

    y: (B,S,H,P) in x's type; final_state: (B,H,P,N) f32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc, cl = s // chunk, chunk
    rep = h // g

    A = -torch.exp(A_log.float())                              # (h,)
    dtf = dt.float()
    dA = dtf * A                                               # (b,s,h)
    xdt = x.float() * dtf[..., None]                           # (b,s,h,p)

    # broadcast groups over heads (head h reads group h // rep)
    Bh = torch.repeat_interleave(B.float(), rep, dim=2)        # (b,s,h,n)
    Ch = torch.repeat_interleave(C.float(), rep, dim=2)

    xc = xdt.reshape(b, nc, cl, h, p)
    Bc = Bh.reshape(b, nc, cl, h, n)
    Cc = Ch.reshape(b, nc, cl, h, n)
    dAc = dA.reshape(b, nc, cl, h)
    dAcs = torch.cumsum(dAc, dim=2)                            # (b,nc,cl,h)

    # --- intra-chunk (dense matmuls) ---------------------------------------
    L = torch.exp(segsum(dAc.permute(0, 1, 3, 2)))             # (b,nc,h,cl,cl)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)

    # --- chunk states --------------------------------------------------------
    decay_states = torch.exp(dAcs[:, :, -1:, :] - dAcs)        # (b,nc,cl,h)
    states = torch.einsum("bckhn,bckh,bckhp->bchpn", Bc, decay_states, xc)

    # --- inter-chunk recurrence (sequential over chunks) --------------------
    chunk_decay = torch.exp(dAcs[:, :, -1, :])                 # (b,nc,h)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)                 # the state *entering* chunk c
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (b,nc,h,p,n)

    decay_out = torch.exp(dAcs)                                # (b,nc,cl,h)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc, prev_states,
                         decay_out)

    y = (y_diag + y_off).reshape(b, s, h, p)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: Optional[torch.Tensor]):
    """Single-token SSD update. x (B,1,H,P); state (B,H,P,N). O(1) in context.
    Returns (y (B,1,H,P) in x's type, new state in state's type)."""
    h = x.shape[2]
    g = B.shape[2]
    rep = h // g
    A = -torch.exp(A_log.float())
    dtf = dt.float()[:, 0]                                     # (b,h)
    dA = torch.exp(dtf * A)                                    # (b,h)
    Bh = torch.repeat_interleave(B.float(), rep, dim=2)[:, 0]  # (b,h,n)
    Ch = torch.repeat_interleave(C.float(), rep, dim=2)[:, 0]
    xf = x.float()[:, 0]                                       # (b,h,p)
    new_state = (state.float() * dA[..., None, None]
                 + torch.einsum("bhp,bhn,bh->bhpn", xf, Bh, dtf))
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    return y[:, None].to(x.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_param_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in = cfg.d_inner
    h = cfg.resolved_ssm_heads
    g, n, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    conv_dim = d_in + 2 * g * n
    return {
        "ln": (d,),
        "in_proj": (d, 2 * d_in + 2 * g * n + h),   # z | x | B | C | dt
        "conv_w": (K, conv_dim),
        "conv_b": (conv_dim,),
        "dt_bias": (h,),
        "A_log": (h,),
        "D": (h,),
        "gate_ln": (d_in,),
        "out_proj": (d_in, d),
    }


def _split_in_proj(zxbcdt: torch.Tensor, d_in: int, gn: int):
    """z | x | B | C | dt → (z, x | B | C, dt): ``d_in`` channels of z
    and x, ``gn`` = G·N columns of B and of C."""
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * gn]   # conv applies to x|B|C jointly
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xbc, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d via K shifted adds. u: (B,S,Cd), w: (K,Cd).
    (Not ``F.conv1d``: cuDNN runs f32 convolutions in TF32 by default.)"""
    K = w.shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + pad[:, k:k + S] * w[k]
    return F.silu(out + b)


def _conv_decode(u: torch.Tensor, conv_cache: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor):
    """u: (B,1,Cd); conv_cache: (B,K-1,Cd) holding previous inputs."""
    window = torch.cat([conv_cache, u], dim=1)                 # (B,K,Cd)
    out = torch.einsum("bkc,kc->bc", window, w)[:, None]
    new_cache = window[:, 1:]
    return F.silu(out + b), new_cache


def _heads_groups(t: torch.Tensor, first: int, count: int,
                  h: int) -> torch.Tensor:
    """B or C (…, G, N) for heads [first, first + count) of ``h``: head j
    reads group j // (h // G), so with one group every head reads it; else
    each head's group, in head order."""
    g = t.shape[-2]
    if g == 1:
        return t
    idx = torch.arange(first, first + count, device=t.device) // (h // g)
    return t.index_select(t.dim() - 2, idx)


def _gate_norm(y: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig,
               tp=None) -> torch.Tensor:
    """``blocks.rms_norm`` over the whole ``d_inner``.  Under ``tp`` the
    last dim of ``y`` holds this model coordinate's channels: Σ y² over
    them is summed over ``model`` in both directions (``tp.reduce_stat``),
    and the mean divides by ``cfg.d_inner``, not by the local width."""
    dt = y.dtype
    y = y.float()
    sq = torch.square(y).sum(-1, keepdim=True)
    var = (sq if tp is None else tp.reduce_stat(sq)) / cfg.d_inner
    return ((y * torch.rsqrt(var + cfg.norm_eps))
            * (1.0 + scale.float())).to(dt)


def mamba2_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
               cache: Optional[dict] = None, mode: Optional[str] = None,
               tp=None):
    """Mamba2 block (pre-norm, residual added by caller).

    cache: {"conv": (B,K-1,Cd), "state": (B,H,P,N)} for decode.
    ``mode`` picks the scan's implementation (``kernels.ops.ssd``).

    ``tp`` (``sharding.tensor_parallel.ModelAxis``): the parallel form
    over ``model``.  ``p`` holds this model coordinate's weights
    (``TPLayout.compute_slice``): ``in_proj`` z_m | x_m | B | C | dt_m,
    the conv's x_m | B | C, its heads' ``dt_bias`` / ``A_log`` / ``D``,
    its channels' ``gate_ln`` and ``out_proj`` rows; the normed input
    passes ``tp.copy`` (f), the scan runs on ``tp.ssm_heads`` heads, the
    gate norm's statistic is summed over ``model`` and the result is this
    coordinate's partial sum, which the caller reduces.  A cache holds the
    rank's conv channels and state heads (``rules.tp_shard_cache``).
    Returns (out, new_cache).
    """
    B_, S, _ = x.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, d_in = cfg.resolved_ssm_heads, cfg.d_inner
    phead = d_in // h
    if tp is not None:
        h, d_in = tp.ssm_heads, tp.d_inner

    hid = rms_norm(x, p["ln"], cfg.norm_eps)
    if tp is not None:
        hid = tp.copy(hid)
    z, xbc, dt = _split_in_proj(hid @ p["in_proj"], d_in, g * n)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    new_cache = None
    if cache is None:
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    else:
        xbc, conv_cache = _conv_decode(xbc, cache["conv"], p["conv_w"],
                                       p["conv_b"])
    xs = xbc[..., :d_in].reshape(B_, S, h, phead)
    Bs = xbc[..., d_in:d_in + g * n].reshape(B_, S, g, n)
    Cs = xbc[..., d_in + g * n:].reshape(B_, S, g, n)
    if tp is not None:
        H = cfg.resolved_ssm_heads
        Bs = _heads_groups(Bs, tp.ssm_head_first, h, H)
        Cs = _heads_groups(Cs, tp.ssm_head_first, h, H)
    if cache is None:
        y = _kops.ssd(xs, dt, p["A_log"], Bs, Cs, p["D"],
                      chunk=min(cfg.ssm_chunk, S), mode=mode)
    else:
        y, state = ssd_decode_step(cache["state"], xs, dt, p["A_log"], Bs,
                                   Cs, p["D"])
        new_cache = {"conv": conv_cache, "state": state}

    y = y.reshape(B_, S, d_in) * F.silu(z)
    y = _gate_norm(y, p["gate_ln"], cfg, tp)
    return y @ p["out_proj"], new_cache


def mamba2_cache_shapes(cfg: ArchConfig, batch: int) -> dict:
    d_in = cfg.d_inner
    h = cfg.resolved_ssm_heads
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": (batch, cfg.ssm_conv - 1, conv_dim),
        "state": (batch, h, d_in // h, cfg.ssm_state),
    }
