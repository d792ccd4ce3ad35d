"""Blocked (flash) attention, forward and backward (counterpart of
``repro/kernels/flash_attention.py``).

Streaming-softmax attention with GQA (q head h reads kv head h // (H/K)), a
causal mask and a sliding window (``window`` > 0: query i sees key j only
if i − j < window); f32 running max, normaliser and accumulator; masked
scores are −1e30 and their probabilities are zeroed, so a fully masked row
outputs 0.  Positions are the indices 0 … S−1.

Two routes, chosen by :func:`route` from the type and the head dim alone:

* ``"mma"`` — bf16 with D ≤ 128 and D % 8 == 0 (TinyLlama, SmolLM, XLM-R
  and CLIP at 64; Llama-2, CodeQwen and Grok at 128): the tensor-core
  kernels (bf16 ``mma.sync`` with f32 accumulation, ``cp.async`` staging).
  P and dS are rounded to bf16 as operands of the next product, as SDPA's
  kernels round them.  The inputs' base addresses must be 16-byte aligned
  and their (b, h, s) strides multiples of 8 elements (:func:`check_aligned`).
  The dK/dV pass splits each kv head's group of q heads over
  :func:`dkdv_parts` blocks when the card would otherwise idle, with a
  second, fixed-order pass over f32 partial sums.
* ``"simt"`` — f32 at any D ≤ 256, and bf16 above D 128 (Gemma and
  PaliGemma at 256) or at a D that is not a multiple of 8: the f32 SIMT
  kernels, exact in f32 (the reduced card-vs-CPU round relies on them).

Anything else raises; a CUDA tensor never falls back to another route or
to the plain version.  :func:`flash_attention` launches the forward and
returns (O, lse), lse = m + log l per row in f32 (natural log), which the
backward needs; :func:`flash_attention_bwd` launches the backward
(FlashAttention-2's split: dQ and Δ by query block, dK/dV by key block, P
recomputed from Q, K and lse; no atomics, the same bits on every launch).
Both take the reference's (B,H,S,D) layout as strided views, so the
model's (B,S,H,D) projections are read in place, and return their outputs
as (B,H,S,D) views of (B,S,H,D) memory.  :func:`flash_attention_torch` is
the plain forward, replaying ``flash_attention_jnp``'s blocked streaming
softmax in f32 (any S: the ragged last block is masked);
:func:`flash_attention_bwd_torch` is the plain backward, dense f32 math
from lse.

The TPU kernel this replaces, ``repro/kernels/flash_attention.py::
flash_attention`` (line 86; body ``_flash_kernel`` line 27), has no
backward: the reference differentiates ``attend_full`` with XLA.  What
bounds the port's kernels on the card, and what their design does about it,
is in the CUDA source's header.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_FLOAT_TYPES = (torch.bfloat16, torch.float32)
MAX_D = 256              # the widest head dim the kernels take (kMaxD)
ROUTES = ("simt", "mma")      # the launch functions' route argument: 0, 1
MMA_MAX_D = 128          # the widest head dim of the tensor-core route
DKDV_BLOCK_K = 64        # keys per dK/dV block on the tensor-core route
# The SMs that :func:`dkdv_parts` plans for on the meta device, which has
# none: an H100 SXM's, the card the dry run (``launch/dryrun.py``) models.
META_SMS = 132


def _visible(q_pos: torch.Tensor, k_pos: torch.Tensor, S: int, causal: bool,
             window: int) -> torch.Tensor:
    """(…, Q, K) bool: key k_pos is a real key that query q_pos sees."""
    q, k = q_pos[..., :, None], k_pos[..., None, :]
    ok = k < S
    if causal:
        ok = ok & (k <= q)
    if window:
        ok = ok & ((q - k) < window)
    return ok


def _heads(t: torch.Tensor, group: int) -> torch.Tensor:
    """(B,K,S,D) → (B,H,S,D) in f32: q head h reads kv head h // group."""
    return torch.repeat_interleave(t.float(), group, dim=1)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_q: int = 128, block_k: int = 128):
    """Plain forward: q (B,H,S,D), k/v (B,K,S,D) → (o (B,H,S,D) in q's
    type, lse (B,H,S) f32).  The same key-block walk, f32 running max,
    normaliser and accumulator and masked-row handling as
    ``flash_attention_jnp``; S need not be a multiple of the blocks."""
    B, H, S, D = q.shape
    K = k.shape[1]
    if H % K:
        raise ValueError(f"q heads {H} not a multiple of kv heads {K}")
    block_q, block_k = min(block_q, S), min(block_k, S)
    nq, nk = -(-S // block_q), -(-S // block_k)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    def blocks(t, n, blk):                  # (B,H,S,D) f32 → (B·H,n,blk,D)
        t = torch.nn.functional.pad(t, (0, 0, 0, n * blk - S))
        return t.reshape(B * H, n, blk, D)
    qf = blocks(q.float(), nq, block_q)
    kf = blocks(_heads(k, H // K), nk, block_k)
    vf = blocks(_heads(v, H // K), nk, block_k)
    q_pos = torch.arange(nq * block_q, device=dev).reshape(nq, block_q)
    m = torch.full((B * H, nq, block_q, 1), NEG_INF, device=dev)
    l = torch.zeros((B * H, nq, block_q, 1), device=dev)
    acc = torch.zeros((B * H, nq, block_q, D), device=dev)
    for ki in range(nk):
        k_pos = ki * block_k + torch.arange(block_k, device=dev)
        ok = _visible(q_pos, k_pos, S, causal, window)      # (nq, bq, bk)
        s = torch.matmul(qf, kf[:, ki, None].transpose(-1, -2)) * scale
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, ki, None])
        m = m_new
    o = acc / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), math.inf)
    o = o.reshape(B, H, nq * block_q, D)[:, :, :S].to(q.dtype)
    return o, lse.reshape(B, H, nq * block_q)[:, :, :S]


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0):
    """Plain backward, dense f32 from the forward's lse: P = exp(s − lse)
    on the visible pairs, Δ = rowsum(dO ⊙ O), dS = P ⊙ (dO·Vᵀ − Δ).
    Returns (dq, dk, dv) in the types and (B,H,S,D) / (B,K,S,D) shapes of
    q, k, v; dk and dv sum over each kv head's group of q heads."""
    B, H, S, D = q.shape
    K = k.shape[1]
    group = H // K
    scale = 1.0 / math.sqrt(D)
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = _heads(k, group), _heads(v, group)
    pos = torch.arange(S, device=q.device)
    ok = _visible(pos, pos, S, causal, window)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.reshape(B, K, group, S, D).sum(2)
    dv = dv.reshape(B, K, group, S, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The Hopper kernels
# ---------------------------------------------------------------------------

def route(dtype: torch.dtype, d: int) -> str:
    """The kernels that take inputs of this type and head dim: ``"mma"``
    (bf16, D ≤ 128, D % 8 == 0) or ``"simt"`` (f32 to D 256; bf16 above D
    128 or at a D that is not a multiple of 8).  Raises on anything else."""
    if dtype not in _FLOAT_TYPES or not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: no kernel takes {dtype} at head "
                         f"dim {d} (bf16 or f32, 1 <= D <= {MAX_D})")
    if dtype == torch.bfloat16 and d <= MMA_MAX_D and d % 8 == 0:
        return "mma"
    return "simt"


def dkdv_parts(B: int, K: int, S: int, group: int, sms: int) -> int:
    """How many blocks share one (key block, kv head) of the tensor-core
    dK/dV pass: the smallest divisor p of the group of q heads per kv head
    with B·K·⌈S/64⌉·p ≥ 2·``sms`` (two dK/dV blocks are resident on an SM,
    and under a causal mask the heaviest key block does ⌈S/64⌉ times the
    lightest one's work, so a grid that only just fills the resident slots
    waits on its heaviest blocks), else the whole group.  Each part sums
    its q heads; a second pass adds the parts in order."""
    blocks = B * K * -(-S // DKDV_BLOCK_K)
    for p in range(1, group + 1):
        if group % p == 0 and blocks * p >= 2 * sms:
            return p
    return group


def dkdv_grid(route_: str, B: int, K: int, S: int, d: int,
              parts: int = 1) -> tuple:
    """The dK/dV kernel's grid: on the tensor-core route (parts × kv heads
    × batch, key blocks), the heaviest key blocks dispatched first; on the
    SIMT route (key blocks, kv heads, batch)."""
    if route_ == "mma":
        return (parts * K * B, -(-S // DKDV_BLOCK_K))
    return (-(-S // (64 if d <= 128 else 32)), K, B)


def check_aligned(name: str, shape, strides, addr: int) -> None:
    """The tensor-core route copies 16-byte rows with ``cp.async``: the
    base address must be 16-byte aligned and each (b, h, s) stride of a
    bf16 (B,H,S,D) view a multiple of 8 elements (size-1 axes aside).
    Raises ValueError otherwise."""
    bad = [s for n, s in zip(shape[:3], strides[:3]) if n > 1 and s % 8]
    if addr % 16 or bad:
        raise ValueError(f"flash_attention: {name} is not aligned for the "
                         f"tensor-core kernels (address {addr:#x} must be a "
                         f"multiple of 16 bytes, strides {tuple(strides)} "
                         f"multiples of 8 elements)")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib():
    lib = _build.load_library("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = (
        [ptr] * 5 + [i32] * 9 + [f32, ptr, ptr])
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 12 + [i32] * 10 + [f32, ptr, ptr])
    lib.flash_attention_fwd_launch.restype = i32
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window: int, **more) -> str:
    """Raise on anything the kernels do not take; return the route."""
    ts = {"q": q, "k": k, "v": v, **more}
    for name, t in ts.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; the "
                             f"kernel takes CUDA tensors on one device")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-d with a "
                             f"contiguous last axis, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    B, H, S, D = q.shape
    K = k.shape[1]
    if (k.shape != (B, K, S, D) or v.shape != k.shape or H % K
            or any(t.shape != q.shape for t in more.values())):
        raise ValueError(f"flash_attention: want q (B,H,S,D), k/v (B,K,S,D) "
                         f"with H % K == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    route_ = route(q.dtype, D)
    if not (S >= 1 and 1 <= B <= 65535 and 1 <= H <= 65535 and window >= 0):
        raise ValueError(f"flash_attention: the kernel takes S >= 1, B and H "
                         f"<= 65535, window >= 0; got S {S}, B {B}, H {H}, "
                         f"window {window}")
    if route_ == "mma":
        for name, t in ts.items():
            check_aligned(name, t.shape, t.stride(), t.data_ptr())
    return route_


def _model_layout_empty(B, H, S, D, like) -> torch.Tensor:
    """(B,H,S,D) view of fresh (B,S,H,D) memory."""
    return torch.empty((B, S, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _fwd_buffers(q: torch.Tensor):
    """The forward's outputs: o (B,H,S,D) over (B,S,H,D) memory, lse
    (B,H,S) f32."""
    B, H, S, D = q.shape
    return (_model_layout_empty(B, H, S, D, q),
            torch.empty((B, H, S), dtype=torch.float32, device=q.device))


def _bwd_buffers(q, k, v, lse, route_: str, sms: int):
    """The backward's outputs and scratch: (parts, Δ, dq, dk, dv, and the
    split's f32 partial dK and dV, or None when it has one part)."""
    B, H, S, D = q.shape
    K = k.shape[1]
    parts = dkdv_parts(B, K, S, H // K, sms) if route_ == "mma" else 1
    delta = torch.empty_like(lse)
    dq = _model_layout_empty(B, H, S, D, q)
    dk = _model_layout_empty(B, K, S, D, k)
    dv = _model_layout_empty(B, K, S, D, v)
    part_dk = part_dv = None
    if parts > 1:
        part_dk, part_dv = (torch.empty((parts, B, K, S, D),
                                        dtype=torch.float32, device=q.device)
                            for _ in range(2))
    return parts, delta, dq, dk, dv, part_dk, part_dv


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0):
    """What :func:`flash_attention` allocates and returns, on the meta
    device, with no launch: (o, lse).  Raises where :func:`route` does."""
    route(q.dtype, q.shape[-1])
    return _fwd_buffers(q)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """What :func:`flash_attention_bwd` allocates (the split's scratch
    planned for :data:`META_SMS`), on the meta device, with no launch:
    (dq, dk, dv)."""
    route_ = route(q.dtype, q.shape[-1])
    _, _, dq, dk, dv, _, _ = _bwd_buffers(q, k, v, lse, route_, META_SMS)
    return dq, dk, dv


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        text = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           f"{text} (cudaError {err})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0):
    """Launch the forward kernel of :func:`route`'s route on the current
    stream: q (B,H,S,D), k/v (B,K,S,D) CUDA views, bf16 or f32, last axis
    contiguous.  Returns (o, lse): o (B,H,S,D) in q's type (a view of
    (B,S,H,D) memory), lse (B,H,S) f32.  Raises on anything the route does
    not take, and if the launch fails."""
    route_ = _check(q, k, v, window)
    o, lse = _fwd_buffers(q)
    B, H, S, D = q.shape
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, k.shape[1], S, D, causal, window,
        q.dtype == torch.bfloat16, ROUTES.index(route_), 1.0 / math.sqrt(D),
        _strides(q, k, v, o), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "forward")
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """Launch the backward kernels of :func:`route`'s route (dQ, then
    dK/dV, then on the tensor-core route the sum of the split's parts) on
    the current stream.  o and lse are the forward's; do is dL/do, (B,H,S,D)
    like q.  Returns (dq, dk, dv) in the inputs' type, as (B,H,S,D) /
    (B,K,S,D) views of model-layout memory.  The dQ kernel writes Δ =
    rowsum(dO ⊙ O) to a (B,H,S) f32 scratch that the dK/dV kernel reads."""
    route_ = _check(q, k, v, window, o=o, do=do)
    B, H, S, D = q.shape
    K = k.shape[1]
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention: lse must be contiguous (B,H,S) "
                         f"f32 on q's device, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    parts, delta, dq, dk, dv, part_dk, part_dv = _bwd_buffers(
        q, k, v, lse, route_, _sm_count(q.device.index or 0))
    err = _lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part_dk.data_ptr() if parts > 1 else None,
        part_dv.data_ptr() if parts > 1 else None, B, H, K, S, D, causal,
        window, q.dtype == torch.bfloat16, ROUTES.index(route_), parts,
        1.0 / math.sqrt(D), _strides(q, k, v, o, do, dq, dk, dv),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "backward")
    return dq, dk, dv
