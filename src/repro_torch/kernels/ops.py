"""Model-layout wrappers over the port's kernels (counterpart of
``repro/kernels/ops.py``: ``flash_attention`` line 48, ``ssd`` line 76,
``layer_grad_norms`` line 103, ``masked_sgd_update`` line 128,
``base_delta_matmul`` line 160).

Dispatch follows the tensor, never ``RuntimeConfig.use_pallas``: a CUDA
tensor launches the kernel (or the launch raises), a CPU tensor takes the
plain PyTorch version, and a meta tensor the meta route, which stands in
for the card in a dry run (``launch/dryrun.py``): it allocates exactly what
the CUDA route allocates (outputs, the forward's lse, each kernel's
scratch, and so the tensors saved for backward), computes nothing, and
counts and reports the launch as the CUDA route does.  ``mode`` forces
one: ``"torch"`` the plain version on any device, ``"cuda"`` the kernel (a
CPU tensor then raises; a meta tensor keeps the meta route).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import delta_matmul as _dmm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import layer_grad_norm as _lgn
from repro_torch.kernels import masked_update as _mu
from repro_torch.kernels import ssd_scan as _ssd

# Kernel launches made through this module, by kernel; the flash forward and
# backward and ssd_scan also by route (``flash_attention.route``,
# ``ssd_scan.route``: "mma" tensor cores, "simt").  Reset it to 0 before a
# run and read it after to show which kernels the run went through.
LAUNCHES = {"base_delta_matmul": 0, "flash_attention": 0,
            "flash_attention_mma": 0, "flash_attention_simt": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_mma": 0,
            "flash_attention_bwd_simt": 0, "layer_grad_norm": 0,
            "masked_update": 0, "ssd_scan": 0, "ssd_scan_mma": 0,
            "ssd_scan_simt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The work recorder that ``repro_torch.analysis.facts`` installs while it
# runs a program, else None.  The kernels launch through ``ctypes``, which
# PyTorch's dispatcher (and so ``FlopCounterMode``) never sees, so each
# launch below, on the CUDA and the meta route, reports its operations, its
# weight operands and the bytes it moves (each input read once, each output
# written once: the bytes of ``chip_smoke.py``'s bounds) here:
# ``RECORDER.launched(kernel, flops, weights, nbytes)``.  Operations are those of
# ``chip_smoke.py``'s bounds (PERF.md §6): flash and ``ssd_scan`` through
# :func:`flash_flops` and :func:`ssd_flops`, which the bounds call too, 2
# per element for ``layer_grad_norm`` and ``masked_update``, and for
# ``delta_matmul`` 2·d·f per row for the base and for every one of the C
# entries (live or not: which are live is on the card).  With no recorder,
# one None check.
RECORDER = None


def cache_stats() -> dict[str, int]:
    """Entries of every cache the kernels keep (the counterpart of the
    reference's ``jit_cache_stats()["programs"]``; eager PyTorch has no
    compiled-program cache): the libraries ``_build`` built or loaded, each
    kernel module's bound library, ``delta_matmul.plan``'s grids (one per
    shape) and flash's SM count (one per device).  Nothing else in the port
    caches by shape."""
    from repro_torch.kernels import _build
    caches = {"_build.load_library": _build.load_library,
              "delta_matmul._launcher": _dmm._launcher,
              "delta_matmul.plan": _dmm.plan,
              "flash_attention._lib": _fa._lib,
              "flash_attention._sm_count": _fa._sm_count,
              "layer_grad_norm._lib": _lgn._lib,
              "masked_update._lib": _mu._lib,
              "ssd_scan._lib": _ssd._lib}
    return {name: fn.cache_info().currsize for name, fn in caches.items()}


def flash_flops(b: int, h: int, d: int, s: int, causal: bool, window: int,
                backward: bool = False) -> int:
    """Operations of one flash forward (QKᵀ and PV, 4·d per visible
    (query, key) pair and head) or backward (its five products, 10·d):
    what the recorder is told and the ``flops`` of ``chip_smoke.py``'s
    flash bound."""
    pairs = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window else 0
        hi = q if causal else s - 1
        pairs += max(hi - lo + 1, 0)
    return (10 if backward else 4) * b * h * d * pairs


def ssd_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """Operations of one ``ssd_scan`` at chunk ``q``: the causal half of
    each chunk's Q × Q products, and the inter-chunk terms (none for the
    first chunk, no state update after the last).  The recorder's and
    ``chip_smoke.py``'s scan bound's count."""
    nc, tri = s // q, q * (q + 1) // 2
    return 2 * b * h * (nc * tri * (n + p) + 2 * (nc - 1) * q * n * p)


def _resolve_mode(mode: Optional[str], t: torch.Tensor) -> str:
    """The route of a call: "cuda" (the kernel), "torch" (its plain
    version) or "meta" (the kernel's allocations alone, for a meta
    tensor)."""
    if mode not in (None, "cuda", "torch"):
        raise ValueError(f"mode must be None, 'cuda' or 'torch', got {mode!r}")
    if t.is_meta and mode != "torch":
        return "meta"
    if mode is None:
        return "cuda" if t.is_cuda else "torch"
    return mode


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _launched(kernel: str, flops, weights=(), moved=()) -> None:
    """Count one launch of ``kernel`` and report it to :data:`RECORDER`:
    ``flops()`` operations, the ``weights`` operands, the bytes of the
    ``moved`` tensors (computed only when a recorder listens)."""
    LAUNCHES[kernel] += 1
    if RECORDER is not None:
        RECORDER.launched(kernel, flops(), weights, _nbytes(moved))


def _sorted_leaves(tree):
    """Leaves of a nested dict in sorted-key order, the order
    ``jax.tree.leaves`` visits a dict (sums across leaves follow it)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# flash attention (model layout: q (B,S,H,D), k/v (B,S,K,D))
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward: the ``flash_attention`` kernel of the inputs' route (or its
    plain version), saving q, k, v, O and the per-row lse, never the
    scores.  Backward: the backward kernels of the same route (or the plain
    backward) from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, mode):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if mode in ("cuda", "meta"):
            fwd = _fa.flash_attention if mode == "cuda" else \
                _fa.flash_attention_meta
            o, lse = fwd(qt, kt, vt, causal=causal, window=window)
            LAUNCHES["flash_attention_" + _fa.route(q.dtype, q.shape[-1])] += 1
            B, S, H, D = q.shape
            _launched("flash_attention", lambda: flash_flops(
                B, H, D, S, causal, window), moved=(q, k, v, o, lse))
        else:
            o, lse = _fa.flash_attention_torch(qt, kt, vt, causal=causal,
                                               window=window)
        out = o.transpose(1, 2)
        ctx.causal, ctx.window, ctx.mode = causal, window, mode
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, lse = ctx.saved_tensors
        args = [t.transpose(1, 2) for t in (q, k, v, out)]
        args += [lse, gout.contiguous().transpose(1, 2)]
        if ctx.mode in ("cuda", "meta"):
            bwd = _fa.flash_attention_bwd if ctx.mode == "cuda" else \
                _fa.flash_attention_bwd_meta
            grads = bwd(*args, causal=ctx.causal, window=ctx.window)
            LAUNCHES["flash_attention_bwd_" + _fa.route(q.dtype,
                                                        q.shape[-1])] += 1
            B, S, H, D = q.shape
            _launched("flash_attention_bwd", lambda: flash_flops(
                B, H, D, S, ctx.causal, ctx.window, backward=True),
                moved=(*args, *grads))
        else:
            grads = _fa.flash_attention_bwd_torch(*args, causal=ctx.causal,
                                                  window=ctx.window)
        dq, dk, dv = (g.transpose(1, 2) for g in grads)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Self-attention over positions 0 … S−1: q (B,S,H,D), k/v (B,S,K,D) →
    (B,S,H,D) in q's type.  One launch of the forward kernel on the card,
    the plain blocked version on the CPU (``mode`` forces either).
    Differentiable: the backward launches the two backward kernels (one
    ``flash_attention_bwd`` count) or runs the plain backward; under
    ``torch.no_grad()`` only the forward runs, and under activation
    checkpointing (``RuntimeConfig.remat``) the backward reruns it."""
    return _FlashAttention.apply(q, k, v, causal, window,
                                 _resolve_mode(mode, q))


# ---------------------------------------------------------------------------
# SSD (model layout: x (B,S,H,P), dt (B,S,H), A_log (H,), B/C (B,S,G,N))
# ---------------------------------------------------------------------------

def _ssd_forward(x, dt, A_log, Bmat, Cmat, D, chunk: int, mode: str):
    A = -torch.exp(A_log.float())
    if mode in ("cuda", "meta"):
        scan = _ssd.ssd_scan if mode == "cuda" else _ssd.ssd_scan_meta
        args = (x, dt.float(), A.contiguous(), Bmat, Cmat,
                D.float().contiguous())
        y = scan(*args, chunk=chunk)
        LAUNCHES["ssd_scan_" + _ssd.route(x.dtype, x.shape[-1],
                                          Bmat.shape[-1])] += 1
        b, s, h, p = x.shape
        _launched("ssd_scan", lambda: ssd_flops(
            b, s, h, p, Bmat.shape[-1], chunk), moved=(*args, y))
        return y
    # the plain version on the reference wrapper's per-head layout
    b, s, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    rep = h // g

    def heads(t):       # (B,S,G,N) -> (B·H,S,N); head h reads group h // rep
        return torch.repeat_interleave(t, rep, dim=2).transpose(1, 2) \
            .reshape(b * h, s, n)
    y = _ssd.ssd_scan_torch(x.transpose(1, 2).reshape(b * h, s, p),
                            dt.transpose(1, 2).reshape(b * h, s),
                            A.repeat(b), heads(Bmat), heads(Cmat),
                            D.float().repeat(b), chunk=chunk)
    return y.reshape(b, h, s, p).transpose(1, 2)


class _SSD(torch.autograd.Function):
    """Forward: the ``ssd_scan`` kernel (or its plain version).  Backward:
    recompute through the model function ``models.ssd.ssd_chunked`` and
    differentiate it, as the reference differentiates ``ssd_chunked`` (it
    has no backward kernel)."""

    @staticmethod
    def forward(ctx, x, dt, A_log, Bmat, Cmat, D, chunk, mode):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A_log, Bmat, Cmat, D)
        return _ssd_forward(x, dt, A_log, Bmat, Cmat, D, chunk, mode)

    @staticmethod
    def backward(ctx, gy):
        from repro_torch.models.ssd import ssd_chunked
        need = ctx.needs_input_grad[:6]
        # on the card this runs on torch's autograd device thread; its
        # parent span is the open ``update`` or ``probe``
        with tracing.span("scan_bwd", device=gy.device), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y, _ = ssd_chunked(*ins, ctx.chunk)
            it = iter(torch.autograd.grad(
                y, [t for t, n in zip(ins, need) if n], gy))
        return (*(next(it) if n else None for n in need), None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
        Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
        chunk: int = 128, mode: Optional[str] = None) -> torch.Tensor:
    """Model-layout SSD → y (B,S,H,P) in x's type: one launch of the
    ``ssd_scan`` kernel on the card, the plain version on the CPU (``mode``
    forces either).  Differentiable: the backward recomputes through
    ``models.ssd.ssd_chunked``; under ``torch.no_grad()`` only the forward
    runs."""
    return _SSD.apply(x, dt, A_log, Bmat, Cmat, D, min(chunk, x.shape[1]),
                      _resolve_mode(mode, x))


def layer_grad_norms(stacked_grads, *,
                     mode: Optional[str] = None) -> torch.Tensor:
    """Σ over leaves of row-wise ‖·‖² for (L, …) stacked leaves → (L,) f32.

    The probe reduction (``core/masks.py`` routes ``per_layer_sq_norms``
    here): one launch of the ``layer_grad_norm`` kernel per leaf on the
    card, the plain version on the CPU.  Leaves are summed in sorted-key
    order, as the reference sums them.
    """
    total = None
    for leaf in _sorted_leaves(stacked_grads):
        flat = leaf.reshape(leaf.shape[0], -1)
        route = _resolve_mode(mode, leaf)
        if route in ("cuda", "meta"):
            flat = flat.contiguous()
            sq = (_lgn.layer_sq_norms_2d if route == "cuda"
                  else _lgn.layer_sq_norms_2d_meta)(flat)
            _launched("layer_grad_norm", lambda: 2 * flat.numel(),
                      moved=(flat, sq))
        else:
            sq = _lgn.layer_sq_norms_2d_torch(flat)
        total = sq if total is None else total + sq
    return total


def masked_sgd_update(stacked_params: dict, stacked_grads: dict,
                      mask: torch.Tensor, lr: float, *,
                      mode: Optional[str] = None) -> dict:
    """Fused Eq.(3) apply θ_l ← θ_l − η·m(l)·g_l over a stacked dict, out of
    place (same keys, new tensors).

    The apply step of the masked τ loop (``core/client.py``): one launch of
    the ``masked_update`` kernel per leaf on the card, the plain version on
    the CPU.  ``mask`` is (L,) f32 on the leaves' device.
    """
    def upd(p, g):
        if isinstance(p, dict):
            return {k: upd(p[k], g[k]) for k in p}
        L = p.shape[0]
        route = _resolve_mode(mode, p)
        if route in ("cuda", "meta"):
            args = (p.reshape(L, -1), g.reshape(L, -1).contiguous(), mask)
            out = (_mu.masked_sgd_update_2d if route == "cuda"
                   else _mu.masked_sgd_update_2d_meta)(*args, lr)
            _launched("masked_update", lambda: 2 * p.numel(),
                      moved=(*args, out))
        else:
            out = _mu.masked_sgd_update_2d_torch(p.reshape(L, -1),
                                                 g.reshape(L, -1), mask, lr)
        return out.reshape(p.shape)

    return upd(stacked_params, stacked_grads)


def base_delta_matmul(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
                      slots: torch.Tensor, *,
                      mode: Optional[str] = None) -> torch.Tensor:
    """``y[b] = x[b] @ w + Σ_{e: slots[e]==b} x[b] @ dw[e]``, the serving
    decode projection with per-slot selected-layer deltas (DESIGN.md §9).

    x: (B, 1, d) decode activations or (B, d); w: (d, f); dw: (C, d, f) f32;
    slots: (C,) int32, -1 = empty.  Returns x's shape with d → f.
    """
    mode = _resolve_mode(mode, x)
    squeeze = x.dim() == 3
    if squeeze:
        if x.shape[1] != 1:
            raise ValueError("delta decode projections are single-token, got "
                             f"x {tuple(x.shape)}")
        x2 = x[:, 0]
    else:
        x2 = x
    if mode in ("cuda", "meta"):
        x2 = x2.contiguous()
        out = (_dmm.base_delta_matmul_2d if mode == "cuda"
               else _dmm.base_delta_matmul_2d_meta)(x2, w, dw, slots)
        _launched("base_delta_matmul", lambda: 2 * x2.shape[0] * w.numel()
                  * (1 + dw.shape[0]), (w, dw), moved=(x2, w, dw, slots, out))
    else:
        out = _dmm.base_delta_matmul_2d_torch(x2, w, dw, slots)
    return out[:, None] if squeeze else out
