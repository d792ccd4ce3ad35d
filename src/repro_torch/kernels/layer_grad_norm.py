"""Per-row squared norms of a stacked (L, F) leaf (counterpart of
``repro/kernels/layer_grad_norm.py``).

    out[l] = Σ_f float(g[l, f])²        g (L, F) bf16 or f32 → (L,) f32

:func:`layer_sq_norms_2d` launches the hand-written Hopper kernel
(``csrc/layer_grad_norm.cu``: per-chunk f32 partials, then a fixed-order
fold, no atomics); :func:`layer_sq_norms_2d_torch` is the plain PyTorch
version of the same function, which the CPU tests and the on-card
comparison use.  Neither replays the TPU kernel's 4096-wide blocking: the
sums agree to f32 rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_FLOAT_TYPES = (torch.bfloat16, torch.float32)
# Elements of a row that one block of the kernel's first pass sums
# (csrc/layer_grad_norm.cu kChunk): its f32 scratch is (L, ⌈F / CHUNK⌉).
CHUNK = 65536


def layer_sq_norms_2d_torch(g: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(g.float() ** 2).sum(1)``."""
    return (g.float() ** 2).sum(1)


@functools.cache
def _lib():
    lib = _build.load_library("layer_grad_norm")
    lib.layer_sq_norms_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.layer_sq_norms_launch.restype = ctypes.c_int
    lib.layer_sq_norms_blocks.argtypes = [ctypes.c_longlong]
    lib.layer_sq_norms_blocks.restype = ctypes.c_longlong
    lib.layer_sq_norms_error_string.argtypes = [ctypes.c_int]
    lib.layer_sq_norms_error_string.restype = ctypes.c_char_p
    return lib


def _check(g: torch.Tensor) -> None:
    if not g.is_cuda:
        raise ValueError(f"layer_sq_norms_2d: g is on {g.device}, the kernel "
                         f"takes CUDA tensors only")
    if g.dim() != 2 or not 1 <= g.shape[0] <= 65535 or g.shape[1] < 1:
        raise ValueError(f"layer_sq_norms_2d: want g (L, F) with "
                         f"1 <= L <= 65535, F >= 1; got {tuple(g.shape)}")
    if g.dtype not in _FLOAT_TYPES:
        raise ValueError(f"layer_sq_norms_2d: g must be bf16 or f32, got "
                         f"{g.dtype}")
    if not g.is_contiguous():
        raise ValueError("layer_sq_norms_2d: g is not contiguous")


def layer_sq_norms_2d_meta(g: torch.Tensor) -> torch.Tensor:
    """What :func:`layer_sq_norms_2d` allocates (its scratch of partials
    too) and returns, on the meta device, with no launch: (L,) f32."""
    L, F = g.shape
    partial = torch.empty((L, -(-F // CHUNK)), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((L,), dtype=torch.float32, device=g.device)
    del partial            # freed after the output, as the launch frees it
    return out


def layer_sq_norms_2d(g: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; CUDA tensors only.
    Raises on anything the kernel does not take, and if the launch fails."""
    _check(g)
    L, F = g.shape
    lib = _lib()
    nb = lib.layer_sq_norms_blocks(F)
    partial = torch.empty((L, nb), dtype=torch.float32, device=g.device)
    out = torch.empty((L,), dtype=torch.float32, device=g.device)
    err = lib.layer_sq_norms_launch(
        g.data_ptr(), partial.data_ptr(), out.data_ptr(), L, F, nb,
        g.dtype == torch.bfloat16,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_sq_norms kernel launch failed: "
                           f"{lib.layer_sq_norms_error_string(err).decode()} "
                           f"(cudaError {err})")
    return out
