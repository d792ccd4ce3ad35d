"""Fused masked-SGD apply on a stacked (L, F) leaf (counterpart of
``repro/kernels/masked_update.py``), Eq.(3)/(6):

    out[l] = p[l] − (lr·mask[l])·g[l]      in f32, cast to p's type

:func:`masked_sgd_update_2d` launches the hand-written Hopper kernel
(``csrc/masked_update.cu``); :func:`masked_sgd_update_2d_torch` is the
plain PyTorch version with the same two rounded operations in the same
order, so the two agree bit for bit.  Both write a fresh tensor: the τ
loop's first input is a view of the global params, which Δ still needs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_FLOAT_TYPES = (torch.bfloat16, torch.float32)


def masked_sgd_update_2d_torch(p: torch.Tensor, g: torch.Tensor,
                               mask: torch.Tensor, lr: float) -> torch.Tensor:
    """Plain version: ``p.f32 − ((lr·m)·g.f32)``, cast to p's type.  Rows
    with m = 0 still compute ``p − 0·g`` (a non-finite g gives NaN)."""
    s = (mask.float() * lr).reshape((mask.shape[0],) + (1,) * (p.dim() - 1))
    return (p.float() - s * g.float()).to(p.dtype)


@functools.cache
def _lib():
    lib = _build.load_library("masked_update")
    lib.masked_sgd_update_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.masked_sgd_update_launch.restype = ctypes.c_int
    lib.masked_sgd_update_error_string.argtypes = [ctypes.c_int]
    lib.masked_sgd_update_error_string.restype = ctypes.c_char_p
    return lib


def _check(p: torch.Tensor, g: torch.Tensor, mask: torch.Tensor) -> None:
    for name, t in (("p", p), ("g", g), ("mask", mask)):
        if not t.is_cuda:
            raise ValueError(f"masked_sgd_update_2d: {name} is on {t.device}, "
                             f"the kernel takes CUDA tensors only")
        if t.device != p.device:
            raise ValueError(f"masked_sgd_update_2d: {name} is on {t.device}, "
                             f"p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"masked_sgd_update_2d: {name} is not contiguous")
    if p.dim() != 2 or g.shape != p.shape or mask.shape != (p.shape[0],) \
            or not 1 <= p.shape[0] <= 65535 or p.shape[1] < 1:
        raise ValueError("masked_sgd_update_2d: want p, g (L, F) and mask "
                         "(L,) with 1 <= L <= 65535, F >= 1; got "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(mask.shape)}")
    if p.dtype not in _FLOAT_TYPES or g.dtype != p.dtype:
        raise ValueError(f"masked_sgd_update_2d: p and g must share one type, "
                         f"bf16 or f32; got {p.dtype}, {g.dtype}")
    if mask.dtype != torch.float32:
        raise ValueError(f"masked_sgd_update_2d: mask must be f32, got "
                         f"{mask.dtype}")


def masked_sgd_update_2d_meta(p: torch.Tensor, g: torch.Tensor,
                              mask: torch.Tensor, lr: float) -> torch.Tensor:
    """What :func:`masked_sgd_update_2d` allocates and returns, on the meta
    device, with no launch: a tensor like p."""
    return torch.empty_like(p)


def masked_sgd_update_2d(p: torch.Tensor, g: torch.Tensor,
                         mask: torch.Tensor, lr: float) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; CUDA tensors only.
    Raises on anything the kernel does not take, and if the launch fails."""
    _check(p, g, mask)
    L, F = p.shape
    out = torch.empty_like(p)
    lib = _lib()
    err = lib.masked_sgd_update_launch(
        # repro: allow[host-sync] -- lr is a host Python number, never a tensor
        p.data_ptr(), g.data_ptr(), mask.data_ptr(), float(lr),
        out.data_ptr(), L, F, p.dtype == torch.bfloat16,
        torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"masked_sgd_update kernel launch failed: "
            f"{lib.masked_sgd_update_error_string(err).decode()} "
            f"(cudaError {err})")
    return out
