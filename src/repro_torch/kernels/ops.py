"""Model-layout wrappers over the port's kernels (counterpart of
``repro/kernels/ops.py``; this slice ports ``base_delta_matmul``, line 160).

Dispatch follows the tensor, never ``RuntimeConfig.use_pallas``: a CUDA
tensor launches the kernel (or the launch raises), a CPU tensor takes the
plain PyTorch version.  ``mode`` forces one: ``"torch"`` the plain version
on any device, ``"cuda"`` the kernel (a CPU tensor then raises).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import delta_matmul as _dmm

# Kernel launches made through this module, by kernel.  Reset it to 0 before
# a run and read it after to show which kernels the run went through.
LAUNCHES = {"base_delta_matmul": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def base_delta_matmul(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
                      slots: torch.Tensor, *,
                      mode: Optional[str] = None) -> torch.Tensor:
    """``y[b] = x[b] @ w + Σ_{e: slots[e]==b} x[b] @ dw[e]``, the serving
    decode projection with per-slot selected-layer deltas (DESIGN.md §9).

    x: (B, 1, d) decode activations or (B, d); w: (d, f); dw: (C, d, f) f32;
    slots: (C,) int32, -1 = empty.  Returns x's shape with d → f.
    """
    if mode not in (None, "cuda", "torch"):
        raise ValueError(f"mode must be None, 'cuda' or 'torch', got {mode!r}")
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    squeeze = x.dim() == 3
    if squeeze:
        if x.shape[1] != 1:
            raise ValueError("delta decode projections are single-token, got "
                             f"x {tuple(x.shape)}")
        x2 = x[:, 0]
    else:
        x2 = x
    if mode == "cuda":
        out = _dmm.base_delta_matmul_2d(x2.contiguous(), w, dw, slots)
        LAUNCHES["base_delta_matmul"] += 1
    else:
        out = _dmm.base_delta_matmul_2d_torch(x2, w, dw, slots)
    return out[:, None] if squeeze else out
