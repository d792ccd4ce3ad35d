"""Fused "base + per-slot delta" matmul (counterpart of
``repro/kernels/delta_matmul.py``).

    y[b] = x[b] @ w  +  Σ_{e : slots[e] == b}  x[b] @ dw[e]

x (B, d) and w (d, f) in bf16 or f32; dw (C, d, f) f32, the delta overlay's
entries for one layer; slots (C,) int32 owner slot per entry, -1 = empty.
Sums are f32 and the result is (B, f) in x's type.

:func:`base_delta_matmul_2d` launches the hand-written Hopper kernel
(``csrc/delta_matmul.cu``: a grid of column tiles × d-splits, as
:func:`plan` lays it out, then a fixed-order fold of the splits);
:func:`base_delta_matmul_2d_torch` is the plain PyTorch version of the same
function, which the CPU tests and the on-card comparison use.  Unlike the
TPU wrapper, neither makes f32 copies of x, w or dw up front: the kernel
widens bf16 in registers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_BATCH = 16          # the kernel's largest decode batch (csrc MAXB)
_FLOAT_TYPES = (torch.bfloat16, torch.float32)

# The grid's planning constants (csrc/delta_matmul.cu): blocks aimed for
# (twice an H100's 132 SMs, a constant so that the split, and with it the
# bits, is the same on every card), the fewest rows of d a block should
# read before the column tile narrows, the most a block stages (kMaxRows),
# columns a lane reads (kVec) and lanes per row segment, widest first.
BLOCK_TARGET = 264
MIN_ROWS = 16
MAX_ROWS = 512
LANE_COLS = 8
LANES_PER_ROW = (32, 16, 8)


class Plan(NamedTuple):
    """The kernel's grid: ``col_tiles`` tiles of ``col_tile`` columns (a row
    segment read by ``lanes_per_row`` lanes) × ``splits`` ranges of
    ``rows`` rows of d (the last may be shorter)."""
    lanes_per_row: int
    col_tile: int
    col_tiles: int
    rows: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.splits


@functools.cache
def plan(B: int, d: int, f: int) -> Plan:
    """The grid for x (B, d) @ w (d, f), from the shape alone: the widest
    column tile whose d-split reaches ``BLOCK_TARGET`` blocks with at least
    ``MIN_ROWS`` rows a block (else the narrowest), at most ``MAX_ROWS``
    rows a block."""
    if not (1 <= B <= MAX_BATCH and d >= 1 and f >= 1):
        raise ValueError(f"delta_matmul.plan: takes 1 <= B <= {MAX_BATCH} "
                         f"and d, f >= 1; got B={B}, d={d}, f={f}")
    for lpr in LANES_PER_ROW:
        tile = lpr * LANE_COLS
        tiles = -(-f // tile)
        rows = max(1, min(MAX_ROWS, d // -(-BLOCK_TARGET // tiles)))
        if rows >= MIN_ROWS:
            break
    return Plan(lpr, tile, tiles, rows, -(-d // rows))


def base_delta_matmul_2d_torch(x: torch.Tensor, w: torch.Tensor,
                               dw: torch.Tensor,
                               slots: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x.float() @ w.float()``, then each entry's row
    correction added in entry order (as ``_entry_accumulate`` does),
    cast to x's type.  Empty entries add a zero correction; no host sync."""
    xf = x.float()
    acc = xf @ w.float()
    safe = slots.clamp(min=0).long()
    live = (slots >= 0).float()
    for e in range(dw.shape[0]):
        idx = safe[e:e + 1]
        corr = (xf.index_select(0, idx) @ dw[e].float()) * live[e]
        acc.index_add_(0, idx, corr)
    return acc.to(x.dtype)


@functools.cache
def _launcher():
    fn = _build.load_library("delta_matmul").base_delta_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.load_library("delta_matmul").base_delta_matmul_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check(x, w, dw, slots) -> None:
    # one decode step calls this 132 times: the common case costs a few
    # attribute reads, the messages are built only on a fault
    if not (x.is_cuda and x.device == w.device == dw.device == slots.device):
        for name, t in (("x", x), ("w", w), ("dw", dw), ("slots", slots)):
            if not t.is_cuda:
                raise ValueError(f"base_delta_matmul_2d: {name} is on "
                                 f"{t.device}, the kernel takes CUDA tensors "
                                 f"only")
        raise ValueError(f"base_delta_matmul_2d: x, w, dw and slots are on "
                         f"{x.device}, {w.device}, {dw.device}, "
                         f"{slots.device}: want one device")
    for name, t in (("x", x), ("w", w), ("dw", dw), ("slots", slots)):
        if not t.is_contiguous():
            raise ValueError(f"base_delta_matmul_2d: {name} is not contiguous")
    if x.dim() != 2 or w.dim() != 2 or dw.dim() != 3 or slots.dim() != 1:
        raise ValueError("base_delta_matmul_2d: want x (B,d), w (d,f), "
                         f"dw (C,d,f), slots (C,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(dw.shape)}, "
                         f"{tuple(slots.shape)}")
    B, d = x.shape
    f = w.shape[1]
    if w.shape[0] != d or tuple(dw.shape[1:]) != (d, f) \
            or slots.shape[0] != dw.shape[0]:
        raise ValueError("base_delta_matmul_2d: shapes disagree: x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, dw "
                         f"{tuple(dw.shape)}, slots {tuple(slots.shape)}")
    if not 1 <= B <= MAX_BATCH or d < 1 or f < 1:
        raise ValueError(f"base_delta_matmul_2d: takes 1 <= B <= {MAX_BATCH} "
                         f"and d, f >= 1; got B={B}, d={d}, f={f}")
    if x.dtype not in _FLOAT_TYPES or w.dtype not in _FLOAT_TYPES:
        raise ValueError(f"base_delta_matmul_2d: x and w must be bf16 or f32, "
                         f"got {x.dtype}, {w.dtype}")
    if dw.dtype != torch.float32 or slots.dtype != torch.int32:
        raise ValueError(f"base_delta_matmul_2d: dw must be f32 and slots "
                         f"int32, got {dw.dtype}, {slots.dtype}")


def _buffers(x: torch.Tensor, p: Plan, f: int):
    """The kernel's output (B, f) in x's type and its f32 partial sums
    (splits, B, f), or None with one split."""
    B = x.shape[0]
    out = torch.empty((B, f), dtype=x.dtype, device=x.device)
    part = (torch.empty((p.splits, B, f), dtype=torch.float32,
                        device=x.device) if p.splits > 1 else None)
    return out, part


def base_delta_matmul_2d_meta(x: torch.Tensor, w: torch.Tensor,
                              dw: torch.Tensor,
                              slots: torch.Tensor) -> torch.Tensor:
    """What :func:`base_delta_matmul_2d` allocates (the fold's partials
    too) and returns, on the meta device, with no launch: (B, f)."""
    f = w.shape[1]
    out, _ = _buffers(x, plan(x.shape[0], x.shape[1], f), f)
    return out


def base_delta_matmul_2d(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (and the fold of its d-splits) on the
    current stream; CUDA tensors only.  Raises on anything the kernel does
    not take, and if the launch fails."""
    _check(x, w, dw, slots)
    B, d = x.shape
    f = w.shape[1]
    p = plan(B, d, f)
    out, part = _buffers(x, p, f)
    err = _launcher()(x.data_ptr(), w.data_ptr(), dw.data_ptr(),
                      slots.data_ptr(), out.data_ptr(),
                      None if part is None else part.data_ptr(), B, d, f,
                      dw.shape[0], x.dtype == torch.bfloat16,
                      w.dtype == torch.bfloat16, p.lanes_per_row, p.rows,
                      torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"base_delta_matmul kernel launch failed: "
                           f"{_error_string(err)} (cudaError {err})")
    return out
