"""Mamba2 SSD chunked scan (counterpart of ``repro/kernels/ssd_scan.py``).

Per chunk of Q positions, with cs = cumsum(dt·A) inside the chunk: the
intra-chunk term ``(C·Bᵀ ⊙ L) @ (x·dt)`` with L[i,j] = exp(cs_i − cs_j) for
i ≥ j, the inter-chunk term ``C·stateᵀ ⊙ exp(cs)``, the carried (P, N)
state update, plus ``x·D`` on the undiscretised x; f32 inside, y in x's
type.

:func:`ssd_scan` launches a hand-written Hopper kernel
(``csrc/ssd_scan.cu``: one block per (batch, head), the chunks looped
inside the block) on the model layout — x (B,S,H,P), dt (B,S,H) f32, A
(H,) f32, B/C (B,S,G,N) read per group, D (H,) f32 — strided views
included.  :func:`route` picks the kernel: bf16 at P and N multiples of 16
takes the tensor-core kernel (the chunk products on bf16 ``mma.sync``, each
f32 factor as a bf16 hi + lo pair, the state in registers), anything else
the f32 SIMT kernel (the state in shared memory).  :func:`ssd_scan_torch` is the plain PyTorch
version on the reference's per-head layout, replaying ``ssd_scan_jnp``: the
same chunking and the same (P, N) state carried across chunks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_FLOAT_TYPES = (torch.bfloat16, torch.float32)
# The kernels of ``csrc/ssd_scan.cu``, by the launch function's route number.
ROUTES = ("simt", "mma")


def route(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel that x, B and C of ``dtype`` with head dim P and state N
    take: ``"mma"`` (bf16 tensor cores) for bf16 at P % 16 == 0 and
    N % 16 == 0, else ``"simt"`` (f32 arithmetic, exact to ~1e-6)."""
    if dtype not in _FLOAT_TYPES:
        raise ValueError(f"ssd_scan: no kernel takes {dtype}")
    if dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0:
        return "mma"
    return "simt"


def ssd_scan_torch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                   *, chunk: int = 128) -> torch.Tensor:
    """Plain version, per head: x (BH,S,P); dt (BH,S); A/D (BH,); B/C
    (BH,S,N) → y (BH,S,P) in x's type."""
    BH, S, P = x.shape
    N = Bmat.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    nc = S // chunk
    xf = x.float().reshape(BH, nc, chunk, P)
    dtf = dt.float().reshape(BH, nc, chunk)
    Af = A.float()
    Bf = Bmat.float().reshape(BH, nc, chunk, N)
    Cf = Cmat.float().reshape(BH, nc, chunk, N)
    Df = D.float()
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]

    state = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        dAcs = torch.cumsum(dtc * Af[:, None], dim=-1)
        xdt = xc * dtc[..., None]
        seg = dAcs[:, :, None] - dAcs[:, None, :]
        L = torch.where(lower, torch.exp(seg), 0.0)
        scores = torch.bmm(cc, bc.transpose(1, 2))              # (BH,Q,Q)
        y = torch.bmm(scores * L, xdt)                          # (BH,Q,P)
        y = y + (torch.bmm(cc, state.transpose(1, 2))
                 * torch.exp(dAcs)[..., None])
        decay_states = torch.exp(dAcs[:, -1:] - dAcs)[..., None]
        state = (state * torch.exp(dAcs[:, -1])[:, None, None]
                 + torch.bmm((xdt * decay_states).transpose(1, 2), bc))
        ys.append(y + xc * Df[:, None, None])
    return torch.stack(ys, dim=1).reshape(BH, S, P).to(x.dtype)


@functools.cache
def _lib():
    lib = _build.load_library("ssd_scan")
    lib.ssd_scan_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    for name in ("ssd_scan_max_q", "ssd_scan_max_p", "ssd_scan_max_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, D) -> None:
    ts = {"x": x, "dt": dt, "A": A, "B": Bm, "C": Cm, "D": D}
    for name, t in ts.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the kernel "
                             f"takes CUDA tensors on one device")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: want x (B,S,H,P), dt (B,S,H), B/C "
                         f"(B,S,G,N); got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(Bm.shape)}, C "
                         f"{tuple(Cm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, s, h) or Bm.shape[:2] != (b, s) or h % g
            or A.shape != (h,) or D.shape != (h,)):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B/C {tuple(Bm.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}")
    if x.dtype not in _FLOAT_TYPES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, B and C must share one type, bf16 or "
                         f"f32; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or D.dtype != torch.float32:
        raise ValueError("ssd_scan: dt, A and D must be f32")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd_scan: the last axis of x, B and C must be "
                         "contiguous")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan: A and D must be contiguous")


def _check_limits(x, Bm, Q: int, lib) -> None:
    b, s, _, p = x.shape
    n = Bm.shape[3]
    if not (1 <= Q <= lib.ssd_scan_max_q() and s % Q == 0
            and 1 <= p <= lib.ssd_scan_max_p()
            and 1 <= n <= lib.ssd_scan_max_n() and 1 <= b <= 65535):
        raise ValueError(f"ssd_scan: the kernel takes chunk <= "
                         f"{lib.ssd_scan_max_q()} dividing S, P <= "
                         f"{lib.ssd_scan_max_p()}, N <= "
                         f"{lib.ssd_scan_max_n()}, B <= 65535; got chunk {Q}, "
                         f"S {s}, P {p}, N {n}, B {b}")


def ssd_scan_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """What :func:`ssd_scan` allocates and returns, on the meta device, with
    no launch: y (B,S,H,P) in x's type.  Raises where :func:`route` does."""
    route(x.dtype, x.shape[-1], Bmat.shape[-1])
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Launch the Hopper kernel of ``route(x.dtype, P, N)`` on the current
    stream; CUDA tensors only, model layout (see the module docstring), A =
    −exp(A_log).  Returns y (B,S,H,P) contiguous in x's type.  Raises on
    anything the kernel does not take, and if the launch fails."""
    _check(x, dt, A, Bmat, Cmat, D)
    lib = _lib()
    Q = min(chunk, x.shape[1])
    _check_limits(x, Bmat, Q, lib)
    b, s, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), D.data_ptr(), y.data_ptr(),
        b, s, h, p, g, n, Q, x.dtype == torch.bfloat16,
        *x.stride()[:3], *dt.stride(), *Bmat.stride()[:3],
        *Cmat.stride()[:3], ROUTES.index(route(x.dtype, p, n)),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} "
                           f"(cudaError {err})")
    return y
