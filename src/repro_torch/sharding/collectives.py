"""The step's collectives, counted by kind (new; the reference's are
``lax.all_gather`` / ``lax.psum_scatter`` / ``lax.psum`` inside its
``shard_map``).

Every collective of the distributed step and of mesh serving goes through
:func:`all_gather_dim`, :func:`reduce_scatter_dim` or :func:`all_reduce_`,
which count it in :data:`COLLECTIVES` (``sharding/fl_step.py`` re-exports
them): the ZeRO-3 gathers over ``data``, the Eq.(5) sums, and the
tensor-parallel operators over ``model`` (``sharding/tensor_parallel.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# Collectives issued through these helpers, by kind.  Reset to 0 before a
# run and read after it, as ``kernels.ops.LAUNCHES``.
COLLECTIVES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


# ---------------------------------------------------------------------------
# Collectives along one dim
# ---------------------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in group-rank
    order (the reference's tiled ``lax.all_gather``), contiguous.  The
    collective runs on dim 0, so for another dim the shards are gathered
    whole and then joined along ``dim``."""
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    COLLECTIVES["all_gather"] += 1
    if dim == 0 or n == 1:
        return out.view((n * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Σ over the group of ``x``, scattered along ``dim``: this rank keeps
    its own slice (the reference's tiled ``lax.psum_scatter``)."""
    n = dist.get_world_size(group)
    if dim == 0 or n == 1:               # the ranks' slices already in order
        chunks = x.contiguous()
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    else:
        chunks = torch.stack(x.chunk(n, dim=dim))  # (n, …) contiguous
        shape = chunks.shape[1:]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1),
                               op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["reduce_scatter"] += 1
    return out


def all_reduce_(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Σ over the group, in place (the reference's ``lax.psum``); ``op``
    ``ReduceOp.MAX`` takes the maximum instead (``lax.pmax``)."""
    dist.all_reduce(x, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    return x


class ZGather(torch.autograd.Function):
    """All-gather along ``dim`` whose backward reduce-scatters in f32, cast
    back: the ZeRO-3 gather over ``data`` (Eq. (5)'s cohort sum
    accumulates in f32 even for bf16 params), and over ``model`` the
    shared kv head's ``wk`` / ``wv`` (``tensor_parallel.ModelAxis``)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        g = reduce_scatter_dim(ct.float(), ctx.dim, ctx.group)
        return g.to(ct.dtype), None, None
