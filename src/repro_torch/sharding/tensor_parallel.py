"""Tensor parallelism over the mesh's ``model`` axis for the dense family
(new; the reference gets the same values from GSPMD under
``RuntimeConfig(tp_constraints=True)``, whose Megatron constraints are
``repro/sharding/fl_step.py``'s ``_tp_constrain`` and ``_model_only``).

Megatron's split of a block: the column-parallel products (``wq``,
``wk``, ``wv``, ``mlp_wi``, the head) take their input through **f**
(:class:`_Copy`: identity forward, all-reduce of the gradient backward),
and each row-parallel ``wo`` gives a partial sum that **g**
(:class:`_Reduce`: all-reduce forward, identity backward) adds up over
``model``.  The embedding and the cross-entropy are vocab-parallel
(``models/model.py``).  Every collective goes through the counted helpers
of ``sharding/collectives.py``.

:class:`ModelAxis` is the models' parallel form's argument
(``blocks.attention_fwd``, ``blocks.mlp_fwd``, ``Model(…, tp=)``): the
rank's head and vocabulary counts and the model-axis operations.  Built
:meth:`ModelAxis.on_mesh` the operations are collectives over the
``model`` group; built directly they default to the identity, so one
process can compute each model coordinate's partial in turn and sum them
by hand (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import rules
from repro_torch.sharding.collectives import (ZGather, all_gather_dim,
                                              all_reduce_)


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, Σ over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: Σ over ``model`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOwn(torch.autograd.Function):
    """All-gather over ``model`` whose backward keeps the rank's own
    slice: every rank computed the same gradient of the whole leaf
    (replicated attention), so a sum would be ``size`` times too large."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class ModelAxis:
    """Model coordinate ``index`` of a dense model under ``layout``
    (:class:`rules.TPLayout`): ``mode`` and ``attn_split`` (attention
    split over ``model``, not replicated), the rank's ``n_heads`` /
    ``n_kv_heads`` and ``vocab_start`` / ``vocab_size``, and the
    operations: ``copy`` (f), ``reduce`` (g), ``reduce_max`` (max over
    ``model``, no gradient), ``gather_last`` (the logits' all-gather along
    the last dim, no gradient) and :meth:`view_row`'s gathers."""

    def __init__(self, layout: rules.TPLayout, index: int, *,
                 copy: Callable = _identity, reduce: Callable = _identity,
                 reduce_max: Optional[Callable] = None,
                 gather_last: Optional[Callable] = None,
                 gather_sum: Optional[Callable] = None,
                 gather_own: Optional[Callable] = None):
        cfg = layout.cfg
        self.layout, self.index, self.size = layout, index, layout.size
        self.mode = layout.mode
        self.attn_split = layout.mode != "replicated"
        self.n_heads = layout.q_heads(index)[1]
        self.kv_first, self.n_kv_heads = layout.kv_heads(index)
        self.vocab_size = cfg.vocab_size // layout.size
        self.vocab_start = index * self.vocab_size
        self.copy, self.reduce = copy, reduce
        self.reduce_max, self.gather_last = reduce_max, gather_last
        self._gather_sum, self._gather_own = gather_sum, gather_own

    @classmethod
    def on_mesh(cls, layout: rules.TPLayout, mesh) -> "ModelAxis":
        """This rank's coordinate, its operations collectives over the
        mesh's ``model`` group."""
        group = mesh.group(rules.MODEL)
        index = mesh.coord(rules.MODEL)
        return cls(
            layout, index,
            copy=lambda x: _Copy.apply(x, group),
            reduce=lambda x: _Reduce.apply(x, group),
            reduce_max=lambda x: all_reduce_(
                x.clone(memory_format=torch.contiguous_format), group,
                op=dist.ReduceOp.MAX),
            gather_last=lambda x: all_gather_dim(x, x.dim() - 1, group),
            gather_sum=lambda x, dim: ZGather.apply(x, dim, group),
            gather_own=lambda x, dim: _GatherOwn.apply(x, dim, group, index))

    def view_row(self, row: dict, specs: dict) -> dict:
        """One ``blocks`` row's leaves, as stored on this rank after the
        gather over ``data`` (model slices), turned into what the rank
        computes with: under ``"kv_shared"`` ``wk`` / ``wv`` (and ``bk`` /
        ``bv``) all-gathered over ``model`` (reduce-scatter backward) and
        narrowed to the rank's kv head; under ``"replicated"`` every
        split attention leaf all-gathered (its own slice backward).
        ``specs`` are the stacked leaves' specs."""
        if self.mode == "heads":
            return row
        hd = self.layout.cfg.resolved_head_dim
        out = {}
        for nm, x in row.items():
            leaf = nm[len("attn_"):] if nm.startswith("attn_") else "ln"
            dim = rules.model_dim(specs[nm])
            if leaf == "ln" or dim is None:
                out[nm] = x
            elif self.mode == "replicated":
                out[nm] = self._gather_own(x, dim - 1)
            elif leaf in ("wk", "wv", "bk", "bv"):
                full = self._gather_sum(x, dim - 1)
                out[nm] = full.narrow(full.dim() - 1, self.kv_first * hd, hd)
            else:
                out[nm] = x
        return out
