"""Tensor parallelism over the mesh's ``model`` axis for the language
models of the dense, vlm, ssm, hybrid, moe and audio families (new; the
reference gets the same values from GSPMD under ``RuntimeConfig(
tp_constraints=True)``, whose Megatron constraints are
``repro/sharding/fl_step.py``'s ``_tp_constrain`` and ``_model_only``).

Megatron's split of a block: the column-parallel products (``wq``,
``wk``, ``wv``, ``mlp_wi``, a Mamba2 ``in_proj``, the head) take their
input through **f** (:class:`_Copy`: identity forward, all-reduce of the
gradient backward), and each row-parallel ``wo`` / ``out_proj`` gives a
partial sum that **g** (:class:`_Reduce`: all-reduce forward, identity
backward) adds up over ``model``.  A Mamba2 block (``models/ssd.py``)
splits by SSD heads: a rank computes its heads' channels of z and x and
all of B and C, whose ``in_proj`` / conv columns it all-gathers over
``model`` (reduce-scatter backward: each rank's gradient of them is a
partial sum); its gate norm's Σ y² over the rank's channels is summed
over ``model`` in both directions (:class:`_Sum`); and the replicated
leaves it narrows to its heads or channels (``gate_ln``, ``A_log``,
``D``, ``dt_bias``) gather their gradient slices back over ``model``
(:class:`_NarrowGather`), so that every rank's copy gets the same whole
gradient.  A moe layer (``models/moe.py``) splits its routed experts by
expert or on ff and its shared experts as an MLP, its router whole on
every rank.  MLA (``models/mla.py``) splits by heads where the ``model``
size divides them: a rank computes its heads of ``wq``, of the ``w_ukv``
expansion and of ``wo`` (a partial sum for g), and the latent whole,
``w_dkv`` and ``w_krope`` all-gathered over ``model`` with the own-slice
backward (:class:`_GatherOwn`), ``kv_ln`` whole.  Its f wraps the normed
input of ``wq`` and the latent ``c_kv`` and rope key where the rank's
heads read them, not the ``h`` that feeds the latent projections: that
path's gradient is whole on every rank already, and one f on ``h``
ahead of both paths would count it ``size`` times.  Where the heads do
not divide, MLA runs replicated, every attention leaf all-gathered.  The
vlm family's projector ``patch_proj`` is all-gathered over ``model`` the
same way (the stub prefix projected whole on every rank), and its
prefix-LM attention splits as the dense family's.  whisper (the audio
family) splits its encoder and decoder rows as dense blocks, its
cross-attention by heads as its self-attention (``xattn_`` leaves through
the same views), its stub ``frame_proj`` all-gathered whole as
``patch_proj`` is; the normed encoder output, which only the rank's split
cross k/v read, passes one f ahead of every decoder row
(``Model.encode``), not one a row.  The embedding and the
cross-entropy are vocab-parallel where the vocabulary divides
(``models/model.py``).  Every collective goes through the counted
helpers of ``sharding/collectives.py``.

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
    (replicated attention, MLA's latent projections, the vlm projector),
    so a sum would be ``size`` times too large."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


class _Sum(torch.autograd.Function):
    """Σ over ``model`` in both directions: a statistic each rank sums
    over its own channels (the gate norm's Σ y²), whose gradient each rank
    also holds only a share of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _NarrowGather(torch.autograd.Function):
    """The rank's slice of a leaf replicated over ``model``, whose
    backward all-gathers the slices' gradients: each rank's gradient of
    the whole leaf is zero outside its slice, so the gather is their sum,
    the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, start, width, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, start, width).clone()

    @staticmethod
    def backward(ctx, g):
        return (all_gather_dim(g, ctx.dim, ctx.group),
                None, None, None, None)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class ModelAxis:
    """Model coordinate ``index`` of a model under ``layout``
    (:class:`rules.TPLayout`): ``mode`` and ``attn_split`` (attention
    split over ``model``, not replicated), the rank's ``n_heads`` /
    ``n_kv_heads``, ``ssm_head_first`` / ``ssm_heads`` and ``d_inner``
    (its Mamba2 channels), ``expert_first`` / ``n_experts`` (its routed
    experts: all of them on its ff columns unless expert-parallel),
    ``vocab_split`` and ``vocab_start`` /
    ``vocab_size``, and the operations: ``copy`` (f), ``reduce`` (g),
    ``reduce_stat`` (Σ over ``model`` both ways), ``reduce_max`` (max over
    ``model``, no gradient), ``gather_last`` (the logits' all-gather along
    the last dim, no gradient) and :meth:`view_row`'s gathers and
    narrows."""

    def __init__(self, layout: rules.TPLayout, index: int, *,
                 copy: Callable = _identity, reduce: Callable = _identity,
                 reduce_stat: Callable = _identity,
                 reduce_max: Optional[Callable] = None,
                 gather_last: Optional[Callable] = None,
                 gather_sum: Optional[Callable] = None,
                 gather_own: Optional[Callable] = None,
                 narrow_sum: Optional[Callable] = None):
        cfg = layout.cfg
        self.layout, self.index, self.size = layout, index, layout.size
        self.mode = layout.mode
        self.attn_split = layout.mode != "replicated"
        self.n_heads = layout.q_heads(index)[1]
        self.kv_first, self.n_kv_heads = layout.kv_heads(index)
        if layout.ssm:
            self.ssm_head_first, self.ssm_heads = layout.ssm_heads(index)
            self.d_inner = cfg.d_inner // layout.size
        if layout.moe:
            self.expert_first, self.n_experts = layout.experts(index)
        self.vocab_split = layout.vocab_split
        self.vocab_size = cfg.vocab_size // (layout.size if self.vocab_split
                                             else 1)
        self.vocab_start = index * self.vocab_size if self.vocab_split else 0
        self.copy, self.reduce, self.reduce_stat = copy, reduce, reduce_stat
        self.reduce_max, self.gather_last = reduce_max, gather_last
        self._gather_sum, self._gather_own = gather_sum, gather_own
        self._narrow_sum = narrow_sum

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
            reduce_stat=lambda x: _Sum.apply(x, group),
            reduce_max=lambda x: all_reduce_(
                x.clone(memory_format=torch.contiguous_format), group,
                op=dist.ReduceOp.MAX),
            gather_last=lambda x: all_gather_dim(x, x.dim() - 1, group),
            gather_sum=lambda x, dim: ZGather.apply(x, dim, group),
            gather_own=lambda x, dim: _GatherOwn.apply(x, dim, group, index),
            narrow_sum=lambda x, dim, start, width: _NarrowGather.apply(
                x, dim, start, width, group))

    def view_row(self, row: dict, specs: dict, lead: int = 1) -> dict:
        """One row's leaves, as stored on this rank after the gather over
        ``data`` (model slices), turned into what the rank computes with;
        ``specs`` are the leaves' specs, ``lead`` the leading dims they
        have and the row has not (1 for a stacked ``blocks`` row, 0 for the
        hybrid's unstacked shared block).  Attention, whisper's
        cross-attention (``xattn_``) alike: under
        ``"kv_shared"`` ``wk`` / ``wv`` (and ``bk`` / ``bv``) all-gathered
        over ``model`` (reduce-scatter backward) and narrowed to the rank's
        kv head; under ``"replicated"`` every split attention leaf, and
        MLA's latent projections ``w_dkv`` / ``w_krope`` in any mode,
        all-gathered (its own slice backward).  Mamba2 (:meth:`_ssm_leaf`):
        the B | C columns all-gathered, the replicated vectors narrowed.
        A moe row's ``moe_`` leaves and a ``dense0`` row's MLP are the
        rank's already.  The embed group's ``patch_proj`` (the vlm
        projector) and ``frame_proj`` (whisper's) are all-gathered whole
        (their own slice backward); ``tok`` stays the rank's vocabulary
        rows."""
        out = {}
        for nm, x in row.items():
            if nm.startswith("ssm_"):
                out[nm] = self._ssm_leaf(nm[len("ssm_"):], x)
            elif nm.startswith(("attn_", "xattn_")):
                out[nm] = self._attn_leaf(nm.split("_", 1)[1], x,
                                          rules.model_dim(specs[nm]), lead)
            elif nm in ("patch_proj", "frame_proj"):
                out[nm] = self._whole(x, rules.model_dim(specs[nm]), lead)
            else:
                out[nm] = x
        return out

    def _whole(self, x: torch.Tensor, dim: Optional[int],
               lead: int) -> torch.Tensor:
        """A leaf split on ``dim`` of its spec, all-gathered whole (its own
        slice of the gradient back); one whole over ``model`` as it is."""
        return x if dim is None else self._gather_own(x, dim - lead)

    def _attn_leaf(self, leaf: str, x: torch.Tensor, dim: Optional[int],
                   lead: int) -> torch.Tensor:
        if leaf == "ln" or dim is None:
            return x
        if self.mode == "replicated" or leaf in rules.TPLayout.LATENT:
            return self._whole(x, dim, lead)
        if self.mode == "kv_shared" and leaf in ("wk", "wv", "bk", "bv"):
            hd = self.layout.cfg.resolved_head_dim
            full = self._gather_sum(x, dim - lead)
            return full.narrow(full.dim() - 1, self.kv_first * hd, hd)
        return x

    def _ssm_leaf(self, leaf: str, x: torch.Tensor) -> torch.Tensor:
        """A Mamba2 leaf's model slice → the rank's compute weights
        (``TPLayout.compute_slice``'s): ``in_proj`` z_m | x_m | B | C |
        dt_m and the conv's x_m | B | C, every B_m | C_m all-gathered over
        ``model`` (reduce-scatter backward); ``gate_ln`` narrowed to the
        rank's channels, ``A_log`` / ``D`` / ``dt_bias`` to its heads
        (gradient slices gathered back); ``ln`` and the row-parallel
        ``out_proj`` as they are."""
        di, gn, _ = self.layout.ssm_widths()
        M, dm, gm = self.size, self.d_inner, gn // self.size
        if leaf in ("in_proj", "conv_w", "conv_b"):
            xs = 2 * dm if leaf == "in_proj" else dm     # z_m | x_m, or x_m
            bc = self._gather_sum(x[..., xs:xs + 2 * gm], x.dim() - 1)
            # B_0 | C_0 | B_1 | C_1 | … → B | C
            bc = bc.unflatten(-1, (M, 2, gm)).transpose(-3, -2).flatten(-3)
            return torch.cat([x[..., :xs], bc, x[..., xs + 2 * gm:]], -1)
        if leaf == "gate_ln":
            return self._narrow_sum(x, 0, self.index * dm, dm)
        if leaf in ("A_log", "D", "dt_bias"):
            return self._narrow_sum(x, 0, self.ssm_head_first,
                                    self.ssm_heads)
        return x
