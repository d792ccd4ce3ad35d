"""The distributed FL round step: Algorithm 1 over a ``torch.distributed``
mesh (counterpart of ``repro/sharding/fl_step.py``).

Mapping (DESIGN.md §4): one cohort client per (pod×data) mesh coordinate,
one process per coordinate.  Every function runs on each rank over its
local shards; the cohort meets only in the collectives, which run on the
``data`` (and ``pod``) sub-groups of the mesh.  By default each client's
compute is replicated over ``model``, as in the reference's own fully
manual fallback (its ``_shard_map`` docstring).  With
``RuntimeConfig(tp_constraints=True)`` the step of the dense, vlm, ssm,
hybrid, moe and audio families' language models is split over ``model``
instead, the values those of GSPMD under the reference's Megatron
constraints: a rank stores and computes its model slice
(``rules.TPLayout``, :func:`storage_layout`), the row loop's hook views
each gathered row as the rank's share (``tensor_parallel.ModelAxis``;
the hybrid's unstacked shared block, deepseek's ``dense0`` and the embed
group once a step, :func:`view_shared`) and the model runs its parallel
form (f and g around every block's products, MLA's heads over a latent
whole on every rank, a Mamba2 block split by SSD heads, the routed
experts by expert or on ff with the routers whole, the vlm's projector
whole and its prefix-LM attention split as the dense family's, whisper's
``enc_blocks`` and ``blocks`` rows each viewed through their own specs,
its cross-attention split by heads and its ``frame_proj`` whole, a
vocab-parallel embedding and cross-entropy where the vocabulary
divides).  The classifiers raise on it (``rules.check_tp_family``).

The per-(client, layer) aggregation of Eq. (5)-(7) is fused into one
backward pass, with the reference's two tricks:

1. **grad-scale**: :func:`gscale` has value ``x`` and gradient ``c·g``.
   Applied per layer to the (gathered) parameters with ``c = w_{i,l}``,
   it makes client i's weight-gradient contribution ``w_{i,l}·g_{i,l}``.
2. **differentiable ZeRO-3 gather**: the frozen base is stored sharded
   over ``data``; the all-gather inside the loss
   (:class:`collectives.ZGather`) differentiates to an f32
   reduce-scatter, which *is* the Eq. (5) sum over clients, landing the
   update already in storage layout (within the rank's model slice,
   under tensor parallelism).

The stacked ``blocks`` / ``enc_blocks`` rows are gathered and scaled one
layer at a time inside the model's row loop (``Model`` ``layer_hook``),
so at most one layer's full weights exist per rank.  With
``RuntimeConfig(sel_upload=True)`` and a static ``sel_idx`` only the
selected rows pass through the differentiable gather, so the backward
collective carries R/L of the bytes.  τ > 1 local steps
(:func:`make_fl_train_step_tau`) keep per-client copies of the selected
rows only and apply each step through the ``masked_update`` kernel.

Every collective goes through :func:`all_gather_dim`,
:func:`reduce_scatter_dim` or :func:`all_reduce_`
(``sharding/collectives.py``), which count it in :data:`COLLECTIVES`.
All ranks issue the same collectives in the same order: every branch
below depends on the specs and the static selection, never on a rank's
data.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.models.model import (HOOKED_SEGMENTS, Model, layer_layout,
                                      split_mask)
from repro_torch.sharding import rules
from repro_torch.sharding.collectives import (COLLECTIVES,  # noqa: F401
                                              ZGather, all_gather_dim,
                                              all_reduce_,
                                              reduce_scatter_dim,
                                              reset_collectives)
from repro_torch.sharding.tensor_parallel import ModelAxis
from repro_torch.tree import tree_items, tree_map, tree_map_with_path

PyTree = Any

# ---------------------------------------------------------------------------
# The step's pieces
# ---------------------------------------------------------------------------

def shard_cohort_rows(mesh, rows: PyTree) -> PyTree:
    """This rank's rows of per-cohort-member arrays (warm-start masks,
    probe stats, sizes, batches): the leading (cohort) axis split over the
    client axes — the DESIGN.md §4 mapping, one cohort member per pod×data
    coordinate.  Rows whose cohort axis does not divide the client-axis
    extent stay whole (replicated), as in the reference; values are never
    changed.  Accepts a tensor or any dict of (cohort, …) tensors."""
    caxes = rules.client_axes(mesh)
    n = mesh.size(caxes) if caxes else 1

    def place(x):
        x = torch.as_tensor(x).to(mesh.device)
        if x.dim() and n > 1 and x.shape[0] % n == 0:
            return rules.local_shard(x, rules.Spec(caxes), mesh)
        return x
    return tree_map(place, rows)


class _GScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c.to(g.dtype), None


def gscale(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Value x, gradient scaled by c (c may broadcast)."""
    return _GScale.apply(x, c)


def _client_mask_scales(mask_row: torch.Tensor, d_i: torch.Tensor,
                        mesh, caxes: Sequence[str]) -> torch.Tensor:
    """Eq. (7): w_{i,l} for this rank's client, via an f32 sum over the
    cohort."""
    dm = mask_row.float() * d_i.float()
    denom = all_reduce_(dm.clone(), mesh.group(caxes))
    return torch.where(denom > 0, dm / torch.where(denom > 0, denom, 1.0),
                       0.0)


def gather_leaf(x: torch.Tensor, spec: rules.Spec, mesh,
                 lead: int = 0) -> torch.Tensor:
    """All-gather the ZeRO-3 ('data') dim of a param leaf, differentiably
    when ``x`` needs a gradient (else without the autograd node's host
    cost); ``lead`` leading dims of the spec were sliced off (a stacked
    row)."""
    ax = rules.zero3_gather_axis(spec)
    if ax is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return ZGather.apply(x, ax - lead, mesh.group(rules.DATA))
    return all_gather_dim(x, ax - lead, mesh.group(rules.DATA))


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def _residual_sum_axes(spec: rules.Spec,
                       caxes: Sequence[str]) -> tuple[str, ...]:
    """Client axes whose Eq.(5) sum is NOT covered by the gather backward:
    the ZeRO-3 gather differentiates to a reduce-scatter over 'data' only;
    replicated leaves (and the 'pod' axis) need an explicit sum."""
    covered = ({rules.DATA} if rules.zero3_gather_axis(spec) is not None
               else set())
    return tuple(a for a in caxes if a not in covered)


def _scale_tree(tree: PyTree, w: torch.Tensor, cfg,
                skip: tuple[str, ...] = ()) -> PyTree:
    """Apply gscale per selectable layer; freeze (detach) other groups.
    Segments in ``skip`` are left untouched (the per-layer hook scales
    them inside the row loop)."""
    parts = split_mask(w, cfg)
    out = {}
    for key, sub in tree.items():
        if key in skip:
            out[key] = sub
        elif key in parts:
            c = parts[key]
            if key == "shared_attn":
                out[key] = tree_map(lambda x, c=c: gscale(x, c[0]), sub)
            else:
                out[key] = tree_map(lambda x, c=c: gscale(x, c.reshape(
                    (c.shape[0],) + (1,) * (x.dim() - 1))), sub)
        else:
            out[key] = tree_map(torch.Tensor.detach, sub)
    return out


def storage_layout(model: Model, mesh) -> Optional[rules.TPLayout]:
    """The tensor-parallel layout of ``model`` on ``mesh`` under
    ``RuntimeConfig(tp_constraints=True)`` (raising for a family without
    one), else None: storage whole over ``model``."""
    if not model.runtime.tp_constraints:
        return None
    return rules.TPLayout(model.cfg, mesh.shape[rules.MODEL])


def model_axis(layout: Optional[rules.TPLayout],
               mesh) -> Optional[ModelAxis]:
    """This rank's parallel form, or None where ``model`` has one rank
    (there every tensor-parallel operation is the plain code)."""
    if layout is None or layout.size == 1:
        return None
    return ModelAxis.on_mesh(layout, mesh)


# Groups gathered whole (not row by row through the hook) that a rank
# views as its share once a step: the hybrid's unstacked shared block,
# deepseek's stacked ``dense0`` (not a hooked segment, as in the
# reference) and the embed group (the vlm's ``patch_proj`` gathered whole)
VIEWED = ("shared_attn", "dense0", "embed")


def view_shared(tree: PyTree, specs: PyTree,
                axis: Optional[ModelAxis]) -> PyTree:
    """``tree`` with its :data:`VIEWED` groups (gathered over ``data``)
    viewed as this rank's share (``ModelAxis.view_row``, its spec dims
    all present: ``lead=0``), once a step rather than at each of the
    hybrid's sites, each ``dense0`` row or each use of ``patch_proj``; any
    other group, or no axis, as it is."""
    if axis is None:
        return tree
    return {k: axis.view_row(v, specs[k], lead=0) if k in VIEWED else v
            for k, v in tree.items()}


def shard_params(model: Model, mesh, params: PyTree,
                 specs: PyTree) -> PyTree:
    """This rank's storage of the full ``params``: ``rules.shard_tree``,
    or ``rules.tp_shard_tree`` under tensor parallelism."""
    layout = storage_layout(model, mesh)
    if layout is None:
        return rules.shard_tree(params, specs, mesh)
    return rules.tp_shard_tree(params, specs, mesh, layout)


def gather_tree_tp(tree: PyTree, specs: PyTree, mesh,
                   layout: rules.TPLayout, path: tuple = ()) -> PyTree:
    """The full tree from tensor-parallel storage, on every rank: each
    leaf gathered over ``data`` (its model slice), then over ``model``,
    then back in its own order (``TPLayout.from_storage_order``)."""
    if isinstance(tree, dict):
        return {k: gather_tree_tp(v, specs[k], mesh, layout, path + (k,))
                for k, v in tree.items()}
    x = gather_leaf(tree, specs, mesh)
    dim = rules.model_dim(specs)
    if dim is not None and layout.size > 1:
        x = all_gather_dim(x, dim, mesh.group(rules.MODEL))
    return layout.from_storage_order(path, x)


def _client_inputs(cfg, batch, masks, sizes):
    """This rank's client's mask row and size, after checking the inputs'
    layout: the family's batch keys, one client's rows."""
    if set(batch) != set(batch_template(cfg)):
        raise ValueError(f"batch keys {sorted(batch)}; the {cfg.family} "
                         f"step takes {sorted(batch_template(cfg))}")
    if masks.shape[0] != 1 or sizes.shape[0] != 1:
        raise ValueError(f"the step takes this rank's client's rows, a "
                         f"leading axis of 1 (shard_cohort_rows); got masks "
                         f"{tuple(masks.shape)}, sizes {tuple(sizes.shape)}")
    return masks[0], sizes[0]


def _metrics(loss: torch.Tensor, mask_row: torch.Tensor, mesh,
             caxes) -> dict:
    n = mesh.size(caxes)
    mean_loss = all_reduce_(loss.detach().float().clone(),
                            mesh.group(caxes)) / n
    union = all_reduce_(mask_row.float().clone(), mesh.group(caxes)) > 0
    return {"loss": mean_loss, "union_frac": union.float().mean()}


def _grads(loss: torch.Tensor, wrt: list) -> list:
    """d loss / d each of ``wrt``; None where the loss does not reach it
    (a missing gradient counts as zero in the update)."""
    return list(torch.autograd.grad(loss, wrt, allow_unused=True))


def _apply(p: torch.Tensor, g: Optional[torch.Tensor],
           lr: float) -> torch.Tensor:
    """Eq. (6) for one leaf: θ − η·Δ in f32, cast back."""
    if g is None:
        return p
    return (p.float() - lr * g.float()).to(p.dtype)


# ---------------------------------------------------------------------------
# τ = 1 (FedSGD)
# ---------------------------------------------------------------------------

def make_fl_train_step(model: Model, mesh, *, zero3: bool = True,
                       sel_idx: Optional[tuple[int, ...]] = None):
    """Build the FL round step (τ = 1, FedSGD semantics).

    ``build(params_or_shapes)`` returns ``(step, specs)``:
    ``step(params, batch, masks, sizes, lr) -> (new_params, metrics)``
    on this rank's local shards (:func:`rules.shard_tree` of the full
    tree by ``specs``), with this rank's client's rows
    (:func:`shard_cohort_rows`): ``batch["tokens"]`` (1, per_client,
    seq) etc., ``masks`` (1, L), ``sizes`` (1,); ``lr`` a float.
    ``metrics``: the cohort's mean ``loss`` and ``union_frac``, 0-d
    tensors.

    ``RuntimeConfig(sel_upload=True)`` with ``sel_idx``: only the selected
    rows of ``blocks`` flow through the differentiable gather (the
    paper's R/L upload, made structural); the rest of the model is
    gathered without a gradient and stays as it is.

    ``RuntimeConfig(tp_constraints=True)`` (the dense, vlm, ssm, hybrid,
    moe and audio families' language models): the local shards are
    :func:`shard_params`'s, model slices included; the Eq.(5) sums are
    unchanged.  The leaves replicated over ``model`` get the same gradient
    on every model rank: the norms (MLA's ``kv_ln``, whisper's
    ``xattn_ln`` and, through the one f on the encoder's output,
    ``enc_norm`` too) and the moe
    routers whole through f, MLA's ``w_dkv`` / ``w_krope`` whole on
    every rank and cut to the rank's slice by the gather's backward, and
    the ones a Mamba2 rank
    narrows to its heads or channels (``gate_ln``, ``A_log``, ``D``,
    ``dt_bias``) by gathering the slices' gradients back over ``model``
    (``tensor_parallel._NarrowGather``).
    """
    cfg, rt = model.cfg, model.runtime
    axis = model_axis(storage_layout(model, mesh), mesh)
    caxes = rules.client_axes(mesh)
    mesh_shape = dict(mesh.shape)
    selectable = tuple(seg.path for seg in layer_layout(cfg))
    sel_upload = rt.sel_upload and sel_idx is not None

    def step(params, specs, batch, masks, sizes, lr):
        mask_row, d_i = _client_inputs(cfg, batch, masks, sizes)
        w = _client_mask_scales(mask_row, d_i, mesh, caxes)       # (L,)
        w_parts = split_mask(w, cfg)
        my_batch = {k: v[0] for k, v in batch.items()}
        hooked = tuple(k for k in HOOKED_SEGMENTS if k in params)
        trained = tuple(k for k in params if k in selectable)

        if sel_upload:
            sel = torch.tensor(sel_idx, dtype=torch.long,
                               device=mesh.device)
            with torch.no_grad():
                frozen = gather_tree(params, specs, mesh)
            wrt = {nm: x[sel].detach().requires_grad_()
                   for nm, x in params["blocks"].items()}
            blocks = {nm: frozen["blocks"][nm].index_copy(
                0, sel, gather_leaf(r, specs["blocks"][nm], mesh))
                for nm, r in wrt.items()}
            p_eff = _scale_tree(view_shared({**frozen, "blocks": blocks},
                                            specs, axis), w, cfg)
            loss = model.seq_loss(
                p_eff, my_batch, tp=axis, layer_hook=None if axis is None
                else lambda pl, idx, seg: axis.view_row(pl, specs[seg]))
            grads = _grads(loss, list(wrt.values()))
            new_blocks = {}
            for (nm, x), g in zip(params["blocks"].items(), grads):
                ra = _residual_sum_axes(specs["blocks"][nm], caxes)
                if g is not None and ra:
                    g = all_reduce_(g.float(), mesh.group(ra))
                new_blocks[nm] = (x if g is None else
                                  x.index_copy(0, sel, _apply(x[sel], g, lr)))
            return ({**params, "blocks": new_blocks},
                    _metrics(loss, mask_row, mesh, caxes))

        def layer_hook(pl, idx, segment):
            """Per-layer ZeRO gather (over ``data``: the rank's model
            slice under tensor parallelism, then its compute view) +
            Eq.(7) grad-scale, in the row loop."""
            c = w_parts[segment][idx]
            rows = {nm: gather_leaf(x, specs[segment][nm], mesh, lead=1)
                    for nm, x in pl.items()}
            if axis is not None:
                rows = axis.view_row(rows, specs[segment])
            return {nm: gscale(x, c) for nm, x in rows.items()}

        wrt, p_in = [], {}
        for key, sub in params.items():
            if key in trained:
                sub = tree_map(lambda t: t.detach().requires_grad_(), sub)
                wrt += tree_items(sub, (key,))
            p_in[key] = sub
        # the hooked segments stay sharded: the hook gathers them by rows
        p_full = {key: sub if key in hooked
                  else gather_tree(sub, specs[key], mesh)
                  for key, sub in p_in.items()}
        p_eff = _scale_tree(view_shared(p_full, specs, axis), w, cfg,
                            skip=hooked)
        loss = model.seq_loss(p_eff, my_batch, layer_hook=layer_hook,
                              tp=axis)
        grads = _grads(loss, [t for _, t in wrt])
        # Eq. (5) cohort sum: the ZeRO-3 gather backward reduce-scattered
        # over 'data'; the remaining client axes (replicated leaves, 'pod')
        # get an explicit f32 sum.  Contributions are already w-scaled.
        spec_of = dict(tree_items(specs))
        summed = {}
        for (path, _), g in zip(wrt, grads):
            ra = _residual_sum_axes(spec_of[path], caxes)
            if g is not None and ra:
                g = all_reduce_(g.float(), mesh.group(ra))
            summed[path] = g
        new_params = tree_map_with_path(
            lambda path, p: _apply(p, summed.get(path), lr), params)
        return new_params, _metrics(loss, mask_row, mesh, caxes)

    def build(params_or_shapes):
        """Return (step, specs) for this arch; ``step`` takes the local
        shards, ``specs`` lays them out."""
        specs = rules.params_pytree_specs(cfg, params_or_shapes, zero3=zero3,
                                          mesh_shape=mesh_shape)

        def fl_step(params, batch, masks, sizes, lr):
            return step(params, specs, batch, masks, sizes, float(lr))
        return fl_step, specs

    return build


# ---------------------------------------------------------------------------
# τ > 1
# ---------------------------------------------------------------------------

def make_fl_train_step_tau(model: Model, mesh, *, sel_idx: tuple[int, ...],
                           tau: int, zero3: bool = True):
    """τ > 1 local steps (Eq. 3-4, Theorem A.2) on the mesh.

    Memory model = the paper's: each client holds *local copies of the
    selected rows only* (R rows of ``blocks``, gathered once per round);
    the frozen base stays ZeRO-sharded and is re-gathered per layer
    without a gradient, so the local backward passes are collective-free.
    Each local step applies ``r − lr·g·m_sel`` through
    ``ops.masked_sgd_update`` (the ``masked_update`` kernel on the card).
    The only cross-client traffic is the Eq.(5) upload of the R rows'
    w-weighted Δ, reduce-scattered back into storage layout (an all-reduce
    for replicated leaves, plus the 'pod' residual).

    Returned step: ``step(params, batch, masks, sizes, lr)`` with batch
    leaves (1, tau, per_client, …), masks (1, L), sizes (1,).

    Under ``RuntimeConfig(tp_constraints=True)`` the local copies are the
    rank's model slices of the R rows, ``masked_update`` runs on them,
    and the local steps issue the model-axis collectives of the parallel
    form.  The rows of the other hooked segment (whisper's
    ``enc_blocks``, gathered over ``data`` once a round with the frozen
    base) are viewed through their own specs at each use, as the
    ``blocks`` rows are.
    """
    cfg = model.cfg
    axis = model_axis(storage_layout(model, mesh), mesh)
    caxes = rules.client_axes(mesh)
    mesh_shape = dict(mesh.shape)
    sel_list = [int(i) for i in sel_idx]
    slot_of = {layer: j for j, layer in enumerate(sel_list)}

    def step(params, specs, batch, masks, sizes, lr):
        mask_row, d_i = _client_inputs(cfg, batch, masks, sizes)
        w = _client_mask_scales(mask_row, d_i, mesh, caxes)       # (L,)
        w_parts = split_mask(w, cfg)
        mask_parts = split_mask(mask_row.float(), cfg)
        my_batch = {k: v[0] for k, v in batch.items()}            # (tau, …)
        sel = torch.tensor(sel_list, dtype=torch.long, device=mesh.device)
        bspecs = specs["blocks"]
        with torch.no_grad():
            rows0 = {nm: gather_leaf(x[sel], bspecs[nm], mesh)
                     for nm, x in params["blocks"].items()}
            others = view_shared({k: gather_tree(v, specs[k], mesh)
                                  for k, v in params.items()
                                  if k != "blocks"}, specs, axis)
        m_sel = mask_parts["blocks"][sel].contiguous()            # (R,)

        def view(rows):
            return rows if axis is None else axis.view_row(rows, bspecs)

        def hook_for(local_rows):
            def hook(pl, idx, segment):
                if segment != "blocks":      # whisper's enc_blocks rows
                    return pl if axis is None else axis.view_row(
                        pl, specs[segment])
                j = slot_of.get(idx)
                if j is not None:
                    return view({nm: local_rows[nm][j] for nm in pl})
                with torch.no_grad():
                    return view({nm: gather_leaf(x, bspecs[nm], mesh,
                                                 lead=1)
                                 for nm, x in pl.items()})
            return hook

        rows, losses = rows0, []
        for s in range(tau):
            wrt = {nm: r.detach().requires_grad_() for nm, r in rows.items()}
            loss = model.seq_loss(
                {**others, "blocks": params["blocks"]},
                {k: v[s] for k, v in my_batch.items()},
                layer_hook=hook_for({nm: r.unbind(0)
                                     for nm, r in wrt.items()}), tp=axis)
            g = dict(zip(wrt, _grads(loss, list(wrt.values()))))
            g = {nm: torch.zeros_like(wrt[nm]) if gi is None else gi
                 for nm, gi in g.items()}
            # Eq.(3): the client updates only ITS selected layers
            rows = ops.masked_sgd_update(
                {nm: r.detach() for nm, r in wrt.items()}, g, m_sel, lr,
                mode=model.kernel_mode)
            losses.append(loss.detach())

        # Eq.(4)/(5): Δ_i rows, w-weighted, reduce-scattered to storage
        w_sel = w_parts["blocks"][sel]
        new_blocks = {}
        for nm, x in params["blocks"].items():
            delta = (rows0[nm] - rows[nm]).float() / lr              # Σ_k g
            delta = delta * w_sel.reshape((-1,) + (1,) * (delta.dim() - 1))
            ax = rules.zero3_gather_axis(bspecs[nm])
            if ax is not None:
                agg = reduce_scatter_dim(delta, ax, mesh.group(rules.DATA))
                if len(caxes) > 1:                        # 'pod' residual
                    agg = all_reduce_(agg, mesh.group(
                        tuple(a for a in caxes if a != rules.DATA)))
            else:
                agg = all_reduce_(delta, mesh.group(caxes))
            new_blocks[nm] = x.index_add(0, sel, (-lr * agg).to(x.dtype))
        return ({**params, "blocks": new_blocks},
                _metrics(torch.stack(losses).mean(), mask_row, mesh, caxes))

    def build(params_or_shapes):
        specs = rules.params_pytree_specs(cfg, params_or_shapes, zero3=zero3,
                                          mesh_shape=mesh_shape)

        def fl_step_tau(params, batch, masks, sizes, lr):
            return step(params, specs, batch, masks, sizes, float(lr))
        return fl_step_tau, specs

    return build


def batch_template(cfg) -> dict:
    """Structure-only template of the training batch (ref
    ``_batch_template``)."""
    t = {"tokens": 0}
    if cfg.family == "vlm":
        t["patches"] = 0
        if cfg.task == "classification":
            t = {"patches": 0, "label": 0}
    elif cfg.family == "audio":
        t["frames"] = 0
    elif cfg.task == "classification":
        t["label"] = 0
    return t
