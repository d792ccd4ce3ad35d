"""Inference steps on the mesh: prefill and single-token decode
(counterpart of ``repro/sharding/serve.py``).

No client aggregation: inference of the fine-tuned global model.
Parameters are stored by the training rules (ZeRO-3 over ``data``) and
gathered without a gradient — the stacked ``blocks`` one row at a time
through the model's ``layer_hook``, the other groups whole at the start
of the step.  The batch and the KV / state caches are split over the
client axes when their batch divides (``rules.batch_spec_serve``,
``rules.cache_specs``).  By default a rank runs its own rows whole over
``model``.  With ``RuntimeConfig(tp_constraints=True)`` (the language
models of the dense, vlm, ssm, hybrid, moe and audio families) a rank
stores its model slice (``fl_step.storage_layout``), computes its heads
(MLA's over the whole latent; whisper's in self- and cross-attention),
MLP columns, SSD heads, experts or their ff columns and, where the
vocabulary divides, vocabulary rows (``tensor_parallel.ModelAxis``; the
hybrid's shared block, deepseek's ``dense0`` and the embed group viewed
once a step: a vlm prefill projects its stub prefix, a whisper prefill
its batch's ``frames``, whole on every rank), keeps its kv heads' cache
rows whole over the sequence (whisper's ``cross_kv``, which the caller
fills from ``Model.encode``, too), its Mamba2 conv channels and state
heads and MLA's latent rows whole (``rules.tp_shard_cache``), and
all-gathers split last-position logits over ``model`` before it returns
or argmaxes them.  A moe model whose
routers share their capacity across the batch keeps the batch whole on
every rank (:func:`batch_spec`).

``build`` returns the step and the specs that lay out its inputs: a
caller passes ``fl_step.shard_params`` of the full params by the param
specs, ``rules.local_shard`` of the batch or tokens by :func:`batch_spec`,
and :func:`shard_cache` of the cache by its cache specs.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import HOOKED_SEGMENTS, Model
from repro_torch.sharding import rules
from repro_torch.sharding.fl_step import (gather_leaf, gather_tree,
                                          model_axis, storage_layout,
                                          view_shared)
from repro_torch.tree import tree_map


def _whole_batch(model: Model) -> bool:
    """A moe model routing over the whole batch (``moe_local_dispatch``
    off): its rows compete for the same expert capacity.  The reference's
    single program routes the global batch; a rank holding a slice would
    route its slice alone and drop other tokens."""
    return model.cfg.family == "moe" and not model.runtime.moe_local_dispatch


def batch_spec(model: Model, mesh, batch: int) -> rules.Spec:
    """The serve steps' batch layout: ``rules.batch_spec_serve``, or whole
    on every rank where :func:`_whole_batch`."""
    if _whole_batch(model):
        return rules.Spec(None)
    return rules.batch_spec_serve(mesh, batch)


def _cache_specs(model: Model, cache_shapes, mesh, batch: int):
    """``rules.cache_specs``, whole over the client axes where
    :func:`_whole_batch`."""
    specs = rules.cache_specs(model.cfg, cache_shapes, mesh, batch)
    if _whole_batch(model):
        return tree_map(rules.without_client_axes, specs)
    return specs


def shard_cache(model: Model, mesh, cache, c_specs):
    """This rank's decode cache from the full one: ``rules.shard_tree``
    by the cache specs, or ``rules.tp_shard_cache`` under tensor
    parallelism."""
    layout = storage_layout(model, mesh)
    if layout is None:
        return rules.shard_tree(cache, c_specs, mesh)
    return rules.tp_shard_cache(cache, c_specs, mesh, layout)


def gathered(params: dict, specs: dict, mesh, axis=None):
    """(the groups gathered whole, the ``layer_hook`` that gathers a
    hooked segment's row), without a gradient; with a ``ModelAxis`` the
    hook also views the row as the rank's share, and the hybrid's shared
    block and deepseek's ``dense0`` are viewed once here."""
    with torch.no_grad():
        full = view_shared({k: (v if k in HOOKED_SEGMENTS else
                                gather_tree(v, specs[k], mesh))
                            for k, v in params.items()}, specs, axis)

    def hook(pl, idx, segment):
        with torch.no_grad():
            row = {nm: gather_leaf(x, specs[segment][nm], mesh, lead=1)
                   for nm, x in pl.items()}
            return row if axis is None else axis.view_row(row,
                                                          specs[segment])
    return full, hook


def make_prefill_step(model: Model, mesh, *, zero3: bool = True):
    """``build(params_shapes, batch_shapes) -> (prefill, specs)``;
    ``prefill(params, batch)`` returns ``Model.logits_seq`` of this rank's
    batch rows (last-position logits, or the classifier's); ``batch``
    carries every input of the family (``tokens``, a vlm's ``patches``,
    whisper's ``frames``), each laid out by :func:`batch_spec`."""
    cfg = model.cfg
    axis = model_axis(storage_layout(model, mesh), mesh)
    mesh_shape = dict(mesh.shape)

    def build(params_shapes, batch_shapes):
        specs = rules.params_pytree_specs(cfg, params_shapes, zero3=zero3,
                                          mesh_shape=mesh_shape)

        def prefill(params, batch):
            full, hook = gathered(params, specs, mesh, axis)
            with torch.no_grad():
                return model.logits_seq(full, batch, layer_hook=hook,
                                        tp=axis)
        return prefill, specs

    return build


def make_serve_step(model: Model, mesh, *, zero3: bool = True,
                    window: int = 0):
    """Single-token decode with a KV cache of the target context length:
    ``build(params_shapes, cache_shapes, batch) -> (serve, (specs,
    cache_specs))``; ``serve(params, tokens, pos, cache)`` returns
    (next tokens (argmax, int32), logits, cache), the cache (laid out by
    :func:`shard_cache`) updated in place, for this rank's rows.
    whisper's cache carries ``cross_kv``, filled by the caller from
    ``Model.encode`` before :func:`shard_cache` lays it out."""
    cfg = model.cfg
    axis = model_axis(storage_layout(model, mesh), mesh)
    mesh_shape = dict(mesh.shape)

    def build(params_shapes, cache_shapes, batch: int):
        specs = rules.params_pytree_specs(cfg, params_shapes, zero3=zero3,
                                          mesh_shape=mesh_shape)
        c_specs = _cache_specs(model, cache_shapes, mesh, batch)

        def serve(params, tokens, pos, cache):
            full, hook = gathered(params, specs, mesh, axis)
            logits, cache = model.decode_step(full, tokens, pos, cache,
                                              window=window, layer_hook=hook,
                                              tp=axis)
            return logits.argmax(-1).to(torch.int32), logits, cache
        return serve, (specs, c_specs)

    return build
