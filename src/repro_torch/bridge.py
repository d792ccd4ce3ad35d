"""Parameter bridge between the JAX package and the port (new; no reference
counterpart).

The JAX package's parameters are a nested dict of arrays; the port keeps the
same paths, the same stacked ``(L, …)`` leaves and the same key order, so a
tree crosses as numpy arrays leaf by leaf.  numpy has no native bfloat16:
bf16 crosses as float32 (every bf16 value is exact in float32) and is cast
back on the torch side, so the round trip is exact.

On a mesh (``sharding/``), :func:`params_to_local` turns a full tree into
this rank's storage shards (sliced on the host, so the full tree never
reaches the device) and :func:`gather_params` joins the shards back into
the full tree on every rank (a collective: every rank calls it).  Given a
tensor-parallel ``layout`` (``sharding.fl_step.storage_layout``), both
take its storage: model slices too, a gated ``mlp_wi`` and a Mamba2
``ssm_in_proj`` / ``ssm_conv_w`` / ``ssm_conv_b`` reordered so that each
model slice holds its part of every packed piece
(``sharding.rules.TPLayout``); a full tree goes to shards and back to the
same full tree, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_to_torch(a, device: torch.device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes bf16 from a JAX array
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(arr)              # a copy: JAX buffers are read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_to_torch(tree: dict, device, dtype=None) -> dict:
    """numpy (or array-like) leaves → torch tensors on ``device``, same
    paths and key order.  ``dtype`` casts every floating leaf."""
    dev = resolve_device(device)

    def to_torch_tree(node):
        if isinstance(node, dict):
            return {k: to_torch_tree(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev, dtype)
    return to_torch_tree(tree)


def params_to_numpy(params: dict) -> dict:
    """torch leaves → numpy on the host, same paths and key order; bf16
    leaves come back as float32."""
    def to_numpy_tree(node):
        if isinstance(node, dict):
            return {k: to_numpy_tree(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return to_numpy_tree(params)


def params_to_local(tree: dict, specs: dict, mesh, dtype=None,
                    layout=None) -> dict:
    """numpy (or array-like) full leaves → this rank's shards on
    ``mesh.device`` by ``specs`` (``sharding.rules.params_pytree_specs``):
    the slice along the spec's client-axis dim, or the whole leaf when it
    is replicated; with a tensor-parallel ``layout``,
    ``rules.tp_local_shard``'s slice."""
    from repro_torch.sharding import rules

    def to_local(node, spec, path=()):
        if isinstance(node, dict):
            return {k: to_local(v, spec[k], path + (k,))
                    for k, v in node.items()}
        arr = np.asarray(node)
        if layout is not None:
            return _leaf_to_torch(
                rules.tp_local_shard(arr, spec, mesh, layout, path),
                mesh.device, dtype)
        dim, axes = rules.shard_dim(spec)
        if dim is not None:
            size = arr.shape[dim] // mesh.size(axes)
            start = mesh.index(axes) * size
            arr = arr[(slice(None),) * dim + (slice(start, start + size),)]
        return _leaf_to_torch(arr, mesh.device, dtype)
    return to_local(tree, specs)


def gather_params(local: dict, specs: dict, mesh, layout=None) -> dict:
    """This rank's shards → the full tree, on every rank of the mesh
    (under a tensor-parallel ``layout`` from its storage)."""
    from repro_torch.sharding.fl_step import gather_tree, gather_tree_tp
    with torch.no_grad():
        if layout is not None:
            return gather_tree_tp(local, specs, mesh, layout)
        return gather_tree(local, specs, mesh)
