"""Parameter / batch / cache partition rules for the mesh (counterpart of
``repro/sharding/rules.py``).

Mesh axes: ``('data', 'model')`` single-pod, ``('pod', 'data', 'model')``
multi-pod.  The *client* axes (pod×data) carry the FL cohort — one client
per (pod, data) coordinate — and ``data`` doubles as the ZeRO-3 storage
axis for the frozen model base.  The rules are the reference's, name-based
over the stacked-parameter layout, and return a :class:`Spec` of the
leaf's rank.

A spec names ``model`` where the reference lays tensor parallelism; the
port keeps those entries (so its specs equal the reference's leaf by
leaf) but runs no tensor parallelism: a rank stores the slice of a leaf
along the client axes of its spec and holds it whole over ``model``
(:func:`local_shard`), as the reference's fully manual fallback does.
``make_shard_hook`` (activation constraints on ``model``) waits with
tensor parallelism (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map_with_path

PyTree = Any

DATA = "data"     # ZeRO-3 / client axis
MODEL = "model"   # tensor-parallel axis
CLIENT = ("pod", DATA)


class Spec(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    dim, each None, an axis name or a tuple of names; a 1-tuple entry is
    its name, as ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(n: int, axis_size: int) -> bool:
    return axis_size > 0 and n % axis_size == 0


_SUBBLOCK_PREFIXES = ("attn_", "xattn_", "mlp_", "moe_", "ssm_")


def param_spec(path: tuple[str, ...], leaf, cfg: ArchConfig, *,
               zero3: bool, mesh_shape: dict[str, int]) -> Spec:
    """Spec for one parameter leaf (stacked or not); ``leaf`` needs only
    ``.shape`` (ref ``param_spec``)."""
    name = path[-1]
    for pref in _SUBBLOCK_PREFIXES:      # stacked blocks prefix their leaves
        if name.startswith(pref):
            name = name[len(pref):]
            break
    group = path[0]
    shape = tuple(leaf.shape)
    dsz, msz = mesh_shape.get(DATA, 1), mesh_shape.get(MODEL, 1)

    stacked = group in ("blocks", "enc_blocks", "dense0")
    off = 1 if stacked else 0          # leading (L,) axis never sharded

    def spec(*dims):
        full = [None] * off + list(dims)
        full += [None] * (len(shape) - len(full))
        # drop axes that do not divide (tuple entries: product must divide)
        out = []
        for dim, ax in zip(shape, full):
            if isinstance(ax, tuple):
                size = math.prod(mesh_shape.get(a, 1) for a in ax)
                if not _divisible(dim, size):
                    ax = tuple(a for a in ax if a == MODEL) or None
                    if isinstance(ax, tuple):
                        ax = ax[0] if _divisible(dim, msz) else None
            elif ax == DATA and not _divisible(dim, dsz):
                ax = None
            elif ax == MODEL and not _divisible(dim, msz):
                ax = None
            out.append(ax)
        return Spec(*out)

    # the ZeRO-3 ('data') axis is co-located with 'model' on the tensor-
    # parallel dim: contraction dims stay unsharded (ref rules.py:71-75)
    tp = (MODEL, DATA) if zero3 else MODEL

    # --- embeddings / head --------------------------------------------------
    if group == "embed":
        if name == "tok":
            return spec(tp, None)                  # (V, d)
        return spec(None, tp)                      # projectors (d, d)
    if group == "head":
        return spec(None, tp)                      # (d, V) or (d, classes)
    if group in ("final_norm", "enc_norm"):
        return Spec(None)

    # --- attention (column: qkv — row: wo, both on the H·hd dim) -----------
    if name in ("wq", "wk", "wv", "w_dkv", "w_krope"):
        return spec(None, tp)                      # (…, d, H·hd)
    if name == "w_ukv":
        return spec(None, tp)                      # (…, lora, H·(nope+v))
    if name == "wo":
        return spec(tp, None)                      # (…, H·hd, d)
    if name in ("bq", "bk", "bv"):
        return spec(MODEL)

    # --- dense MLP (column: wi — row: wo, both on the ff dim) ----------------
    if name == "wi" or name == "wi_s":
        return spec(None, tp)                      # (…, d, 2ff)
    if name == "wo" or name == "wo_s":
        return spec(tp, None)                      # (…, ff, d)

    # --- MoE ------------------------------------------------------------------
    if name == "router":
        return spec(None, None)                    # (…, d, E)
    if name == "wi_e":                             # (…, E, d, F)
        if _divisible(cfg.n_experts, msz):
            return spec(MODEL, None, DATA if zero3 else None)
        return spec(None, None, tp)
    if name == "wo_e":                             # (…, E, F, d)
        if _divisible(cfg.n_experts, msz):
            return spec(MODEL, DATA if zero3 else None, None)
        return spec(None, tp, None)

    # --- SSM --------------------------------------------------------------------
    if name == "in_proj":
        return spec(None, tp)                      # (…, d, zxbcdt)
    if name == "out_proj":
        return spec(tp, None)                      # (…, d_in, d)
    if name == "conv_w":
        return spec(None, MODEL)                   # (…, K, conv_dim)
    if name == "conv_b":
        return spec(MODEL)

    # small vectors (ln / dt_bias / A_log / D / gate_ln / kv_ln)
    return Spec(*([None] * len(shape)))


def params_pytree_specs(cfg: ArchConfig, params_shapes: PyTree, *,
                        zero3: bool, mesh_shape: dict[str, int]) -> PyTree:
    """:func:`param_spec` over a nested dict of leaves with ``.shape``
    (tensors, meta tensors), same paths."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, zero3=zero3,
                                      mesh_shape=mesh_shape), params_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def client_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in CLIENT)


def n_clients(mesh) -> int:
    """Clients on the mesh: the product of its client axes."""
    return math.prod(mesh.shape[a] for a in client_axes(mesh))


def batch_spec_train(mesh) -> Spec:
    """FL training batch (clients, per_client, seq): clients over pod×data."""
    return Spec(client_axes(mesh))


def batch_spec_serve(mesh, batch: int) -> Spec:
    """Inference batch dim over the client axes when divisible."""
    ca = client_axes(mesh)
    return Spec(ca) if batch % n_clients(mesh) == 0 else Spec(None)


def cache_specs(cfg: ArchConfig, cache_shapes: PyTree, mesh,
                batch: int) -> PyTree:
    """KV/state cache specs: batch over client axes, heads-or-seq over model."""
    msz = mesh.shape[MODEL]
    ca = client_axes(mesh)
    b_ax = ca if batch % n_clients(mesh) == 0 else None

    def spec_for(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        # layouts: kv (L,B,W,K,hd) | pos (L,W) | mla ckv (L,B,W,lora)
        # ssm conv (L,B,K-1,Cd) | ssm state (L,B,H,P,N) | shared (G,B,W,K,hd)
        if name == "pos":
            return Spec(*([None] * len(shape)))
        if name in ("k", "v"):
            L_, B_, W_, K_, hd_ = shape
            kv_ax = MODEL if _divisible(K_, msz) else None
            w_ax = MODEL if kv_ax is None and _divisible(W_, msz) else None
            return Spec(None, b_ax, w_ax, kv_ax, None)
        if name == "ckv" or name == "krope":
            L_, B_, W_, R_ = shape
            r_ax = MODEL if _divisible(R_, msz) else None
            return Spec(None, b_ax, None, r_ax)
        if name == "conv":
            return Spec(None, b_ax, None,
                        MODEL if _divisible(shape[-1], msz) else None)
        if name == "state":
            L_, B_, H_, P_, N_ = shape
            h_ax = MODEL if _divisible(H_, msz) else None
            return Spec(None, b_ax, h_ax, None, None)
        return Spec(*([None] * len(shape)))

    return tree_map_with_path(spec_for, cache_shapes)


def zero3_gather_axis(spec: Spec) -> Optional[int]:
    """Index of the client/ZeRO axis in a param spec (None if replicated)."""
    for i, entry in enumerate(spec):
        if DATA in _names(entry):
            return i
    return None


# ---------------------------------------------------------------------------
# Storage: a full leaf and this rank's shard
# ---------------------------------------------------------------------------

def shard_dim(spec: Spec) -> tuple[Optional[int], tuple[str, ...]]:
    """(dim, client axes) along which a leaf of ``spec`` is stored split
    over the mesh, or (None, ()) for a replicated leaf.  ``model`` entries
    are dropped: a shard is whole over ``model``."""
    for i, entry in enumerate(spec):
        names = tuple(a for a in _names(entry) if a in CLIENT)
        if names:
            return i, names
    return None, ()


def without_client_axes(spec: Spec) -> Spec:
    """``spec`` with its client-axis entries dropped: a leaf stored whole
    on every rank."""
    return Spec(*(None if set(_names(e)) & set(CLIENT) else e
                  for e in spec))


def local_shard(leaf: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's storage of a full ``leaf``: its slice along the spec's
    client-axis dim (a view), or the leaf itself when replicated."""
    dim, axes = shard_dim(spec)
    if dim is None:
        return leaf
    n = mesh.size(axes)
    size = leaf.shape[dim] // n
    return leaf.narrow(dim, mesh.index(axes) * size, size)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """:func:`local_shard` leaf by leaf, same paths."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)
