"""Federated aggregation, Eq. (5)-(7) (counterpart of
``repro/core/aggregation.py``).

    Δ^t = Σ_{l∈L_t} Σ_{i∈S_t} w_{i,l}^t Δ_{i,l}^t ,   θ^{t+1} = θ^t − η Δ^t

* :func:`aggregate` — the sequential oracle: one scale-and-add per cohort
  member's delta tree.
* :func:`aggregate_stacked` / :func:`aggregate_suffix` — the
  vectorized engine's path over a stacked (n, …) delta tree (whole tree,
  or the trainable suffix above the round's prefix cut).  The reference's
  einsum over n becomes an explicit sum in client order, so no (n, …)
  temporary is written.
* :func:`apply_update` / :func:`apply_suffix_update` — Eq. (6).

The suffix functions keep the reference's names (``aggregate_stacked_suffix``,
``apply_update_suffix``) as aliases; the round path calls the port's own
names, which the repo lint's by-name call graph does not link to the
reference's (``models/model.py``).
* :func:`apply_delta_rows` — personalized-delta serving.

The hybrid family's shared block is one selectable layer whose leaves are
unstacked.  Its segment's (1,) mask or weight column, shaped as a row
factor of rank ``x.dim()``, broadcasts over such a leaf as the scalar the
reference's ``shared_attn`` branches take, and ``p[0:]`` is the whole
leaf: the functions below need no branch of their own for it.  The fault
helpers only read the stacked deltas' leading (n,) client axis.

* :func:`corrupt_delta_rows`, :func:`finite_row_mask`,
  :func:`zero_delta_rows` — the fault path's injected corruption and
  finite guard on a stacked (n, …) delta tree (DESIGN.md §12).  The
  reference's are out of place; these write into the stacked buffer the
  round owns (the same values), so a full-width cohort's deltas are never
  copied.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.masks import aggregation_weights
from repro_torch.models.model import (segment_prefix_cuts, split_mask,
                                      split_mask_matrix)
from repro_torch.tree import tree_leaves, tree_map


def _row_scale(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(c,) per-row values broadcast against a (c, …) stacked leaf."""
    return s.to(x.dtype).reshape((s.shape[0],) + (1,) * (x.dim() - 1))


def scale_by_layer(tree: dict, scale_vec: torch.Tensor, cfg) -> dict:
    """Multiply each selectable layer's subtree by its entry of scale_vec
    (L,); frozen groups (embed/head/norms) are zeroed."""
    parts = split_mask(scale_vec, cfg)
    out = {}
    for key, sub in tree.items():
        if key not in parts:
            out[key] = tree_map(torch.zeros_like, sub)
        else:
            out[key] = tree_map(lambda x, s=parts[key]: x * _row_scale(s, x),
                                sub)
    return out


def corrupt_delta_rows(deltas: dict, codes, explode_scale) -> dict:
    """Apply per-row injected corruption to a stacked (n, …) delta tree, in
    place, and return it.

    ``codes`` (n,) int, a host array (the injector draws it on the host),
    uses :data:`repro_torch.faults.CORRUPT_CODES`: 0 clean, 1 NaN-fill,
    2 Inf-fill, 3 ×``explode_scale`` in the leaf's dtype.  A corrupted row
    is filled in every leaf, the zero rows of unselected layers included;
    clean rows are not touched.
    """
    codes = np.asarray(codes, np.int32)
    for x in tree_leaves(deltas):
        # the scale rounded to the leaf's dtype, on the host
        scale = torch.tensor(explode_scale, dtype=x.dtype).item()
        for i in np.flatnonzero(codes).tolist():
            if codes[i] == 3:
                x[i].mul_(scale)
            else:
                x[i].fill_(math.inf if codes[i] == 2 else math.nan)
    return deltas


def finite_row_mask(deltas: dict, max_sq) -> torch.Tensor:
    """(n,) f32 quarantine mask over a stacked delta tree: 1 where every
    entry of the row is finite AND the row's Δ sq-norm, summed in f32, is
    at most ``max_sq``.  The two predicates stay apart: with ``max_sq =
    inf`` a finite row whose square sum overflows to inf is kept (inf ≤
    inf), as in the reference.  Row by row, in two reads of each row and
    no row-sized transient: a row is all finite iff its min and max are
    (``aminmax`` propagates NaN)."""
    leaves = tree_leaves(deltas)
    fin, sq = [], []
    for i in range(leaves[0].shape[0]):
        f = s = None
        for x in leaves:
            r = x[i].reshape(-1).float()
            lo, hi = torch.aminmax(r)
            fi, si = torch.isfinite(lo) & torch.isfinite(hi), torch.dot(r, r)
            f = fi if f is None else f & fi
            s = si if s is None else s + si
        fin.append(f)
        sq.append(s)
    limit = float(np.float32(max_sq))     # compared in f32
    return (torch.stack(fin) & (torch.stack(sq) <= limit)).float()


def zero_delta_rows(deltas: dict, ok: torch.Tensor) -> dict:
    """Zero, in place, the rows ``ok`` marks dead or quarantined, and
    return the tree.  Needed before the Eq.(5) contraction: a zero Eq.(7)
    weight does not cancel a NaN/Inf row (0·NaN = NaN), so the rows are
    filled with zeros, never multiplied by ``ok``."""
    dead = ok <= 0
    for x in tree_leaves(deltas):
        x.masked_fill_(dead.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
    return deltas


def aggregate(deltas: Sequence[dict], mask_matrix, sizes, cfg) -> dict:
    """Eq. (5): Δ^t = Σ_l Σ_i w_{i,l} Δ_{i,l}, client by client."""
    dev = tree_leaves(deltas[0])[0].device
    W = aggregation_weights(torch.as_tensor(mask_matrix, device=dev),
                            torch.as_tensor(sizes, device=dev))
    total = None
    for i, d in enumerate(deltas):
        scaled = scale_by_layer(d, W[i], cfg)
        total = scaled if total is None else tree_map(torch.add, total, scaled)
    return total


def _weighted_sum(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_n w[n, :] ⊙ x[n] in f32 for a (n, c, …) leaf and (n, c) weights,
    summed in client order."""
    acc = None
    for n in range(x.shape[0]):
        term = _row_scale(w[n].float(), x[n].float()) * x[n].float()
        acc = term if acc is None else acc + term
    return acc


def aggregate_stacked(deltas: dict, weights: torch.Tensor, cfg) -> dict:
    """Eq. (5) over a stacked cohort delta tree (leaves carry a leading
    (n,) client axis); ``weights`` is the (n, L) Eq.(7) matrix.  Frozen
    groups come back zero, as in :func:`aggregate`."""
    parts = split_mask_matrix(weights, cfg)
    out = {}
    for key, sub in deltas.items():
        if key not in parts:
            out[key] = tree_map(lambda x: torch.zeros(
                x.shape[1:], dtype=torch.float32, device=x.device), sub)
        else:
            out[key] = tree_map(lambda x, w=parts[key]: _weighted_sum(w, x),
                                sub)
    return out


def apply_update(params: dict, update: dict, lr: float) -> dict:
    """Eq. (6): θ^{t+1} = θ^t − η Δ^t."""
    return tree_map(lambda p, u: p - lr * u.to(p.dtype), params, update)


def aggregate_suffix(deltas: dict, weights: torch.Tensor, cut: int,
                     cfg) -> dict:
    """Eq. (5) over the trainable suffix only: ``deltas`` is the
    ``trainable_rows``-shaped tree with a leading (n,) client axis;
    ``weights`` the full (n, L) Eq.(7) matrix (its frozen columns are zero
    by construction).  Returns the suffix-shaped global update."""
    parts = split_mask_matrix(weights, cfg)
    cuts = segment_prefix_cuts(cut, cfg)
    return {key: tree_map(lambda x, w=parts[key][:, cuts[key]:]:
                          _weighted_sum(w, x), sub)
            for key, sub in deltas.items()}


aggregate_stacked_suffix = aggregate_suffix


def apply_suffix_update(params: dict, update: dict, lr: float, cut: int,
                        cfg) -> dict:
    """Eq. (6) on the trainable suffix, scattered back into the full tree:
    suffix rows get ``p − η·u``; frozen rows and groups pass through as
    the same tensors (the dense path's ``p − η·0 = p`` exactly)."""
    cuts = segment_prefix_cuts(cut, cfg)
    out = {}
    for key, sub in params.items():
        if key not in update:
            out[key] = sub
            continue
        c = cuts[key]

        def upd(p, u, c=c):
            new = p[c:] - lr * u.to(p.dtype)
            return new if c == 0 else torch.cat([p[:c], new], 0)

        out[key] = tree_map(upd, sub, update[key])
    return out


apply_update_suffix = apply_suffix_update


def apply_delta_rows(params: dict, rows: dict, deltas: dict,
                     scale: float = 1.0) -> dict:
    """Scatter additive per-layer delta rows into the full tree.

    ``rows`` maps a segment path to the (k,) local layer indices a user
    fine-tuned, ``deltas`` to the matching ``{leaf_name: (k, *shape)}`` rows
    (host numpy or tensors).  Returns a new tree; segments absent from
    ``rows`` pass through as the same tensors — exactly the frozen layers.
    """
    out = {}
    for key, sub in params.items():
        if key not in rows:
            out[key] = sub
            continue
        out[key] = {}
        for name, p in sub.items():
            idx = torch.as_tensor(rows[key], dtype=torch.long, device=p.device)
            d = torch.as_tensor(deltas[key][name], device=p.device)
            out[key][name] = p.index_add(0, idx, scale * d.to(p.dtype))
    return out


def add_delta_rows_(params: dict, rows: dict, deltas: dict) -> dict:
    """:func:`apply_delta_rows` in place: the user's delta rows are added
    into ``params``' own rows (the same ``index_add``, so the same values),
    and no second copy of a segment is made.  Returns ``params``."""
    for key, idx in rows.items():
        for name, p in params[key].items():
            p.index_add_(0, torch.as_tensor(idx, dtype=torch.long,
                                            device=p.device),
                         torch.as_tensor(deltas[key][name],
                                         device=p.device).to(p.dtype))
    return params
