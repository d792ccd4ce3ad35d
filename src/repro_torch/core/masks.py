"""Masking vectors m_i^t ∈ {0,1}^L and per-layer gradient utilities, §3
(counterpart of ``repro/core/masks.py``).

Mask matrices are host numpy (the select stage's output); the per-layer
reductions run on the tensors' device, the squared norms through the
``layer_grad_norm`` kernel (``kernels/ops.py``).  Selectable segments are
stacked (count, …), except the hybrid family's shared block, whose leaves
are unstacked: its one mask entry reads them as a single row.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import layer_layout
from repro_torch.tree import tree_leaves


def mask_from_indices(indices, n_layers: int) -> np.ndarray:
    m = np.zeros(n_layers, dtype=np.float32)
    m[np.asarray(list(indices), dtype=int)] = 1.0
    return m


def union_mask(mask_matrix: np.ndarray) -> np.ndarray:
    """L_t = ∪_i L_i^t from the (cohort, L) mask matrix."""
    return (np.asarray(mask_matrix).sum(0) > 0).astype(np.float32)  # repro: allow[host-sync] -- mask matrices are host np by contract (select stage)


def first_trainable_layer(mask_matrix: np.ndarray) -> int:
    """Host-side prefix cut for the mask-aware engine: the smallest mask
    index any cohort member selects.  Layers below it are frozen for
    everyone this round; an all-empty matrix returns L (forward only)."""
    cols = np.flatnonzero(np.asarray(mask_matrix).sum(0) > 0)  # repro: allow[host-sync] -- mask matrices are host np by contract (select stage)
    return int(cols[0]) if cols.size else int(np.asarray(mask_matrix).shape[-1])  # repro: allow[host-sync] -- host np indices, no device value


def aggregation_weights(mask_matrix, sizes) -> torch.Tensor:
    """Eq. (7): w_{i,l} = d_i·m_i(l) / Σ_j d_j·m_j(l)   (0 where denom is 0).

    mask_matrix: (n, L) 0/1; sizes: (n,) client dataset sizes d_i (tensors,
    or host arrays, which land on the CPU).  Returns (n, L) float32.
    """
    mm = torch.as_tensor(mask_matrix, dtype=torch.float32)
    d = torch.as_tensor(sizes, dtype=torch.float32,
                        device=mm.device)[:, None]
    denom = (mm * d).sum(0, keepdim=True)                   # (1, L)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, mm * d / safe, torch.zeros_like(mm))


def chi_divergence(weights: torch.Tensor, alpha) -> torch.Tensor:
    """χ²_{w_l ‖ α} = Σ_i (w_{i,l} − α_i)² / α_i per layer (Lemma 4.6)."""
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=weights.device)[:, None]
    return ((weights - a) ** 2 / a).sum(0)                  # (L,)


# ---------------------------------------------------------------------------
# Per-layer gradient norms (the strategy inputs)
# ---------------------------------------------------------------------------

def _segment_rows(tree: dict, path: str) -> dict:
    """A selectable segment's leaves with their leading (count, …) axis:
    the hybrid's unstacked shared block gains one of length 1 (a view)."""
    sub = tree[path]
    if path == "shared_attn":
        return {k: v[None] for k, v in sub.items()}
    return sub


def per_layer_sq_norms(grads: dict, cfg, *,
                       mode: Optional[str] = None) -> torch.Tensor:
    """‖g_{i,l}‖² for every selectable layer l — the L-vector clients upload.

    Each segment's stacked leaves go through ``ops.layer_grad_norms``: the
    ``layer_grad_norm`` kernel on the card, its plain version on the CPU
    (``mode`` forces either); the hybrid's shared leaves as one row each.
    Only the selectable segments are read.
    """
    return torch.cat([ops.layer_grad_norms(_segment_rows(grads, seg.path),
                                           mode=mode)
                      for seg in layer_layout(cfg)])


def per_layer_param_sq_norms(params: dict, cfg, *,
                             mode: Optional[str] = None) -> torch.Tensor:
    """‖θ_l‖² per layer (for the RGN baseline)."""
    return per_layer_sq_norms(params, cfg, mode=mode)


def layer_grad_stats(grads: dict, cfg):
    """(sq_norm, mean, var) of gradient elements per layer (for SNR)."""
    sq, mean, var = [], [], []
    for seg in layer_layout(cfg):
        sub = _segment_rows(grads, seg.path)
        leaves = [sub[k].float() for k in sorted(sub)]
        n = sum(math.prod(x.shape[1:]) for x in leaves)
        s1 = sum(x.reshape(x.shape[0], -1).sum(1) for x in leaves)
        s2 = sum((x * x).reshape(x.shape[0], -1).sum(1) for x in leaves)
        mu = s1 / n
        sq.append(s2)
        mean.append(mu)
        var.append(s2 / n - mu ** 2)
    return torch.cat(sq), torch.cat(mean), torch.cat(var)


# the reference's name; the probe calls layer_grad_stats, which the repo
# lint's by-name call graph does not link to the reference's function
per_layer_stats = layer_grad_stats


def count_layer_params(params: dict, cfg) -> np.ndarray:
    """Number of parameters per selectable layer (cost model R(m))."""
    out = []
    for seg in layer_layout(cfg):
        leaves = tree_leaves(_segment_rows(params, seg.path))
        per = sum(int(np.prod(x.shape[1:])) for x in leaves)  # repro: allow[host-sync] -- static shape arithmetic, no device value
        out.append(np.full(seg.count, per))
    return np.concatenate(out).astype(np.int64)
