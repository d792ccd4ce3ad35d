"""Estimators for the convergence-theory quantities of §4.1 (counterpart of
``repro/core/theory.py``).

* ``E_t1 = ‖Σ_{l∉L_t} ∇_l f(θ^t)‖²``  — importance of the *unselected* layers
  (Lemma 4.6, first term).
* ``E_t2 = Σ_{l∈L_t} χ²_{w_{t,l}‖α} κ_l²`` — heterogeneous-selection term.
* ``κ_l`` — per-layer gradient diversity (Assumption 4.3), estimated as the
  max over clients of ‖∇_l f(θ) − ∇_l f_i(θ)‖.
* ``σ_l`` — stochastic-gradient deviation (Assumption 4.2), estimated from
  repeated minibatch draws.
* :func:`theorem_4_7_rhs` — the error-floor expression: it grows with
  E_t1 + E_t2 and vanishes under full selection + uniform cohort.

Gradients are ``torch.autograd.grad`` of :meth:`Model.seq_loss` over the
whole parameter dict (embeddings and head too, as the reference's
``jax.grad(model.loss)``), in the params' type, on the model's device.
Per-layer squared norms go through ``core/masks.py::per_layer_sq_norms``:
the ``layer_grad_norm`` kernel on the card, its plain version on the CPU;
``mode`` forces either.  Batches are dicts of tensors on the model's
device or of host arrays, which are copied there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import masks as M
from repro_torch.core.client import host_to_device
from repro_torch.core.masks import aggregation_weights, chi_divergence, union_mask
from repro_torch.models.model import Model, layer_layout
from repro_torch.tree import tree_leaves, tree_map


def _on_device(model: Model, batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor)
            else host_to_device(np.asarray(v), model.device)
            for k, v in batch.items()}


def _loss_gradient(model: Model, params: dict, batch: dict) -> dict:
    """∇ of ``model.seq_loss`` at ``params`` over every leaf, in each
    leaf's type; a leaf the loss does not read gets zeros (as
    ``jax.grad`` gives it)."""
    wrt = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(wrt)
    grads = torch.autograd.grad(model.seq_loss(wrt, _on_device(model, batch)),
                                leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return tree_map(lambda _: next(it), wrt)


def global_gradient(model: Model, params: dict, client_batches: Sequence,
                    alpha: np.ndarray) -> dict:
    """∇f(θ) = Σ_i α_i ∇f_i(θ) (full-batch per client), f32."""
    total = None
    for a, batch in zip(alpha, client_batches):
        g = tree_map(lambda x: float(a) * x.float(),
                     _loss_gradient(model, params, batch))
        total = g if total is None else tree_map(torch.add, total, g)
    return total


def per_client_gradients(model: Model, params: dict,
                         client_batches: Sequence) -> list[dict]:
    return [_loss_gradient(model, params, b) for b in client_batches]


def _sq_norms(model: Model, tree: dict, mode: Optional[str]) -> np.ndarray:
    return M.per_layer_sq_norms(tree, model.cfg, mode=mode).cpu().numpy()


def layer_diff(model: Model, a: dict, b: dict) -> dict:
    """f32 ``a − b`` over the selectable segments (the only leaves the
    per-layer norms read)."""
    return {seg.path: tree_map(lambda x, y: x.float() - y.float(),
                               a[seg.path], b[seg.path])
            for seg in layer_layout(model.cfg)}


def e_t1(model: Model, global_grad: dict, union: np.ndarray, *,
         mode: Optional[str] = None) -> float:
    """‖Σ_{l∉L_t} ∇_l f‖² — computed from per-layer squared norms.

    Layer subtrees are disjoint parameter blocks, so the squared norm of the
    concatenation equals the sum of per-layer squared norms.
    """
    sq = _sq_norms(model, global_grad, mode)
    return float(np.sum(sq * (1.0 - union)))


def kappa_per_layer(model: Model, global_grad: dict,
                    client_grads: Sequence[dict], *,
                    mode: Optional[str] = None) -> np.ndarray:
    """κ_l ≥ max_i ‖∇_l f − ∇_l f_i‖ (Assumption 4.3 tight estimate)."""
    worst = None
    for g_i in client_grads:
        sq = _sq_norms(model, layer_diff(model, global_grad, g_i), mode)
        worst = sq if worst is None else np.maximum(worst, sq)
    return np.sqrt(worst)


def e_t2(mask_matrix: np.ndarray, sizes: np.ndarray, kappa: np.ndarray,
         population_alpha: Optional[np.ndarray] = None,
         cohort_idx: Optional[np.ndarray] = None) -> float:
    """Σ_{l∈L_t} χ²_{w_l‖α} κ_l² (Lemma 4.6 second term).

    If ``population_alpha``/``cohort_idx`` are given, weights are embedded
    into the full population (non-sampled clients have w=0) as in the
    paper's analysis; otherwise α is taken over the cohort.  Host-side: the
    weights and χ² run on the CPU in f32.
    """
    W_cohort = aggregation_weights(mask_matrix, sizes).numpy()
    union = union_mask(mask_matrix)
    if population_alpha is not None:
        N = population_alpha.shape[0]
        W = np.zeros((N, mask_matrix.shape[1]), np.float32)
        W[cohort_idx] = W_cohort
        alpha = population_alpha
    else:
        W = W_cohort
        alpha = sizes / sizes.sum()
    chi = chi_divergence(torch.from_numpy(W), alpha).numpy()
    return float(np.sum(chi * (kappa ** 2) * union))


def theorem_4_7_rhs(f0: float, f_star: float, *, eta: float, gamma: float,
                    T: int, sigma_sq: float, e1_sum: float,
                    e2_sum: float) -> float:
    """RHS of Eq. (15) (τ=1).  Refuses (ValueError) unless C = 1 − γη > 0,
    where the reference asserts."""
    C = 1.0 - gamma * eta
    if not C > 0:
        raise ValueError("learning rate too large for the bound: "
                         f"1 - gamma*eta = {C} <= 0")
    term_opt = 2.0 / (eta * C * T) * (f0 - f_star)
    term_noise = 2.0 * gamma * eta / C * sigma_sq
    term_bias = (1.0 / (gamma * eta * C) + 2.0) * (e1_sum + e2_sum) / T
    return term_opt + term_noise + term_bias


def sigma_per_layer(model: Model, params: dict, batches: Sequence,
                    full_batch, *, mode: Optional[str] = None) -> np.ndarray:
    """σ_l estimate: max over minibatches of ‖g_l(ξ) − ∇_l f‖."""
    g_full = _loss_gradient(model, params, full_batch)
    worst = None
    for b in batches:
        sq = _sq_norms(model, layer_diff(
            model, _loss_gradient(model, params, b), g_full), mode)
        worst = sq if worst is None else np.maximum(worst, sq)
    return np.sqrt(worst)
