"""Solver for the paper's layer-selection problem (P1), §4.2 (a numpy copy
of ``repro/core/solver.py``; the port imports nothing of ``repro``).

    max_{m_i}  Σ_{i∈S_t} Σ_{l∈L_i^t} ‖g_{i,l}(θ^t; ξ_i^t)‖²
               − (λ/2) Σ_{i∈S_t} Σ_{j≠i} ‖m_i^t − m_j^t‖₁
    s.t.       R(m_i^t) ≤ R_i^t  ∀ i∈S_t

This is a small integer program over (|S_t| × L) binary variables that the
*server* solves each selection round (inputs are the L-vectors of gradient
norms the clients upload — L floats per client, §4.2).

Note: the paper's (P1) display renders the penalty with a squared ℓ1 norm
while the accompanying text introduces it as the plain ℓ1 regulariser
"Σ_{j≠i}‖m_i − m_j‖₁".  We implement the ℓ1 form (default), which makes the
objective layer-separable given the other clients' masks, plus the squared
variant for ablation.

Solvers:

* :func:`solve_icm` — iterated conditional modes (block coordinate ascent):
  per client, the conditional objective is separable per layer, so the
  conditional argmax under a knapsack budget is a greedy top-k by utility
  density.  Monotone in the objective ⇒ converges to a fixed point.
* :func:`solve_unified` — the λ→∞ limit: one global ranking by
  Σ_i ‖g_{i,l}‖², each client takes its top-R_i prefix (all clients agree
  on ordering ⇒ maximal overlap, χ divergence minimised for equal budgets).
"""
from __future__ import annotations

import numpy as np


def _pick_topk_budget(util: np.ndarray, costs: np.ndarray, budget: float) -> np.ndarray:
    """Greedy knapsack: pick layers by utility density until budget exhausted.

    The constraint R(m_i) ≤ R_i is hard: when the budget does not admit even
    the cheapest layer the result is the *empty* mask — the client sits the
    round out (its delta is zero and Eq. 7 gives it zero aggregation weight)
    rather than silently training a layer it cannot afford.  (The previous
    fallback forced ``argmin(costs)`` regardless of cost, violating the
    budget.)  With any affordable layer the greedy scan always selects at
    least one, so masks stay non-empty whenever the budget admits one.
    """
    m = np.zeros(util.shape[0], dtype=np.float32)
    density = util / np.maximum(costs, 1e-12)
    order = np.argsort(-density)
    spent = 0.0
    for l in order:
        if util[l] <= 0 and spent > 0:
            break   # never select negative-utility layers beyond the first
        if spent + costs[l] <= budget + 1e-9:
            m[l] = 1.0
            spent += costs[l]
    return m


def greedy_rows(G: np.ndarray, budgets, *,
                costs: np.ndarray | None = None) -> np.ndarray:
    """Per-row greedy-knapsack masks — the ICM solver's cold-start init,
    exposed so the round engines can greedily fill *unseen* members of a
    warm-start matrix instead of discarding the whole cohort's warm rows
    (FLServer._warm_init).  Budget-exact per row (:func:`_pick_topk_budget`).
    """
    n, L = G.shape
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    costs = np.ones(L) if costs is None else np.asarray(costs, np.float64)
    return np.stack([_pick_topk_budget(G[i], costs, budgets[i])
                     for i in range(n)])


def objective(G: np.ndarray, masks: np.ndarray, lam: float,
              penalty: str = "l1") -> float:
    """The (P1) objective value for a candidate mask matrix."""
    gain = float(np.sum(G * masks))
    diff = np.abs(masks[:, None, :] - masks[None, :, :]).sum(-1)   # (n,n) ℓ1
    if penalty == "l1_sq":
        diff = diff ** 2
    pen = 0.5 * lam * (diff.sum() - np.trace(diff))
    return gain - pen


def solve_icm(G: np.ndarray, budgets, lam: float, *,
              costs: np.ndarray | None = None, penalty: str = "l1",
              max_iters: int = 50, init: np.ndarray | None = None):
    """Block coordinate ascent on (P1).

    G: (n, L) per-client per-layer squared gradient norms.
    budgets: scalar or (n,) — R_i, in units of ``costs`` (default: #layers).
    init: optional (n, L) warm-start mask matrix (e.g. the previous selection
    round's converged masks, keyed by client id — the round engines pass it
    via ``SelectionContext.init``).  A warm start that is already a fixed
    point of the conditional updates converges in one sweep, so solver
    iterations shrink as training stabilises.  Every returned row comes from
    :func:`_pick_topk_budget`, so the budget constraint holds regardless of
    the init.
    Returns (masks (n,L) float32, objective value, n_iters).
    """
    n, L = G.shape
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    costs = np.ones(L) if costs is None else np.asarray(costs, np.float64)
    if init is not None and init.shape != (n, L):
        raise ValueError(f"init shape {init.shape} != {(n, L)}")
    masks = init.copy().astype(np.float32) if init is not None else \
        greedy_rows(G, budgets, costs=costs)

    for it in range(max_iters):
        changed = False
        for i in range(n):
            others = masks.sum(0) - masks[i]                  # Σ_{j≠i} m_j(l)
            if penalty == "l1":
                # ∂pen/∂m_i(l) = λ Σ_{j≠i} (1 − 2 m_j(l))
                util = G[i] - lam * ((n - 1) - 2.0 * others)
            else:  # l1_sq: linearise around current disagreement (heuristic)
                disagree = np.abs(masks[i][None, :] - masks).sum(-1)  # (n,)
                util = G[i] - lam * ((n - 1) - 2.0 * others) * (1.0 + disagree.mean())
            new = _pick_topk_budget(util, costs, budgets[i])
            if not np.array_equal(new, masks[i]):
                masks[i] = new
                changed = True
        if not changed:
            return masks, objective(G, masks, lam, penalty), it + 1
    return masks, objective(G, masks, lam, penalty), max_iters


def solve_unified(G: np.ndarray, budgets, *, costs: np.ndarray | None = None):
    """λ→∞: shared ranking by aggregate gradient norm; per-client prefix.

    The prefix scan only takes layers that fit the remaining budget, so
    R(m_i) ≤ R_i holds for every client; a budget that admits no layer at
    all yields the empty row (same contract as :func:`_pick_topk_budget`).
    """
    n, L = G.shape
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    costs = np.ones(L) if costs is None else np.asarray(costs, np.float64)
    total = G.sum(0)
    order = np.argsort(-total / np.maximum(costs, 1e-12))
    masks = np.zeros((n, L), np.float32)
    for i in range(n):
        spent = 0.0
        for l in order:
            if spent + costs[l] <= budgets[i] + 1e-9:
                masks[i, l] = 1.0
                spent += costs[l]
    return masks


# Named solver lookup, so host strategies (repro.api.strategy) can be
# parameterised by solver without hard-wiring callables.
SOLVERS = {"icm": solve_icm, "unified": solve_unified}


def get_solver(name: str):
    """Resolve a (P1) solver by name ('icm' | 'unified')."""
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(f"unknown (P1) solver {name!r} "
                         f"(available: {', '.join(sorted(SOLVERS))})") from None
