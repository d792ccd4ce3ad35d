"""The numbers that decide ``correct``: a candidate's first rounds (the
program's, or the control's) against the reference's, which follows the
candidate's cohorts, batches and masks.

A trajectory is ``{"rounds": [{"cohort", "probe_ids", "G", "masks",
"losses", "eval_loss"}, ...], "change1": {key: ‖θ¹ − θ⁰‖},
"change": {key: ‖θᵀ − θ⁰‖}}`` over its T rounds, with one key per leaf
row; the reference's also carries ``"update1"`` and ``"update"``: for η·U
of round 1 and for Σ η·U over the rounds, before rounding to bf16, its
norm and how many of its elements reach half an ulp of the bf16 weight
they are added to.

* ``loss``: the widest relative gap of a client's mean local loss or of
  the eval loss, over the rounds.
* ``probe``: the widest gap of a client's ‖g_l‖², against the reference's
  of that layer or its median layer's, whichever is larger.
* ``masks``: how much iterated conditional modes on the reference's
  utilities can still gain from the candidate's masks, over the gain of
  the masks it ends at (0 where they are a fixed point; a budget broken or
  a positional mask that differs reads 1).
* ``grad1`` / ``change``: the widest gap of a leaf row's change after
  round 1 (η times the first aggregate gradient as the server applies it)
  / after the last round between the two, against the reference's change of
  that row or of the median moved row, whichever is larger.  Rows whose
  reference update is nought to rounding are left out: under a thousandth
  of the median moved row's, or reaching half an ulp of its bf16 weights
  in fewer than :data:`MIN_MOVING` elements (there the change is a few
  roundings, which a gradient 1% off flips).  Rows the reference leaves
  unmoved stay in: the candidate must not move them.
"""
from __future__ import annotations

import numpy as np

from fedbench.reference.rounds import objective, solve_icm, top_masks

MIN_MOVING = 1000


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def loss_gap(cand: list, ref: list) -> float:
    gaps = []
    for c, r in zip(cand, ref):
        gaps += [_rel(a, b) for a, b in zip(c["losses"], r["losses"])]
        gaps.append(_rel(c["eval_loss"], r["eval_loss"]))
    return max(gaps)


def probe_gap(cand: list, ref: list):
    gaps = []
    for c, r in zip(cand, ref):
        if c["G"] is None:
            continue
        Gc, Gr = np.asarray(c["G"], np.float64), np.asarray(r["G"], np.float64)
        den = np.maximum(Gr, np.median(Gr, axis=1, keepdims=True))
        gaps.append(float((np.abs(Gc - Gr) / np.maximum(den, 1e-30)).max()))
    return max(gaps) if gaps else None


def mask_gap(cand: list, ref: list, strategy: str, budget: int,
             lam: float) -> float:
    gaps = []
    for c, r in zip(cand, ref):
        M = np.asarray(c["masks"], np.float32)
        if (M.sum(1) > budget).any():
            gaps.append(1.0)
            continue
        if strategy == "top":
            gaps.append(float(not np.array_equal(
                M, top_masks(len(M), M.shape[1], budget))))
            continue
        G = np.asarray(r["G"], np.float64)
        best = solve_icm(G, budget, lam, init=M)
        gain = objective(G, best, lam) - objective(G, M, lam)
        gaps.append(max(gain, 0.0) / max(float((G * best).sum()), 1e-30))
    return max(gaps)


def change_gaps(cand: dict, ref: dict, update: dict) -> dict:
    """Each kept leaf row's gap (see the module's docstring)."""
    moved = np.array([n for n, _ in update.values() if n > 0])
    if not moved.size:
        return {k: float(v > 0) for k, v in cand.items()}
    floor = 1e-3 * float(np.median(moved))
    keep = [k for k in ref if k not in update or update[k][0] == 0
            or (update[k][0] >= floor and update[k][1] >= MIN_MOVING)]
    med = np.median([ref[k] for k in keep if ref[k] > 0] or [0.0])
    if med <= 0:
        return {k: float(cand[k] > 0) for k in keep}
    return {k: abs(cand[k] - ref[k]) / max(ref[k], med) for k in keep}


def change_gap(cand: dict, ref: dict, update: dict) -> float:
    return float(max(change_gaps(cand, ref, update).values(), default=0.0))


def readings(cand: dict, ref: dict, strategy: str, budget: int,
             lam: float) -> dict:
    out = {"loss": loss_gap(cand["rounds"], ref["rounds"]),
           "probe": probe_gap(cand["rounds"], ref["rounds"]),
           "masks": mask_gap(cand["rounds"], ref["rounds"], strategy,
                             budget, lam),
           "grad1": change_gap(cand["change1"], ref["change1"],
                               ref["update1"]),
           "change": change_gap(cand["change"], ref["change"],
                                 ref["update"])}
    return {k: v for k, v in out.items() if v is not None}
