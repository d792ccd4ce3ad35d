"""Layer-selection probe report (§5.1) (a numpy copy of
``repro/core/strategies.py``).

Strategies themselves live in the registry (``repro_torch.api.strategy``):

* ``top``    — last R layers (near the output) [Kovaleva+19, Lee+19b]
* ``bottom`` — first R layers (near the input) [Lee+22]
* ``both``   — R/2 top + R/2 bottom [Xiao+23] (undefined for R=1, as in Table 1)
* ``snr``    — highest |mean(g)| / var(g) per layer [Mahsereci+17]
* ``rgn``    — highest ‖g_l‖ / ‖θ_l‖ (relative gradient norm) [Lee+22]
* ``full``   — all layers (the paper's performance benchmark)
* ``ours``   — solve (P1) with local gradient norms + λ consistency
  regulariser (solve_icm), the paper's proposed strategy
* ``ours_unified`` (alias ``unified``) — the λ→∞ fast path

Strategies are resolved with ``repro_torch.api.strategy.get_strategy``;
the reference's string-dispatch ``select`` shim is not ported.

Every strategy maps a :class:`ProbeReport` (what clients upload at the start
of a selection round) + per-client budgets → a (cohort, L) mask matrix.
Strategies declare ``probe_requirements`` so clients compute (and upload)
only the stats actually consumed — a report may therefore carry any subset
of the stat fields, plus optional device-computed ``scores``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np

PROBE_KEYS = ("grad_sq_norms", "param_sq_norms", "grad_means", "grad_vars")


@dataclass
class ProbeReport:
    """Per-cohort probe statistics (rows = cohort clients, cols = layers).

    All fields are optional — a requirements-trimmed probe fills only what
    the strategy asked for.  ``scores`` holds device-computed per-layer
    scores when the strategy's scoring fused into the probe program.
    """

    grad_sq_norms: Optional[np.ndarray] = None    # (n, L): ‖g_{i,l}‖²
    param_sq_norms: Optional[np.ndarray] = None   # (n, L): ‖θ_l‖² (RGN)
    grad_means: Optional[np.ndarray] = None       # (n, L): mean(g_l)  (SNR)
    grad_vars: Optional[np.ndarray] = None        # (n, L): var(g_l)   (SNR)
    scores: Optional[np.ndarray] = None           # (n, L): fused scores

    KEYS = PROBE_KEYS

    @classmethod
    def from_rows(cls, rows: "list[dict[str, np.ndarray]]") -> "ProbeReport":
        """Stack per-client stat dicts (one row per cohort member).

        Only keys present (and non-None) in *every* row are stacked — rows
        from a requirements-trimmed probe simply omit the unused stats.
        """
        names = [f.name for f in fields(cls)]
        return cls(**{k: np.stack([r[k] for r in rows]) for k in names
                      if all(r.get(k) is not None for r in rows)})

    def _shape(self) -> tuple[int, int]:
        for f in fields(self):
            v = getattr(self, f.name)
            if v is not None:
                return v.shape
        raise ValueError("empty ProbeReport: no stat field is set")

    @property
    def n(self) -> int:
        return self._shape()[0]

    @property
    def L(self) -> int:
        return self._shape()[1]

    def take(self, rows) -> "ProbeReport":
        """Row-subset view (e.g. one mixture member's cohort rows)."""
        idx = np.asarray(rows)
        return ProbeReport(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name)[idx])
            for f in fields(self)})


def _positional(n: int, L: int, budgets, mode: str) -> np.ndarray:
    budgets = np.broadcast_to(np.asarray(budgets, int), (n,))
    masks = np.zeros((n, L), np.float32)
    for i in range(n):
        R = min(int(budgets[i]), L)
        if mode == "top":
            masks[i, L - R:] = 1.0
        elif mode == "bottom":
            masks[i, :R] = 1.0
        elif mode == "both":
            lo = R // 2
            hi = R - lo
            if lo:
                masks[i, :lo] = 1.0
            masks[i, L - hi:] = 1.0
        else:
            raise ValueError(mode)
    return masks


def _score_topk(scores: np.ndarray, budgets) -> np.ndarray:
    n, L = scores.shape
    budgets = np.broadcast_to(np.asarray(budgets, int), (n,))
    masks = np.zeros((n, L), np.float32)
    for i in range(n):
        R = min(int(budgets[i]), L)
        masks[i, np.argsort(-scores[i])[:R]] = 1.0
    return masks
