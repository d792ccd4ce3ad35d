"""Task protocol: the datasource seam of the federation API (counterpart of
``repro/api/task.py``; its ``DirichletTokenMixtureTask`` and ``ChaosTask``
are not ported yet, ROADMAP.md).

A *Task* is anything the round engines can federate over.  The required
surface (structural — no inheritance needed) is:

* ``sizes`` — (n_clients,) int array of per-client dataset sizes d_i;
* ``cohort_batches(cohort, batch_size, n)`` — stacked host (numpy) batches
  with leading ``(len(cohort), n)`` axes, drawn from each member's stream;
* ``test_batch(batch_size=None)`` — the held-out eval batch, the same on
  every call.

Optional plan-stage hooks (consumed by ``FLServer.plan_round``):
``available_clients(t, rng) -> ids`` (the pool the round-t cohort is drawn
from; None = everyone) and ``drop_stragglers(t, cohort, rng) -> keep_mask``
(members that fail to report this round).
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Task(Protocol):
    """Structural datasource protocol for the round engines."""

    sizes: np.ndarray

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict: ...

    def test_batch(self, batch_size: Optional[int] = None) -> dict: ...
