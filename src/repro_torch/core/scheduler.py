"""Depth-k lookahead round scheduler with a background (P1) solve
(counterpart of ``repro/core/scheduler.py``).

``FLServer.run`` streams the vectorized engine through
:class:`RoundScheduler`: the host plans and samples rounds t+1..t+k while
round t's kernels are still queued on the card, the layer-selection solve
(the probe stats' copy to the host, then (P1)) runs on a single background
thread, and round t+1's probe is queued right behind round t's update, on
the updated params (``Client.probe_update_cohort_raw`` when
``selection_period == 1``, otherwise a separate probe call after the
update).  Nothing on the main thread waits for the card: batches go up
through pinned memory with ``non_blocking`` copies, probe stats and round
records come down the same way behind a recorded event
(``Client.HostCopy``), and only the solver thread (for the stats) and a
record's finalisation wait on such an event.

Parity contract (``tests/test_torch_scheduler.py``): a pure scheduling
change — cohorts and masks bit-identical to the synchronous
:meth:`FLServer.run_round` loop, params within fp tolerance, at every
depth, including under the task's availability/straggler hooks.  Three
orderings pin when work may fire, as in the reference:

* **Server rng** — ``plan_round`` consumes the server RandomState (cohort
  draw and hooks), so plans fire in round order: the prefetch queue issues
  them strictly ascending.
* **Per-client data streams** — each client's rng must see round t's draws
  (probe before update) before round t+1's; ``sample_round`` draws a whole
  round at enqueue time, so queue order keeps stream order.
* **Stats-cache reads** — with ``selection_period > 1`` a non-refresh
  ``plan_round(t+1)`` reads the per-client stats cache as select(t) left
  it, so its plan fires only once that select completed
  (:meth:`RoundScheduler._can_plan`).  Refresh rounds and probe-free
  strategies may plan the full depth ahead.

The select stage touches no rng, and only the solver thread writes the
server's stats/warm-mask caches (one solve in flight at a time), so it
runs beside host sampling without a race.  An exception on the solver
thread surfaces in :meth:`RoundScheduler.run`; nothing falls back to the
synchronous loop.

``wall_s`` in pipelined records is host time per round (select submit →
dispatch complete, the prefetch inside it included), not device latency:
the end-of-run drain is excluded, so ``sum(wall_s)`` ≤ the elapsed time.
Its two reads are of the monotonic clock (``tracing.now_ns``) and, with
``repro_torch.tracing`` on, the ``round`` span's ends; the loop also opens
``select_wait`` around its wait for the round's masks.
``verbose=True`` prints round t at the end of iteration t+1, once its
record has come down.  With faults active the guarded round step
(``FLServer._update_round_faulty``) replaces the update and round t+1's
probe is queued behind it; its fault accounting waits once a round for the
guard's ``ok`` rows and losses (the reference's sanctioned round-boundary
sync), and those host losses ride the round's pending record.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

from repro_torch import tracing
from repro_torch.core.client import HostCopy
from repro_torch.core.server import (FLServer, History, RoundRecord,
                                     SampledRound)


class RoundScheduler:
    """Depth-k streaming executor for ``FLServer``'s round stages.

    ``depth`` is how many rounds ahead of the queued round the host plans
    and samples; ``depth=1`` is the classic double buffer.  An instance
    drives one ``run`` at a time (it owns a single-worker solver thread for
    the run's duration).
    """

    def __init__(self, server: FLServer, depth: int = 1):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.server = server
        self.depth = depth
        self._queue: deque[SampledRound] = deque()   # rounds, t ascending
        self._next_plan = 0          # next round index to plan (rng order)
        self._selected_through = -1  # highest t whose select completed
        self._barrier = -1           # next unsaved checkpoint boundary
        self._late = None            # (future, t) of a deadline-missed solve

    # -- host prefetch ----------------------------------------------------
    def _next_barrier(self, after: int, T: int) -> int:
        """The first checkpoint boundary past ``after`` (T+1 = none left).
        Planning round b consumes the server rng and client streams, so no
        round at or after an unsaved boundary may be planned: a checkpoint
        written at b would capture post-b draws and break exact resume."""
        srv = self.server
        if srv.checkpoint_dir is None:
            return T + 1
        b = after + 1
        while b <= T and not srv._is_ckpt_round(b, T):
            b += 1
        return b if b <= T else T + 1

    def _can_plan(self, t: int) -> bool:
        """May ``plan_round(t)`` fire now?  Plans fire in t order (queue
        discipline); a non-refresh plan's probe_ids read the stats cache as
        select(t-1) left it, and no plan crosses an unsaved checkpoint
        boundary (:meth:`_next_barrier`)."""
        srv = self.server
        if t >= self._barrier:
            return False
        if not srv.needs_probe or t % srv.fl.selection_period == 0:
            return True
        return self._selected_through >= t - 1

    def _prefetch(self, T: int, want: int) -> None:
        """Top the queue up to ``want`` pending rounds (plan + sample)."""
        while (self._next_plan < T and len(self._queue) < want
               and self._can_plan(self._next_plan)):
            plan = self.server.plan_round(self._next_plan)
            self._queue.append(self.server.sample_round(plan))
            self._next_plan += 1

    # -- async select -----------------------------------------------------
    def _join_late(self, block: bool) -> None:
        """Join a deadline-missed solve.  The late solver thread is still
        the store's single writer; once it lands, the cache-dependent plans
        :meth:`_can_plan` held back may fire.  Called non-blocking each
        iteration, blocking before a checkpoint save (the save must capture
        a settled store) and at the end of the run (its exception, if any,
        surfaces here)."""
        if self._late is None:
            return
        fut, t_late = self._late
        if not block and not fut.done():
            return
        fut.result()
        self._selected_through = max(self._selected_through, t_late)
        self._late = None

    def _select(self, plan, stats):
        """Solver-thread body: wait for the probe stats' copy to the host
        (the pipeline's one wait on the card) and run the host selection.
        Mutates only the server's stats/warm-mask caches, whose reads by
        the main thread are gated on this select (:meth:`_can_plan`)."""
        srv = self.server
        return srv.select_round(plan, srv._stats_np(stats))

    def _probe(self, params: dict, sampled: SampledRound):
        """Queue a standalone probe and its stats' copy to the host."""
        if sampled.probe_batches is None:
            return None
        srv = self.server
        return HostCopy(srv.client.probe_cohort_raw(
            params, sampled.probe_batches, srv._probe_reqs, srv._score_fn))

    # -- the round loop ---------------------------------------------------
    def run(self, params: dict, T: int, verbose: bool, start: int = 0,
            history: Optional[History] = None) -> tuple[dict, History]:
        srv = self.server
        fl, client = srv.fl, srv.client
        reqs, score_fn = srv._probe_reqs, srv._score_fn
        fuse = srv.needs_probe and fl.selection_period == 1
        srv._ensure_layer_params(params)
        # on the card once for the whole run (the task's held-out batch is
        # the same on every call)
        test = srv._to_device(srv.data.test_batch())

        self._next_plan = start
        self._selected_through = start - 1
        self._barrier = self._next_barrier(start, T)
        prefix = list(history.records) if history is not None else []

        self._prefetch(T, self.depth)
        sampled = self._queue.popleft()              # round `start`
        stats = self._probe(params, sampled)
        pending: list = []       # raw entries; finalized lazily (verbose)
        printed = 0              # pending entries already printed (in order)
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="p1-solver")
        try:
            for t in range(start, T):
                t0 = tracing.now_ns()
                rnd = tracing.begin("round", t, t0)
                self._join_late(block=False)
                plan = sampled.plan
                # the host solve (stats copy + (P1)) overlaps the queued
                # kernels and the prefetch below
                masks_fut = pool.submit(self._select, plan, stats)
                # lookahead: sample rounds t+1..t+depth whose plans are
                # cache-free while the solver thread works
                self._prefetch(T, self.depth)
                with tracing.span("select_wait"):
                    if srv.solver_deadline_s is None:
                        masks = masks_fut.result()
                        self._selected_through = t
                    else:
                        try:
                            masks = masks_fut.result(
                                timeout=srv.solver_deadline_s)
                            self._selected_through = t
                        except FutureTimeout:
                            # degrade, don't stall: round t runs on the
                            # warm rows while the solve finishes in the
                            # background (it stays the store's single
                            # writer); cache-dependent plans wait for
                            # _join_late
                            masks = srv._fallback_rows(plan)
                            self._late = (masks_fut, t)
                # cache-dependent plans (selection_period > 1, non-refresh)
                # unblock once select(t) has landed in the stats cache
                self._prefetch(T, self.depth)

                # the mask-aware engine's prefix cut, from the solved masks
                cut = srv._cut_for(masks)
                nxt = self._queue[0] if self._queue else None
                nstats = None
                if srv._faults_active:
                    # the guarded round step (host losses), then round
                    # t+1's probe on the updated params
                    params, losses = srv._update_round_faulty(
                        params, sampled, masks)
                    if nxt is not None:
                        nstats = self._probe(params, nxt)
                elif fuse and nxt is not None and \
                        nxt.probe_batches is not None:
                    # round t+1's probe, queued right behind round t's
                    # update on the updated params
                    params, losses, raw = client.probe_update_cohort_raw(
                        params, sampled.update_batches, masks, plan.sizes,
                        fl.lr, nxt.probe_batches, reqs, score_fn, cut=cut)
                    nstats = HostCopy(raw)
                else:
                    params, losses = client.cohort_update_raw(
                        params, sampled.update_batches, masks, plan.sizes,
                        fl.lr, cut=cut)
                    if nxt is not None:
                        nstats = self._probe(params, nxt)
                loss_dev, acc_dev = client.evaluate_raw(params, test)
                vals = HostCopy({"losses": losses, "loss": loss_dev,
                                 "acc": acc_dev})
                t1 = tracing.now_ns()
                tracing.end(rnd, t1)
                pending.append((plan, masks, vals, (t1 - t0) / 1e9))
                if verbose:
                    # print up to the *previous* round, whose record has
                    # long come down: printing never waits on the round
                    # just queued
                    while printed < len(pending) - 1:
                        if not isinstance(pending[printed], RoundRecord):
                            pending[printed] = srv._finalize(pending[printed])
                        srv._print_round(pending[printed])
                        printed += 1
                if t + 1 == self._barrier:
                    # checkpoint boundary: the prefetch gate drained the
                    # queue here (no round past the boundary was planned),
                    # so params and the pending records are exactly the
                    # synchronous loop's state after round t
                    self._join_late(block=True)
                    for i in range(len(pending)):
                        if not isinstance(pending[i], RoundRecord):
                            pending[i] = srv._finalize(pending[i])
                    srv.save_state(params, t + 1,
                                   History(records=prefix + pending))
                    self._barrier = self._next_barrier(t + 1, T)
                    self._prefetch(T, self.depth)
                    if self._queue:
                        # restart the stream: the boundary round's probe
                        # runs standalone on the saved params (the same
                        # math as the queued-behind-update probe)
                        sampled = self._queue.popleft()
                        stats = self._probe(params, sampled)
                elif self._queue:
                    sampled, stats = self._queue.popleft(), nstats
            self._join_late(block=True)
        finally:
            pool.shutdown(wait=True)

        hist = History(records=prefix)
        for i, p in enumerate(pending):              # end-of-run drain
            rec = p if isinstance(p, RoundRecord) else srv._finalize(p)
            if verbose and i >= printed:
                srv._print_round(rec)
            hist.records.append(rec)
        return params, hist
