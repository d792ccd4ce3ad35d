"""The FL server: Algorithm 1, selective layer fine-tuning in FL
(counterpart of ``repro/core/server.py``).

A round is composed of explicit stages:

    plan → sample → probe → select → update → eval

:meth:`FLServer.run_round` executes them synchronously; the default
:meth:`FLServer.run` path for the vectorized engine streams them instead
(``pipeline=True``) through :class:`repro_torch.core.scheduler.RoundScheduler`,
a depth-k lookahead (``pipeline_depth``, default 1): rounds t+1..t+k are
planned and sampled on the host while round t's kernels run, the (P1)
solve runs on a background thread, and round t+1's probe is queued right
behind round t's update on the updated params.  Plan, sample and select are
numpy on the host and byte-identical to the reference (same rng streams,
same (P1) solver); probe, update and eval run on the model's device.
Sampled batches reach the card through pinned memory with ``non_blocking``
copies, so sampling ahead never waits for queued kernels.

Two round engines (``FLServer(..., engine=...)``):

* ``"vectorized"`` (default) — one cohort-wide update call per round with
  the Eq.(5)-(7) aggregation inside it (``Client.cohort_update``), and with
  the mask-aware cut on (``mask_aware``, the default wherever the family
  admits it): only the trainable suffix above the round's smallest
  selected layer is differentiated, and each τ step is applied by the
  ``masked_update`` kernel.
* ``"sequential"`` — the paper-literal per-client loop, kept as the parity
  oracle; it stays dense.

Selection-period caching, warm starts and the select memo follow the
reference: probe statistics are cached per client id at refresh rounds
(``t % selection_period == 0``), masks are re-derived every round from the
current cohort's stats and budgets, the (P1) solve is warm-started from
each member's previous masks (unseen members greedily filled), and an
identical (cohort, budgets, stats, init) round skips the solve.

Round-boundary checkpoints (``checkpoint_dir``, every
``checkpoint_every`` rounds and at the end of a run) hold params, the
client-state store, the server rng and the task's streams in the
reference's format (``ckpt/checkpoint.py``), so a run resumes bit-exactly
on masks (:meth:`FLServer.restore_state`, ``run(start=, history=)``), in
either package.

Fault injection and graceful degradation (``faults=FaultPlan(...)``,
DESIGN.md §12) follow the reference: client death and delta corruption
run the guarded round step (``Client.cohort_update_guarded``, the dense
program with the finite guard and survivor-reweighted Eq.(5)-(7); the
sequential engine's oracle does the same on the host), solver stalls fall
back to warm/greedy masks, injected dispatch failures retry boundedly and
re-raise once the retries are spent, and a saved checkpoint may be damaged
after the write (restore then falls back to the newest intact one).  A
disabled injector changes nothing.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.api.strategy import SelectionContext, Strategy, get_strategy
from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import masks as M
from repro_torch.core.client import Client, host_to_device
from repro_torch.core.solver import greedy_rows
from repro_torch.core.state import (ClientStateStore, rng_state_from_arrays,
                                    rng_state_to_arrays, sub_state)
from repro_torch.core.strategies import ProbeReport
from repro_torch.faults.injector import TransientFault, coerce_injector
from repro_torch.models.model import Model, supports_prefix_cut
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class RoundRecord:
    round: int
    test_loss: float
    test_acc: float
    train_loss: float
    mask_matrix: np.ndarray
    cohort: np.ndarray
    union_frac: float
    uploaded_params: int
    wall_s: float


@dataclass
class History:
    records: list[RoundRecord] = field(default_factory=list)

    @staticmethod
    def _finite(r: RoundRecord) -> bool:
        return all(math.isfinite(v)
                   for v in (r.test_loss, r.test_acc, r.train_loss))

    def summary(self) -> dict:
        """Aggregate stats over the run; rounds with a non-finite loss or
        accuracy are left out of final/best and counted instead."""
        if not self.records:
            return {"final_loss": None, "final_acc": None, "best_acc": None,
                    "rounds": 0, "uploaded_params_total": 0,
                    "nonfinite_rounds": 0}
        clean = [r for r in self.records if self._finite(r)]
        last = clean[-1] if clean else None
        return {"final_loss": last.test_loss if last else None,
                "final_acc": last.test_acc if last else None,
                "best_acc": max(r.test_acc for r in clean) if clean else None,
                "rounds": len(self.records),
                "uploaded_params_total": sum(r.uploaded_params
                                             for r in self.records),
                "nonfinite_rounds": len(self.records) - len(clean)}

    def selection_heatmap(self) -> np.ndarray:
        """(T, L) count of clients selecting each layer — Figure 2 analogue."""
        return np.stack([r.mask_matrix.sum(0) for r in self.records])

    def to_json(self) -> dict:
        """JSON-serialisable dict, the reference's layout (a checkpoint's
        manifest carries it)."""
        return {
            "summary": self.summary(),
            "records": [{
                "round": r.round, "test_loss": r.test_loss,
                "test_acc": r.test_acc, "train_loss": r.train_loss,
                "mask_matrix": np.asarray(r.mask_matrix).astype(int).tolist(),
                "cohort": np.asarray(r.cohort).astype(int).tolist(),
                "union_frac": r.union_frac,
                "uploaded_params": r.uploaded_params,
                "wall_s": r.wall_s,
            } for r in self.records]}

    @classmethod
    def from_json(cls, d: dict) -> "History":
        """Inverse of :meth:`to_json`: masks and cohorts come back in the
        engine's dtypes, so a resumed history equals an uninterrupted one."""
        hist = cls()
        for r in d["records"]:
            hist.records.append(RoundRecord(
                round=int(r["round"]), test_loss=float(r["test_loss"]),
                test_acc=float(r["test_acc"]),
                train_loss=float(r["train_loss"]),
                mask_matrix=np.asarray(r["mask_matrix"], np.float32),
                cohort=np.asarray(r["cohort"], np.int64),
                union_frac=float(r["union_frac"]),
                uploaded_params=int(r["uploaded_params"]),
                wall_s=float(r["wall_s"])))
        return hist


@dataclass
class RoundPlan:
    """Host-side round schedule: who participates and who gets probed."""
    t: int
    cohort: np.ndarray
    budgets: np.ndarray
    sizes: np.ndarray
    probe_ids: np.ndarray    # cohort members needing a fresh probe (cohort order)
    refresh: bool            # full re-probe round (t % selection_period == 0)


@dataclass
class SampledRound:
    """All host-drawn data for one round, moved to the model's device."""
    plan: RoundPlan
    update_batches: dict                    # leaves (cohort, τ, B, ...)
    probe_batches: Optional[dict]           # leaves (len(probe_ids), sel, B, ...)


ENGINES = ("vectorized", "sequential")


class FLServer:
    def __init__(self, model: Model, fl: FLConfig, data: "Task",
                 rng: Optional[np.random.RandomState] = None,
                 engine: str = "vectorized",
                 pipeline: Optional[bool] = None,
                 pipeline_depth: int = 1,
                 strategy: "Optional[Strategy | str]" = None,
                 mask_aware: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10,
                 faults: Optional[object] = None,
                 solver_deadline_s: Optional[float] = None):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if solver_deadline_s is not None and solver_deadline_s <= 0:
            raise ValueError(
                f"solver_deadline_s must be > 0, got {solver_deadline_s}")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if mask_aware and not supports_prefix_cut(model.cfg):
            raise ValueError(
                f"mask_aware=True but family {model.cfg.family!r} has no "
                f"prefix-cut path (models.model.supports_prefix_cut)")
        if mask_aware and engine != "vectorized":
            raise ValueError("mask_aware=True requires engine='vectorized' "
                             "(the sequential oracle stays dense)")
        self.model = model
        self.fl = fl
        self.data = data
        self.client = Client(model)
        self.rng = rng or np.random.RandomState(fl.seed)
        self.engine = engine
        # the streaming scheduler (vectorized engine only), pipeline_depth
        # rounds ahead; the same results as the synchronous loop
        self.pipeline = (engine == "vectorized") if pipeline is None else pipeline
        self.pipeline_depth = pipeline_depth
        self.mask_aware = (engine == "vectorized"
                           and supports_prefix_cut(model.cfg)
                           if mask_aware is None else bool(mask_aware))
        self.L = model.n_selectable
        self.layer_costs = None      # optional per-layer cost vector for (P1)
        self.strategy = get_strategy(strategy if strategy is not None
                                     else fl.strategy)
        unknown = set(self.strategy.probe_requirements) - set(ProbeReport.KEYS)
        if unknown:
            raise ValueError(
                f"strategy {self.strategy.name!r} declares unknown "
                f"probe_requirements {sorted(unknown)}; the probe computes "
                f"{ProbeReport.KEYS}")
        # the probe computes only what the strategy declared it needs
        self._probe_reqs = tuple(k for k in ProbeReport.KEYS
                                 if k in self.strategy.probe_requirements)
        # device-side scoring in the vectorized probe; the sequential
        # oracle scores the uploaded stats on the host instead
        self._score_fn = (self.strategy.device_score_fn()
                          if engine == "vectorized" else None)
        # per-client-id cross-round state: probe-stat cache, warm-start
        # mask rows and last-seen rounds, O(cohort) per round
        self.state = ClientStateStore(fl.n_clients, self.L)
        self._layer_params: Optional[np.ndarray] = None
        # (inputs-key, masks) of the last host solve: an identical round
        # skips the solve (byte-compared inputs, deterministic solver)
        self._select_memo: Optional[tuple] = None
        # the reference's counter set, so a checkpoint's manifest means
        # the same in both packages
        self.select_stats = {"solves": 0, "memo_hits": 0,
                             "partial_warm_starts": 0,
                             "all_straggler_rounds": 0,
                             "quarantined_rows": 0, "dead_clients": 0,
                             "solver_timeouts": 0, "dispatch_retries": 0,
                             "ckpt_fallbacks": 0}
        self._straggler_warned = False
        # fault injection (None = no injector); a wired but disabled
        # injector never touches the round path
        self._injector = coerce_injector(faults)
        # a real wall-clock deadline on the scheduler's background (P1)
        # solve (None = wait for it)
        self.solver_deadline_s = solver_deadline_s
        # round-boundary checkpointing (None = off): every checkpoint_every
        # completed rounds and at the end of run()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every

    @property
    def needs_probe(self) -> bool:
        return bool(self._probe_reqs)

    def _to_device(self, batch: dict) -> dict:
        return {k: host_to_device(v, self.model.device)
                for k, v in batch.items()}

    # -- fault machinery (DESIGN.md §12) ---------------------------------
    @property
    def _faults_active(self) -> bool:
        return self._injector is not None and self._injector.enabled

    def _dispatch(self, t: int, fn, *args):
        """Run a round step with bounded retry and backoff over injected
        :class:`TransientFault` only; any other exception propagates.  Once
        ``max_dispatch_retries`` retries are spent the fault re-raises: a
        dispatch that keeps failing ends the run."""
        if not self._faults_active:
            return fn(*args)
        plan = self._injector.plan
        attempt = 0
        while True:
            try:
                self._injector.maybe_fail_dispatch(t, attempt)
                return fn(*args)
            except TransientFault:
                attempt += 1
                self.select_stats["dispatch_retries"] += 1
                if attempt > plan.max_dispatch_retries:
                    raise
                if plan.retry_backoff_s > 0:
                    time.sleep(plan.retry_backoff_s * (2 ** (attempt - 1)))

    # -- stage 1: plan ---------------------------------------------------
    def _budgets(self, cohort: np.ndarray) -> np.ndarray:
        return np.array([self.fl.budget_of(int(i)) for i in cohort])

    def _plan_for(self, cohort: np.ndarray, t: int) -> RoundPlan:
        fl = self.fl
        needs_probe = self.needs_probe
        refresh = needs_probe and t % fl.selection_period == 0
        if refresh:
            probe_ids = np.asarray(cohort)
        elif needs_probe:
            probe_ids = self.state.missing_stats(np.asarray(cohort))
        else:
            probe_ids = np.zeros((0,), np.int64)
        return RoundPlan(t=t, cohort=cohort, budgets=self._budgets(cohort),
                         sizes=self.data.sizes[cohort], probe_ids=probe_ids,
                         refresh=refresh)

    def plan_round(self, t: int) -> RoundPlan:
        """Draw the round-t cohort, honouring the task's plan-stage hooks
        (``available_clients``, ``drop_stragglers``); a task without hooks
        consumes the server rng exactly as the reference does."""
        avail = getattr(self.data, "available_clients", None)
        pool = avail(t, self.rng) if callable(avail) else None
        if pool is None:                 # full availability
            cohort = self.rng.choice(self.fl.n_clients,
                                     size=self.fl.cohort_size, replace=False)
        else:
            pool = np.asarray(pool)
            if pool.size == 0:
                raise ValueError(
                    f"available_clients returned an empty pool for round "
                    f"{t}: no cohort can be drawn (the task's availability "
                    f"hook must return at least one client id, or None for "
                    f"full availability)")
            k = min(self.fl.cohort_size, len(pool))
            cohort = pool[self.rng.choice(len(pool), size=k, replace=False)]
        drop = getattr(self.data, "drop_stragglers", None)
        if callable(drop):
            keep = np.asarray(drop(t, cohort, self.rng), bool)
            if keep.shape != cohort.shape:
                raise ValueError(
                    f"drop_stragglers returned keep-mask of shape "
                    f"{keep.shape} for a round-{t} cohort of shape "
                    f"{cohort.shape}")
            if keep.any():               # never drop the whole cohort
                cohort = cohort[keep]
            else:
                self.select_stats["all_straggler_rounds"] += 1
                if not self._straggler_warned:
                    warnings.warn(
                        f"round {t}: drop_stragglers marked the entire "
                        f"cohort; running it in full instead (counted in "
                        f"select_stats['all_straggler_rounds']; warning "
                        f"once per server)", stacklevel=2)
                    self._straggler_warned = True
        return self._plan_for(cohort, t)

    # -- stage 2: sample (host) ------------------------------------------
    def sample_round(self, plan: RoundPlan) -> SampledRound:
        """Draw all of this round's data (per-client stream order: probe
        batches first, then update batches) and move it to the device."""
        fl = self.fl
        probe_b = (self.data.cohort_batches(plan.probe_ids, fl.batch_size,
                                            fl.selection_batches)
                   if len(plan.probe_ids) else None)
        update_b = self.data.cohort_batches(plan.cohort, fl.batch_size,
                                            fl.local_steps)
        return SampledRound(
            plan=plan, update_batches=self._to_device(update_b),
            probe_batches=None if probe_b is None
            else self._to_device(probe_b))

    # -- stage 3: probe (device) -----------------------------------------
    def probe_round(self, params: dict,
                    sampled: SampledRound) -> Optional[dict[str, np.ndarray]]:
        """Stat rows for ``plan.probe_ids`` (engine-specific compute)."""
        if sampled.probe_batches is None:
            return None
        if self.engine == "vectorized":
            return self.client.probe_cohort(params, sampled.probe_batches,
                                            self._probe_reqs, self._score_fn)
        nb = self.fl.selection_batches
        rows: list[dict[str, np.ndarray]] = []
        for r in range(len(sampled.plan.probe_ids)):
            acc = None
            for b in range(nb):
                batch = {k: v[r, b] for k, v in sampled.probe_batches.items()}
                out = self.client.probe(params, batch, self._probe_reqs)
                acc = out if acc is None else {k: acc[k] + out[k] for k in out}
            rows.append({k: v / nb for k, v in acc.items()})
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    # -- stage 4: select (host) ------------------------------------------
    def _warm_init(self, cohort: np.ndarray, probe: ProbeReport,
                   budgets: np.ndarray) -> Optional[np.ndarray]:
        """Warm-start rows for an iterative host solve: the cohort's
        previous masks, unseen members greedily filled from this round's
        utilities (``select_stats["partial_warm_starts"]``)."""
        if not self.strategy.host or not self.state.has_warm:
            return None
        rows, valid = self.state.warm_rows(cohort)
        if not valid.all():
            if probe.grad_sq_norms is None:
                return None      # no utilities to greedy-fill from
            G = np.asarray(probe.grad_sq_norms)
            budgets = np.broadcast_to(np.asarray(budgets), (len(rows),))
            missing = np.flatnonzero(~valid)
            rows[missing] = greedy_rows(G[missing], budgets[missing],
                                        costs=self.layer_costs)
            self.select_stats["partial_warm_starts"] += 1
        return rows

    def _memo_key(self, plan: RoundPlan, probe: ProbeReport,
                  init: Optional[np.ndarray]) -> tuple:
        """Exact-inputs key for the host-solve memo: cohort ids, budgets, λ,
        layer costs, every present probe stat and the warm-start rows,
        byte-compared."""
        stat_bytes = tuple(
            (k, v.tobytes()) for k, v in (
                (k, getattr(probe, k)) for k in (*ProbeReport.KEYS, "scores"))
            if v is not None)
        costs = (None if self.layer_costs is None
                 else np.asarray(self.layer_costs, np.float64).tobytes())
        return (np.asarray(plan.cohort, np.int64).tobytes(),
                np.asarray(plan.budgets, np.float64).tobytes(),
                float(self.fl.lam), costs, stat_bytes,
                None if init is None else init.astype(np.float32).tobytes())

    def select_round(self, plan: RoundPlan,
                     stats: Optional[dict[str, np.ndarray]]) -> np.ndarray:
        """Derive the round's (cohort, L) masks on the host: warm-started
        and memoized for host strategies, as in the reference."""
        fl = self.fl
        if plan.refresh:
            self.state.clear_stats()     # generation bump: O(1), any n
        if stats is not None:
            self.state.set_stat_rows(plan.probe_ids, stats)
        if self.needs_probe:
            probe = ProbeReport(**self.state.stat_rows(plan.cohort))
        else:
            probe = ProbeReport(grad_sq_norms=np.zeros((len(plan.cohort),
                                                        self.L), np.float32))
        ctx = SelectionContext(client_ids=np.asarray(plan.cohort),
                               round=plan.t, lam=fl.lam,
                               costs=self.layer_costs, n_layers=self.L,
                               init=self._warm_init(plan.cohort, probe,
                                                    plan.budgets))
        if not self.strategy.host:
            return self.strategy.select(probe, plan.budgets, ctx)
        if self._faults_active and self._injector.solver_stalls(plan.t):
            # injected stall: the (P1) solve missed its deadline — degrade
            # to warm/greedy masks instead of waiting
            return self._select_fallback(plan, probe)
        memoizable = getattr(self.strategy, "memoizable_select", False)
        key = self._memo_key(plan, probe, ctx.init) if memoizable else None
        if memoizable and self._select_memo is not None \
                and self._select_memo[0] == key:
            self.select_stats["memo_hits"] += 1
            masks = self._select_memo[1].copy()
        else:
            with tracing.span("solve", t=plan.t):
                masks = self.strategy.select(probe, plan.budgets, ctx)
            self.select_stats["solves"] += 1
            if memoizable:
                self._select_memo = (key, masks.copy())
        self.state.set_warm_rows(plan.cohort, masks, t=plan.t)
        return masks

    def _select_fallback(self, plan: RoundPlan,
                         probe: Optional[ProbeReport]) -> np.ndarray:
        """Masks for an injected solver stall: each member's warm row where
        one exists, a greedy solve on this round's utilities for unseen
        members, zeros (a forward-only row) when neither is there.  The
        memo is cleared (fallback masks are no solve output) and the rows
        become the next round's warm start, as solved masks do."""
        self.select_stats["solver_timeouts"] += 1
        rows, valid = self.state.warm_rows(plan.cohort)
        if not valid.all() and probe is not None \
                and probe.grad_sq_norms is not None:
            G = np.asarray(probe.grad_sq_norms)
            budgets = np.broadcast_to(np.asarray(plan.budgets), (len(rows),))
            missing = np.flatnonzero(~valid)
            rows[missing] = greedy_rows(G[missing], budgets[missing],
                                        costs=self.layer_costs)
        self._select_memo = None
        self.state.set_warm_rows(plan.cohort, rows, t=plan.t)
        return rows

    def _fallback_rows(self, plan: RoundPlan) -> np.ndarray:
        """Masks for a round whose (P1) solve missed ``solver_deadline_s``:
        warm rows where valid, zeros elsewhere.  Touches no store or memo
        state: the late solve is still running on the solver thread and
        stays the single writer."""
        self.select_stats["solver_timeouts"] += 1
        rows, _ = self.state.warm_rows(plan.cohort)
        return rows

    # -- stage 5: update (device) ----------------------------------------
    def _cut_for(self, masks: np.ndarray) -> Optional[int]:
        """The round's prefix cut for the mask-aware engine (None = the
        dense program), computed on the host from the selected masks."""
        return M.first_trainable_layer(masks) if self.mask_aware else None

    def update_round(self, params: dict, sampled: SampledRound,
                     masks: np.ndarray) -> tuple[dict, np.ndarray]:
        fl, plan = self.fl, sampled.plan
        if self._faults_active:
            return self._update_round_faulty(params, sampled, masks)
        if self.engine == "vectorized":
            return self.client.cohort_update(params, sampled.update_batches,
                                             masks, plan.sizes, fl.lr,
                                             cut=self._cut_for(masks))
        deltas, losses = self._local_updates(params, sampled, masks)
        update = agg.aggregate(deltas, masks, plan.sizes, self.model.cfg)
        return agg.apply_update(params, update, fl.lr), np.asarray(losses)

    def _local_updates(self, params: dict, sampled: SampledRound,
                       masks: np.ndarray) -> tuple[list, list]:
        """The sequential engine's per-client τ steps: full Δ trees and
        mean losses, in cohort order."""
        deltas, losses = [], []
        for row in range(len(sampled.plan.cohort)):
            batches = {k: v[row] for k, v in sampled.update_batches.items()}
            delta, loss = self.client.local_update(params, batches,
                                                   masks[row], self.fl.lr)
            deltas.append(delta)
            losses.append(loss)
        return deltas, losses

    # -- stage 5, fault path (DESIGN.md §12) ------------------------------
    def _update_round_faulty(self, params: dict, sampled: SampledRound,
                             masks: np.ndarray) -> tuple[dict, np.ndarray]:
        """The round step with the injector live: client death (survivor-
        reweighted Eq.(7)), injected delta corruption and the finite guard
        that quarantines poisoned rows before they reach the params.  The
        vectorized engine runs ``Client.cohort_update_guarded``; the
        sequential engine runs the host oracle.  The returned losses cover
        the rows that aggregated (``[nan]`` when none did, so the record
        shows the poisoned round)."""
        fl, plan = self.fl, sampled.plan
        fp = self._injector.plan
        survivors, codes = self._injector.round_faults(plan.t,
                                                       len(plan.cohort))
        if self.engine == "vectorized":
            params, losses, ok = self._dispatch(
                plan.t, self.client.cohort_update_guarded, params,
                sampled.update_batches, masks, plan.sizes, fl.lr,
                survivors, codes, fp.explode_scale, fp.max_delta_sq)
        else:
            params, losses, ok = self._dispatch(
                plan.t, self._sequential_guarded, params, sampled, masks,
                survivors, codes)
        self._account_faults(survivors, ok)
        kept = np.asarray(losses)[np.asarray(ok) > 0]
        return params, (kept if kept.size
                        else np.asarray([np.nan], np.float32))

    def _sequential_guarded(self, params: dict, sampled: SampledRound,
                            masks: np.ndarray, survivors: np.ndarray,
                            codes: np.ndarray
                            ) -> tuple[dict, np.ndarray, np.ndarray]:
        """The fault path's sequential oracle: per-client updates, the
        corruption and the finite guard on the host, then Eq.(5)-(7) over
        exactly the surviving finite rows."""
        fl, plan = self.fl, sampled.plan
        fp = self._injector.plan
        deltas, losses = self._local_updates(params, sampled, masks)
        ok = np.asarray(survivors, np.float32).copy()
        for i, code in enumerate(np.asarray(codes, np.int32).tolist()):
            if code:
                deltas[i] = self._corrupt_host(deltas[i], code,
                                               fp.explode_scale)
            finite, sq = True, np.float32(0.0)
            for leaf in tree_leaves(deltas[i]):
                # repro: allow[host-sync] -- the sequential oracle is host-side by definition
                a = leaf.detach().float().cpu().numpy().ravel()
                finite = finite and bool(np.isfinite(a).all())
                sq = np.float32(sq + a.dot(a))
            if not finite or not sq <= fp.max_delta_sq:
                ok[i] = 0.0
        idx = np.flatnonzero(ok > 0)
        if idx.size:                     # all quarantined: θ unchanged
            update = agg.aggregate([deltas[i] for i in idx],
                                   np.asarray(masks)[idx], plan.sizes[idx],
                                   self.model.cfg)
            params = agg.apply_update(params, update, fl.lr)
        return params, np.asarray(losses), ok

    @staticmethod
    def _corrupt_host(delta: dict, code: int, scale: float) -> dict:
        """One client's Δ tree under corruption ``code`` (the sequential
        oracle's twin of ``aggregation.corrupt_delta_rows``)."""
        if code == 3:
            return tree_map(lambda x: x.float() * torch.tensor(
                scale, dtype=torch.float32, device=x.device), delta)
        fill = math.nan if code == 1 else math.inf
        return tree_map(lambda x: torch.full_like(x, fill,
                                                  dtype=torch.float32),
                        delta)

    def _account_faults(self, survivors: np.ndarray, ok: np.ndarray) -> None:
        survivors = np.asarray(survivors)
        ok = np.asarray(ok)  # repro: allow[host-sync] -- fault accounting at the round boundary (sanctioned sync)
        self.select_stats["dead_clients"] += int((survivors <= 0).sum())
        self.select_stats["quarantined_rows"] += int(
            ((ok <= 0) & (survivors > 0)).sum())

    # -- stage 6: eval + record ------------------------------------------
    def _ensure_layer_params(self, params: dict) -> None:
        """Shape-only per-layer param counts; computed once, params not kept."""
        if self._layer_params is None:
            self._layer_params = M.count_layer_params(params, self.model.cfg)

    def _make_record(self, plan: RoundPlan, masks: np.ndarray,
                     train_loss: float, test_loss: float, test_acc: float,
                     wall_s: float) -> RoundRecord:
        # repro: allow[host-sync] -- round-boundary record finalisation on host np masks
        uploaded = int(sum(int(masks[r] @ self._layer_params)
                           for r in range(len(plan.cohort))))
        return RoundRecord(
            round=plan.t, test_loss=test_loss, test_acc=test_acc,
            train_loss=train_loss, mask_matrix=masks, cohort=plan.cohort,
            union_frac=float(M.union_mask(masks).mean()),  # repro: allow[host-sync] -- host np mask matrix, no device value
            uploaded_params=uploaded, wall_s=wall_s)

    # ------------------------------------------------------------------
    def run_round(self, params: dict, t: int) -> tuple[dict, RoundRecord]:
        """One synchronous round: plan → sample → probe → select → update →
        eval."""
        t0 = tracing.now_ns()
        plan = self.plan_round(t)
        sampled = self.sample_round(plan)
        stats = self.probe_round(params, sampled)
        masks = self.select_round(plan, stats)
        self._ensure_layer_params(params)
        params, losses = self.update_round(params, sampled, masks)
        test_loss, test_acc = self.client.evaluate(
            params, self._to_device(self.data.test_batch()))
        rec = self._make_record(plan, masks, float(np.mean(losses)),
                                test_loss, test_acc,
                                (tracing.now_ns() - t0) / 1e9)
        return params, rec

    # -- round-boundary checkpointing ------------------------------------
    def _is_ckpt_round(self, t_next: int, T: int) -> bool:
        """Save once ``t_next`` rounds have completed?  Every
        ``checkpoint_every`` rounds and at the end of the run."""
        if self.checkpoint_dir is None:
            return False
        return t_next % self.checkpoint_every == 0 or t_next == T

    def save_state(self, params: dict, t_next: int, history: History) -> str:
        """Checkpoint the resumable state after ``t_next`` completed rounds:
        params, the client-state store, the server rng and (when the task
        has ``state_dict``) the task's streams as one tree; History and
        select_stats ride the manifest."""
        from repro_torch.ckpt import save_checkpoint
        tree = {"params": params,
                "client": self.state.state_dict(),
                "server_rng": rng_state_to_arrays(self.rng)}
        task_sd = getattr(self.data, "state_dict", None)
        if callable(task_sd):
            tree["task"] = task_sd()
        extra = {"round": t_next, "history": history.to_json(),
                 "select_stats": dict(self.select_stats)}
        path = save_checkpoint(self.checkpoint_dir, t_next, tree, extra=extra)
        if self._faults_active:          # media damage after the save
            self._injector.maybe_corrupt_checkpoint(path, t_next)
        return path

    def restore_state(self, params_template: dict,
                      step: Optional[int] = None
                      ) -> Optional[tuple[dict, int, History]]:
        """Restore the latest (or ``step``) checkpoint into this server.

        Returns ``(params, completed_rounds, history)``, or None when the
        checkpoint dir is unset or holds nothing intact.  Params restore
        against the template (shape-checked, its dtypes and device); the
        store, rng and task restore byte-exact, so ``run(params,
        start=completed_rounds, history=history)`` continues with the
        uninterrupted run's masks.  With no ``step``, checkpoints are
        verified newest first and the latest intact one is taken; a
        fallback past a corrupt one warns and counts in
        ``select_stats["ckpt_fallbacks"]``."""
        from repro_torch.ckpt import latest_intact_step, load_checkpoint_arrays
        from repro_torch.ckpt.checkpoint import restore_tree
        if self.checkpoint_dir is None:
            return None
        fell_back = False
        if step is None:
            step, skipped = latest_intact_step(self.checkpoint_dir)
            if skipped:
                fell_back = True
                detail = "; ".join(f"step {s}: {why}" for s, why in skipped)
                warnings.warn(
                    f"skipping corrupt checkpoint(s) [{detail}]; resuming "
                    f"from {'step %d' % step if step is not None else 'scratch'}",
                    RuntimeWarning, stacklevel=2)
        if step is None:
            return None
        flat, manifest = load_checkpoint_arrays(self.checkpoint_dir, step)
        restored, _, _ = restore_tree(flat, manifest,
                                      {"params": params_template},
                                      source=self.checkpoint_dir)
        self.state.load_state_dict(sub_state(flat, "client/"))
        rng_state_from_arrays(sub_state(flat, "server_rng/"), self.rng)
        task_state = sub_state(flat, "task/")
        task_ld = getattr(self.data, "load_state_dict", None)
        if task_state and callable(task_ld):
            task_ld(task_state)
        self._select_memo = None         # a hit needs byte-equal inputs
        extra = manifest["extra"]
        self.select_stats.update(extra.get("select_stats", {}))
        if fell_back:                    # after the update, which would
            self.select_stats["ckpt_fallbacks"] += 1   # overwrite it
        return (restored["params"], int(extra["round"]),
                History.from_json(extra["history"]))

    def run(self, params: dict, rounds: Optional[int] = None,
            verbose: bool = False, *, start: int = 0,
            history: Optional[History] = None) -> tuple[dict, History]:
        """Run rounds ``start..rounds-1`` (``start``/``history`` come from
        :meth:`restore_state` on resume), checkpointing at boundaries when
        ``checkpoint_dir`` is set.  The vectorized engine streams through
        :class:`~repro_torch.core.scheduler.RoundScheduler` unless
        ``pipeline=False``."""
        T = rounds if rounds is not None else self.fl.rounds
        if self.engine == "vectorized" and self.pipeline and T > start:
            from repro_torch.core.scheduler import RoundScheduler
            return RoundScheduler(self, depth=self.pipeline_depth).run(
                params, T, verbose, start=start, history=history)
        hist = history if history is not None else History()
        for t in range(start, T):
            params, rec = self.run_round(params, t)
            hist.records.append(rec)
            if verbose:
                self._print_round(rec)
            if self._is_ckpt_round(t + 1, T):
                self.save_state(params, t + 1, hist)
        return params, hist

    # -- streaming pipeline (repro_torch.core.scheduler.RoundScheduler) ----
    @staticmethod
    def _stats_np(stats) -> Optional[dict[str, np.ndarray]]:
        """Materialise a probe result on its way to the host (a
        :class:`~repro_torch.core.client.HostCopy`, or None): waits for its
        copy only, not for the kernels queued behind it."""
        return None if stats is None else stats.to_numpy()

    def _finalize(self, entry: tuple) -> RoundRecord:
        """A pipelined round's record from its pending entry (plan, masks,
        the HostCopy of losses / test loss / test acc, wall_s)."""
        plan, masks, vals, wall_s = entry
        v = vals.to_numpy()
        # repro: allow[host-sync] -- the round boundary: host numpy already copied off the card
        return self._make_record(plan, masks, float(np.mean(v["losses"])),
                                 float(v["loss"]), float(v["acc"]), wall_s)  # repro: allow[host-sync] -- host numpy scalars

    @staticmethod
    def _print_round(rec: RoundRecord) -> None:
        print(f"[round {rec.round:3d}] test_loss={rec.test_loss:.4f} "
              f"acc={rec.test_acc:.4f} union={rec.union_frac:.2f} "
              f"({rec.wall_s:.2f}s)")
