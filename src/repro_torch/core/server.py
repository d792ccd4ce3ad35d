"""The FL server: Algorithm 1, selective layer fine-tuning in FL
(counterpart of ``repro/core/server.py``).

A round is composed of explicit stages:

    plan → sample → probe → select → update → eval

:meth:`FLServer.run_round` executes them synchronously, and
:meth:`FLServer.run` loops over rounds.  Plan, sample and select are numpy
on the host and byte-identical to the reference (same rng streams, same
(P1) solver); probe, update and eval run on the model's device.

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

Not ported yet (ROADMAP.md, 'Slice 5'): the streaming ``RoundScheduler``
that ``run`` uses by default for the vectorized engine (``pipeline=True``
raises; pass ``pipeline=False``), round-boundary checkpoints
(``checkpoint_dir``) and fault injection (``faults``).
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.api.strategy import SelectionContext, Strategy, get_strategy
from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import masks as M
from repro_torch.core.client import Client
from repro_torch.core.solver import greedy_rows
from repro_torch.core.state import ClientStateStore
from repro_torch.core.strategies import ProbeReport
from repro_torch.models.model import Model, supports_prefix_cut

_NOT_PORTED = "is not ported yet (ROADMAP.md, 'Slice 5', item {})"


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
                 strategy: "Optional[Strategy | str]" = None,
                 mask_aware: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 faults: Optional[object] = None):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "round-boundary checkpoints " + _NOT_PORTED.format(4))
        if faults is not None:
            raise NotImplementedError(
                "fault injection " + _NOT_PORTED.format(5))
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
        # the reference streams the vectorized engine through its round
        # scheduler by default; run() raises while that is not ported
        self.pipeline = (engine == "vectorized") if pipeline is None else pipeline
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
        self.select_stats = {"solves": 0, "memo_hits": 0,
                             "partial_warm_starts": 0,
                             "all_straggler_rounds": 0}
        self._straggler_warned = False

    @property
    def needs_probe(self) -> bool:
        return bool(self._probe_reqs)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.model.device)
                for k, v in batch.items()}

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
        memoizable = getattr(self.strategy, "memoizable_select", False)
        key = self._memo_key(plan, probe, ctx.init) if memoizable else None
        if memoizable and self._select_memo is not None \
                and self._select_memo[0] == key:
            self.select_stats["memo_hits"] += 1
            masks = self._select_memo[1].copy()
        else:
            masks = self.strategy.select(probe, plan.budgets, ctx)
            self.select_stats["solves"] += 1
            if memoizable:
                self._select_memo = (key, masks.copy())
        self.state.set_warm_rows(plan.cohort, masks, t=plan.t)
        return masks

    # -- stage 5: update (device) ----------------------------------------
    def _cut_for(self, masks: np.ndarray) -> Optional[int]:
        """The round's prefix cut for the mask-aware engine (None = the
        dense program), computed on the host from the selected masks."""
        return M.first_trainable_layer(masks) if self.mask_aware else None

    def update_round(self, params: dict, sampled: SampledRound,
                     masks: np.ndarray) -> tuple[dict, np.ndarray]:
        fl, plan = self.fl, sampled.plan
        if self.engine == "vectorized":
            return self.client.cohort_update(params, sampled.update_batches,
                                             masks, plan.sizes, fl.lr,
                                             cut=self._cut_for(masks))
        deltas, losses = [], []
        for row in range(len(plan.cohort)):
            batches = {k: v[row] for k, v in sampled.update_batches.items()}
            delta, loss = self.client.local_update(params, batches,
                                                   masks[row], fl.lr)
            deltas.append(delta)
            losses.append(loss)
        update = agg.aggregate(deltas, masks, plan.sizes, self.model.cfg)
        return agg.apply_update(params, update, fl.lr), np.asarray(losses)

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
        t0 = time.time()  # repro: allow[nondeterminism] -- wall_s telemetry only, never an input to round math
        plan = self.plan_round(t)
        sampled = self.sample_round(plan)
        stats = self.probe_round(params, sampled)
        masks = self.select_round(plan, stats)
        self._ensure_layer_params(params)
        params, losses = self.update_round(params, sampled, masks)
        test_loss, test_acc = self.client.evaluate(
            params, self._to_device(self.data.test_batch()))
        rec = self._make_record(plan, masks, float(np.mean(losses)),
                                test_loss, test_acc, time.time() - t0)  # repro: allow[nondeterminism] -- wall_s telemetry only
        return params, rec

    def run(self, params: dict, rounds: Optional[int] = None,
            verbose: bool = False) -> tuple[dict, History]:
        """Run rounds ``0..rounds-1`` on the synchronous loop."""
        T = rounds if rounds is not None else self.fl.rounds
        if self.engine == "vectorized" and self.pipeline and T > 0:
            raise NotImplementedError(
                "the streaming round scheduler (pipeline=True, the "
                "reference's default for the vectorized engine) "
                + _NOT_PORTED.format(1) + "; pass pipeline=False")
        hist = History()
        for t in range(T):
            params, rec = self.run_round(params, t)
            hist.records.append(rec)
            if verbose:
                self._print_round(rec)
        return params, hist

    @staticmethod
    def _print_round(rec: RoundRecord) -> None:
        print(f"[round {rec.round:3d}] test_loss={rec.test_loss:.4f} "
              f"acc={rec.test_acc:.4f} union={rec.union_frac:.2f} "
              f"({rec.wall_s:.2f}s)")
