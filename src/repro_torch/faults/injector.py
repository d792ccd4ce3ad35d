"""FaultPlan / FaultInjector: seeded, replayable fault schedules
(counterpart of ``repro/faults/injector.py``; numpy only, the same draws).

Every hook draws from a ``RandomState`` derived from ``(plan.seed, site,
round)``, never from one shared stream, so the schedule a seed gives is
independent of call order, engine, pipeline depth and of which other fault
classes are on — and byte-equal to the reference injector's for the same
plan.

==================  =====================================================
site                consumer
==================  =====================================================
client death        ``FLServer._update_round_faulty`` — survivors mask
delta corruption    the same round step — NaN/Inf/exploding delta rows
solver stall        ``FLServer.select_round`` — warm/greedy fallback
dispatch failure    ``FLServer._dispatch`` — bounded retry with backoff
ckpt corruption     ``FLServer.save_state`` — truncate/bitflip/manifest
delta upload        ``serve.DeltaOverlay`` — bounded per-entry retry
slot failure        ``launch.serve.SlotServer`` — free + requeue, bounded
==================  =====================================================

The injector changes nothing it observes: it returns masks, codes and
bools and raises :class:`TransientFault`; the degradation policy lives
with the consumers.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

# per-row corruption codes of the guarded round step (int32 device data)
CORRUPT_CODES = {"clean": 0, "nan": 1, "inf": 2, "explode": 3}

CKPT_CORRUPT_KINDS = ("truncate", "bitflip", "manifest")

# per-site stream ids (see FaultInjector._rng)
_SITE_DEATH = 1
_SITE_CORRUPT = 2
_SITE_STALL = 3
_SITE_DISPATCH = 4
_SITE_CKPT = 5
_SITE_UPLOAD = 6
_SITE_SLOT = 7


class TransientFault(RuntimeError):
    """An injected, retry-able failure (dispatch, upload).  The engines
    retry only this type: every other exception propagates."""


@dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule; every rate in [0, 1].

    ``enabled=False`` keeps the injector wired but inert: every hook
    returns its no-fault answer without touching a stream.
    """

    seed: int = 0
    enabled: bool = True
    # mid-round client death (after sampling, before reporting)
    death_rate: float = 0.0
    # reported-delta corruption
    corrupt_rate: float = 0.0
    corrupt_kinds: tuple = ("nan", "inf", "explode")
    explode_scale: float = 1e30
    # finite guard's norm threshold: rows whose Δ sq-norm exceeds it are
    # quarantined even when finite (inf = non-finite rows only)
    max_delta_sq: float = math.inf
    # host solver stalls
    stall_rate: float = 0.0
    # round dispatch failures
    dispatch_fail_rate: float = 0.0
    dispatch_fail_count: int = 1          # consecutive failures per event
    max_dispatch_retries: int = 3
    retry_backoff_s: float = 0.0          # 0 = immediate retry
    # checkpoint damage after a save
    ckpt_corrupt_rate: float = 0.0
    ckpt_corrupt_kind: str = "truncate"   # truncate | bitflip | manifest
    # serving
    upload_fail_rate: float = 0.0
    slot_fault_rate: float = 0.0

    def __post_init__(self):
        for name in ("death_rate", "corrupt_rate", "stall_rate",
                     "dispatch_fail_rate", "ckpt_corrupt_rate",
                     "upload_fail_rate", "slot_fault_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        unknown = set(self.corrupt_kinds) - (set(CORRUPT_CODES) - {"clean"})
        if unknown:
            raise ValueError(
                f"corrupt_kinds {sorted(unknown)} unknown; choose from "
                f"{sorted(set(CORRUPT_CODES) - {'clean'})}")
        if not self.corrupt_kinds and self.corrupt_rate > 0:
            raise ValueError("corrupt_rate > 0 needs at least one kind in "
                             "corrupt_kinds")
        if self.ckpt_corrupt_kind not in CKPT_CORRUPT_KINDS:
            raise ValueError(
                f"ckpt_corrupt_kind must be one of {CKPT_CORRUPT_KINDS}, "
                f"got {self.ckpt_corrupt_kind!r}")
        if self.max_dispatch_retries < 0:
            raise ValueError("max_dispatch_retries must be >= 0")
        if self.dispatch_fail_count < 1:
            raise ValueError("dispatch_fail_count must be >= 1")
        if self.explode_scale <= 0 or not math.isfinite(self.explode_scale):
            raise ValueError("explode_scale must be finite and > 0")


class FaultInjector:
    """Concrete fault draws for a :class:`FaultPlan`.

    Stateless between hooks apart from the ``stats`` counters: every draw
    re-derives its stream from (seed, site, round).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.stats = {"dead_clients": 0, "corrupted_rows": 0, "stalls": 0,
                      "dispatch_faults": 0, "ckpt_corruptions": 0,
                      "upload_faults": 0, "slot_faults": 0}

    @property
    def enabled(self) -> bool:
        return self.plan.enabled

    def _rng(self, site: int, t: int) -> np.random.RandomState:
        # one independent lane per (site, round)
        return np.random.RandomState(
            (self.plan.seed * 1_000_003 + site * 7_919 + t) % (2**31 - 1))

    # -- round-step faults ------------------------------------------------
    def round_faults(self, t: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-row ``(survivors f32 (n,), corruption codes int32 (n,))`` for
        the round-``t`` cohort: a 1/0 alive mask (death strikes after
        sampling, before the update is reported) and a
        :data:`CORRUPT_CODES` entry per reported delta row."""
        p = self.plan
        survivors = np.ones(n, np.float32)
        codes = np.zeros(n, np.int32)
        if not p.enabled:
            return survivors, codes
        if p.death_rate > 0:
            dead = self._rng(_SITE_DEATH, t).random_sample(n) < p.death_rate
            survivors[dead] = 0.0
            self.stats["dead_clients"] += int(dead.sum())  # repro: allow[host-sync] -- host np fault draw, no device value
        if p.corrupt_rate > 0:
            rng = self._rng(_SITE_CORRUPT, t)
            hit = rng.random_sample(n) < p.corrupt_rate
            kinds = rng.randint(0, len(p.corrupt_kinds), n)
            for i in np.flatnonzero(hit):
                codes[i] = CORRUPT_CODES[p.corrupt_kinds[kinds[i]]]
            self.stats["corrupted_rows"] += int(hit.sum())  # repro: allow[host-sync] -- host np fault draw, no device value
        return survivors, codes

    def solver_stalls(self, t: int) -> bool:
        """Does the round-``t`` host solve stall past its deadline?"""
        p = self.plan
        if not p.enabled or p.stall_rate <= 0:
            return False
        stalled = bool(self._rng(_SITE_STALL, t).random_sample()
                       < p.stall_rate)
        if stalled:
            self.stats["stalls"] += 1
        return stalled

    # -- dispatch faults --------------------------------------------------
    def dispatch_failures(self, t: int) -> int:
        """How many consecutive dispatch attempts fail for round ``t``."""
        p = self.plan
        if not p.enabled or p.dispatch_fail_rate <= 0:
            return 0
        if self._rng(_SITE_DISPATCH, t).random_sample() \
                < p.dispatch_fail_rate:
            return p.dispatch_fail_count
        return 0

    def maybe_fail_dispatch(self, t: int, attempt: int) -> None:
        """Raise :class:`TransientFault` while ``attempt`` (from 0) is still
        inside the round's injected failure run."""
        if attempt < self.dispatch_failures(t):
            self.stats["dispatch_faults"] += 1
            raise TransientFault(
                f"injected dispatch failure (round {t}, attempt {attempt})")

    # -- checkpoint faults ------------------------------------------------
    def maybe_corrupt_checkpoint(self, path: str, t: int) -> bool:
        """Damage the just-written checkpoint at ``path`` (after the save
        succeeded: media or torn-write damage found only at restore)."""
        p = self.plan
        if not p.enabled or p.ckpt_corrupt_rate <= 0:
            return False
        if self._rng(_SITE_CKPT, t).random_sample() >= p.ckpt_corrupt_rate:
            return False
        self.corrupt_checkpoint_dir(path, p.ckpt_corrupt_kind)
        self.stats["ckpt_corruptions"] += 1
        return True

    @staticmethod
    def corrupt_checkpoint_dir(path: str, kind: str) -> None:
        """Damage one ``step_*/`` checkpoint directory so that a restore
        detects it: ``truncate`` halves ``arrays.npz`` (a torn write),
        ``bitflip`` XORs its middle byte with 0xFF (media decay, caught by
        the per-array checksums), ``manifest`` overwrites
        ``manifest.json`` with junk."""
        if kind not in CKPT_CORRUPT_KINDS:
            raise ValueError(f"unknown checkpoint corruption {kind!r}")
        arrays = os.path.join(path, "arrays.npz")
        if kind == "manifest":
            with open(os.path.join(path, "manifest.json"), "w") as f:
                f.write("{this is not json")
            return
        size = os.path.getsize(arrays)
        if kind == "truncate":
            with open(arrays, "r+b") as f:
                f.truncate(size // 2)
            return
        with open(arrays, "r+b") as f:      # bitflip
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))

    # -- serving faults ---------------------------------------------------
    def maybe_fail_upload(self, seq: int) -> None:
        """Raise :class:`TransientFault` for overlay entry write ``seq`` (a
        monotone per-overlay counter stands in for the round index)."""
        p = self.plan
        if not p.enabled or p.upload_fail_rate <= 0:
            return
        if self._rng(_SITE_UPLOAD, seq).random_sample() < p.upload_fail_rate:
            self.stats["upload_faults"] += 1
            raise TransientFault(f"injected delta-upload failure (#{seq})")

    def slot_faults(self, step: int, n_slots: int) -> np.ndarray:
        """(n_slots,) bool: decode slots struck at serve step ``step``."""
        p = self.plan
        if not p.enabled or p.slot_fault_rate <= 0:
            return np.zeros(n_slots, bool)
        hit = (self._rng(_SITE_SLOT, step).random_sample(n_slots)
               < p.slot_fault_rate)
        self.stats["slot_faults"] += int(hit.sum())  # repro: allow[host-sync] -- host np fault draw, no device value
        return hit


def coerce_injector(faults) -> Optional[FaultInjector]:
    """None | FaultPlan | FaultInjector → Optional[FaultInjector]."""
    if faults is None or isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    raise TypeError(
        f"faults must be a FaultPlan or FaultInjector, got {type(faults)}")


__all__ = ["CORRUPT_CODES", "CKPT_CORRUPT_KINDS", "FaultInjector",
           "FaultPlan", "TransientFault", "coerce_injector"]
