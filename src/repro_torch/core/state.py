"""Population-scale client state: flat arrays indexed by client id (a
numpy copy of ``repro/core/state.py``).

Everything the federation keeps *per client id* across rounds lives here,
stored as flat numpy arrays sized for populations of 10⁵–10⁶ clients with
O(cohort) per-round access (DESIGN.md §8):

* :class:`ClientStateStore` — the server-side store: warm-start mask rows,
  the probe-stat cache (selection_period > 1), and last-seen round markers.
  Per-round operations are vectorized gathers/scatters over the cohort's
  ids; cache invalidation is a generation counter bump (O(1), never an
  O(population) sweep).
* :class:`ClientStreamState` — the task-side store: per-client data-stream
  draw counters (flat int64) plus the numpy rng streams themselves, created
  *lazily* on first touch so a 10⁶-client task costs O(touched ≤
  rounds·cohort) rather than O(population) to construct and to checkpoint.

Both serialize to flat ``{name: np.ndarray}`` dicts (``state_dict`` /
``load_state_dict``) consumed by the round-boundary checkpoints
(``ckpt/checkpoint.py`` via ``FLServer.save_state``): restoring them is
byte-exact, which is what makes kill-at-round-t + resume reproduce the
uninterrupted run bit-identically on masks (tests/test_checkpoint.py).

The rng helpers pack ``np.random.RandomState`` (MT19937) state to arrays
and back, so every host stream — the server's cohort rng and each touched
client's data stream — rides the same npz checkpoint as the params.

``warm_rows_device`` places the cohort's warm rows on the card, or on a
mesh (this rank's rows, ``sharding/fl_step.py::shard_cohort_rows``);
it is the one place this module touches ``torch``, imported there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["ClientStateStore", "ClientStreamState",
           "rng_state_to_arrays", "rng_state_from_arrays", "sub_state"]


# ---------------------------------------------------------------------------
# RandomState (MT19937) <-> flat arrays
# ---------------------------------------------------------------------------

def rng_state_to_arrays(rng: np.random.RandomState) -> dict[str, np.ndarray]:
    """Pack an MT19937 RandomState's full state into checkpointable arrays."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    if name != "MT19937":            # RandomState is always MT19937
        raise ValueError(f"unsupported bit generator {name!r}")
    return {"keys": np.asarray(keys, np.uint32),
            "pos": np.asarray(pos, np.int64),
            "has_gauss": np.asarray(has_gauss, np.int64),
            "cached_gaussian": np.asarray(cached, np.float64)}


def rng_state_from_arrays(d: dict[str, np.ndarray],
                          rng: Optional[np.random.RandomState] = None
                          ) -> np.random.RandomState:
    """Restore (into ``rng`` if given, else a fresh RandomState)."""
    rng = rng if rng is not None else np.random.RandomState()  # repro: allow[nondeterminism] -- state is fully overwritten by set_state below
    rng.set_state(("MT19937", np.asarray(d["keys"], np.uint32),
                   int(d["pos"]), int(d["has_gauss"]),
                   float(d["cached_gaussian"])))
    return rng


def sub_state(d: dict[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """The ``prefix``-namespaced slice of a flat state dict, prefix stripped."""
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Task-side per-client stream state
# ---------------------------------------------------------------------------

class ClientStreamState:
    """Per-client data streams: flat draw counters + lazy rng streams.

    ``seed_fn(i)`` gives client i's stream seed; the RandomState itself is
    only materialised when the client is first touched (a sampled cohort
    member), so host memory and checkpoint size are O(touched clients), not
    O(population).
    """

    def __init__(self, n_clients: int, seed_fn):
        self.n = int(n_clients)
        self._seed_fn = seed_fn
        self.positions = np.zeros(self.n, np.int64)   # samples drawn so far
        self._rngs: dict[int, np.random.RandomState] = {}

    def rng(self, i: int) -> np.random.RandomState:
        i = int(i)
        r = self._rngs.get(i)
        if r is None:
            r = self._rngs[i] = np.random.RandomState(self._seed_fn(i))
        return r

    def advance(self, i: int, k: int) -> None:
        self.positions[int(i)] += k

    def touched(self) -> np.ndarray:
        """Sorted ids whose streams have been materialised."""
        return np.array(sorted(self._rngs), np.int64)

    # -- checkpointing ---------------------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        ids = self.touched()
        packed = [rng_state_to_arrays(self._rngs[int(i)]) for i in ids]
        return {
            "positions": self.positions.copy(),
            "ids": ids,
            "keys": (np.stack([p["keys"] for p in packed])
                     if len(packed) else np.zeros((0, 624), np.uint32)),
            "pos": np.array([p["pos"] for p in packed], np.int64),
            "has_gauss": np.array([p["has_gauss"] for p in packed], np.int64),
            "cached_gaussian": np.array([p["cached_gaussian"] for p in packed],
                                        np.float64),
        }

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        positions = np.asarray(d["positions"], np.int64)
        if positions.shape != (self.n,):
            raise ValueError(f"stream positions shape {positions.shape} != "
                             f"({self.n},) — population size changed?")
        self.positions = positions.copy()
        self._rngs = {}
        ids = np.asarray(d["ids"], np.int64)
        for r, i in enumerate(ids):
            self._rngs[int(i)] = rng_state_from_arrays(
                {"keys": d["keys"][r], "pos": d["pos"][r],
                 "has_gauss": d["has_gauss"][r],
                 "cached_gaussian": d["cached_gaussian"][r]})


# ---------------------------------------------------------------------------
# Server-side per-client state
# ---------------------------------------------------------------------------

class ClientStateStore:
    """Flat per-client-id state for the FL server, O(cohort) per round.

    Layout (all indexed by client id, population ``n``):

    * ``warm``       — (n, L) float32 warm-start mask rows + (n,) validity
    * ``stats``      — one (n, L) float32 array per probe-stat key, lazily
      allocated on first scatter; validity is a per-client int64 *stamp*
      against a generation counter, so a refresh (``clear_stats``) is a
      counter bump — O(1) regardless of population
    * ``last_seen``  — (n,) int64 round at which each client last received
      masks (-1 = never selected)
    """

    def __init__(self, n_clients: int, n_layers: int):
        self.n = int(n_clients)
        self.L = int(n_layers)
        self._warm = np.zeros((self.n, self.L), np.float32)
        self._warm_valid = np.zeros(self.n, bool)
        self._n_warm = 0
        self._stats: dict[str, np.ndarray] = {}
        self._stats_stamp = np.zeros(self.n, np.int64)   # valid iff == _gen
        self._gen = 1                                    # 0 = never written
        self._gen_keys: tuple[str, ...] = ()
        self.last_seen = np.full(self.n, -1, np.int64)

    # -- warm-start mask rows -------------------------------------------
    @property
    def has_warm(self) -> bool:
        return self._n_warm > 0

    def warm_rows(self, cohort) -> tuple[np.ndarray, np.ndarray]:
        """(rows (k, L) float32, valid (k,) bool) for the cohort's ids.
        Rows are fresh copies; invalid rows are zeros."""
        ids = np.asarray(cohort, np.int64)  # repro: allow[host-sync] -- cohort ids are host np; the store is host-resident by design
        return self._warm[ids].copy(), self._warm_valid[ids].copy()

    def set_warm_rows(self, cohort, masks: np.ndarray,
                      t: Optional[int] = None) -> None:
        ids = np.asarray(cohort, np.int64)
        masks = np.asarray(masks, np.float32)
        if masks.shape != (len(ids), self.L):
            raise ValueError(f"mask rows {masks.shape} != "
                             f"({len(ids)}, {self.L})")
        self._warm[ids] = masks
        self._n_warm += int((~self._warm_valid[ids]).sum())
        self._warm_valid[ids] = True
        if t is not None:
            self.last_seen[ids] = t

    def warm_rows_device(self, cohort, mesh=None, *, device="cuda"):
        """The cohort's warm rows as a device tensor, and the host valid
        flags (ref ``warm_rows_device``).  With ``mesh``, this rank's rows:
        the cohort axis split over the client axes (one row per client
        coordinate), or whole when it does not divide; ``mesh=None`` puts
        every row on ``device``.  Values are the host gather's, bit for
        bit."""
        import torch

        from repro_torch import resolve_device
        rows, valid = self.warm_rows(cohort)
        if mesh is None:
            return torch.from_numpy(rows).to(resolve_device(device)), valid
        from repro_torch.sharding.fl_step import shard_cohort_rows
        return shard_cohort_rows(mesh, torch.from_numpy(rows)), valid

    # -- probe-stat cache ------------------------------------------------
    def clear_stats(self) -> None:
        """Invalidate every cached stat row — a generation bump, O(1)."""
        self._gen += 1
        self._gen_keys = ()

    def stats_valid(self, cohort) -> np.ndarray:
        ids = np.asarray(cohort, np.int64)
        return self._stats_stamp[ids] == self._gen

    def missing_stats(self, cohort) -> np.ndarray:
        """Cohort members without current-generation stats, cohort order."""
        cohort = np.asarray(cohort)
        return cohort[~self.stats_valid(cohort)]

    def set_stat_rows(self, cohort, stats: dict[str, np.ndarray]) -> None:
        """Scatter probe-stat rows for ``cohort`` (row r -> cohort[r])."""
        ids = np.asarray(cohort, np.int64)
        if not len(ids):
            return
        keys = tuple(stats.keys())
        for k in keys:
            rows = np.asarray(stats[k], np.float32)
            arr = self._stats.get(k)
            if arr is None or arr.shape[1:] != rows.shape[1:]:
                arr = self._stats[k] = np.zeros((self.n,) + rows.shape[1:],
                                                np.float32)
            arr[ids] = rows
        # mirror ProbeReport.from_rows: a stat participates only if every
        # scatter this generation carried it
        self._gen_keys = (keys if not self._gen_keys
                          else tuple(k for k in self._gen_keys if k in keys))
        self._stats_stamp[ids] = self._gen

    def stat_rows(self, cohort) -> dict[str, np.ndarray]:
        """Gather the cohort's cached stat rows (all must be current)."""
        ids = np.asarray(cohort, np.int64)
        missing = self._stats_stamp[ids] != self._gen
        if missing.any():
            raise KeyError(f"no cached stats for client ids "
                           f"{ids[missing].tolist()} (generation {self._gen})")
        return {k: self._stats[k][ids] for k in self._gen_keys}

    # -- checkpointing ---------------------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        d = {
            "warm": self._warm.copy(),
            "warm_valid": self._warm_valid.copy(),
            "stats_stamp": self._stats_stamp.copy(),
            "gen": np.asarray(self._gen, np.int64),
            "gen_keys": np.asarray(self._gen_keys, dtype=np.str_),
            "last_seen": self.last_seen.copy(),
        }
        for k, v in self._stats.items():
            d[f"stat/{k}"] = v.copy()
        return d

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        warm = np.asarray(d["warm"], np.float32)
        if warm.shape != (self.n, self.L):
            raise ValueError(f"warm-mask store {warm.shape} != "
                             f"({self.n}, {self.L}) — population or layer "
                             f"count changed?")
        self._warm = warm.copy()
        self._warm_valid = np.asarray(d["warm_valid"], bool).copy()
        self._n_warm = int(self._warm_valid.sum())
        self._stats_stamp = np.asarray(d["stats_stamp"], np.int64).copy()
        self._gen = int(d["gen"])
        self._gen_keys = tuple(str(k) for k in np.asarray(d["gen_keys"]))
        self.last_seen = np.asarray(d["last_seen"], np.int64).copy()
        self._stats = {k[len("stat/"):]: np.asarray(v, np.float32).copy()
                       for k, v in d.items() if k.startswith("stat/")}
