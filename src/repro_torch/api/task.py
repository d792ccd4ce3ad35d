"""Task protocol: the datasource seam of the federation API (counterpart of
``repro/api/task.py``).

A *Task* is anything the round engines can federate over.  The required
surface (structural — no inheritance needed) is:

* ``sizes`` — (n_clients,) int array of per-client dataset sizes d_i;
* ``cohort_batches(cohort, batch_size, n)`` — stacked host (numpy) batches
  with leading ``(len(cohort), n)`` axes, drawn from each member's stream;
* ``test_batch(batch_size=None)`` — the held-out eval batch, the same on
  every call (the streaming scheduler fetches it once per run, the
  synchronous loop every round).

Optional plan-stage hooks (consumed by ``FLServer.plan_round``):
``available_clients(t, rng) -> ids`` (the pool the round-t cohort is drawn
from; None = everyone) and ``drop_stragglers(t, cohort, rng) -> keep_mask``
(members that fail to report this round).

Optional extras: ``client_batch(i, batch_size)`` and
``pretrain_batch(batch_size)`` (the pretraining corpus,
``data/pretrain.py``), and the checkpoint hooks ``state_dict() ->
{name: np.ndarray}`` / ``load_state_dict(d)`` (the task's resumable stream
state as flat arrays, consumed by ``FLServer.save_state`` /
``restore_state``).

:class:`DirichletTokenMixtureTask` is a second implementation beside
``SyntheticFederatedData``: a Dirichlet-partitioned topic-mixture text
task with built-in availability windows and stragglers, a numpy copy of
the reference's (the same seed gives the same bytes).  :class:`ChaosTask`
wraps any task and forces its plan-stage hooks to the worst case on chosen
rounds (DESIGN.md §12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.state import (ClientStreamState, rng_state_from_arrays,
                                    rng_state_to_arrays, sub_state)


@runtime_checkable
class Task(Protocol):
    """Structural datasource protocol for the round engines."""

    sizes: np.ndarray

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict: ...

    def test_batch(self, batch_size: Optional[int] = None) -> dict: ...


@dataclass
class DirichletTaskConfig:
    """A Dirichlet-partitioned token-mixture task (non-IID text analogue).

    Each of ``n_topics`` topics owns a token distribution; client i's topic
    weights are drawn from Dirichlet(α) — the standard partition protocol
    the paper's CIFAR-10 split uses, here over topics instead of labels.
    A sample draws its topic from the client's weights, its label *is* the
    topic, and ``signal`` of the positions carry topic-conditional tokens.
    """

    n_clients: int = 32
    n_topics: int = 8
    vocab_size: int = 512
    seq_len: int = 32
    samples_per_client: int = 64
    dirichlet_alpha: float = 0.5
    objective: str = "classification"     # classification | lm
    test_samples: int = 256
    seed: int = 0
    signal: float = 0.7
    # --- plan-stage heterogeneity hooks -------------------------------
    # fraction of clients reachable per round (1.0 = everyone, no hook
    # effect); the available pool is a deterministic rotating window, so
    # tests can recompute it
    availability: float = 1.0
    # probability a drawn cohort member fails to report (straggler drop)
    straggler_rate: float = 0.0


class DirichletTokenMixtureTask:
    """Second Task implementation (independent of SyntheticFederatedData)."""

    def __init__(self, cfg: DirichletTaskConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        K, V = cfg.n_topics, cfg.vocab_size

        # topic-conditional token distributions: each topic prefers a band
        logits = rng.randn(K, V) * 0.5
        for k in range(K):
            logits[k, np.arange(V) % K == k] += 3.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        self._topic_cdf = cdf / cdf[:, -1:]

        # Dirichlet partition: per-client topic weights
        self.client_topic_p = rng.dirichlet(
            np.full(K, cfg.dirichlet_alpha), size=cfg.n_clients)
        tcdf = np.cumsum(self.client_topic_p, axis=1)
        self._client_cdf = tcdf / tcdf[:, -1:]

        self.sizes = np.maximum(
            (cfg.samples_per_client *
             np.exp(rng.randn(cfg.n_clients) * 0.3)).astype(int), 8)
        # lazy per-client streams (flat positions + on-first-touch rngs):
        # the reference's per-(seed, i) stream seeds, O(touched) memory at
        # population scale, checkpointable via state_dict
        self._streams = ClientStreamState(
            cfg.n_clients, lambda i, s=cfg.seed: s * 977 + 13 * i + 5)
        self._heldout_rng = np.random.RandomState(cfg.seed + 131071)
        self._pretrain_rng = np.random.RandomState(cfg.seed + 524287)
        self._test_set: Optional[dict] = None

    def stream_positions(self) -> np.ndarray:
        """(n_clients,) samples drawn per client stream so far."""
        return self._streams.positions.copy()

    def state_dict(self) -> dict[str, np.ndarray]:
        """Flat-array resumable state (see the Task protocol docstring).
        The held-out rng is not saved: the fixed test set is its first and
        only consumer, so a fresh task redraws it identically."""
        d = {f"streams/{k}": v for k, v in self._streams.state_dict().items()}
        d.update({f"pretrain_rng/{k}": v for k, v in
                  rng_state_to_arrays(self._pretrain_rng).items()})
        return d

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        self._streams.load_state_dict(sub_state(d, "streams/"))
        rng_state_from_arrays(sub_state(d, "pretrain_rng/"),
                              self._pretrain_rng)

    # ------------------------------------------------------------------
    @property
    def n_clients(self) -> int:
        return self.cfg.n_clients

    @property
    def alpha(self) -> np.ndarray:
        return self.sizes / self.sizes.sum()

    # -- sampling --------------------------------------------------------
    def _draw(self, rng: np.random.RandomState, topic_cdf_row: np.ndarray,
              n: int) -> dict:
        cfg = self.cfg
        y = np.searchsorted(topic_cdf_row, rng.random_sample(n),
                            side="right").astype(np.int64)
        sig = rng.random_sample((n, cfg.seq_len))
        u = rng.random_sample((n, cfg.seq_len))
        noise = rng.randint(0, cfg.vocab_size, (n, cfg.seq_len))
        topical = np.empty((n, cfg.seq_len), np.int64)
        for k in np.unique(y):
            m = y == k
            topical[m] = np.searchsorted(self._topic_cdf[k], u[m],
                                         side="right")
        toks = np.where(sig < cfg.signal, topical, noise).astype(np.int32)
        batch = {"tokens": toks}
        if cfg.objective == "classification":
            batch["label"] = y.astype(np.int32)
        return batch

    def client_batch(self, i: int, batch_size: int) -> dict:
        self._streams.advance(i, batch_size)
        return self._draw(self._streams.rng(i), self._client_cdf[i],
                          batch_size)

    def client_batches(self, i: int, batch_size: int, n: int) -> dict:
        self._streams.advance(i, n * batch_size)
        flat = self._draw(self._streams.rng(i), self._client_cdf[i],
                          n * batch_size)
        return {k: v.reshape((n, batch_size) + v.shape[1:])
                for k, v in flat.items()}

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict:
        per = [self.client_batches(int(i), batch_size, n) for i in cohort]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}

    def pretrain_batch(self, batch_size: int) -> dict:
        """Balanced topic mixture — the 'pretraining corpus' stand-in."""
        uniform = np.linspace(1 / self.cfg.n_topics, 1.0, self.cfg.n_topics)
        return self._draw(self._pretrain_rng, uniform, batch_size)

    def test_batch(self, batch_size: Optional[int] = None) -> dict:
        cfg = self.cfg
        n = batch_size or cfg.test_samples
        if n > cfg.test_samples:
            raise ValueError(f"test_batch({n}) exceeds the fixed held-out "
                             f"set (test_samples={cfg.test_samples})")
        if self._test_set is None:
            rng = self._heldout_rng
            owners = rng.choice(cfg.n_clients, size=cfg.test_samples,
                                p=self.alpha)
            outs = {}
            for i in np.unique(owners):
                m = owners == i
                # repro: allow[host-sync] -- one-time test-set assembly on host np arrays, not a round loop
                outs[int(i)] = (m, self._draw(rng, self._client_cdf[i],
                                              int(m.sum())))  # repro: allow[host-sync] -- host np owner counts
            sample = next(iter(outs.values()))[1]
            merged = {k: np.empty((cfg.test_samples,) + v.shape[1:], v.dtype)
                      for k, v in sample.items()}
            for m, b in outs.values():
                for k in merged:
                    merged[k][m] = b[k]
            self._test_set = merged
        return {k: v[:n] for k, v in self._test_set.items()}

    # -- plan-stage hooks ------------------------------------------------
    def available_pool(self, t: int) -> np.ndarray:
        """The deterministic rotating availability window for round t."""
        cfg = self.cfg
        n = cfg.n_clients
        k = max(1, int(round(n * cfg.availability)))
        start = (t * max(1, n // 4)) % n
        return (start + np.arange(k)) % n

    def available_clients(self, t: int, rng: np.random.RandomState):
        if self.cfg.availability >= 1.0:
            return None                     # full availability: no hook effect
        return self.available_pool(t)

    def drop_stragglers(self, t: int, cohort: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
        if self.cfg.straggler_rate <= 0.0:
            return np.ones(len(cohort), bool)
        return rng.random_sample(len(cohort)) >= self.cfg.straggler_rate


class ChaosTask:
    """Wrap any Task and force its plan-stage hooks to the worst case on
    chosen rounds: the adversarial fixture of the degradation contracts.

    ``empty_pool_rounds``: rounds whose availability pool is empty;
    ``all_straggler_rounds``: rounds where every drawn cohort member fails
    to report.  Everything else (data streams, sizes, checkpoint hooks)
    delegates verbatim to ``inner``, so outside the listed rounds a
    ChaosTask run is bit-identical to the inner task's.
    """

    def __init__(self, inner, *, empty_pool_rounds=(),
                 all_straggler_rounds=()):
        self.inner = inner
        self.empty_pool_rounds = frozenset(int(t) for t in empty_pool_rounds)
        self.all_straggler_rounds = frozenset(
            int(t) for t in all_straggler_rounds)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def sizes(self) -> np.ndarray:
        return self.inner.sizes

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict:
        return self.inner.cohort_batches(cohort, batch_size, n)

    def test_batch(self, batch_size: Optional[int] = None) -> dict:
        return self.inner.test_batch(batch_size)

    def available_clients(self, t: int, rng: np.random.RandomState):
        if t in self.empty_pool_rounds:
            return np.zeros(0, np.int64)
        hook = getattr(self.inner, "available_clients", None)
        return hook(t, rng) if callable(hook) else None

    def drop_stragglers(self, t: int, cohort: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
        if t in self.all_straggler_rounds:
            return np.zeros(len(cohort), bool)
        hook = getattr(self.inner, "drop_stragglers", None)
        if callable(hook):
            return hook(t, cohort, rng)
        return np.ones(len(cohort), bool)
