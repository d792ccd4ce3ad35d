"""Synthetic federated datasets with the paper's two non-IID patterns (§5.1)
(a numpy copy of ``repro/data/synthetic.py``: the same seed gives the same
bytes).

The paper's datasets (CIFAR-10 / DomainNet / XGLUE-NC / QA) are not available
offline; we synthesise tasks with the same *heterogeneity structure*:

* **Label skew** (CIFAR-10 analogue): class proportions per client drawn from
  Dirichlet(α) (paper uses α=0.1); inputs are class-conditional token
  sequences — each class has its own token distribution, so the task is
  learnable and layer importance differs across classes.
* **Feature skew** (DomainNet/XGLUE analogue): each client belongs to one
  *domain*; a domain applies a fixed token permutation ("style") to the
  class-conditional sequences — P(x|y) shifts across clients while labels
  stay balanced.

Both variants support classification (pooled head) and LM (next-token)
objectives.  Sampling is numpy-based and deterministic per (seed, client).

Sampling is whole-tensor per ``(client, call)``: labels via
``rng.choice``, class-conditional tokens via cumsum+searchsorted over
``class_probs``, signal/noise masks and noise tokens as whole-tensor draws,
each client on its own ``RandomState`` stream.  The held-out test set is
drawn **once** (lazily, from a dedicated rng stream) from the global
mixture Σ_i α_i P_i; :meth:`test_batch` returns a fixed slice of it.

``pretrain_batch`` draws balanced, identity-domain samples (the
pretraining corpus, ``data/pretrain.py``) from ``_test_rng``, a stream of
its own beside the held-out set's; ``state_dict``/``load_state_dict`` carry
the client streams and that rng through round-boundary checkpoints.

Not ported: the reference's scalar sampling oracle and its legacy
(pre-pipeline) sampling path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.state import (ClientStreamState, rng_state_from_arrays,
                                    rng_state_to_arrays, sub_state)


@dataclass
class FederatedTaskConfig:
    n_clients: int = 100
    n_classes: int = 10
    vocab_size: int = 512
    seq_len: int = 32
    samples_per_client: int = 64
    skew: str = "label"              # label | feature
    dirichlet_alpha: float = 0.1
    n_domains: int = 5
    objective: str = "classification"  # classification | lm
    test_samples: int = 256
    seed: int = 0
    # class signal strength: fraction of positions carrying class-token signal
    signal: float = 0.5
    # feature skew severity: fraction of the vocabulary each domain permutes
    # (DomainNet-style shift: features partially transfer across domains)
    domain_strength: float = 0.3
    # modality: "tokens" (text) or "patches" (vision — CLIP-style stubbed
    # patch embeddings: class prototypes + per-domain linear style shift)
    modality: str = "tokens"
    patch_tokens: int = 8
    patch_dim: int = 64


class SyntheticFederatedData:
    """Generator for per-client batches and a held-out global test set.

    Implements the ``repro_torch.api.task.Task`` protocol (``sizes`` /
    ``cohort_batches`` / ``test_batch``) consumed by the round engines and
    ``repro_torch.api.experiment.Experiment``; it declares no plan-stage
    hooks, so cohort draws consume the server rng as the reference's do.
    """

    def __init__(self, cfg: FederatedTaskConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        C, V = cfg.n_classes, cfg.vocab_size

        # class-conditional token distributions: each class prefers a band of tokens
        logits = rng.randn(C, V) * 0.5
        for c in range(C):
            band = np.arange(V) % C == c
            logits[c, band] += 3.0
        self.class_probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

        # domains: partial token permutations (feature shift preserving labels;
        # only `domain_strength` of the vocab is scrambled, so pretrained
        # features partially transfer — DomainNet-style)
        self.domain_perm = []
        for _ in range(cfg.n_domains):
            perm = np.arange(V)
            k = min(int(V * cfg.domain_strength), V)
            if k > 1:
                subset = rng.choice(V, size=k, replace=False)
                perm[subset] = perm[rng.permutation(subset)]
            self.domain_perm.append(perm)
        self.domain_perm.append(np.arange(V))   # identity (pretraining corpus)

        # client -> label distribution & domain
        if cfg.skew == "label":
            self.client_label_p = rng.dirichlet(
                np.full(C, cfg.dirichlet_alpha), size=cfg.n_clients)
            self.client_domain = np.zeros(cfg.n_clients, int)
        else:
            self.client_label_p = np.full((cfg.n_clients, C), 1.0 / C)
            self.client_domain = rng.randint(0, cfg.n_domains, cfg.n_clients)

        # heterogeneous dataset sizes d_i (log-normal, as in real FL)
        self.sizes = np.maximum(
            (cfg.samples_per_client *
             np.exp(rng.randn(cfg.n_clients) * 0.3)).astype(int), 8)

        # per-client data streams: flat draw counters + rng streams created
        # lazily on first touch (O(touched) host memory at 10⁵–10⁶ client
        # populations; each stream's seed depends only on (seed, i), so
        # laziness never changes a draw).  The depth-k round scheduler
        # prefetches rounds ahead of wall-clock execution; equality of the
        # positions (and of the streams' final states) across scheduled and
        # synchronous runs is the observable half of the stream-order
        # parity contract (tests/test_scheduler.py).
        self._streams = ClientStreamState(
            cfg.n_clients, lambda i, s=cfg.seed: s * 1000 + 7 * i + 1)
        self._test_rng = np.random.RandomState(cfg.seed + 999)

        if cfg.modality == "patches":
            # class prototypes in patch-embedding space + per-domain style
            # maps (identity-leaning linear shifts; last = pure identity).
            # Only `signal` of the patch positions carry class evidence and
            # the prototypes are weak relative to noise, so accuracy does
            # not saturate (strategies must actually adapt features).
            self.proto = rng.randn(C, cfg.patch_tokens, cfg.patch_dim) * 0.5
            self.patch_signal = rng.rand(cfg.patch_tokens) < cfg.signal
            self.proto[:, ~self.patch_signal] = 0.0
            self.domain_map = []
            for _ in range(cfg.n_domains):
                M = np.eye(cfg.patch_dim) + \
                    cfg.domain_strength * rng.randn(cfg.patch_dim, cfg.patch_dim) \
                    / np.sqrt(cfg.patch_dim)
                self.domain_map.append(M)
            self.domain_map.append(np.eye(cfg.patch_dim))
            self._maps = np.stack(self.domain_map)

        # vectorized-sampling tables: per-class / per-client inverse-cdf rows
        # (normalised exactly like np.random.choice: cumsum then /= last)
        self._perms = np.stack(self.domain_perm)
        cdf = np.cumsum(self.class_probs, axis=1)
        self._class_cdf = cdf / cdf[:, -1:]
        lcdf = np.cumsum(self.client_label_p, axis=1)
        self._label_cdf = lcdf / lcdf[:, -1:]

        # held-out test set: drawn once (lazily) from a dedicated stream so
        # pretrain_batch (on _test_rng) never shifts it; test_batch() slices
        # it
        self._heldout_rng = np.random.RandomState(cfg.seed + 424242)
        self._test_set: Optional[dict] = None

    # ------------------------------------------------------------------
    @property
    def n_clients(self) -> int:
        return self.cfg.n_clients

    @property
    def alpha(self) -> np.ndarray:
        """Relative sample sizes α_i = d_i / Σ d_j (Eq. 1)."""
        return self.sizes / self.sizes.sum()

    # -- vectorized path ------------------------------------------------
    def _cls_tokens(self, y: np.ndarray, u: np.ndarray) -> np.ndarray:
        """Inverse-cdf class-conditional tokens: searchsorted per class."""
        out = np.empty(u.shape, np.int64)
        for c in np.unique(y):
            m = y == c
            out[m] = np.searchsorted(self._class_cdf[c], u[m], side="right")
        return out

    def _sample_vec(self, rng: np.random.RandomState, label_p: np.ndarray,
                    domain: int, n: int) -> dict:
        """Whole-tensor draws; rng stream order: y, [eps | sig, u, noise]."""
        cfg = self.cfg
        y = rng.choice(cfg.n_classes, size=n, p=label_p)
        if cfg.modality == "patches":
            base = self.proto[y] + rng.randn(n, cfg.patch_tokens,
                                             cfg.patch_dim) * 1.5
            M = self.domain_map[domain if domain < len(self.domain_map)
                                else -1]
            patches = base @ M.T
            batch = {"patches": patches.astype(np.float32)}
            if cfg.objective == "classification":
                batch["label"] = y.astype(np.int32)
            return batch
        sig = rng.random_sample((n, cfg.seq_len))
        u = rng.random_sample((n, cfg.seq_len))
        noise = rng.randint(0, cfg.vocab_size, (n, cfg.seq_len))
        toks = np.where(sig < cfg.signal, self._cls_tokens(y, u), noise)
        toks = self.domain_perm[domain][toks].astype(np.int32)
        batch = {"tokens": toks}
        if cfg.objective == "classification":
            batch["label"] = y.astype(np.int32)
        return batch

    def _sample_mixture_vec(self, rng: np.random.RandomState,
                            owners: np.ndarray) -> dict:
        """Batched draw with per-sample (label_p, domain) given by owners."""
        cfg = self.cfg
        n = len(owners)
        u_y = rng.random_sample(n)
        y = np.empty(n, np.int64)
        for i in np.unique(owners):
            m = owners == i
            y[m] = np.searchsorted(self._label_cdf[i], u_y[m], side="right")
        domains = self.client_domain[owners]
        if cfg.modality == "patches":
            base = self.proto[y] + rng.randn(n, cfg.patch_tokens,
                                             cfg.patch_dim) * 1.5
            patches = np.einsum("npd,ned->npe", base, self._maps[domains])
            batch = {"patches": patches.astype(np.float32)}
            if cfg.objective == "classification":
                batch["label"] = y.astype(np.int32)
            return batch
        sig = rng.random_sample((n, cfg.seq_len))
        u = rng.random_sample((n, cfg.seq_len))
        noise = rng.randint(0, cfg.vocab_size, (n, cfg.seq_len))
        toks = np.where(sig < cfg.signal, self._cls_tokens(y, u), noise)
        toks = self._perms[domains[:, None], toks].astype(np.int32)
        batch = {"tokens": toks}
        if cfg.objective == "classification":
            batch["label"] = y.astype(np.int32)
        return batch

    # -- public API ------------------------------------------------------
    def stream_positions(self) -> np.ndarray:
        """(n_clients,) samples drawn per client stream so far — the
        cross-round bookkeeping the scheduler parity tests compare."""
        return self._streams.positions.copy()

    def state_dict(self) -> dict[str, np.ndarray]:
        """Flat-array resumable state: stream positions, the touched
        streams' rng states and the pretraining rng.  The held-out rng is
        not saved: the fixed test set is its first and only consumer, so a
        fresh task redraws it identically."""
        d = {f"streams/{k}": v for k, v in self._streams.state_dict().items()}
        d.update({f"test_rng/{k}": v
                  for k, v in rng_state_to_arrays(self._test_rng).items()})
        return d

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        self._streams.load_state_dict(sub_state(d, "streams/"))
        rng_state_from_arrays(sub_state(d, "test_rng/"), self._test_rng)

    def client_batch(self, i: int, batch_size: int) -> dict:
        """One minibatch from client i's distribution."""
        self._streams.advance(i, batch_size)
        return self._sample_vec(self._streams.rng(i), self.client_label_p[i],
                                self.client_domain[i], batch_size)

    def client_batches(self, i: int, batch_size: int, n: int) -> dict:
        """``n`` stacked minibatches (leading axis = τ): ONE draw of
        ``n·batch_size`` samples reshaped to ``(n, batch_size, ...)``."""
        self._streams.advance(i, n * batch_size)
        flat = self._sample_vec(self._streams.rng(i), self.client_label_p[i],
                                self.client_domain[i], n * batch_size)
        return {k: v.reshape((n, batch_size) + v.shape[1:])
                for k, v in flat.items()}

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict:
        """Stacked batches for a whole cohort: leaves (len(cohort), n, ...).

        Draws are identical to calling :meth:`client_batches` per cohort
        member in order (each client owns its RNG stream), so the vectorized
        and sequential engines consume the same data stream — the basis of
        the engine-parity guarantee (tests/test_round_engine.py).
        """
        per = [self.client_batches(int(i), batch_size, n) for i in cohort]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}

    def pretrain_batch(self, batch_size: int) -> dict:
        """Balanced, identity-domain samples — the 'pretraining corpus'."""
        cfg = self.cfg
        label_p = np.full(cfg.n_classes, 1.0 / cfg.n_classes)
        identity = len(self.domain_perm) - 1
        return self._sample_vec(self._test_rng, label_p, identity, batch_size)

    def _draw_test_set(self) -> dict:
        """The global-mixture held-out set, drawn once (dedicated stream)."""
        cfg = self.cfg
        owners = self._heldout_rng.choice(cfg.n_clients, size=cfg.test_samples,
                                          p=self.alpha)
        return self._sample_mixture_vec(self._heldout_rng, owners)

    def test_batch(self, batch_size: Optional[int] = None) -> dict:
        """Held-out batch from the *global* mixture Σ_i α_i P_i: a fixed
        slice of the once-drawn test set, so repeated calls are
        deterministic and free of sampling noise."""
        cfg = self.cfg
        n = batch_size or cfg.test_samples
        if n > cfg.test_samples:
            raise ValueError(
                f"test_batch({n}) exceeds the fixed held-out set "
                f"(test_samples={cfg.test_samples})")
        if self._test_set is None:
            self._test_set = self._draw_test_set()
        return {k: v[:n] for k, v in self._test_set.items()}
