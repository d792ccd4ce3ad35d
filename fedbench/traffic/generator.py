"""The federation's data: per-client token streams with label and feature
skew, read from a traffic file (``fedbench/traffic/<name>.json``).

A frozen copy of the LM sampling of ``repro_torch/data/synthetic.py``
(``SyntheticFederatedData``: class-conditional token bands, per-domain
partial token permutations, log-normal client sizes, one numpy stream per
client, a held-out set drawn once from the global mixture), so that a later
change to the program cannot move the benchmark's inputs.  Here label skew
(Dirichlet class proportions) and feature skew (each client in one domain)
can act together.  The object implements the program's ``Task`` protocol:
``sizes``, ``cohort_batches(cohort, batch_size, n)`` and ``test_batch()``;
it declares no plan-stage hooks.

Every stream seed derives from the data seed alone, so the same seed gives
the same bytes.
"""
from __future__ import annotations

import numpy as np


class LMTraffic:
    """Token batches for ``n_clients`` clients of a causal LM federation."""

    def __init__(self, p: dict, vocab_size: int, seq_len: int, seed: int):
        self.p = p
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        rng = np.random.RandomState(self.seed)
        C, V = int(p["n_classes"]), self.vocab_size
        n = int(p["n_clients"])

        # class-conditional token distributions: each class prefers a band
        logits = rng.randn(C, V) * 0.5
        for c in range(C):
            logits[c, np.arange(V) % C == c] += 3.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        self._class_cdf = cdf / cdf[:, -1:]

        # domains: partial token permutations (the feature shift)
        perms = []
        for _ in range(int(p["n_domains"])):
            perm = np.arange(V)
            k = min(int(V * float(p["domain_strength"])), V)
            if k > 1:
                subset = rng.choice(V, size=k, replace=False)
                perm[subset] = perm[rng.permutation(subset)]
            perms.append(perm)
        perms.append(np.arange(V))
        self._perms = np.stack(perms)

        alpha = p.get("dirichlet_alpha")
        self.client_label_p = (
            rng.dirichlet(np.full(C, float(alpha)), size=n) if alpha
            else np.full((n, C), 1.0 / C))
        lcdf = np.cumsum(self.client_label_p, axis=1)
        self._label_cdf = lcdf / lcdf[:, -1:]
        self.client_domain = (rng.randint(0, int(p["n_domains"]), n)
                              if p.get("feature_skew") else np.zeros(n, int))

        # heterogeneous dataset sizes d_i (log-normal)
        self.sizes = np.maximum((int(p["samples_per_client"])
                                 * np.exp(rng.randn(n) * 0.3)).astype(int), 8)
        self._rngs: dict[int, np.random.RandomState] = {}
        self._heldout_rng = np.random.RandomState(self.seed + 424242)
        self._test_set = None

    @property
    def n_clients(self) -> int:
        return len(self.sizes)

    def _rng(self, i: int) -> np.random.RandomState:
        r = self._rngs.get(i)
        if r is None:
            r = self._rngs[i] = np.random.RandomState(self.seed * 1000
                                                      + 7 * i + 1)
        return r

    def _tokens(self, rng: np.random.RandomState, y: np.ndarray,
                domains: np.ndarray) -> np.ndarray:
        n, S, V = len(y), self.seq_len, self.vocab_size
        sig = rng.random_sample((n, S))
        u = rng.random_sample((n, S))
        noise = rng.randint(0, V, (n, S))
        cls = np.empty((n, S), np.int64)
        for c in np.unique(y):
            m = y == c
            cls[m] = np.searchsorted(self._class_cdf[c], u[m], side="right")
        toks = np.where(sig < float(self.p["signal"]), cls, noise)
        return self._perms[domains[:, None], toks].astype(np.int32)

    def client_batches(self, i: int, batch_size: int, n: int) -> dict:
        """``n`` stacked minibatches of client ``i``: one draw of
        ``n·batch_size`` sequences, shaped ``(n, batch_size, seq_len)``."""
        rng = self._rng(int(i))
        k = n * batch_size
        y = rng.choice(len(self._label_cdf[0]), size=k,
                       p=self.client_label_p[int(i)])
        toks = self._tokens(rng, y, np.full(k, self.client_domain[int(i)]))
        return {"tokens": toks.reshape(n, batch_size, self.seq_len)}

    def cohort_batches(self, cohort, batch_size: int, n: int) -> dict:
        per = [self.client_batches(int(i), batch_size, n) for i in cohort]
        return {"tokens": np.stack([b["tokens"] for b in per])}

    def test_batch(self, batch_size=None) -> dict:
        """The held-out set: drawn once from the global mixture Σ α_i P_i."""
        if self._test_set is None:
            rng = self._heldout_rng
            n = int(self.p["test_samples"])
            owners = rng.choice(self.n_clients, size=n,
                                p=self.sizes / self.sizes.sum())
            u = rng.random_sample(n)
            y = np.empty(n, np.int64)
            for i in np.unique(owners):
                m = owners == i
                y[m] = np.searchsorted(self._label_cdf[i], u[m], side="right")
            self._test_set = {"tokens": self._tokens(
                rng, y, self.client_domain[owners])}
        n = batch_size or len(self._test_set["tokens"])
        return {k: v[:n] for k, v in self._test_set.items()}
