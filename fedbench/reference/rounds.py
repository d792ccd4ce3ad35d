"""The federated round in plain PyTorch and numpy (Algorithm 1 of the
paper the port reproduces): probe, layer selection (P1), τ masked local
SGD steps per client, Eq.(5)–(7) aggregation and the server's apply.

Weights live as a flat dict of bfloat16 tensors, one per leaf row (the
configurations' stated storage); every product runs in the precision of a
:class:`~fedbench.reference.numerics.Numerics`.  A local step stores
θ ← bf16(θ − η·m_l·g) for the selected layers (rounded once from float32);
Δ_i = (θ^{t,0} − θ^{t,τ}) / η in float32; the server takes
U = Σ_i w_{i,l} Δ_{i,l} with w_{i,l} = d_i m_i(l) / Σ_j d_j m_j(l) and stores
θ ← bf16(θ − η·U).  The (P1) solver is a copy of the paper's iterated
conditional modes (a greedy budgeted top-k per client, warm-started from
each client's previous masks).

``Federation.fault`` plants one fault where the reference stands in for
the program (the control's readings): ``"half_batch"`` (the loss over the
first half of each batch), ``"alter"`` (the first client's update of its
first selected layer doubled where it is produced), ``"frozen"`` (a round
that returns the weights unchanged).

Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# (P1): max Σ_i Σ_l m_i(l)‖g_{i,l}‖² − (λ/2) Σ_i Σ_{j≠i} ‖m_i − m_j‖₁, R(m_i) ≤ R_i
# ---------------------------------------------------------------------------

def pick_topk(util: np.ndarray, budget: float) -> np.ndarray:
    """Layers by utility, unit costs, until the budget is spent; never a
    non-positive utility past the first pick."""
    m = np.zeros(util.shape[0], np.float32)
    spent = 0.0
    for l in np.argsort(-util):
        if util[l] <= 0 and spent > 0:
            break
        if spent + 1.0 <= budget + 1e-9:
            m[l] = 1.0
            spent += 1.0
    return m


def objective(G: np.ndarray, masks: np.ndarray, lam: float) -> float:
    diff = np.abs(masks[:, None, :] - masks[None, :, :]).sum(-1)
    return float(np.sum(G * masks)) - 0.5 * lam * float(diff.sum()
                                                        - np.trace(diff))


def solve_icm(G: np.ndarray, budgets, lam: float, init=None,
              max_iters: int = 50) -> np.ndarray:
    n, _ = G.shape
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    masks = (init.astype(np.float32).copy() if init is not None else
             np.stack([pick_topk(G[i], budgets[i]) for i in range(n)]))
    for _ in range(max_iters):
        changed = False
        for i in range(n):
            others = masks.sum(0) - masks[i]
            new = pick_topk(G[i] - lam * ((n - 1) - 2.0 * others), budgets[i])
            if not np.array_equal(new, masks[i]):
                masks[i] = new
                changed = True
        if not changed:
            break
    return masks


def top_masks(n: int, L: int, budget: int) -> np.ndarray:
    masks = np.zeros((n, L), np.float32)
    masks[:, L - min(budget, L):] = 1.0
    return masks


class Selector:
    """The server's selection with the warm start the paper's server
    keeps: each client's last masks, unseen clients filled greedily."""

    def __init__(self, strategy: str, L: int, budget: int, lam: float):
        self.strategy, self.L, self.budget, self.lam = strategy, L, budget, lam
        self.warm: dict[int, np.ndarray] = {}

    def select(self, cohort, G) -> np.ndarray:
        n = len(cohort)
        if self.strategy == "top":
            return top_masks(n, self.L, self.budget)
        init = None
        if self.warm:
            init = np.stack([self.warm.get(int(i), pick_topk(G[r], self.budget))
                             for r, i in enumerate(cohort)])
        masks = solve_icm(G, self.budget, self.lam, init=init)
        for r, i in enumerate(cohort):
            self.warm[int(i)] = masks[r].copy()
        return masks


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------

def bf16_step(theta: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """θ − step, computed in float32 and stored as θ's bfloat16."""
    return (theta.float() - step).to(theta.dtype)


class Federation:
    """A federation's weights and the reference's round on them."""

    def __init__(self, family, c: dict, state: dict, fl: dict, num,
                 fault=None):
        self.family, self.c, self.fl, self.num = family, c, fl, num
        self.fault = fault
        self.state = dict(state)
        self.units = family.units(c)
        self.stack = family.stack(c, num)

    def _loss(self, tokens: torch.Tensor, want=None, state=None):
        if self.fault == "half_batch":
            tokens = tokens[: max(1, tokens.shape[0] // 2)]
        return self.stack.loss(self.state if state is None else state,
                               tokens, self.c, self.num, want)

    def probe(self, tokens: torch.Tensor) -> np.ndarray:
        """‖g_l‖² of every selectable layer on one batch (float64)."""
        _, g = self._loss(tokens, range(len(self.units)))
        return np.array([sum(float(g[k].double().square().sum()) for k in keys)
                         for keys in self.units])

    def client(self, tokens: torch.Tensor, mask: np.ndarray):
        """τ masked steps on a client's batches (τ, b, s): (Δ on its
        selected layers' keys, mean loss)."""
        lr = self.fl["lr"]
        want = [l for l in range(len(self.units)) if mask[l]]
        local = dict(self.state)
        losses = []
        for s in range(tokens.shape[0]):
            loss, g = self._loss(tokens[s], want, local)
            for k, gk in g.items():
                local[k] = bf16_step(local[k], lr * gk)
            losses.append(float(loss))
        delta = {k: (self.state[k].float() - local[k].float()) / lr
                 for l in want for k in self.units[l]}
        return delta, float(np.mean(losses)), want

    def round(self, tokens: torch.Tensor, masks: np.ndarray,
              sizes: np.ndarray):
        """One round step for the cohort: (per-client mean losses, the
        f32 aggregate update U by key)."""
        lr = self.fl["lr"]
        d = np.asarray(sizes, np.float64)[:, None] * masks
        denom = d.sum(0)
        w = np.where(denom > 0, d / np.where(denom > 0, denom, 1.0), 0.0)
        update: dict = {}
        losses = []
        for i in range(len(masks)):
            delta, loss, want = self.client(tokens[i], masks[i])
            losses.append(loss)
            if self.fault == "alter" and i == 0 and want:
                for k in self.units[want[0]]:
                    delta[k] = 2.0 * delta[k]
            for l in want:
                for k in self.units[l]:
                    term = float(w[i, l]) * delta[k]
                    update[k] = term if k not in update else update[k] + term
        if self.fault != "frozen":
            for k, u in update.items():
                self.state[k] = bf16_step(self.state[k], lr * u)
        return np.array(losses), update

    def evaluate(self, tokens: torch.Tensor, chunk: int = 4) -> float:
        parts = [float(self._loss(tokens[i:i + chunk])[0])
                 * len(tokens[i:i + chunk])
                 for i in range(0, len(tokens), chunk)]
        return sum(parts) / len(tokens)
