"""Functional optimizers over nested dicts of tensors (counterpart of
``repro/optim/optimizers.py``).

The paper's algorithm is plain SGD (Eq. 3/6); AdamW is for the pretraining
that stands in for the foundation-model checkpoint (``data/pretrain.py``).
Each optimizer is an ``init(params) -> state`` / ``update(grads, state,
params) -> (updates, state)`` pair, applied as ``p + u``
(:func:`apply_updates`), and keeps the reference's rounding order: AdamW's
moments are f32, the step is computed in f32 and cast to the param's dtype,
then added.  ``torch.optim.AdamW`` rounds a bf16 param at other points, so
it would not hold to the reference.

AdamW's step count ``t`` is a 0-d int32 tensor on the CPU, and the bias
corrections are computed there as f32 scalars (the reference's
``1 - b ** t`` in f32), so an update never reads a value back from the card.
A Python scalar meets a tensor as the reference's weakly typed scalar does:
rounded to the tensor's dtype first (:func:`_scalar`); the bias
corrections divide as 0-d tensors on the moments' device (CUDA divides by a
host scalar through its reciprocal, which rounds differently).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[dict], dict]
    update: Callable[..., tuple[dict, dict]]
    # update(grads, state, params) -> (updates, new_state); apply as p + u


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d CPU tensor of ``like``'s dtype."""
    return torch.tensor(x, dtype=like.dtype)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: _scalar(momentum, m) * m
                          + g.to(m.dtype), state["mu"], grads)
            return tree_map(lambda m: _scalar(-lr, m) * m, mu), {"mu": mu}
        return tree_map(lambda g: _scalar(-lr, g) * g, grads), state

    return Optimizer(init, update)


def _bias_correction(b: float, t: torch.Tensor) -> float:
    """``1 - b ** t`` as an f32 scalar, computed on the CPU."""
    # repro: allow[host-sync] -- t and the result are CPU tensors, no device value
    return (1 - torch.tensor(b, dtype=torch.float32)
            ** t.to(torch.float32)).item()


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "v": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        bc1 = _bias_correction(b1, t)
        bc2 = _bias_correction(b2, t)

        def u(m_, v_, p):
            c1, c2 = (torch.full((), c, dtype=torch.float32,
                                 device=m_.device) for c in (bc1, bc2))
            step = m_ / c1 / ((v_ / c2).sqrt() + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        return tree_map(u, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0):
    """``lr_at(step)``: linear warm-up, then a cosine decay to 0 at
    ``total_steps``; an f32 0-d CPU tensor, as the reference's f32 scalar."""
    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))
    return lr_at
