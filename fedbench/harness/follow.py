"""Drive the reference over a federation's first rounds, and replay the
program's plan for the control.

:func:`follow` runs the reference's rounds on the inputs a candidate saw
(cohorts, token batches, sizes) and, unless it chooses them itself
(``selector``), the candidate's masks, and returns its trajectory in the
form :mod:`fedbench.harness.readings` compares.  :func:`plan_inputs`
draws the rounds' inputs as the program's server does with no plan-stage
hooks: the cohort from a ``RandomState`` of the federation's seed, then
each round's probe batches and update batches from the traffic.
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.harness.weights import flat_rows
from fedbench.reference.numerics import Numerics
from fedbench.reference.rounds import Federation


@torch.no_grad()
def moving(update: torch.Tensor, theta: torch.Tensor) -> int:
    """Elements of ``update`` at least half an ulp of the bfloat16 weight
    it is added to (the ones that can move it; any, on a zero weight)."""
    _, e = torch.frexp(theta.float())
    half_ulp = torch.where(theta == 0, 0.0, torch.ldexp(
        torch.ones_like(update), e - 9))
    return int(((update != 0) & (update.abs() >= half_ulp)).sum())


@torch.no_grad()
def flat_change_norms(new: dict, old: dict) -> dict:
    out = {}
    for k, t in old.items():
        out[k] = 0.0 if new[k] is t else float(
            (new[k].float() - t.float()).norm())
    return out


def plan_inputs(traffic: dict, task, fl_seed: int, rounds: int) -> list:
    fl = traffic["fl"]
    rng = np.random.RandomState(fl_seed)
    n = len(task.sizes)
    k = min(fl["cohort_size"], n)
    out = []
    for _ in range(rounds):
        cohort = rng.choice(n, size=k, replace=False)
        probe = (task.cohort_batches(cohort, fl["batch_size"],
                                     fl["selection_batches"])["tokens"]
                 if traffic["strategy"] != "top" else None)
        update = task.cohort_batches(cohort, fl["batch_size"],
                                     fl["local_steps"])["tokens"]
        out.append({"cohort": cohort, "probe_ids": cohort,
                    "probe_tokens": probe, "update_tokens": update,
                    "sizes": task.sizes[cohort], "masks": None})
    return out


def follow(family, c: dict, params0: dict, inputs: list, test_tokens,
           fl: dict, device, num: Numerics = None, fault=None,
           selector=None) -> dict:
    """The reference's (or, with ``num``/``fault``/``selector``, the
    control's) trajectory over ``inputs``."""
    num = num or Numerics("f32")
    state0 = flat_rows(params0)
    fed = Federation(family, c, state0, fl, num, fault)
    lr = fl["lr"]

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)
    rounds, acc, traj = [], {}, {}
    for r, inp in enumerate(inputs):
        G = None
        if inp["probe_tokens"] is not None:
            G = np.stack([np.mean([fed.probe(dev(b)) for b in row], axis=0)
                          for row in inp["probe_tokens"]])
        masks = (np.asarray(inp["masks"], np.float32) if selector is None
                 else selector.select(inp["cohort"], G))
        losses, update = fed.round(dev(inp["update_tokens"]), masks,
                                   inp["sizes"])
        rounds.append({"cohort": inp["cohort"], "probe_ids": inp["probe_ids"],
                       "G": G, "masks": masks, "losses": losses,
                       "eval_loss": fed.evaluate(dev(test_tokens))})
        for k, u in update.items():
            acc[k] = lr * u if k not in acc else acc[k] + lr * u
        if r == 0:
            traj["change1"] = flat_change_norms(fed.state, state0)
            traj["update1"] = {k: (float((lr * u).norm()),
                                   moving(lr * u, state0[k]))
                               for k, u in update.items()}
    traj["rounds"] = rounds
    traj["change"] = flat_change_norms(fed.state, state0)
    traj["update"] = {k: (float(u.norm()), moving(u, state0[k]))
                       for k, u in acc.items()}
    return traj
