"""The benchmark's own wrappers around the program's calls, installed on
instances (the program is not edited):

* :class:`Recorder`, for the set-up's first rounds: the batches the
  traffic hands out, each select stage's inputs and masks, each round
  step's losses and the weights after the first one;
* :class:`SelectSpans`, for a traced window: the host seconds of each
  ``FLServer.select_round`` call (the (P1) solve and its bookkeeping, not
  the wait for the probe's statistics);
* :class:`LastRound`, for a traced window: the client calls of its last
  round that probes (of its last round, where none does), without their
  weights, to be replayed on the window's final weights under the
  profiler.
"""
from __future__ import annotations

import time

import numpy as np

from fedbench.harness.weights import change_norms


class Recorder:
    def __init__(self, server, task, params0: dict):
        self.server, self.task, self.params0 = server, task, params0
        self.batches, self.selects, self.losses = [], [], []
        self.change1 = None
        self._orig: set = set()

    def install(self) -> "Recorder":
        srv, client, task = self.server, self.server.client, self.task
        orig_batches = task.cohort_batches
        orig_select = srv.select_round
        orig_update = client.cohort_update_raw

        def cohort_batches(cohort, batch_size, n):
            out = orig_batches(cohort, batch_size, n)
            self.batches.append((np.array(cohort), n, out["tokens"].copy()))
            return out

        def select_round(plan, stats):
            masks = orig_select(plan, stats)
            self.selects.append({
                "cohort": np.array(plan.cohort),
                "probe_ids": np.array(plan.probe_ids),
                "sizes": np.array(plan.sizes),
                "G": None if stats is None
                else np.array(stats["grad_sq_norms"], np.float64),
                "masks": np.array(masks, np.float32)})
            return masks

        def cohort_update_raw(params, *args, **kw):
            new, losses = orig_update(params, *args, **kw)
            self.losses.append(losses.detach().float().cpu().numpy())
            if self.change1 is None:
                self.change1 = change_norms(new, self.params0)
            return new, losses

        task.cohort_batches = cohort_batches
        srv.select_round = select_round
        client.cohort_update_raw = cohort_update_raw
        self._orig = {(task, "cohort_batches"), (srv, "select_round"),
                      (client, "cohort_update_raw")}
        return self

    def remove(self) -> None:
        for obj, name in self._orig:
            delattr(obj, name)
        self._orig = set()

    def trajectory(self, history, params_end: dict,
                   needs_probe: bool) -> tuple[dict, list]:
        """The program's trajectory and the inputs it saw, round by round."""
        per = 2 if needs_probe else 1
        rounds, inputs = [], []
        for t, sel in enumerate(self.selects):
            probe = self.batches[per * t] if needs_probe else None
            upd = self.batches[per * t + per - 1]
            if not np.array_equal(upd[0], sel["cohort"]) or (
                    probe is not None
                    and not np.array_equal(probe[0], sel["probe_ids"])):
                raise RuntimeError(f"round {t}: the batches drawn do not "
                                   f"match the round's cohort")
            rec = history.records[t]
            rounds.append({"cohort": sel["cohort"],
                           "probe_ids": sel["probe_ids"], "G": sel["G"],
                           "masks": sel["masks"], "losses": self.losses[t],
                           "eval_loss": rec.test_loss})
            inputs.append({"cohort": sel["cohort"],
                           "probe_ids": sel["probe_ids"],
                           "probe_tokens": None if probe is None else probe[2],
                           "update_tokens": upd[2], "sizes": sel["sizes"],
                           "masks": sel["masks"]})
        traj = {"rounds": rounds, "change1": self.change1,
                "change": change_norms(params_end, self.params0)}
        return traj, inputs


class SelectSpans:
    def __init__(self, server):
        self.server = server
        self.seconds: list = []

    def install(self) -> "SelectSpans":
        orig = self.server.select_round

        def select_round(plan, stats):
            t0 = time.perf_counter()
            try:
                return orig(plan, stats)
            finally:
                self.seconds.append(time.perf_counter() - t0)
        self.server.select_round = select_round
        return self

    def remove(self) -> None:
        del self.server.select_round


def _lead(batches: dict) -> tuple:
    return tuple(next(iter(batches.values())).shape)


class LastRound:
    """One round's client calls, in the order the round loop made them: the
    round step (the update, fused with the next cohort's probe where the
    loop queues it so), any standalone probe, and the eval that closes the
    round."""
    CALLS = ("probe_update_cohort_raw", "cohort_update_raw",
             "probe_cohort_raw", "evaluate_raw")

    def __init__(self, client):
        self.client = client
        self.calls: list = []
        self._open: list = []
        self._depth = 0

    def install(self) -> "LastRound":
        for name in self.CALLS:
            setattr(self.client, name,
                    self._wrap(name, getattr(self.client, name)))
        return self

    def remove(self) -> None:
        for name in self.CALLS:
            delattr(self.client, name)

    def _wrap(self, name, orig):
        def call(params, *args, **kw):
            self._depth += 1
            try:
                return orig(params, *args, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self._note(name, args, kw)
        return call

    def _note(self, name, args, kw) -> None:
        self._open.append((name, args, kw))
        if name != "evaluate_raw":
            return
        probes = any("probe" in n for n, _, _ in self._open)
        if probes or not any("probe" in n for n, _, _ in self.calls):
            self.calls = self._open
        self._open = []

    def replay(self, params: dict) -> None:
        for name, args, kw in self.calls:
            getattr(self.client, name)(params, *args, **kw)

    def forwards(self) -> list:
        """The (batch, sequence) shape of each sequence batch the replayed
        calls run forward: τ per update client, one per probe client and
        selection batch, and the eval's."""
        out = []
        for name, args, _ in self.calls:
            batches = [args[0]] + ([args[4]] if name.startswith(
                "probe_update") else [])
            for b in batches:
                shape = _lead(b)
                if name == "evaluate_raw":
                    out.append(shape[:2])
                else:
                    out += [shape[2:4]] * (shape[0] * shape[1])
        return out
