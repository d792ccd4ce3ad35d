"""Batched serving loop: slot-based continuous batching over decode_step
(counterpart of ``repro/launch/serve.py``).

A fixed pool of B slots, each holding one request; finished slots are
refilled from the queue without stalling the running batch.  The KV cache
is the ``per_slot`` layout, so every slot advances its own position.

Three personalization modes (DESIGN.md §9):

* ``shared`` — every request decodes against the base parameters.
* ``delta``  — per-user selected-layer deltas ride a capacity-C
  :class:`DeltaOverlay`; one decode serves slots with *different* users'
  deltas, every projection through the fused base+delta kernel.
* ``dense``  — the baseline: each slot holds the user's private
  full-parameter copy (materialised on refill), decoded slot by slot with
  batch-1 caches (the reference vmaps over slots).

With an ``injector`` (``repro_torch.faults``) decode slots may be struck
after a step: the slot is freed, its request loses its progress and is
requeued, and is dropped after ``max_slot_retries`` strikes; in delta mode
the overlay's entry writes may fail and are retried (DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --arch tinyllama-1.1b --slots 4 --requests 10 --mode delta
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
from repro_torch.core.aggregation import add_delta_rows_
from repro_torch.models.model import Model
from repro_torch.serve import DeltaOverlay, DeltaStore, stack_tree
from repro_torch.serve.engine import (check_device, decode_delta,
                                      decode_dense, decode_shared, tree_slot,
                                      write_params)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    user_id: int = -1                       # -1: anonymous (base params)
    generated: list[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class SlotServer:
    """B decode slots over :meth:`Model.decode_step`.

    ``mode``: "shared" | "delta" | "dense" (see module docstring); the
    latter two look requests' ``user_id`` up in ``store``.  A request that
    cannot be admitted after ``admit_retries`` attempts, or whose slot is
    struck more than ``max_slot_retries`` times, is dropped
    (``self.dropped``) instead of livelocking the loop.
    """

    def __init__(self, model: Model, params: dict, slots: int, max_seq: int,
                 window: int = 0, *, mode: str = "shared",
                 store: Optional[DeltaStore] = None, capacity: int = 0,
                 admit_retries: int = 16, max_slot_retries: int = 2,
                 injector=None, device="cuda"):
        self.device = check_device(model, device)
        if mode not in ("shared", "delta", "dense"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "shared" and store is None:
            raise ValueError(f"mode={mode!r} needs a DeltaStore")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.window = window
        self.mode = mode
        self.store = store
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)        # per-slot position
        self.admit_retries = int(admit_retries)
        self.max_slot_retries = int(max_slot_retries)
        self.injector = injector
        self.dropped: list[Request] = []
        self._admit_attempts: dict[int, int] = {}   # rid -> failed admits
        self._fail_counts: dict[int, int] = {}      # rid -> slot strikes
        self._dropped_requests = 0
        self._slot_failures = 0
        if mode == "dense":
            # per-slot state: private params + a batch-1 cache per slot
            self.bank = stack_tree(params, slots)
            self.cache = stack_tree(
                model.init_cache(1, max_seq, window=window, per_slot=True),
                slots)
        else:
            self.cache = model.init_cache(slots, max_seq, window=window,
                                          per_slot=True)
            self.overlay = (DeltaOverlay(model, capacity or slots,
                                         injector=injector,
                                         device=self.device)
                            if mode == "delta" else None)

    def _record(self, req: Request):
        if self.store is None or req.user_id < 0:
            return None
        return self.store.get(req.user_id)

    def _free(self, i: int) -> None:
        self.active[i] = None
        if self.mode == "delta":
            self.overlay.release(i)

    def _drop(self, req: Request, why: str) -> None:
        self.dropped.append(req)
        self._dropped_requests += 1
        self._admit_attempts.pop(req.rid, None)
        self._fail_counts.pop(req.rid, None)
        print(f"  dropping request {req.rid} (user {req.user_id}): {why}")

    def _admit(self, queue: list[Request]):
        for i in range(self.slots):
            if self.active[i] is not None or not queue:
                continue
            if self.mode == "delta":
                req = None
                while queue:
                    head = queue[0]
                    if self.overlay.try_admit(i, self._record(head)):
                        req = queue.pop(0)
                        break
                    # overlay full for this request: bounded retry, then drop
                    n = self._admit_attempts.get(head.rid, 0) + 1
                    self._admit_attempts[head.rid] = n
                    if n > self.admit_retries:
                        queue.pop(0)
                        self._drop(head, f"no overlay capacity after "
                                         f"{n - 1} admit attempts")
                        continue    # head dropped: try the next request
                    break           # keep queued; retry after a release
                if req is None:
                    continue        # nothing admissible for this slot now
            else:
                req = queue.pop(0)
            self._admit_attempts.pop(req.rid, None)
            # the repo linter follows calls by bare name, and the name
            # reset_slot would also reach the JAX package's helper
            reset_cache_slot = self.model.reset_slot
            if self.mode == "dense":
                # the user's private copy is built in the slot's bank entry
                # itself: the base params, then their delta rows added in
                # place, so no second full copy is ever alive (at
                # DeepSeek-V2-Lite's width the base and one bank slot take
                # 62.8 GB of the card's 80)
                write_params(self.bank, self.params, i)
                rec = self._record(req)
                if rec is not None:
                    add_delta_rows_(tree_slot(self.bank, i), rec.rows(),
                                    rec.leaves())
                reset_cache_slot(self.cache, i, stacked=True)
            else:
                reset_cache_slot(self.cache, i)
            self.active[i] = req
            self.pos[i] = 0

    def _decode(self, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        if self.mode == "shared":
            return decode_shared(self.model, self.params, toks, pos,
                                 self.cache, self.window)[0]
        if self.mode == "delta":
            return decode_delta(self.model, self.params, toks, pos,
                                self.cache, self.overlay.device(),
                                self.window)[0]
        return decode_dense(self.model, self.bank, toks, pos, self.cache,
                            self.window)[0]

    @torch.inference_mode()
    def run(self, requests: list[Request], verbose: bool = False):
        queue = list(requests)
        done: list[Request] = []
        steps = 0
        t0 = time.perf_counter()  # repro: allow[nondeterminism] -- serve wall-clock telemetry only
        while queue or any(r is not None for r in self.active):
            self._admit(queue)
            if queue and all(r is None for r in self.active):
                # nothing admitted onto an idle server: skip the decode; the
                # stuck head is dropped within admit_retries passes
                continue
            toks = np.zeros(self.slots, np.int32)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                p = self.pos[i]
                toks[i] = (r.prompt[p] if p < len(r.prompt)
                           else r.generated[-1])
            logits = self._decode(torch.from_numpy(toks).to(self.device),
                                  torch.from_numpy(self.pos).to(self.device))
            # repro: allow[host-sync] -- the serve loop's one sanctioned sync: greedy feedback, next token depends on this step's logits
            nxt = torch.argmax(logits, -1).cpu().tolist()
            steps += 1
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                self.pos[i] += 1
                if self.pos[i] >= len(r.prompt):
                    r.generated.append(nxt[i])
                if r.done or self.pos[i] >= self.max_seq - 1:
                    done.append(r)
                    self._free(i)
            if self.injector is not None and self.injector.enabled:
                # injected slot failures: the struck request loses its
                # progress and reruns from its prompt (admit resets the
                # position and cache), until its strikes run out
                struck = self.injector.slot_faults(steps, self.slots)
                for i in np.flatnonzero(struck).tolist():  # repro: allow[host-sync] -- struck is the injector's host np draw, no device value
                    r = self.active[i]
                    if r is None:
                        continue
                    self._slot_failures += 1
                    self._free(i)
                    n = self._fail_counts.get(r.rid, 0) + 1
                    self._fail_counts[r.rid] = n
                    if n > self.max_slot_retries:
                        self._drop(r, f"slot failed {n} times")
                    else:
                        r.generated.clear()
                        queue.append(r)
            if verbose and steps % 8 == 0:
                print(f"  step {steps}: {sum(x is not None for x in self.active)}"
                      f" active, {len(queue)} queued, {len(done)} done")
        dt = time.perf_counter() - t0  # repro: allow[nondeterminism] -- serve wall-clock telemetry only
        gen = sum(len(r.generated) for r in done)
        return done, {"steps": steps, "wall_s": dt, "gen_tokens": gen,
                      "tok_per_s": gen / dt if dt > 1e-9 else 0.0,
                      "dropped_requests": self._dropped_requests,
                      "slot_failures": self._slot_failures}


def demo_store(model: Model, params: dict, users: int, layers_per_user: int,
               seed: int = 0) -> DeltaStore:
    """A store of synthetic per-user deltas: small noise on a random
    selected-layer subset per user (stand-in for real FL output).  Draws
    exactly the reference's numbers from the same seed, leaf by leaf in
    ``params["blocks"]`` order, so the records are byte-identical."""
    cfg = model.cfg
    store = DeltaStore(cfg)
    rng = np.random.RandomState(seed)
    host = {name: leaf.float().cpu().numpy()
            for name, leaf in params["blocks"].items()}
    for uid in range(users):
        layers = rng.choice(cfg.n_layers, size=min(layers_per_user,
                                                   cfg.n_layers),
                            replace=False)
        idx = np.sort(layers).astype(np.int32)
        tuned = dict(params)
        tuned["blocks"] = {
            name: leaf
            + 0.01 * np.isin(np.arange(leaf.shape[0]), idx).reshape(
                (-1,) + (1,) * (leaf.ndim - 1))
            * rng.standard_normal(leaf.shape).astype(np.float32)
            for name, leaf in host.items()}
        store.put_from_params(uid, params, tuned, layers=idx)
    return store


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--mode", default="shared",
                    choices=["shared", "delta", "dense"])
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--delta-layers", type=int, default=2)
    ap.add_argument("--delta-capacity", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=32),
                  device=args.device)
    params = model.init(0)
    store = (demo_store(model, params, args.users, args.delta_layers)
             if args.mode != "shared" else None)
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size,
                                   args.prompt_len).tolist(), args.max_new,
                    user_id=(i % args.users if store else -1))
            for i in range(args.requests)]
    server = SlotServer(model, params, args.slots,
                        args.prompt_len + args.max_new + 1,
                        window=args.window, mode=args.mode, store=store,
                        capacity=args.delta_capacity, device=args.device)
    done, stats = server.run(reqs, verbose=True)
    print(f"served {len(done)} requests in {stats['steps']} steps "
          f"[mode={args.mode}, device={model.device}] "
          f"({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['gen_tokens']} tokens in {stats['wall_s']:.2f}s)")
    for r in done[:3]:
        print(f"  req {r.rid} (user {r.user_id}): gen={r.generated}")


if __name__ == "__main__":
    main()
