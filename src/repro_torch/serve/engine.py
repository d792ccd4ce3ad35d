"""Device-side machinery for personalized-delta serving (counterpart of
``repro/serve/engine.py``, DESIGN.md §9).

:class:`DeltaOverlay` is the capacity-C per-layer delta entry table the
fused decode consumes.  Its device state is the reference's: ``{"slots":
(L, C) int32 owner slot ids (-1 = free), "leaves": {name: (L, C, *shape)
f32}}``, with a host ``slot_ids`` mirror that makes admit/release pure
bookkeeping.  Admitting a user writes only *their* delta rows, in place
(``copy_`` into the entry; the reference donates the table to a jitted
write); releasing a slot only marks its entries free — the kernel masks
stale rows by the -1 owner id.  With an ``injector`` each entry write
may fail (an injected ``TransientFault`` before the write); it is retried
up to ``max_upload_retries`` times, and an admit whose write still fails
is rolled back whole, so no user is ever half-admitted.  The reference's
``serve_suite`` and jit cache have no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.faults.injector import TransientFault
from repro_torch.models.model import Model, _block_shapes, supports_delta_decode
from repro_torch.serve.deltas import DeltaRecord


def check_device(model: Model, device) -> torch.device:
    """Resolve an entry point's ``device`` and hold it to the model's."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"device {dev} differs from the model's "
                         f"{model.device}")
    return dev


class DeltaOverlay:
    """Capacity-C per-layer delta entries over the ``blocks`` stack.

    ``injector`` (a ``repro_torch.faults.FaultInjector``, optional) makes
    entry writes failable: ``stats["upload_retries"]`` counts the retried
    writes, ``stats["failed_admits"]`` the admits rolled back."""

    def __init__(self, model: Model, capacity: int, *, injector=None,
                 max_upload_retries: int = 3, device="cuda"):
        self._device = check_device(model, device)
        if not supports_delta_decode(model.cfg):
            raise ValueError(
                f"family {model.cfg.family!r} has no delta-decode path")
        shapes = _block_shapes(model.cfg, "dense")   # per-layer leaf shapes
        L = model.cfg.n_layers
        self.capacity = int(capacity)
        self.leaves = {
            name: torch.zeros((L, self.capacity) + tuple(shp),
                              dtype=torch.float32, device=self._device)
            for name, shp in shapes.items()}
        self.slot_ids = np.full((L, self.capacity), -1, np.int32)
        self.entries: dict[int, list[tuple[int, int]]] = {}
        self._slots_dev = torch.tensor(self.slot_ids, device=self._device)
        self._dirty = False
        self.injector = injector
        self.max_upload_retries = int(max_upload_retries)
        self.stats = {"upload_retries": 0, "failed_admits": 0}
        self._upload_seq = 0     # monotone entry-write counter (fault lane)

    @property
    def n_entries(self) -> int:
        return int((self.slot_ids >= 0).sum())

    def try_admit(self, slot: int, record: Optional[DeltaRecord]) -> bool:
        """Claim one entry per selected layer for ``slot`` and write the
        delta rows.  Returns False, leaving no entry of ``slot`` live, if
        any layer's capacity is exhausted (the caller keeps the request
        queued) or an entry write fails past its retries."""
        self.release(slot)
        if record is None or record.n_layers == 0:
            self.entries[slot] = []
            return True
        extra = set(record.segments) - {"blocks"}
        if extra:
            raise ValueError(
                f"delta overlay only serves the 'blocks' stack, record "
                f"touches {sorted(extra)}")
        rows_idx, leaves = record.segments["blocks"]
        plan = []
        taken: dict[int, int] = {}
        # repro: allow[host-sync] -- admission control runs at delta-publish time on the host np row index, not per decode step
        for li in rows_idx.tolist():
            # repro: allow[host-sync] -- slot_ids is the overlay's host np owner table, no device value
            free = np.nonzero(self.slot_ids[li] < 0)[0].tolist()
            free = free[taken.get(li, 0):]
            if not free:
                return False
            taken[li] = taken.get(li, 0) + 1
            plan.append((li, free[0]))
        ent = []
        for j, (li, c) in enumerate(plan):
            if not self._upload_entry(j, li, c, leaves):
                # the write failed for good: free the entries this admit
                # already wrote (the -1 owner masks their rows)
                for rli, rc in ent:
                    self.slot_ids[rli, rc] = -1
                self.entries[slot] = []
                self._dirty = True
                self.stats["failed_admits"] += 1
                return False
            self.slot_ids[li, c] = slot
            ent.append((li, c))
        self.entries[slot] = ent
        self._dirty = True
        return True

    def _upload_entry(self, j: int, li: int, c: int, leaves: dict) -> bool:
        """Write delta row ``j`` into entry (li, c), retrying injected
        failures up to ``max_upload_retries`` times.  The failure fires
        before the write, so a failed attempt leaves the table as it was."""
        attempt = 0
        while True:
            seq = self._upload_seq
            self._upload_seq += 1
            try:
                if self.injector is not None and self.injector.enabled:
                    self.injector.maybe_fail_upload(seq)
            except TransientFault:
                attempt += 1
                if attempt > self.max_upload_retries:
                    return False
                self.stats["upload_retries"] += 1
                continue
            write_entry(self.leaves, li, c, {
                name: torch.from_numpy(
                    np.ascontiguousarray(leaves[name][j], np.float32))
                for name in self.leaves})
            return True

    def release(self, slot: int) -> None:
        for li, c in self.entries.pop(slot, []):
            self.slot_ids[li, c] = -1
            self._dirty = True

    def device(self) -> dict:
        """The ``delta`` argument for :meth:`Model.decode_step`."""
        if self._dirty:
            self._slots_dev = torch.tensor(self.slot_ids, device=self._device)
            self._dirty = False
        return {"slots": self._slots_dev, "leaves": self.leaves}


def stack_tree(tree: dict, n: int) -> dict:
    """n identical copies along a new leading axis (dense-baseline layout)."""
    return {k: stack_tree(v, n) if isinstance(v, dict)
            else v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
            for k, v in tree.items()}


def tree_slot(tree: dict, i: int) -> dict:
    """Views of entry ``i`` of every leaf of a stacked tree."""
    return {k: tree_slot(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# -- the serving programs (``SlotServer`` and the audit run these) ----------

def decode_shared(model: Model, params: dict, tokens, pos, cache,
                  window: int):
    """One decode step of every slot against the shared base params."""
    return model.decode_step(params, tokens, pos, cache, window=window)


def decode_delta(model: Model, params: dict, tokens, pos, cache,
                 delta: dict, window: int):
    """One decode step, every projection through base + the slot's live
    overlay entries (``DeltaOverlay.device()``)."""
    return model.decode_step(params, tokens, pos, cache, window=window,
                             delta=delta)


def decode_dense(model: Model, bank: dict, tokens, pos, cache,
                 window: int):
    """The dense baseline: slot i decodes against its private copy
    ``bank[i]`` with its batch-1 cache ``cache[i]`` (the reference vmaps
    over slots); the caches advance in place."""
    logits = torch.cat([
        model.decode_step(tree_slot(bank, i), tokens[i:i + 1],
                          pos[i:i + 1], tree_slot(cache, i),
                          window=window)[0]
        for i in range(tokens.shape[0])])
    return logits, cache


def write_params(bank: dict, params: dict, b: int) -> dict:
    """Set bank slot ``b`` to ``params``, in place (the dense refill)."""
    _set_slot(bank, params, b)
    return bank


def _set_slot(bank: dict, params: dict, b: int) -> None:
    for k, v in params.items():
        if isinstance(v, dict):
            _set_slot(bank[k], v, b)
        else:
            bank[k][b].copy_(v)


def write_entry(leaves: dict, li: int, c: int, rows: dict) -> dict:
    """Set entry (li, c) of every overlay leaf to the user's delta row, in
    place: an admit moves only its (k,)-layer rows, never the (L, C, …)
    table.  ``rows`` may lie on the host (an admit's upload)."""
    for name, leaf in leaves.items():
        leaf[li, c].copy_(rows[name])
    return leaves


# -- program-auditor enumeration hook ---------------------------------------

def serve_program_specs(model: Model, *, slots: int = 3, capacity: int = 2,
                        capacities: tuple = (1, 2, 3), max_seq: int = 16,
                        window: int = 0) -> list[dict]:
    """Audit specs for every serving program family (the reference's list).

    Shared decode and the dense per-slot baseline at batch ``slots`` and
    ``2·slots`` (the baseline's weight traffic must scale with B: the
    contrast that makes the delta contract meaningful), delta decode at
    both batches for each overlay capacity in ``capacities`` (the
    B-independence / C-linearity contract reads these), and the two
    donated writes: an overlay entry and a dense bank slot, in place.
    Every ``fn`` is the function the server itself runs
    (:func:`decode_shared`, :func:`decode_delta`, :func:`decode_dense`,
    :func:`write_entry`, :func:`write_params`), and the entry write takes
    its rows from the host, as an admit's upload does.

    Each entry's ``args`` is a zero-argument callable that builds concrete
    inputs on the model's device when the auditor runs it (params from
    ``model.init(0)``, one copy shared; per-slot caches; overlay entries
    owned round-robin by the slots), so a full-width audit holds one
    program's tables at a time.  Plain dicts.
    """
    cfg, dev = model.cfg, model.device
    params = model.init(0)
    L = cfg.n_layers

    def cache_for(b):
        return model.init_cache(b, max_seq, window=window, per_slot=True)

    def toks_pos(b):
        toks = torch.arange(b, dtype=torch.int32, device=dev) % cfg.vocab_size
        return toks, torch.zeros(b, dtype=torch.int32, device=dev)

    base = dict(donate_argnums=(), weight_argnums=(0,))
    common = {"single_host": True, "dtype": cfg.dtype}
    specs = []
    for b in (slots, 2 * slots):
        specs.append(dict(
            base, name=f"serve_decode/B{b}",
            fn=functools.partial(decode_shared, model),
            args=lambda b=b: (params, *toks_pos(b), cache_for(b), window),
            meta=dict(common, kind="serve_decode", batch=b)))
    if supports_delta_decode(cfg):
        shapes = _block_shapes(cfg, "dense")

        def overlay(b, C):
            owner = torch.arange(C, dtype=torch.int32, device=dev) % b
            return {"slots": owner[None].repeat(L, 1).contiguous(),
                    "leaves": {name: torch.zeros(
                        (L, C) + tuple(shp), dtype=torch.float32, device=dev)
                        for name, shp in shapes.items()}}
        for b in (slots, 2 * slots):
            for C in capacities:
                specs.append(dict(
                    base, name=f"serve_decode_delta/B{b}/C{C}",
                    fn=functools.partial(decode_delta, model),
                    args=lambda b=b, C=C: (params, *toks_pos(b),
                                           cache_for(b), overlay(b, C),
                                           window),
                    weight_argnums=(0, 4),
                    meta=dict(common, kind="serve_decode_delta", batch=b,
                              capacity=C)))
        specs.append(dict(
            base, name="serve_write_delta_entry", fn=write_entry,
            args=lambda: (
                {name: torch.zeros((L, capacity) + tuple(shp),
                                   dtype=torch.float32, device=dev)
                 for name, shp in shapes.items()}, L // 2, capacity - 1,
                {name: torch.ones(tuple(shp), dtype=torch.float32)
                 for name, shp in shapes.items()}),
            donate_argnums=(0,),
            meta=dict(common, kind="delta_write", donates=True)))
    for b in (slots, 2 * slots):
        specs.append(dict(
            base, name=f"serve_decode_dense/B{b}",
            fn=functools.partial(decode_dense, model),
            args=lambda b=b: (stack_tree(params, b), *toks_pos(b),
                              stack_tree(cache_for(1), b), window),
            meta=dict(common, kind="serve_decode_dense", batch=b)))
    specs.append(dict(
        base, name="serve_write_params", fn=write_params,
        args=lambda: (stack_tree(params, slots), params, 0),
        donate_argnums=(0,), weight_argnums=(0, 1),
        meta=dict(common, kind="dense_write", donates=True)))
    return specs
