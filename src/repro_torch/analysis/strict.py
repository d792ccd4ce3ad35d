"""Runtime tripwires: opt-in strict mode (counterpart of
``repro/analysis/strict.py``).

``REPRO_STRICT=1`` arms two tripwires that prove at run time what the
linter can only approximate:

* :func:`no_implicit_transfers` — no operation inside the region may make
  the host wait for the card.  On the card:
  ``torch.cuda.set_sync_debug_mode("error")`` (a blocking copy to the host,
  ``.item()``, ``nonzero``, a stream or device synchronise raise; waiting
  on a recorded event, as ``core.client.HostCopy`` does, stays legal, and
  so do explicit ``non_blocking`` copies).  On the CPU there is nothing to
  wait for, so two modes on the calling thread stand in for it and raise:
  a dispatch mode on the ops that would wait (``facts.host_sync_op``:
  ``_local_scalar_dense`` — ``.item()``, ``float(t)`` —, ``nonzero``, a
  boolean-mask index), and a torch-function mode on the readbacks that
  never reach the dispatcher there (``Tensor.cpu``, ``.numpy()``,
  ``.tolist()``, ``__array__``).  ``HostCopy.to_numpy``, the sanctioned
  readback, is the one exception on both.  What the CPU cannot see is a
  ``.to("cpu")`` (there it looks like any copy onto the "device") and a
  stream or device synchronise: only the card's mode catches those.
* :class:`RetraceSentinel` — snapshots ``kernels.ops.cache_stats()`` (the
  counterpart of ``jit_cache_stats()["programs"]``: the kernel libraries
  built or loaded and the per-shape caches) on entry and raises on exit if
  an entry grew: a steady-state loop builds and plans nothing new.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.facts import host_sync_op
from repro_torch.kernels.ops import cache_stats

STRICT_ENV = "REPRO_STRICT"


def strict_enabled() -> bool:
    return os.environ.get(STRICT_ENV, "").strip() not in ("", "0", "false")


class HostSyncError(RuntimeError):
    """An operation inside a strict region would wait for the card."""


class _HostSyncGuard(TorchDispatchMode):
    """Raises :class:`HostSyncError` on the ops the card's sync-debug mode
    flags (active on the thread that entered it)."""

    def __init__(self, label: str):
        super().__init__()
        self.label = label

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = host_sync_op(func, args, kwargs, card=False)
        if why is not None:
            raise HostSyncError(
                f"host sync inside {self.label}: {func} ({why}) would wait "
                f"for the card")
        return func(*args, **kwargs)


# Tensor methods that read a tensor back to the host without an op the
# dispatcher sees when the tensor already lies there (a CPU run):
_READBACKS = frozenset({torch.Tensor.cpu, torch.Tensor.numpy,
                        torch.Tensor.tolist, torch.Tensor.__array__})


class _HostReadGuard(TorchFunctionMode):
    """Raises :class:`HostSyncError` on a readback method called on the
    thread that entered it (on the card each would be a blocking copy)."""

    def __init__(self, label: str):
        super().__init__()
        self.label = label

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _READBACKS:
            raise HostSyncError(
                f"host sync inside {self.label}: Tensor.{func.__name__} "
                f"(blocking readback) would wait for the card")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_implicit_transfers(enabled: bool = True, label: str = "region",
                          device: Optional[str] = None):
    """Forbid host syncs inside the block (no-op if disabled).  ``device``
    picks the guard: ``"cuda"`` the sync-debug mode, ``"cpu"`` the dispatch
    guard; the default is the card when there is one."""
    if not enabled:
        yield
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return
    with _HostSyncGuard(label), _HostReadGuard(label):
        yield


class RetraceSentinel:
    """Assert the kernels built, loaded and planned nothing new across a
    region.

    >>> with RetraceSentinel("steady-state rounds"):
    ...     scheduler.run(params, T=4, verbose=False)
    """

    def __init__(self, label: str = "region", enabled: bool = True):
        self.label = label
        self.enabled = enabled
        self.before: dict[str, int] = {}
        self.after: dict[str, int] = {}

    @staticmethod
    def _programs() -> dict[str, int]:
        return cache_stats()

    def __enter__(self) -> "RetraceSentinel":
        if self.enabled:
            self.before = self._programs()
        return self

    def grown(self) -> dict[str, tuple[int, int]]:
        """cache -> (before, after) for every grown counter."""
        return {k: (self.before.get(k, 0), v)
                for k, v in self.after.items()
                if v > self.before.get(k, 0)}

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self.enabled or exc_type is not None:
            return
        self.after = self._programs()
        grown = self.grown()
        if grown:
            detail = ", ".join(f"{k}: {b}->{a}"
                               for k, (b, a) in sorted(grown.items()))
            raise AssertionError(
                f"retrace inside {self.label}: the kernels built or planned "
                f"anew ({detail}) — a steady-state hot loop must reuse "
                f"what it built")


@contextlib.contextmanager
def strict_region(label: str = "region", enabled: Optional[bool] = None,
                  device: Optional[str] = None):
    """Both tripwires at once; ``enabled=None`` reads REPRO_STRICT."""
    on = strict_enabled() if enabled is None else enabled
    with no_implicit_transfers(on, label, device), \
            RetraceSentinel(label, enabled=on):
        yield
