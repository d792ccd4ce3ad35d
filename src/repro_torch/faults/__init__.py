"""Deterministic fault injection and the degradation contracts (counterpart
of ``repro/faults``, DESIGN.md §12).

A :class:`FaultPlan` declares a rate for each fault class, a
:class:`FaultInjector` turns the rates into per-round draws from its own
seeded numpy streams, and the engines consult it at fixed sites: client
death and delta corruption in the round step, solver stalls in the select
stage, dispatch failures around the round step, checkpoint damage after a
save, and delta-upload and slot failures in serving.
``Experiment(faults=...)``, ``SlotServer(injector=...)`` and
``DeltaOverlay(injector=...)`` wire it in.

A wired but disabled injector (``FaultPlan(enabled=False)``) returns its
no-fault answer from every hook without touching a stream, so a run with
it is bit-identical to one without an injector.
"""
from repro_torch.faults.injector import (CKPT_CORRUPT_KINDS,  # noqa: F401
                                         CORRUPT_CODES, FaultInjector,
                                         FaultPlan, TransientFault,
                                         coerce_injector)

__all__ = ["CKPT_CORRUPT_KINDS", "CORRUPT_CODES", "FaultInjector",
           "FaultPlan", "TransientFault", "coerce_injector"]
