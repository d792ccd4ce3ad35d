"""Runtime strict mode and the program auditor (counterpart of
``repro/analysis``).

    python -m repro_torch.analysis program [--json] [--device cpu|cuda]

Strict mode (``REPRO_STRICT=1``): :mod:`repro_torch.analysis.strict`.  The
reference's source linter reads JAX idioms and is not ported.
"""
from repro_torch.analysis.contracts import CONTRACTS, Violation, check_all
from repro_torch.analysis.facts import ProgramFacts, extract_facts
from repro_torch.analysis.program import (ProgramSpec, audit_models,
                                          audit_report, enumerate_specs,
                                          run_audit)
from repro_torch.analysis.strict import (HostSyncError, RetraceSentinel,
                                         no_implicit_transfers,
                                         strict_enabled, strict_region)

__all__ = [
    "CONTRACTS", "Violation", "check_all", "ProgramFacts", "extract_facts",
    "ProgramSpec", "audit_models", "audit_report", "enumerate_specs",
    "run_audit", "HostSyncError", "RetraceSentinel", "no_implicit_transfers",
    "strict_enabled", "strict_region",
]
