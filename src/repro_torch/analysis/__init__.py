"""The source linter, runtime strict mode and the program auditor
(counterpart of ``repro/analysis``).

    python -m repro_torch.analysis [lint] [paths...]      # src/repro_torch
    python -m repro_torch.analysis program [--json] [--device cpu|cuda]
                                   [--full-width] [--update-budgets]

The linter (:mod:`~repro_torch.analysis.engine`, ``rules``, ``callgraph``)
reads source only and imports the stdlib alone.  Strict mode
(``REPRO_STRICT=1``): :mod:`repro_torch.analysis.strict`.  The auditor
gates each program's facts on the contracts and on the budget manifest.
"""
from repro_torch.analysis.engine import (AnalysisConfig, Finding, RULES,
                                         run_files, run_paths)
from repro_torch.analysis import rules as _rules  # noqa: F401  (populates RULES)
from repro_torch.analysis.contracts import CONTRACTS, Violation, check_all
from repro_torch.analysis.facts import ProgramFacts, extract_facts
from repro_torch.analysis.program import (ProgramSpec, audit_models,
                                          audit_report, budgets_from_facts,
                                          check_budgets, enumerate_specs,
                                          load_budgets, run_audit,
                                          save_budgets)
from repro_torch.analysis.strict import (HostSyncError, RetraceSentinel,
                                         no_implicit_transfers,
                                         strict_enabled, strict_region)

__all__ = [
    "AnalysisConfig", "Finding", "RULES", "run_files", "run_paths",
    "CONTRACTS", "Violation", "check_all", "ProgramFacts", "extract_facts",
    "ProgramSpec", "audit_models", "audit_report", "budgets_from_facts",
    "check_budgets", "enumerate_specs", "load_budgets", "run_audit",
    "save_budgets", "HostSyncError", "RetraceSentinel",
    "no_implicit_transfers", "strict_enabled", "strict_region",
]
