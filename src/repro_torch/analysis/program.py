"""Program auditor: enumerate → run → extract facts → gate (counterpart of
``repro/analysis/program.py``, DESIGN.md §11).

The reference lowers every program family its jit-suite cache can hold on
shape-only inputs and reads the compiled programs.  The port has no jit
suite: a program here is a call of the port's entry point at fixed
arguments — the dense round step, every masked-cut variant, the probe, the
probe queued behind the update, the guarded step, the serve decode
programs (shared / delta / dense baseline) and the in-place delta and bank
writes — and the auditor runs each once on concrete inputs at the audit
sizes (:func:`repro_torch.analysis.facts.extract_facts`).  The contracts
(:mod:`repro_torch.analysis.contracts`) read the fact table.

The reference's second gate, the budget manifest
(``experiments/bench/PROGRAM_BUDGETS.json``: absolute per-program XLA
numbers), has no counterpart: eager numbers are not XLA's.

Audit configs are the reference's three ``reduced()`` variants (dense
TinyLlama and Mamba2 in f32, bf16 dense serving), chosen so block FLOPs
dominate the loss head; ``reduced=False`` audits the same three at full
width, Mamba2 at every sixth cut.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence


@dataclass
class ProgramSpec:
    """One auditable program: an entry point and a zero-argument callable
    building its concrete arguments (built when the audit runs it)."""
    name: str
    fn: Callable
    args: Callable[[], tuple]
    donate_argnums: tuple = ()
    weight_argnums: tuple = ()
    meta: dict = field(default_factory=dict)


def audit_models(device="cuda", reduced: bool = True) -> list[tuple]:
    """(label, Model, {train, serve[, cuts]}) triples for the audit.

    ``remat=False`` keeps the trained-layer cost at the paper's 3× forward
    (1 fwd + 2 bwd), the ratio the cut-monotone margins assume.
    """
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.configs.base import reduced as shrink
    from repro_torch.models.model import Model

    rt = RuntimeConfig(remat=False, seq_chunk=32)
    dense, ssm = get_arch("tinyllama_1_1b"), get_arch("mamba2_370m")
    ssm_what = {"train": True, "serve": False}
    if reduced:
        dense = shrink(dense, n_layers=4, d_model=64)
        ssm = shrink(ssm, n_layers=4, d_model=64)
    else:
        dense = dataclasses.replace(dense, dtype="float32")
        ssm = dataclasses.replace(ssm, dtype="float32")
        ssm_what["cuts"] = tuple(range(0, ssm.n_layers + 1, 6))
    bf16 = dataclasses.replace(dense, dtype="bfloat16")
    return [
        ("dense", Model(dense, rt, device=device),
         {"train": True, "serve": True}),
        ("ssm", Model(ssm, rt, device=device), ssm_what),
        ("dense_bf16", Model(bf16, rt, device=device),
         {"train": False, "serve": True}),
    ]


def enumerate_specs(models: Optional[list] = None, *,
                    device="cuda") -> list[ProgramSpec]:
    """Every audited program across the audit configs, name-prefixed by
    config label (``dense/fl_step_masked/cut2``, ...)."""
    from repro_torch.core.client import suite_program_specs
    from repro_torch.serve.engine import serve_program_specs

    specs: list[ProgramSpec] = []
    for label, model, what in (models if models is not None
                               else audit_models(device)):
        rows: list[dict] = []
        if what.get("train"):
            rows += suite_program_specs(model, cuts=what.get("cuts"))
        if what.get("serve"):
            rows += serve_program_specs(model)
        for r in rows:
            specs.append(ProgramSpec(
                name=f"{label}/{r['name']}", fn=r["fn"], args=r["args"],
                donate_argnums=tuple(r["donate_argnums"]),
                weight_argnums=tuple(r["weight_argnums"]),
                meta=dict(r["meta"], config=label)))
    return specs


def run_audit(specs: Optional[Sequence[ProgramSpec]] = None,
              progress: Optional[Callable[[str], None]] = None,
              device="cuda") -> dict:
    """Run + extract facts for every spec.  Returns {name: ProgramFacts}."""
    from repro_torch.analysis.facts import extract_facts

    if specs is None:
        specs = enumerate_specs(device=device)
    facts = {}
    for s in specs:
        if progress:
            progress(s.name)
        facts[s.name] = extract_facts(
            s.name, s.fn, s.args(), donate_argnums=s.donate_argnums,
            weight_argnums=s.weight_argnums, meta=s.meta)
    return facts


def audit_report(facts: dict, violations) -> dict:
    """The machine-readable report ``python -m repro_torch.analysis program
    --json`` prints."""
    return {
        "programs": {n: f.to_dict() for n, f in sorted(facts.items())},
        "violations": [v.to_dict() for v in violations],
        "ok": not violations,
    }
