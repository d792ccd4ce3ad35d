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

The second gate is the budget manifest: per program its FLOPs, weight,
argument and peak temporary bytes, and each Hopper kernel's launches,
against committed values with per-key tolerances (the reference's
``experiments/bench/PROGRAM_BUDGETS.json`` holds XLA's numbers, so the
port keeps manifests of its own under ``analysis/budgets/``): the reduced
audit on the CPU (``cpu_reduced.json``, diffed by the tests) and the
full-width audit on the H100 (``h100_full_width.json``, diffed by
``chip_smoke.py``).  Refresh one with ``python -m repro_torch.analysis
program --update-budgets`` on its device and width.

Audit configs are the reference's three ``reduced()`` variants (dense
TinyLlama and Mamba2 in f32, bf16 dense serving), chosen so block FLOPs
dominate the loss head; ``reduced=False`` audits the same three at full
width, Mamba2 at every sixth cut.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

BUDGETS_DIR = os.path.join(os.path.dirname(__file__), "budgets")
CPU_REDUCED_BUDGETS = os.path.join(BUDGETS_DIR, "cpu_reduced.json")
H100_FULL_WIDTH_BUDGETS = os.path.join(BUDGETS_DIR, "h100_full_width.json")

# Relative drift allowed per budget key before the gate fails, the
# reference's for its keys that have an eager counterpart.  ``hbm_bytes``
# is XLA's fusion-boundary traffic and 0 here (facts.py), so it is not
# budgeted.  ``kernel_launches`` (per kernel name) is held exactly: launches
# are what a launch-bound program spends.  ``temp_bytes`` is 0 on the CPU.
BUDGET_TOLERANCES = {
    "flops": 0.10,
    "weight_bytes": 0.10,
    "arg_bytes": 0.25,
    "temp_bytes": 0.60,
    "kernel_launches": 0.0,
}
BUDGET_KEYS = tuple(BUDGET_TOLERANCES)


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


# -- budget manifest ---------------------------------------------------------

def default_budgets_path(device, reduced: bool) -> Optional[str]:
    """The committed manifest for a device and width: the CPU at reduced
    widths, the card at full width; None for the other pairings."""
    kind = str(device).split(":")[0]
    if kind == "cpu" and reduced:
        return CPU_REDUCED_BUDGETS
    if kind == "cuda" and not reduced:
        return H100_FULL_WIDTH_BUDGETS
    return None


def device_line(device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if str(device).split(":")[0] == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def budgets_from_facts(facts: dict, *, device="cpu",
                       reduced: bool = True) -> dict:
    import torch
    width = "" if reduced else " --full-width"
    return {
        "_meta": {
            "tolerances": dict(BUDGET_TOLERANCES),
            "torch_version": torch.__version__,
            "device": device_line(device),
            "refresh": f"PYTHONPATH=src python -m repro_torch.analysis "
                       f"program --device {str(device).split(':')[0]}"
                       f"{width} --update-budgets",
        },
        "programs": {name: budget_row(f)
                     for name, f in sorted(facts.items())},
    }


def budget_row(f) -> dict:
    """One program's manifest entry: its facts under :data:`BUDGET_KEYS`."""
    return {k: (dict(sorted(getattr(f, k).items()))
                if k == "kernel_launches" else getattr(f, k))
            for k in BUDGET_KEYS}


def load_budgets(path: str = CPU_REDUCED_BUDGETS) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def save_budgets(facts: dict, path: str = CPU_REDUCED_BUDGETS, *,
                 device="cpu", reduced: bool = True) -> dict:
    manifest = budgets_from_facts(facts, device=device, reduced=reduced)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return manifest


def budget_drifts(f, row: dict):
    """(label, key, budget, audited, relative drift) for every budgeted
    value of one program: each scalar key, and ``kernel_launches[name]``
    for every kernel in the budget or the facts (a missing one counts 0).
    Drift is relative to ``max(|budget|, 1)``."""
    for key, want in row.items():
        have = getattr(f, key, None)
        if have is None:
            continue
        if isinstance(want, dict):
            pairs = [(f"{key}[{k}]", want.get(k, 0), have.get(k, 0))
                     for k in sorted(set(want) | set(have))]
        else:
            pairs = [(key, want, have)]
        for label, w, h in pairs:
            yield label, key, w, h, abs(h - w) / max(abs(w), 1.0)


def check_budgets(facts: dict, manifest: dict) -> list[str]:
    """Diff audited facts against a manifest.

    New/vanished programs are drift too: a program silently falling out of
    the audit is exactly the kind of regression the gate exists to catch.
    """
    failures: list[str] = []
    tols = dict(BUDGET_TOLERANCES,
                **manifest.get("_meta", {}).get("tolerances", {}))
    committed = manifest.get("programs", {})
    for name in sorted(set(facts) - set(committed)):
        failures.append(f"{name}: audited but missing from manifest "
                        f"(new program? run --update-budgets)")
    for name in sorted(set(committed) - set(facts)):
        failures.append(f"{name}: in manifest but no longer audited "
                        f"(vanished program? run --update-budgets)")
    for name in sorted(set(facts) & set(committed)):
        for label, key, want, have, drift in budget_drifts(
                facts[name], committed[name]):
            tol = tols.get(key, 0.25)
            if drift > tol:
                failures.append(
                    f"{name}: {label} drifted {drift:+.1%} beyond ±{tol:.0%} "
                    f"(budget {want:.3g}, audited {have:.3g})")
    return failures


def audit_report(facts: dict, violations, budget_failures=()) -> dict:
    """The machine-readable report ``python -m repro_torch.analysis program
    --json`` prints."""
    return {
        "programs": {n: f.to_dict() for n, f in sorted(facts.items())},
        "violations": [v.to_dict() for v in violations],
        "budget_failures": list(budget_failures),
        "ok": not violations and not budget_failures,
    }
