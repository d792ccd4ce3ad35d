"""CLI: the source linter and the program auditor (counterpart of
``repro/analysis/__main__.py``).

    python -m repro_torch.analysis [lint] [paths...] [--rule NAME ...]
                                   [--root DIR] [--list-rules] [--json]
    python -m repro_torch.analysis program [--json] [--device cpu|cuda]
                                   [--full-width] [--update-budgets]
                                   [--budgets PATH]

``lint`` (the default) reads source only and touches no device: it prints
``file:line rule message`` per finding over ``src/repro_torch`` (or the
paths given) and exits 1 if any exist.  ``program`` runs every program
family of the three audit configs once on ``--device`` (reduced widths, or
``--full-width``), checks the DESIGN.md §11 contracts, diffs the facts
against the budget manifest for that device and width (or ``--budgets``),
and exits 1 on a violation or a budget failure; ``--update-budgets``
rewrites the manifest from this audit instead.  ``--json`` prints a
machine-readable report for either mode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.engine import RULES, _ensure_rules_loaded, run_paths

DEFAULT_PATHS = ("src/repro_torch",)


def lint_main(argv) -> int:
    _ensure_rules_loaded()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis [lint]",
        description="Static invariant linter over the port (DESIGN.md §10).")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories (default: %(default)s)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                    help="run only this rule (repeatable)")
    ap.add_argument("--root", default=os.getcwd(),
                    help="repo root for relative paths (default: cwd)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name}: {RULES[name].doc}")
        return 0

    findings = run_paths(args.paths, repo_root=args.root, only=args.rules)
    if args.json:
        print(json.dumps({
            "findings": [{"path": f.path, "line": f.line, "rule": f.rule,
                          "message": f.message} for f in findings],
            "ok": not findings,
        }, indent=1))
        return 1 if findings else 0
    for f in findings:
        print(f.format())
    if findings:
        print(f"{len(findings)} finding(s) across "
              f"{len({f.path for f in findings})} file(s)", file=sys.stderr)
    return 1 if findings else 0


def program_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis program",
        description="Program auditor: run each program family once, check "
                    "the DESIGN.md §11 contracts and the budget manifest.")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the programs run (default: %(default)s)")
    ap.add_argument("--full-width", action="store_true",
                    help="audit the configs at full width, not reduced")
    ap.add_argument("--update-budgets", action="store_true",
                    help="refresh the budget manifest from this audit "
                         "instead of diffing against it")
    ap.add_argument("--budgets", default=None, metavar="PATH",
                    help="budget manifest path (default: the committed "
                         "manifest for the device and width, if any)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import contracts as C
    from repro_torch.analysis import program as P

    reduced = not args.full_width
    path = args.budgets or P.default_budgets_path(args.device, reduced)
    progress = (None if args.json else
                (lambda n: print(f"  running {n}", file=sys.stderr)))
    specs = P.enumerate_specs(P.audit_models(args.device, reduced=reduced))
    facts = P.run_audit(specs, progress=progress)
    violations = C.check_all(facts)

    budget_failures: list[str] = []
    if args.update_budgets:
        if path is None:
            print("error: no default manifest for this device and width; "
                  "pass --budgets PATH", file=sys.stderr)
            return 2
        P.save_budgets(facts, path, device=args.device, reduced=reduced)
        print(f"wrote {len(facts)} program budgets to {path}",
              file=sys.stderr)
    else:
        manifest = P.load_budgets(path) if path else None
        if manifest is None:
            print(f"note: no budget manifest for --device {args.device}"
                  f"{' --full-width' if args.full_width else ''}"
                  f"{f' at {path}' if path else ''} (run --update-budgets "
                  f"to create it); checking contracts only", file=sys.stderr)
        else:
            budget_failures = P.check_budgets(facts, manifest)

    if args.json:
        print(json.dumps(P.audit_report(facts, violations, budget_failures),
                         indent=1))
        return 1 if (violations or budget_failures) else 0
    for name, f in sorted(facts.items()):
        print(f"{name:44s} flops={f.flops:12.4g} "
              f"weight={f.weight_bytes:10.4g} "
              f"donate={f.donation_applied}/{f.donated_declared}")
    for v in violations:
        print(f"CONTRACT {v.contract} :: {v.program}: {v.message}")
    for msg in budget_failures:
        print(f"BUDGET {msg}")
    print(f"{len(facts)} programs audited, {len(violations)} contract "
          f"violation(s), {len(budget_failures)} budget failure(s)",
          file=sys.stderr)
    return 1 if (violations or budget_failures) else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "program":
        return program_main(argv[1:])
    if argv and argv[0] == "lint":
        argv = argv[1:]
    return lint_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
