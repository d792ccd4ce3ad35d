"""CLI: the program auditor (counterpart of ``repro/analysis/__main__.py``'s
``program`` mode).

    python -m repro_torch.analysis program [--json] [--device cpu|cuda]

runs every program family of the three audit configs once, checks the
DESIGN.md §11 contracts, prints each program's facts and each violation,
and exits 1 on any.  ``--json`` prints a machine-readable report instead.
The reference's source linter (``lint``) reads JAX idioms and has no
counterpart here; its budget manifest neither.
"""
from __future__ import annotations

import argparse
import json
import sys


def program_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis program",
        description="Program auditor: run each program family once and "
                    "check the DESIGN.md §11 contracts.")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the programs run (default: %(default)s)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import contracts as C
    from repro_torch.analysis import program as P

    progress = (None if args.json else
                (lambda n: print(f"  running {n}", file=sys.stderr)))
    facts = P.run_audit(progress=progress, device=args.device)
    violations = C.check_all(facts)
    if args.json:
        print(json.dumps(P.audit_report(facts, violations), indent=1))
        return 1 if violations else 0
    for name, f in sorted(facts.items()):
        print(f"{name:44s} flops={f.flops:12.4g} "
              f"weight={f.weight_bytes:10.4g} "
              f"donate={f.donation_applied}/{f.donated_declared}")
    for v in violations:
        print(f"CONTRACT {v.contract} :: {v.program}: {v.message}")
    print(f"{len(facts)} programs audited, {len(violations)} contract "
          f"violation(s)", file=sys.stderr)
    return 1 if violations else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "program":
        return program_main(argv[1:])
    print("usage: python -m repro_torch.analysis program [--json] "
          "[--device cpu|cuda]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
