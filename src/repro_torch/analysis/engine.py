"""Rule engine for the port's static invariant linter (counterpart of
``repro/analysis/engine.py``, DESIGN.md §10).

The port's performance rests on contracts no single test owns: no host
sync inside the round/serve loops (a CUDA graph may not sync either),
deterministic rng sourcing, a plain PyTorch version beside every Hopper
kernel, no per-call compilation or graph capture.  ``repro_torch.analysis``
encodes each as an AST rule over the port's source (``python -m
repro_torch.analysis``), with PyTorch's idioms where the reference reads
JAX's.

This module, :mod:`~repro_torch.analysis.rules` and
:mod:`~repro_torch.analysis.callgraph` import only the stdlib: the linter
reads source and touches no device.  The runtime complement is
:mod:`repro_torch.analysis.strict`.

Suppression keeps the reference's syntax, so one pragma serves both
linters: a pragma on the offending line or the line directly above it::

    nxt = logits.argmax(-1).tolist()   # repro: allow[host-sync] -- greedy feedback

The ``-- reason`` tail is mandatory — a pragma without one does **not**
suppress and is itself reported (rule id ``pragma``), as is a pragma
naming an unknown rule.  Unused pragmas are tolerated.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

PRAGMA_RE = re.compile(
    r"#\s*repro:\s*allow\[([^\]]*)\]\s*(?:--\s*(\S.*))?\s*$")

# engine-level rule id for malformed pragmas (not one of the contract rules)
PRAGMA_RULE = "pragma"


@dataclass(frozen=True)
class Finding:
    """One rule violation at ``path:line`` (path repo-relative)."""
    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass(frozen=True)
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: Optional[str]


@dataclass
class SourceFile:
    """A parsed file plus its suppression pragmas."""
    path: str                      # absolute
    rel: str                       # repo-relative, '/'-separated
    text: str
    tree: ast.Module
    pragmas: dict[int, Pragma] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, rel: str) -> "SourceFile":
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        sf = cls(path=path, rel=rel, text=text,
                 tree=ast.parse(text, filename=rel))
        for i, line in enumerate(text.splitlines(), start=1):
            m = PRAGMA_RE.search(line)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                sf.pragmas[i] = Pragma(line=i, rules=rules,
                                       reason=m.group(2))
        return sf

    def allowed(self, rule: str, line: int) -> bool:
        """Is ``rule`` suppressed at ``line`` (same line or line above)?
        Only well-formed pragmas (with a reason) suppress."""
        for ln in (line, line - 1):
            p = self.pragmas.get(ln)
            if p is not None and p.reason and rule in p.rules:
                return True
        return False


_PORT = "src/repro_torch/"


@dataclass
class AnalysisConfig:
    """Knobs the rules read; tests override these to point at fixtures."""
    # jit-outside-cache: modules sanctioned to build compiled or captured
    # callables outside module scope (the reference's jit-suite modules)
    jit_sanctioned: tuple[str, ...] = (
        _PORT + "core/client.py",
        _PORT + "serve/engine.py",
        _PORT + "sharding/",
    )
    # host-sync: hot-loop entry points, matched against "Class.method" /
    # bare function qualnames; reachability stops at the host-stage
    # boundary (the pipeline's plan/sample/checkpoint stages, which by
    # contract overlap the in-flight device work)
    hot_entry_points: tuple[str, ...] = (
        "RoundScheduler.run",
        "SlotServer.run",
    )
    host_stage_boundary: frozenset = frozenset({
        "plan_round", "sample_round", "save_state", "restore_state",
        "_next_barrier", "_print_round", "_is_ckpt_round",
        # the fault path materialises survivor/quarantine masks at the
        # round boundary by design (DESIGN.md §12)
        "_update_round_faulty",
    })
    # nondeterminism: round/selection/state code where the flat rng
    # streams and explicit generators are the only sanctioned entropy
    nondet_scope: tuple[str, ...] = tuple(_PORT + d for d in (
        "core/", "data/", "api/", "serve/", "ckpt/", "launch/", "faults/"))
    # exception-swallow: failure-handling code where a silently swallowed
    # exception would defeat the degradation contracts (DESIGN.md §12)
    swallow_scope: tuple[str, ...] = tuple(_PORT + d for d in (
        "core/", "ckpt/", "serve/", "faults/", "launch/"))
    # kernel-parity: Hopper kernel modules and where their contracts live
    kernel_dir: str = _PORT + "kernels/"
    kernel_exclude: tuple[str, ...] = ("ops.py", "_build.py", "__init__.py")
    kernel_dispatch: str = _PORT + "kernels/ops.py"
    kernel_sources: str = _PORT + "kernels/csrc/"
    # every file matching this glob, read as one text
    kernel_tests: str = "tests/test_torch_*.py"
    kernel_smoke: str = "chip_smoke.py"


class Context:
    """Shared analysis state: every scanned file + the project call graph."""

    def __init__(self, files: list[SourceFile], config: AnalysisConfig,
                 repo_root: str):
        self.files = files
        self.config = config
        self.repo_root = repo_root
        self.by_rel = {f.rel: f for f in files}
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from repro_torch.analysis.callgraph import CallGraph
            self._callgraph = CallGraph.build(self.files)
        return self._callgraph

    def read_rel(self, rel: str) -> Optional[str]:
        """Source text of a repo-relative path — from the scanned set if
        present, else from disk (tests/ are not scanned but rules may need
        to look at them)."""
        sf = self.by_rel.get(rel)
        if sf is not None:
            return sf.text
        path = os.path.join(self.repo_root, rel)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                return fh.read()
        return None

    def exists(self, rel: str) -> bool:
        return os.path.exists(os.path.join(self.repo_root, rel))


# -- rule registry -----------------------------------------------------------

RULES: dict[str, "Rule"] = {}


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: Callable[[SourceFile, Context], Iterable[Finding]]


def register_rule(name: str, doc: str):
    def deco(fn):
        RULES[name] = Rule(name=name, doc=doc, check=fn)
        return fn
    return deco


def _ensure_rules_loaded() -> None:
    if not RULES:
        from repro_torch.analysis import rules as _rules  # noqa: F401


# -- runner ------------------------------------------------------------------

def collect_files(paths: list[str], repo_root: str) -> list[SourceFile]:
    out: list[SourceFile] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isfile(ap):
            found = [ap]
        else:
            found = sorted(
                os.path.join(dp, fn)
                for dp, _, fns in os.walk(ap) for fn in fns
                if fn.endswith(".py"))
        for f in found:
            rel = os.path.relpath(f, repo_root).replace(os.sep, "/")
            out.append(SourceFile.parse(f, rel))
    return out


def pragma_findings(sf: SourceFile) -> list[Finding]:
    """Engine-level validation of the file's pragmas: a reason is
    mandatory, and every named rule must exist."""
    _ensure_rules_loaded()
    out = []
    for p in sf.pragmas.values():
        if not p.reason:
            out.append(Finding(
                sf.rel, p.line, PRAGMA_RULE,
                "allow[...] pragma is missing its ' -- reason' tail "
                "(reasonless suppressions are rejected)"))
        for r in p.rules:
            if r not in RULES:
                out.append(Finding(
                    sf.rel, p.line, PRAGMA_RULE,
                    f"pragma names unknown rule {r!r} "
                    f"(known: {', '.join(sorted(RULES))})"))
    return out


def run_files(files: list[SourceFile], repo_root: str,
              config: Optional[AnalysisConfig] = None,
              only: Optional[Iterable[str]] = None) -> list[Finding]:
    _ensure_rules_loaded()
    config = config or AnalysisConfig()
    ctx = Context(files, config, repo_root)
    names = list(only) if only else sorted(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; "
                         f"known: {sorted(RULES)}")
    findings: list[Finding] = []
    for sf in files:
        findings.extend(pragma_findings(sf))
        for name in names:
            for f in RULES[name].check(sf, ctx):
                if not sf.allowed(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_paths(paths: list[str], repo_root: Optional[str] = None,
              config: Optional[AnalysisConfig] = None,
              only: Optional[Iterable[str]] = None) -> list[Finding]:
    """Lint ``paths`` (files or directories); returns sorted findings."""
    root = repo_root or os.getcwd()
    return run_files(collect_files(paths, root), root, config, only)
