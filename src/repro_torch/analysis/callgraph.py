"""Name-based project call graph for reachability rules (counterpart of
``repro/analysis/callgraph.py``).

The host-sync rule needs "functions reachable from the round/serve hot
loops".  Python's dynamism makes exact resolution impossible statically,
so this over-approximates the way review-time linters usually do: an edge
from function F to every function *named* like something F calls —
``self.probe_round(...)`` links to every ``def probe_round`` in the
scanned set, regardless of receiver type.  False edges make the rule
stricter (more sites need an explicit pragma), never looser, which is the
right failure mode for an invariant linter.

Reachability deliberately stops at the *host-stage boundary*
(``AnalysisConfig.host_stage_boundary``): plan/sample/checkpoint run on
the host by design, overlapped with the in-flight device program, so a
sync there costs nothing — the rule polices the dispatch segment only.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field


def _called_names(node: ast.AST) -> set[str]:
    """Last-segment names of everything ``node``'s body calls."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


@dataclass
class FunctionInfo:
    rel: str                       # file (repo-relative)
    qualname: str                  # e.g. "RoundScheduler.run" or "main"
    name: str                      # last segment
    node: ast.AST
    calls: set[str] = field(default_factory=set)


class CallGraph:
    def __init__(self, functions: list[FunctionInfo]):
        self.functions = functions
        self.by_name: dict[str, list[FunctionInfo]] = {}
        for fn in functions:
            self.by_name.setdefault(fn.name, []).append(fn)

    @classmethod
    def build(cls, files) -> "CallGraph":
        funcs: list[FunctionInfo] = []

        def visit(node, stack, rel):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = ".".join(stack + [child.name])
                    funcs.append(FunctionInfo(
                        rel=rel, qualname=qual, name=child.name,
                        node=child, calls=_called_names(child)))
                    visit(child, stack + [child.name], rel)
                elif isinstance(child, ast.ClassDef):
                    visit(child, stack + [child.name], rel)
                else:
                    visit(child, stack, rel)

        for sf in files:
            visit(sf.tree, [], sf.rel)
        return cls(funcs)

    def reachable(self, entry_points, boundary) -> list[FunctionInfo]:
        """Functions reachable from any entry point, not expanding through
        names in ``boundary``.  Entry points match on qualname suffix
        ("Class.method") or bare name."""
        seeds = [f for f in self.functions
                 if f.qualname in entry_points or f.name in entry_points]
        seen: set[int] = set()
        order: list[FunctionInfo] = []
        frontier = list(seeds)
        while frontier:
            fn = frontier.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            order.append(fn)
            for cname in fn.calls:
                if cname in boundary:
                    continue
                for target in self.by_name.get(cname, ()):
                    if id(target) not in seen:
                        frontier.append(target)
        return order
