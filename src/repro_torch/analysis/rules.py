"""The port's contract rules (counterpart of ``repro/analysis/rules.py``,
DESIGN.md §10).

Each reference rule whose hazard exists in eager PyTorch keeps its id, with
PyTorch's idioms in place of JAX's:

* ``host-sync`` — the reference's rule over functions reachable from the
  hot loops, reading ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.synchronize()``, ``.nonzero()``, ``.to("cpu")``,
  ``torch.cuda.synchronize``, ``torch.unique``, ``torch.masked_select``,
  ``np.asarray`` / ``np.array`` and ``float()`` / ``int()`` / ``bool()`` of
  a non-literal.  The reference's ``tracer-hazard`` is folded in: eager
  code has no tracer, and an ``if`` / ``while`` on a tensor expression is
  an implicit ``bool()`` of a device value — a host sync;
* ``nondeterminism`` — stdlib ``random``, numpy's global generator and
  wall clocks as in the reference, plus torch's global generator
  (``torch.manual_seed``, the random factories and in-place samplers
  called without ``generator=``);
* ``exception-swallow`` — unchanged;
* ``kernel-parity`` — keyed on a kernel module that loads a Hopper
  library (``_build.load_library``) where the reference keys on
  ``pallas_call``;
* ``jit-outside-cache`` — ``torch.compile``, ``torch.jit.script`` /
  ``trace`` and CUDA-graph capture built inside a function outside the
  sanctioned modules.

Two reference rules have no eager counterpart and are not ported:
``unhashable-static`` (eager code has no static arguments and no program
cache keyed on them) and ``donation-miss`` (in-place writes are explicit
ops in eager code; the auditor's ``donation_applied`` fact holds them).
"""
from __future__ import annotations

import ast
import glob
import os
from typing import Iterable, Optional

from repro_torch.analysis.engine import (Context, Finding, SourceFile,
                                         register_rule)

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize'-style dotted name of a Name/Attribute
    chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name → canonical dotted module for every import in the file."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def canonical(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """Dotted chain with its head import-alias expanded: ``np.asarray`` →
    ``numpy.asarray`` under ``import numpy as np``."""
    d = dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    root = aliases.get(head, head)
    return f"{root}.{rest}" if rest else root


def walk_with_function(tree: ast.Module):
    """Yield ``(node, enclosing_function_node_or_None)`` for every node."""
    def rec(node, fn):
        for child in ast.iter_child_nodes(node):
            nfn = (child if isinstance(child, (ast.FunctionDef,
                                               ast.AsyncFunctionDef,
                                               ast.Lambda)) else fn)
            yield child, fn
            yield from rec(child, nfn)
    yield from rec(tree, None)


def _in_file(rel: str, prefixes: Iterable[str]) -> bool:
    return any(rel == p or rel.startswith(p) for p in prefixes)


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# ---------------------------------------------------------------------------
# Rule: jit-outside-cache
# ---------------------------------------------------------------------------

GRAPH_CTORS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
               "torch.cuda.CUDAGraph", "torch.cuda.graph",
               "torch.cuda.make_graphed_callables")


@register_rule(
    "jit-outside-cache",
    "torch.compile / torch.jit.script / torch.jit.trace and CUDA-graph "
    "capture (torch.cuda.CUDAGraph, torch.cuda.graph, "
    "make_graphed_callables) belong at module scope or in the sanctioned "
    "modules (core/client.py, serve/engine.py, sharding/); built inside a "
    "function elsewhere, each call compiles or captures anew and no cache "
    "keeps the result.")
def jit_outside_cache(sf: SourceFile, ctx: Context):
    if _in_file(sf.rel, ctx.config.jit_sanctioned):
        return
    aliases = import_aliases(sf.tree)
    for node, fn in walk_with_function(sf.tree):
        if fn is None:
            continue                    # module scope: built once per import
        if isinstance(node, ast.Call):
            exprs = [node.func]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            exprs = [d.func if isinstance(d, ast.Call) else d
                     for d in node.decorator_list]
        else:
            continue
        for e in exprs:
            name = canonical(e, aliases)
            if name in GRAPH_CTORS:
                yield Finding(
                    sf.rel, e.lineno, "jit-outside-cache",
                    f"{name} built inside "
                    f"{getattr(fn, 'name', '<lambda>')}() outside the "
                    f"sanctioned modules: each call compiles or captures "
                    f"anew (hoist it to module scope or a cache)")


# ---------------------------------------------------------------------------
# Rule: host-sync
# ---------------------------------------------------------------------------

SYNC_ATTR_CALLS = ("item", "tolist", "cpu", "numpy", "synchronize",
                   "nonzero")
SYNC_FUNCS = ("torch.cuda.synchronize", "torch.nonzero", "torch.unique",
              "torch.masked_select", "numpy.asarray", "numpy.array")
CASTS = ("float", "int", "bool")
# an `if`/`while` test calling one of these reads a device value
TENSOR_ATTR_TESTS = ("any", "all", "item")
# torch functions that read host state only (flags, dtypes, types)
HOST_QUERIES = ("torch.is_grad_enabled", "torch.is_inference_mode_enabled",
                "torch.is_autocast_enabled", "torch.is_tensor",
                "torch.is_floating_point", "torch.is_complex",
                "torch.cuda.is_available")


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` with a literal device."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = call.args[:1] + [kw.value for kw in call.keywords
                            if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
               and v.value.split(":")[0] == "cpu" for v in vals)


def _tensor_test(expr: ast.AST, aliases) -> Optional[str]:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            name = canonical(n.func, aliases)
            if (name and name.startswith("torch.")
                    and name not in HOST_QUERIES):
                return name
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in TENSOR_ATTR_TESTS:
                return f".{f.attr}()"
    return None


@register_rule(
    "host-sync",
    "No device→host synchronisation inside functions reachable from the "
    "round/serve hot loops: .item(), .tolist(), .cpu(), .numpy(), "
    ".synchronize(), .nonzero(), .to('cpu'), torch.cuda.synchronize, "
    "torch.unique, torch.masked_select, np.asarray/np.array and "
    "float()/int()/bool() of a non-literal stall the launch stream (and "
    "break CUDA-graph capture).  Folds in the reference's tracer-hazard: "
    "an `if`/`while` whose test calls torch.* or .any()/.all()/.item() "
    "is an implicit bool() of a device tensor, a host sync in eager code "
    "(torch's host-state queries such as torch.is_grad_enabled excepted).")
def host_sync(sf: SourceFile, ctx: Context):
    cfg = ctx.config
    reach = ctx.callgraph.reachable(set(cfg.hot_entry_points),
                                    cfg.host_stage_boundary)
    here = [f for f in reach if f.rel == sf.rel]
    if not here:
        return
    aliases = import_aliases(sf.tree)
    where = "/".join(cfg.hot_entry_points)
    for info in here:
        for node in ast.walk(info.node):
            if isinstance(node, (ast.If, ast.While)):
                hit = _tensor_test(node.test, aliases)
                if hit:
                    kw = "if" if isinstance(node, ast.If) else "while"
                    yield Finding(
                        sf.rel, node.lineno, "host-sync",
                        f"Python `{kw}` on a tensor expression ({hit}) in "
                        f"{info.qualname} is an implicit bool() of a device "
                        f"value: use torch.where, or decide on the host")
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in SYNC_ATTR_CALLS:
                yield Finding(
                    sf.rel, node.lineno, "host-sync",
                    f".{f.attr}() in {info.qualname} (reachable from "
                    f"{where}) forces a device sync in the hot path")
                continue
            if _to_cpu(node):
                yield Finding(
                    sf.rel, node.lineno, "host-sync",
                    f".to('cpu') in {info.qualname} (reachable from "
                    f"{where}) copies to the host and waits in the hot path")
                continue
            name = canonical(f, aliases)
            if name in SYNC_FUNCS:
                yield Finding(
                    sf.rel, node.lineno, "host-sync",
                    f"{name}(...) in {info.qualname} waits for the device "
                    f"inside the hot path — move it to a round boundary "
                    f"or annotate the sanctioned sync point")
            elif (isinstance(f, ast.Name) and f.id in CASTS and node.args
                  and not isinstance(node.args[0], ast.Constant)):
                yield Finding(
                    sf.rel, node.lineno, "host-sync",
                    f"{f.id}(...) on a non-literal in {info.qualname} "
                    f"blocks on the device value if it is a tensor")


# ---------------------------------------------------------------------------
# Rule: nondeterminism
# ---------------------------------------------------------------------------

SEEDED_CTORS = ("RandomState", "default_rng", "Generator", "SeedSequence")
TIME_FUNCS = ("time.time", "time.time_ns", "time.perf_counter",
              "time.monotonic")
TORCH_GLOBAL_SEED = ("torch.manual_seed", "torch.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all")
TORCH_RANDOM = tuple(f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson"))
TORCH_INPLACE_RANDOM = ("uniform_", "normal_", "bernoulli_", "random_",
                        "exponential_")


@register_rule(
    "nondeterminism",
    "Round/selection/state code draws entropy only from seeded, "
    "checkpointable streams (ClientStreamState, an explicit RandomState "
    "or torch.Generator): the global random module, wall clocks, numpy's "
    "global generator and torch's (torch.manual_seed, torch.rand*/"
    "randperm/normal/bernoulli/multinomial/poisson and Tensor.uniform_/"
    "normal_/bernoulli_/random_/exponential_ without generator=) break "
    "bit-exact resume and the engine-parity oracles.")
def nondeterminism(sf: SourceFile, ctx: Context):
    if not _in_file(sf.rel, ctx.config.nondet_scope):
        return
    aliases = import_aliases(sf.tree)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in TORCH_INPLACE_RANDOM
                and not _has_kw(node, "generator")):
            yield Finding(
                sf.rel, node.lineno, "nondeterminism",
                f".{f.attr}(...) without generator= draws from torch's "
                f"global generator — pass an explicitly seeded "
                f"torch.Generator")
            continue
        name = canonical(f, aliases)
        if name is None:
            continue
        if name.startswith("random."):
            yield Finding(
                sf.rel, node.lineno, "nondeterminism",
                f"stdlib {name}(...) uses the unseeded global generator — "
                f"draw from the server/task RandomState streams instead")
        elif name in TIME_FUNCS:
            yield Finding(
                sf.rel, node.lineno, "nondeterminism",
                f"{name}(...) is wall-clock state: fine for telemetry "
                f"(annotate it), never as an input to round math")
        elif name.startswith("numpy.random."):
            tail = name.rsplit(".", 1)[1]
            if tail not in SEEDED_CTORS:
                yield Finding(
                    sf.rel, node.lineno, "nondeterminism",
                    f"{name}(...) draws from numpy's global generator — "
                    f"use an explicitly seeded RandomState/stream")
            elif not node.args and not node.keywords:
                yield Finding(
                    sf.rel, node.lineno, "nondeterminism",
                    f"{name}() without a seed is entropy from the OS — "
                    f"pass an explicit seed")
        elif name in TORCH_GLOBAL_SEED:
            yield Finding(
                sf.rel, node.lineno, "nondeterminism",
                f"{name}(...) seeds torch's process-wide generator — "
                f"state every draw on an explicit torch.Generator")
        elif name in TORCH_RANDOM and not _has_kw(node, "generator"):
            yield Finding(
                sf.rel, node.lineno, "nondeterminism",
                f"{name}(...) without generator= draws from torch's "
                f"global generator — pass an explicitly seeded "
                f"torch.Generator")


# ---------------------------------------------------------------------------
# Rule: kernel-parity
# ---------------------------------------------------------------------------

def _read_glob(ctx: Context, pattern: str) -> str:
    texts = []
    for path in sorted(glob.glob(os.path.join(ctx.repo_root, pattern))):
        rel = os.path.relpath(path, ctx.repo_root).replace(os.sep, "/")
        texts.append(ctx.read_rel(rel) or "")
    return "\n".join(texts)


@register_rule(
    "kernel-parity",
    "Every Hopper kernel module (one under kernels/ that calls "
    "_build.load_library) ships a public plain PyTorch version "
    "(`*_torch`) beside its csrc/<module>.cu, is named by kernels/ops.py's "
    "dispatch, and has its name and every plain version named by the "
    "tests/test_torch_*.py files (held against the JAX kernel on the CPU) "
    "and its plain versions by chip_smoke.py (held against the kernel on "
    "the card) — a CUDA-only path is never the only implementation of "
    "round math.")
def kernel_parity(sf: SourceFile, ctx: Context):
    cfg = ctx.config
    if not sf.rel.startswith(cfg.kernel_dir):
        return
    base = sf.rel.rsplit("/", 1)[1]
    if base in cfg.kernel_exclude:
        return
    aliases = import_aliases(sf.tree)
    load_lines = [
        node.lineno for node in ast.walk(sf.tree)
        if isinstance(node, ast.Call)
        and (canonical(node.func, aliases) or "").endswith("load_library")]
    if not load_lines:
        return
    line = min(load_lines)
    stem = base[:-3]
    plains = [
        n.name for n in ast.walk(sf.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name.endswith("_torch") and not n.name.startswith("_")]
    if not plains:
        yield Finding(
            sf.rel, line, "kernel-parity",
            f"{base} loads a Hopper library but defines no public *_torch "
            f"plain version — the CPU has no reference for this kernel")
    source = f"{cfg.kernel_sources}{stem}.cu"
    if not ctx.exists(source):
        yield Finding(
            sf.rel, line, "kernel-parity",
            f"{base} loads a Hopper library but {source} does not exist")
    dispatch_src = ctx.read_rel(cfg.kernel_dispatch)
    if dispatch_src is not None and stem not in dispatch_src:
        yield Finding(
            sf.rel, line, "kernel-parity",
            f"{base} is not referenced by {cfg.kernel_dispatch} — the "
            f"kernel is unreachable from the ops dispatch")
    tests_src = _read_glob(ctx, cfg.kernel_tests)
    if stem not in tests_src:
        yield Finding(
            sf.rel, line, "kernel-parity",
            f"{base} has no matching parity coverage in "
            f"{cfg.kernel_tests} (module name never mentioned)")
    else:
        for fb in plains:
            if fb not in tests_src:
                yield Finding(
                    sf.rel, line, "kernel-parity",
                    f"plain version {fb}() is never exercised by "
                    f"{cfg.kernel_tests} — its parity with the JAX kernel "
                    f"is unpinned")
    smoke_src = ctx.read_rel(cfg.kernel_smoke) or ""
    for fb in plains:
        if fb not in smoke_src:
            yield Finding(
                sf.rel, line, "kernel-parity",
                f"plain version {fb}() is never named by {cfg.kernel_smoke} "
                f"— the kernel is not held against it on the card")


# ---------------------------------------------------------------------------
# Rule: exception-swallow  (the fault harness, DESIGN.md §12)
# ---------------------------------------------------------------------------

@register_rule(
    "exception-swallow",
    "failure-handling code in core/, ckpt/, serve/, faults/ and launch/ "
    "must not silently swallow exceptions: a bare 'except:' that never "
    "re-raises, or an 'except Exception/BaseException:' whose body is "
    "only pass/continue/..., hides exactly the faults the degradation "
    "contracts are supposed to surface (count, warn, fall back — never "
    "ignore).  Narrow the handler to the expected types, or pragma the "
    "reason swallowing is genuinely safe.")
def exception_swallow(sf: SourceFile, ctx: Context):
    if not _in_file(sf.rel, ctx.config.swallow_scope):
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            if not any(isinstance(n, ast.Raise) for n in ast.walk(node)):
                yield Finding(
                    sf.rel, node.lineno, "exception-swallow",
                    "bare 'except:' with no re-raise swallows every "
                    "failure (including KeyboardInterrupt) — name the "
                    "expected exception types or re-raise")
            continue
        name = dotted(node.type)
        if name not in ("Exception", "BaseException"):
            continue                      # narrow/tuple handlers are fine
        body_is_noop = all(
            isinstance(stmt, (ast.Pass, ast.Continue))
            or (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant))
            for stmt in node.body)
        if body_is_noop:
            yield Finding(
                sf.rel, node.lineno, "exception-swallow",
                f"'except {name}: pass' silently discards the failure — "
                f"handle it (count/warn/fall back), narrow the type, or "
                f"pragma why ignoring it is safe")
