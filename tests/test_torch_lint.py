"""The port's source linter (repro_torch.analysis.engine / rules /
callgraph) on fixtures and on the port itself:

* a bad and a good fixture for each rule, and one per PyTorch idiom of
  ``host-sync`` (the folded branch check included) and ``nondeterminism``;
* the reference's pragma cases, the CLI's exit codes and ``--json``;
* parity with the reference's linter (``repro.analysis``) on the same
  fixture trees, scopes pointed at them: equal (path, line, rule) sets for
  ``exception-swallow``, the stdlib / numpy / clock part of
  ``nondeterminism`` and the pragma findings, and equal reachable sets;
* the self-lint pin over ``src/repro_torch``, and a guard that the sweep
  is real: with the port's pragmas stripped, ``host-sync`` names the serve
  loop's readback and ``HostCopy.to_numpy``.
"""
import json
import os
import re
import shutil
import textwrap

import pytest

from repro.analysis import AnalysisConfig as JConfig
from repro.analysis import run_paths as jrun_paths
from repro.analysis.callgraph import CallGraph as JCallGraph
from repro.analysis.engine import collect_files as jcollect
from repro_torch.analysis import AnalysisConfig, RULES, run_paths
from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.engine import PRAGMA_RE, collect_files

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def write(root, sources):
    for rel, text in sources.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def lint(tmp_path, sources, config=None, only=None):
    write(tmp_path, sources)
    return run_paths([str(tmp_path)], repo_root=str(tmp_path),
                     config=config, only=only)


def rules_hit(findings):
    return {f.rule for f in findings}


def test_rules_registered():
    assert set(RULES) == {"host-sync", "nondeterminism", "exception-swallow",
                          "kernel-parity", "jit-outside-cache"}
    assert all(RULES[n].doc for n in RULES)


# -- host-sync ---------------------------------------------------------------

HOT_CFG = AnalysisConfig(hot_entry_points=("main",),
                         host_stage_boundary=frozenset({"sample_round"}))

SYNC_IDIOMS = {
    "item": "y = x.item()",
    "tolist": "y = x.tolist()",
    "cpu": "y = x.cpu()",
    "numpy": "y = x.numpy()",
    "event_synchronize": "ev.synchronize()",
    "nonzero": "y = x.nonzero()",
    "to_cpu": "y = x.to('cpu')",
    "to_device_cpu": "y = x.to(device='cpu', non_blocking=True)",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "torch_nonzero": "y = torch.nonzero(x)",
    "torch_unique": "y = torch.unique(x)",
    "masked_select": "y = torch.masked_select(x, x > 0)",
    "np_asarray": "y = np.asarray(x)",
    "np_array": "y = np.array(x)",
    "float": "y = float(x.sum())",
    "int": "y = int(x.sum())",
    "bool": "y = bool(x.any())",
    "if_torch": "if torch.any(x > 0):\n        y = 1",
    "if_any": "if (x > 0).any():\n        y = 1",
    "while_all": "while (x > 0).all():\n        x = x - 1",
    "if_item": "if x.max().item() > 0:\n        y = 1",
}


@pytest.mark.parametrize("idiom", sorted(SYNC_IDIOMS))
def test_host_sync_idiom_bad(tmp_path, idiom):
    out = lint(tmp_path, {"hot.py": f"""
import numpy as np
import torch
def main(xs, ev):
    for x in xs:
        record(x, ev)
def record(x, ev):
    {SYNC_IDIOMS[idiom]}
"""}, config=HOT_CFG, only=["host-sync"])
    assert rules_hit(out) == {"host-sync"}
    assert {f.line for f in out} == {8}, [f.format() for f in out]
    assert all("record" in f.message for f in out)


@pytest.mark.parametrize("idiom", sorted(SYNC_IDIOMS))
def test_host_sync_idiom_unreachable_good(tmp_path, idiom):
    out = lint(tmp_path, {"hot.py": f"""
import numpy as np
import torch
def main(xs, ev):
    return xs
def record(x, ev):
    {SYNC_IDIOMS[idiom]}
"""}, config=HOT_CFG, only=["host-sync"])
    assert not out


def test_host_sync_good_idioms(tmp_path):
    out = lint(tmp_path, {"hot.py": """
        import torch
        def main(x, device):
            if torch.is_grad_enabled() and torch.cuda.is_available():
                x = x.to(device)
            y = float(1.0) + int("3")
            return torch.where(x > 0, x, 0.0), y, x.to(torch.float32)
        """}, config=HOT_CFG, only=["host-sync"])
    assert not out


def test_host_sync_stops_at_stage_boundary(tmp_path):
    out = lint(tmp_path, {"hot.py": """
        def main(xs):
            sample_round(xs)
        def sample_round(xs):
            return xs.cpu().numpy()    # host stage: sanctioned by design
        """}, config=HOT_CFG, only=["host-sync"])
    assert not out


# -- nondeterminism ----------------------------------------------------------

NONDET_CFG = AnalysisConfig(nondet_scope=("",))

NONDET_BAD = {
    "stdlib_random": "random.random()",
    "time": "time.time()",
    "np_global": "np.random.rand()",
    "np_unseeded": "np.random.RandomState()",
    "manual_seed": "torch.manual_seed(0)",
    "seed": "torch.seed()",
    "cuda_manual_seed": "torch.cuda.manual_seed(0)",
    "cuda_manual_seed_all": "torch.cuda.manual_seed_all(0)",
    "rand": "torch.rand(3)",
    "randn": "torch.randn(3)",
    "randint": "torch.randint(0, 5, (3,))",
    "randperm": "torch.randperm(5)",
    "rand_like": "torch.rand_like(x)",
    "randn_like": "torch.randn_like(x)",
    "randint_like": "torch.randint_like(x, 5)",
    "normal": "torch.normal(0.0, 1.0, (3,))",
    "bernoulli": "torch.bernoulli(x)",
    "multinomial": "torch.multinomial(x, 1)",
    "poisson": "torch.poisson(x)",
    "uniform_": "x.uniform_()",
    "normal_": "x.normal_()",
    "bernoulli_": "x.bernoulli_(0.5)",
    "random_": "x.random_()",
    "exponential_": "x.exponential_()",
}
# the torch draws again, on an explicit generator
NONDET_GOOD = {k: v[:-1] + (", " if v[-2] != "(" else "") + "generator=g)"
               for k, v in NONDET_BAD.items()
               if k not in ("stdlib_random", "time", "np_global",
                            "np_unseeded", "manual_seed", "seed",
                            "cuda_manual_seed", "cuda_manual_seed_all")}


@pytest.mark.parametrize("idiom", sorted(NONDET_BAD))
def test_nondeterminism_bad(tmp_path, idiom):
    out = lint(tmp_path, {"sel.py": f"""
import random, time
import numpy as np
import torch
def pick(x):
    return {NONDET_BAD[idiom]}
"""}, config=NONDET_CFG, only=["nondeterminism"])
    assert [(f.rule, f.line) for f in out] == [("nondeterminism", 6)]


@pytest.mark.parametrize("idiom", sorted(NONDET_GOOD))
def test_nondeterminism_explicit_generator_good(tmp_path, idiom):
    out = lint(tmp_path, {"sel.py": f"""
import torch
def pick(x, seed):
    g = torch.Generator().manual_seed(seed)
    return {NONDET_GOOD[idiom]}
"""}, config=NONDET_CFG, only=["nondeterminism"])
    assert not out, [f.format() for f in out]


def test_nondeterminism_seeded_and_out_of_scope(tmp_path):
    out = lint(tmp_path, {"src/repro_torch/core/sel.py": """
        import numpy as np
        def pick(xs, seed):
            rng = np.random.RandomState(seed)
            return xs[rng.randint(len(xs))]
        """, "src/repro_torch/models/init.py": """
        import torch
        def init(w):
            return torch.randn(3), w.normal_()
        """}, only=["nondeterminism"])
    assert not out


# -- exception-swallow -------------------------------------------------------

SWALLOW_CFG = AnalysisConfig(swallow_scope=("core/",))


def test_exception_swallow_bad_and_good(tmp_path):
    out = lint(tmp_path, {"core/a.py": """
        def f(g):
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except:
                return None
            try:
                g()
            except BaseException:
                raise
            try:
                g()
            except (OSError, ValueError):
                pass
        """, "tools/b.py": """
        def f(g):
            try:
                g()
            except Exception:
                pass
        """}, config=SWALLOW_CFG, only=["exception-swallow"])
    assert [(f.path, f.line) for f in out] == [("core/a.py", 5),
                                                ("core/a.py", 9)]


# -- kernel-parity -----------------------------------------------------------

KERNEL_TREE = {
    "src/repro_torch/kernels/foo.py": """
        import functools
        from repro_torch.kernels import _build

        def foo_torch(x):
            return x

        @functools.cache
        def _lib():
            return _build.load_library("foo")
        """,
    "src/repro_torch/kernels/plain.py": """
        def bar_torch(x):
            return x
        """,
    "src/repro_torch/kernels/ops.py": "from repro_torch.kernels import foo\n",
    "src/repro_torch/kernels/csrc/foo.cu": "// kernel\n",
    "tests/test_torch_foo.py": "from repro_torch.kernels import foo\n"
                               "foo.foo_torch\n",
    "chip_smoke.py": "# holds foo against foo_torch on the card\n",
}


def test_kernel_parity_good(tmp_path):
    write(tmp_path, KERNEL_TREE)
    out = run_paths(["src"], repo_root=str(tmp_path), only=["kernel-parity"])
    assert not out, [f.format() for f in out]


@pytest.mark.parametrize("breakage,needle", [
    ("no_plain", "no public *_torch"),
    ("no_source", "csrc/foo.cu does not exist"),
    ("no_dispatch", "not referenced by"),
    ("no_test_module", "no matching parity coverage"),
    ("no_test_plain", "never exercised"),
    ("no_smoke_plain", "never named by chip_smoke.py"),
])
def test_kernel_parity_bad(tmp_path, breakage, needle):
    tree = dict(KERNEL_TREE)
    mod = "src/repro_torch/kernels/foo.py"
    if breakage == "no_plain":
        tree[mod] = tree[mod].replace("def foo_torch", "def _foo_torch")
    elif breakage == "no_source":
        del tree["src/repro_torch/kernels/csrc/foo.cu"]
    elif breakage == "no_dispatch":
        tree["src/repro_torch/kernels/ops.py"] = "x = 1\n"
    elif breakage == "no_test_module":
        tree["tests/test_torch_foo.py"] = "x = 1\n"
    elif breakage == "no_test_plain":
        tree["tests/test_torch_foo.py"] = "from repro_torch.kernels import foo\n"
    elif breakage == "no_smoke_plain":
        tree["chip_smoke.py"] = "# foo\n"
    write(tmp_path, tree)
    out = run_paths(["src"], repo_root=str(tmp_path), only=["kernel-parity"])
    assert rules_hit(out) == {"kernel-parity"}
    assert {f.path for f in out} == {mod}
    assert any(needle in f.message for f in out), [f.message for f in out]


# -- jit-outside-cache -------------------------------------------------------

GRAPH_IDIOMS = {
    "compile": "return torch.compile(fn)",
    "jit_script": "return torch.jit.script(fn)",
    "jit_trace": "return torch.jit.trace(fn, (x,))",
    "cuda_graph": "g = torch.cuda.CUDAGraph()",
    "graph_capture": "with torch.cuda.graph(g):\n        fn(x)",
    "graphed_callables": "return torch.cuda.make_graphed_callables(fn, (x,))",
    "compile_decorator": "@torch.compile\n    def inner(y):\n        return y",
}


@pytest.mark.parametrize("idiom", sorted(GRAPH_IDIOMS))
def test_jit_outside_cache_bad(tmp_path, idiom):
    out = lint(tmp_path, {"a.py": f"""
import torch
def make(fn, x, g):
    {GRAPH_IDIOMS[idiom]}
"""}, only=["jit-outside-cache"])
    assert [(f.rule, f.line) for f in out] == [("jit-outside-cache", 4)]


def test_jit_outside_cache_module_scope_and_sanctioned_good(tmp_path):
    out = lint(tmp_path, {"a.py": """
        import torch
        def loss(p, b):
            return p
        loss_compiled = torch.compile(loss)     # module scope: built once
        """, "src/repro_torch/core/client.py": """
        import torch
        def build(fn):
            return torch.compile(fn)
        """}, only=["jit-outside-cache"])
    assert not out


# -- pragmas -----------------------------------------------------------------

BAD_SWALLOW = """
def f(g):
    try:
        g()
    except Exception:{tail}
        pass
"""


def test_pragma_suppresses_with_reason(tmp_path):
    out = lint(tmp_path, {"core/p.py": BAD_SWALLOW.format(
        tail="  # repro: allow[exception-swallow] -- test fixture")},
        config=SWALLOW_CFG, only=["exception-swallow"])
    assert not out


def test_pragma_line_above(tmp_path):
    out = lint(tmp_path, {"core/p.py": """
        def f(g):
            try:
                g()
            # repro: allow[exception-swallow] -- test fixture
            except Exception:
                pass
        """}, config=SWALLOW_CFG, only=["exception-swallow"])
    assert not out


def test_pragma_without_reason_rejected(tmp_path):
    out = lint(tmp_path, {"core/p.py": BAD_SWALLOW.format(
        tail="  # repro: allow[exception-swallow]")},
        config=SWALLOW_CFG, only=["exception-swallow"])
    assert rules_hit(out) == {"exception-swallow", "pragma"}


def test_pragma_unknown_rule_rejected(tmp_path):
    out = lint(tmp_path, {"p.py": """
        x = 1  # repro: allow[no-such-rule] -- because
        """})
    assert rules_hit(out) == {"pragma"}
    assert "no-such-rule" in out[0].message


def test_pragma_only_suppresses_named_rule(tmp_path):
    out = lint(tmp_path, {"core/p.py": BAD_SWALLOW.format(
        tail="  # repro: allow[host-sync] -- wrong rule named")},
        config=SWALLOW_CFG, only=["exception-swallow"])
    assert rules_hit(out) == {"exception-swallow"}


# -- CLI ---------------------------------------------------------------------

BAD_FILE = "import torch\ndef f(g):\n    return torch.compile(g)\n"


def test_cli_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "bad.py").write_text(BAD_FILE)
    assert main([str(tmp_path / "bad.py"), "--root", str(tmp_path)]) == 1
    assert main(["lint", str(tmp_path / "bad.py"), "--root", str(tmp_path),
                 "--rule", "host-sync"]) == 0
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = dict(line.split(": ", 1)
                  for line in capsys.readouterr().out.splitlines())
    assert set(listed) == set(RULES) and all(listed.values())


def test_cli_json_findings(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "bad.py").write_text(BAD_FILE)
    rc = main(["--json", str(tmp_path / "bad.py"), "--root", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and not report["ok"]
    assert [(f["rule"], f["line"], f["path"]) for f in report["findings"]] \
        == [("jit-outside-cache", 3, "bad.py")]

    (tmp_path / "ok.py").write_text("x = 1\n")
    rc = main(["--json", str(tmp_path / "ok.py"), "--root", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"] and report["findings"] == []


# -- parity with the reference's linter ---------------------------------------

PARITY_TREE = {
    "pkg/sel.py": """
        import random, time
        from time import perf_counter
        import numpy as np
        import numpy.random as npr
        def pick(xs, seed):
            t = time.time(); t2 = perf_counter(); t3 = time.monotonic()
            i = random.randrange(len(xs)) + random.random()
            rng = np.random.RandomState(seed)
            bad = np.random.RandomState()
            gen = np.random.default_rng(seed); npr.shuffle(xs)
            return xs[i] + np.random.rand() + rng.randn(), t, t2, t3, gen
        """,
    "pkg/handlers.py": """
        def f(g):
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except:
                return None
            try:
                g()
            except BaseException:
                '''doc'''
            try:
                g()
            except Exception:  # repro: allow[exception-swallow] -- verdict
                pass
            try:
                g()
            except Exception:  # repro: allow[exception-swallow]
                continue
            try:
                g()
            except ValueError:
                pass
        """,
    "pkg/pragmas.py": """
        x = 1  # repro: allow[no-such-rule] -- because
        y = 2  # repro: allow[host-sync, nope] -- two rules
        z = 3  # repro: allow[nondeterminism]
        """,
    "pkg/hot.py": """
        def main(xs):
            for x in xs:
                record(x)
            sample_round(xs)
        def record(x):
            return helper(x) + x.probe_round()
        def helper(x):
            return [one(v) for v in x]
        def sample_round(xs):
            return inner(xs)
        def inner(xs):
            return xs
        class Server:
            def probe_round(self):
                return self.one()
            def one(self):
                return 1
        def one(v):
            return v
        def unrelated():
            return main([])
        """,
}


def _triples(findings, rule):
    return {(f.path, f.line, f.rule) for f in findings if f.rule == rule}


@pytest.mark.parametrize("rule", ["exception-swallow", "nondeterminism",
                                  "pragma"])
def test_parity_with_reference(tmp_path, rule):
    write(tmp_path, PARITY_TREE)
    scopes = dict(nondet_scope=("pkg/",), swallow_scope=("pkg/",))
    only = ["exception-swallow", "nondeterminism"]
    ours = run_paths(["pkg"], repo_root=str(tmp_path),
                     config=AnalysisConfig(**scopes), only=only)
    ref = jrun_paths(["pkg"], repo_root=str(tmp_path),
                     config=JConfig(**scopes), only=only)
    assert _triples(ours, rule) == _triples(ref, rule)
    assert _triples(ours, rule)


def test_reachable_parity_with_reference(tmp_path):
    write(tmp_path, PARITY_TREE)
    boundary = frozenset({"sample_round"})
    ours = CallGraph.build(collect_files(["pkg"], str(tmp_path))).reachable(
        {"main"}, boundary)
    ref = JCallGraph.build(jcollect(["pkg"], str(tmp_path))).reachable(
        {"main"}, boundary)
    names = {f.qualname for f in ours}
    assert names == {f.qualname for f in ref}
    # by bare name across receivers; the boundary is not expanded
    assert names == {"main", "record", "helper", "Server.probe_round",
                     "Server.one", "one"}


# -- the port itself ---------------------------------------------------------

def test_self_lint_port_clean():
    """The port is clean under every rule of its own linter: a new
    finding needs a fix or a reasoned pragma to land."""
    findings = run_paths(["src/repro_torch"], repo_root=REPO_ROOT)
    assert not findings, "\n".join(f.format() for f in findings)


def test_sweep_is_real(tmp_path):
    """With the port's pragmas stripped, host-sync finds the sanctioned
    syncs the sweep annotated: the serve loop's greedy readback and the
    scheduler's readback through ``HostCopy.to_numpy``."""
    src = os.path.join(REPO_ROOT, "src", "repro_torch")
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for path in dst.rglob("*.py"):
        text = path.read_text()
        path.write_text("\n".join(PRAGMA_RE.sub("", line)
                                  for line in text.split("\n")))
    out = run_paths(["src/repro_torch"], repo_root=str(tmp_path),
                    only=["host-sync"])
    serve = (tmp_path / "src/repro_torch/launch/serve.py").read_text()
    readback = 1 + serve.split("\n").index(next(
        line for line in serve.split("\n")
        if re.search(r"nxt = torch\.argmax\(logits, -1\)\.cpu\(\)\.tolist\(\)",
                     line)))
    hits = {(f.path, f.line) for f in out if "SlotServer.run" in f.message}
    assert ("src/repro_torch/launch/serve.py", readback) in hits
    assert any("HostCopy.to_numpy" in f.message
               and f.path == "src/repro_torch/core/client.py" for f in out)
