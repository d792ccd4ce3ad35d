"""The port's program contracts and auditor (repro_torch.analysis) against
the JAX package's (repro.analysis):

* ``check_all`` of both packages on the same synthetic fact tables — each
  of the five contracts clean and violated — gives the same (contract,
  program) pairs;
* the port's auditor over the three reduced audit configs on the CPU: no
  violation, masked-cut FLOPs strictly decreasing, the forward-only
  fraction at most ``FORWARD_ONLY_MAX_FRAC``, B-independent and C-linear
  delta weight bytes, honoured donations, and the same program names as
  the reference's ``enumerate_specs`` (which builds specs without
  lowering);
* the kernel wrappers' recorder hook (``kernels.ops.RECORDER``): each
  wrapper's launch reports its operations and weight operands, and with no
  recorder nothing is recorded.
"""
import pytest
import torch

from repro.analysis import contracts as jcon
from repro.analysis import facts as jfacts
from repro.analysis import program as jprog
from repro_torch.analysis import contracts as tcon
from repro_torch.analysis import facts as tfacts
from repro_torch.analysis import program as tprog
from repro_torch.kernels import delta_matmul as dmm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import layer_grad_norm as lgn
from repro_torch.kernels import masked_update as mu
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes here are tiny, and the suite runs
    files in parallel workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L = 4


def _cut_rows(flops, cfg="dense", n_sel=L):
    return [(f"{cfg}/fl_step_masked/cut{c}",
             dict(kind="fl_step_masked", cut=c, n_selectable=n_sel,
                  single_host=True, config=cfg), dict(flops=f))
            for c, f in enumerate(flops)]


def _delta_rows(w, cfg="dense_bf16", dtype="bfloat16"):
    """w: {(B, C): weight bytes}."""
    return [(f"{cfg}/serve_decode_delta/B{b}/C{c}",
             dict(kind="serve_decode_delta", batch=b, capacity=c,
                  single_host=True, dtype=dtype, config=cfg),
             dict(weight_bytes=v, out_dtypes=["bfloat16", "float32"]))
            for (b, c), v in w.items()]


def _dense_rows(w, cfg="dense_bf16"):
    return [(f"{cfg}/serve_decode_dense/B{b}",
             dict(kind="serve_decode_dense", batch=b, single_host=True,
                  dtype="bfloat16", config=cfg),
             dict(weight_bytes=v, out_dtypes=["bfloat16"]))
            for b, v in w.items()]


GOOD_DELTA = {(3, c): 1e6 + c * 5e5 for c in (1, 2, 3)}
GOOD_DELTA.update({(6, c): v for (_, c), v in list(GOOD_DELTA.items())})
GOOD = (_cut_rows([100.0, 90.0, 80.0, 70.0, 30.0])
        + _delta_rows(GOOD_DELTA) + _dense_rows({3: 3e6, 6: 6e6})
        + [("dense_bf16/serve_write_params",
            dict(kind="dense_write", donates=True, single_host=True,
                 config="dense_bf16"),
            dict(donated_declared=11, donation_applied=11,
                 jaxpr_dtypes=["bfloat16", "int32"])),
           ("ssm/probe", dict(kind="probe", single_host=True, config="ssm"),
            dict(jaxpr_dtypes=["float32", "int32"], hlo_dtypes={"f32": 9})),
           ("sharded/fl_step",
            dict(kind="fl_step", single_host=False,
                 allowed_collectives=("all-reduce",), config="sharded"),
            dict(collective_counts={"all-reduce": 2}))])


def _replace(rows, name, **fields):
    return [(n, m, dict(f, **fields) if n == name else f)
            for n, m, f in rows]


TABLES = {
    "clean": GOOD,
    "cut_not_decreasing": _cut_rows([100.0, 90.0, 90.0, 95.0, 30.0]),
    "forward_only_too_costly": _cut_rows([100.0, 90.0, 80.0, 75.0, 70.0]),
    "forward_only_unchecked_without_L": _cut_rows([100.0, 90.0, 80.0],
                                                  n_sel=None),
    "delta_bytes_depend_on_batch": _delta_rows(
        {**GOOD_DELTA, (6, 2): 2.0 * GOOD_DELTA[(3, 2)]}),
    "delta_bytes_not_linear_in_capacity": _delta_rows(
        {(b, c): 1e6 + (c ** 2) * 5e5 for b in (3, 6) for c in (1, 2, 3)}),
    "delta_bytes_not_increasing": _delta_rows(
        {(b, c): 1e6 for b in (3, 6) for c in (1, 2, 3)}),
    "dense_baseline_stops_scaling": _dense_rows({3: 3e6, 6: 3e6}),
    "donation_missed": _replace(GOOD, "dense_bf16/serve_write_params",
                                donation_applied=7),
    "f64_in_census": _replace(GOOD, "ssm/probe",
                              jaxpr_dtypes=["float32", "float64"]),
    "f64_count": _replace(GOOD, "ssm/probe", hlo_dtypes={"f64": 1}),
    "bf16_decode_leaks_f32": [(n, m, dict(f, out_dtypes=["float32"] * 3))
                              for n, m, f in _delta_rows(GOOD_DELTA)],
    "collective_in_single_host": _replace(
        GOOD, "ssm/probe", collective_counts={"all-gather": 1}),
    "transfer_in_single_host": _replace(
        GOOD, "ssm/probe", transfer_ops={"_local_scalar_dense": 1}),
    "collective_off_the_allowlist": _replace(
        GOOD, "sharded/fl_step",
        collective_counts={"all-reduce": 1, "all-to-all": 1}),
    "transfer_in_sharded": _replace(
        GOOD, "sharded/fl_step", transfer_ops={"device_to_host_copy": 1}),
}


def _facts(pkg, rows):
    return {n: pkg.ProgramFacts(name=n, meta=dict(m), **f) for n, m, f in rows}


def _pairs(violations):
    return sorted((v.contract, v.program) for v in violations)


@pytest.mark.parametrize("table", list(TABLES))
def test_contracts_match_reference(table):
    rows = TABLES[table]
    got = tcon.check_all(_facts(tfacts, rows))
    want = jcon.check_all(_facts(jfacts, rows))
    assert _pairs(got) == _pairs(want)
    assert (table == "clean"
            or table == "forward_only_unchecked_without_L") == (not want)


def test_contract_constants_match_reference():
    for k in ("FORWARD_ONLY_MAX_FRAC", "B_INDEPENDENCE_RTOL",
              "C_LINEARITY_RTOL", "DENSE_SCALE_RTOL"):
        assert getattr(tcon, k) == getattr(jcon, k)
    assert list(tcon.CONTRACTS) == list(jcon.CONTRACTS)


# -- the port's auditor on the three reduced audit configs -------------------

@pytest.fixture(scope="module")
def audit():
    specs = tprog.enumerate_specs(device="cpu")
    return specs, tprog.run_audit(specs)


def test_audit_names_match_reference(audit):
    specs, facts = audit
    ref = {s.name for s in jprog.enumerate_specs()}
    assert {s.name for s in specs} == ref == set(facts)


def test_audit_clean(audit):
    _, facts = audit
    violations = tcon.check_all(facts)
    assert not violations, "\n".join(
        f"{v.contract} {v.program}: {v.message}" for v in violations)
    report = tprog.audit_report(facts, violations)
    assert report["ok"] and len(report["programs"]) == len(facts)


@pytest.mark.parametrize("cfg", ["dense", "ssm"])
def test_audit_cut_flops_strictly_decreasing(audit, cfg):
    _, facts = audit
    cuts = {f.meta["cut"]: f.flops for f in facts.values()
            if f.meta.get("kind") == "fl_step_masked"
            and f.meta["config"] == cfg}
    series = [cuts[c] for c in sorted(cuts)]
    assert len(series) == L + 1
    assert all(b < a for a, b in zip(series, series[1:])), series
    assert series[-1] / series[0] <= tcon.FORWARD_ONLY_MAX_FRAC


def test_audit_delta_weight_traffic(audit):
    _, facts = audit
    rows = [f for f in facts.values()
            if f.meta.get("kind") == "serve_decode_delta"
            and f.meta["config"] == "dense_bf16"]
    w = {(f.meta["batch"], f.meta["capacity"]): f.weight_bytes for f in rows}
    for c in (1, 2, 3):
        assert w[(3, c)] == w[(6, c)] > 0
    assert w[(3, 3)] - w[(3, 2)] == w[(3, 2)] - w[(3, 1)] > 0
    dense = {f.meta["batch"]: f.weight_bytes for f in facts.values()
             if f.meta.get("kind") == "serve_decode_dense"
             and f.meta["config"] == "dense_bf16"}
    assert dense[6] == 2 * dense[3]


def test_serve_specs_audit_the_servers_programs(audit, monkeypatch):
    """The serving specs run the very functions ``SlotServer`` and
    ``DeltaOverlay`` call (no copies): each spec's ``fn`` is one of
    ``serve.engine``'s programs, and a dense and a delta server really go
    through them."""
    import functools

    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    specs, _ = audit
    want = {"serve_decode": engine.decode_shared,
            "serve_decode_delta": engine.decode_delta,
            "serve_decode_dense": engine.decode_dense,
            "serve_write_delta_entry": engine.write_entry,
            "serve_write_params": engine.write_params}
    for s in specs:
        kind = s.name.split("/")[1]
        if kind in want:
            fn = s.fn.func if isinstance(s.fn, functools.partial) else s.fn
            assert fn is want[kind], s.name

    calls = []

    def counted(name, fn):
        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapper
    for name in ("decode_shared", "decode_delta", "decode_dense",
                 "write_params"):
        monkeypatch.setattr(serve, name, counted(name, getattr(engine, name)))
    monkeypatch.setattr(engine, "write_entry",
                        counted("write_entry", engine.write_entry))
    cfg = reduced(get_arch("tinyllama_1_1b"), n_layers=2, d_model=32)
    model = Model(cfg, RuntimeConfig(remat=False), device="cpu")
    params = model.init(0)
    store = serve.demo_store(model, params, users=2, layers_per_user=1)
    for mode in ("shared", "delta", "dense"):
        srv = serve.SlotServer(model, params, slots=2, max_seq=8, mode=mode,
                               store=store, device="cpu")
        srv.run([serve.Request(rid=i, prompt=[1, 2], max_new=2, user_id=i)
                 for i in range(2)])
    assert set(calls) == {"decode_shared", "decode_delta", "decode_dense",
                          "write_params", "write_entry"}


def test_audit_donation_and_dtypes(audit):
    _, facts = audit
    writes = [f for f in facts.values() if f.meta.get("donates")]
    assert len(writes) == 4
    assert all(f.donated_declared == f.donation_applied > 0 for f in writes)
    assert all("float64" not in f.jaxpr_dtypes for f in facts.values())
    assert all(not f.transfer_ops and not f.collective_counts
               for f in facts.values())


@pytest.mark.parametrize("name", ["dense/fl_step_masked/cut2", "ssm/probe",
                                  "dense_bf16/serve_decode_delta/B3/C2"])
def test_audit_flops_are_flop_counter_modes(audit, name):
    """The audit counts FLOPs as ``FlopCounterMode`` does (no kernel
    launches on the CPU), the backward and inference-mode decode too."""
    from torch.utils.flop_counter import FlopCounterMode
    specs, facts = audit
    spec = next(s for s in specs if s.name == name)
    counter = FlopCounterMode(display=False)
    with counter:
        spec.fn(*spec.args())
    assert facts[name].flops == counter.get_total_flops() > 0


def test_facts_catch_broken_programs():
    """The extractor sees what the contracts need: an f64 cast, a host
    read, a dropped donation (a copy handed back) and weight bytes."""
    w = torch.randn(8, 4)
    x = torch.randn(3, 8)
    f = tfacts.extract_facts("p", lambda x, w: (x @ w).double(), (x, w),
                             weight_argnums=(1,))
    assert "float64" in f.jaxpr_dtypes and f.hlo_dtypes.get("f64")
    assert f.weight_bytes == w.numel() * 4 and f.flops == 2 * 3 * 8 * 4
    f = tfacts.extract_facts("p", lambda x: x.sum().item(), (x,))
    assert f.transfer_ops == {"_local_scalar_dense": 1}
    f = tfacts.extract_facts("p", lambda s: s.clone().add_(1), (x,),
                             donate_argnums=(0,))
    assert (f.donated_declared, f.donation_applied) == (1, 0)
    f = tfacts.extract_facts("p", lambda s: s.add_(1), (x,),
                             donate_argnums=(0,))
    assert (f.donated_declared, f.donation_applied) == (1, 1)


# -- the recorder hook in kernels/ops.py -------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def launched(self, kernel, flops, weights, nbytes):
        self.calls.append((kernel, flops, tuple(weights)))


@pytest.fixture
def stub_kernels(monkeypatch):
    """The kernels' entry points replaced by stubs that compute nothing
    (there is no card), so ``mode="cuda"`` reaches each wrapper's launch
    branch on the CPU."""
    monkeypatch.setattr(lgn, "layer_sq_norms_2d",
                        lambda g: torch.zeros(g.shape[0]))
    monkeypatch.setattr(mu, "masked_sgd_update_2d",
                        lambda p, g, m, lr: p.clone())
    monkeypatch.setattr(dmm, "base_delta_matmul_2d",
                        lambda x, w, dw, s: x.new_zeros(x.shape[0],
                                                        w.shape[1]))
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, causal, window:
                        (torch.zeros_like(q), q.new_zeros(q.shape[:3])))
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda q, k, v, o, lse, do, causal, window:
                        (torch.zeros_like(q), torch.zeros_like(k),
                         torch.zeros_like(v)))
    monkeypatch.setattr(ssd, "ssd_scan", lambda x, *a, **k: x.clone())


def _drive_wrappers():
    """One call of each wrapper on the launch branch; returns the expected
    (kernel, flops, weights) reports."""
    B, S, H, K, D = 2, 8, 4, 2, 16
    q = torch.randn(B, S, H, D, requires_grad=True)
    k = torch.randn(B, S, K, D)
    v = torch.randn(B, S, K, D)
    out = ops.flash_attention(q, k, v, causal=True, window=0, mode="cuda")
    out.sum().backward()
    pairs = S * (S + 1) // 2
    g = {"a": torch.randn(3, 5, 7), "b": torch.randn(3, 11)}
    ops.layer_grad_norms(g, mode="cuda")
    ops.masked_sgd_update(g, g, torch.ones(3), 0.1, mode="cuda")
    x, w = torch.randn(2, 1, 16), torch.randn(16, 24)
    dw, slots = torch.zeros(3, 16, 24), torch.tensor([0, 1, -1],
                                                     dtype=torch.int32)
    ops.base_delta_matmul(x, w, dw, slots, mode="cuda")
    b, s, h, p, n, chunk = 1, 64, 2, 8, 4, 32
    ops.ssd(torch.randn(b, s, h, p), torch.rand(b, s, h), torch.zeros(h),
            torch.randn(b, s, 1, n), torch.randn(b, s, 1, n), torch.ones(h),
            chunk=chunk, mode="cuda")
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    return [("flash_attention", 4 * B * H * D * pairs, ()),
            ("flash_attention_bwd", 10 * B * H * D * pairs, ()),
            ("layer_grad_norm", 2 * 35 * 3, ()),
            ("layer_grad_norm", 2 * 33, ()),
            ("masked_update", 2 * 105, ()), ("masked_update", 2 * 33, ()),
            ("base_delta_matmul", 2 * 2 * 16 * 24 * 4, (w, dw)),
            ("ssd_scan", 2 * b * h * (nc * tri * (n + p)
                                      + 2 * (nc - 1) * chunk * n * p), ())]


def test_recorder_sees_each_kernel_launch(stub_kernels, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(ops, "RECORDER", rec)
    want = _drive_wrappers()
    assert [(k, f) for k, f, _ in rec.calls] == [(k, f) for k, f, _ in want]
    got_w = [ws for _, _, ws in rec.calls if ws]
    want_w = [ws for _, _, ws in want if ws]
    assert len(got_w) == len(want_w) == 1
    assert all(a is b for a, b in zip(got_w[0], want_w[0]))


def test_no_recorder_records_nothing(stub_kernels, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(ops, "RECORDER", None)
    _drive_wrappers()
    assert rec.calls == [] and ops.RECORDER is None


def test_facts_count_kernel_work(stub_kernels):
    """Under ``extract_facts`` the audit is the recorder: a stubbed flash
    launch's operations and a delta launch's weight bytes reach the facts
    (FlopCounterMode cannot see a ctypes launch), and the hook is cleared
    afterwards."""
    x, w = torch.randn(2, 1, 16), torch.randn(16, 24)
    dw = torch.zeros(3, 16, 24)
    slots = torch.tensor([0, 1, -1], dtype=torch.int32)
    f = tfacts.extract_facts(
        "delta", lambda x, w, dw: ops.base_delta_matmul(
            x, w, dw, slots, mode="cuda"), (x, w, dw), weight_argnums=(1, 2))
    assert f.flops == 2 * 2 * 16 * 24 * 4
    assert f.weight_bytes == (w.numel() + dw.numel()) * 4
    assert f.kernel_launches == {"base_delta_matmul": 1}
    assert ops.RECORDER is None
    q = torch.randn(1, 8, 2, 16)
    f = tfacts.extract_facts("flash", lambda q: ops.flash_attention(
        q, q, q, causal=False, mode="cuda"), (q,))
    assert f.flops == 4 * 2 * 16 * 64 and f.weight_bytes == 0
