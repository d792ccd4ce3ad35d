"""The port's tracer (``repro_torch.tracing``): off by default and free
there; on, a tiny depth-1 round of the ssm family (reduced Mamba2: 3 rows,
d 32) comes out bit-identical to the same run with it off, and records
each round's spans with their parents and rounds; its anchor puts a span
on the profiler's clock."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api.experiment import Experiment
from repro_torch.configs import base as tcfg
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model as tmodel

ROUNDS = 3
TASK = dict(n_clients=8, seq_len=32, samples_per_client=8, skew="label",
            objective="lm")
FL = dict(cohort_size=3, local_steps=2, lr=0.01, batch_size=2, budget=1,
          lam=1.0, seed=3)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off, on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = tcfg.reduced(tcfg.get_arch("mamba2_370m"), n_layers=3, d_model=32)
    return tmodel.Model(cfg, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                        device="cpu")


def _run(model, strategy: str, traced: bool):
    """ROUNDS depth-1 rounds from fixed weights; with ``traced`` the spans
    the tracer collected, and the server."""
    data = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=model.cfg.vocab_size, **TASK))
    exp = Experiment(model, data, strategy, rounds=ROUNDS, pipeline_depth=1,
                     device="cpu", **FL)
    tracer = tracing.enable() if traced else None
    try:
        params, hist = exp.run(model.init(0))
    finally:
        tracing.disable()
    spans = tracer.collect() if traced else None
    return params, hist, spans, exp.server


@pytest.fixture(scope="module")
def runs(model):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {(s, tr): _run(model, s, tr) for s in ("ours", "top")
           for tr in (False, True)}
    torch.set_num_threads(n)
    return out


def test_off_by_default_and_free():
    assert tracing.TRACER is None
    a, b = tracing.span("update"), tracing.span("solve", t=3, device="x")
    assert a is b is tracing.NULL
    with a as got:
        assert got is None
    assert tracing.begin("round", 0, tracing.now_ns()) is None
    tracing.end(None, tracing.now_ns())
    # nothing recorded while off reaches a tracer switched on later
    tracer = tracing.enable()
    assert tracer.collect() == []


def test_a_run_with_no_tracer_records_nothing(runs):
    *_, spans, _ = runs[("ours", False)]
    assert spans is None and tracing.TRACER is None


@pytest.mark.parametrize("strategy", ["ours", "top"])
def test_traced_run_is_bit_identical(runs, strategy):
    p_off, h_off, *_ = runs[(strategy, False)]
    p_on, h_on, *_ = runs[(strategy, True)]
    assert len(h_off.records) == len(h_on.records) == ROUNDS
    for a, b in zip(h_off.records, h_on.records):
        np.testing.assert_array_equal(a.mask_matrix, b.mask_matrix)
        np.testing.assert_array_equal(a.cohort, b.cohort)
        assert (a.train_loss, a.test_loss) == (b.train_loss, b.test_loss)

    def leaves(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + k + "/")
            else:
                yield pre + k, v
    off, on = dict(leaves(p_off)), dict(leaves(p_on))
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def _by(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("strategy", ["ours", "top"])
def test_each_round_records_its_spans(runs, strategy):
    _, hist, spans, server = runs[(strategy, True)]
    rounds = _by(spans, "round")
    assert sorted(s.t for s in rounds) == list(range(ROUNDS))
    for name in ("select_wait", "update", "eval"):
        got = _by(spans, name)
        assert sorted(s.t for s in got) == list(range(ROUNDS)), name
        assert all(s.parent.name == "round" and s.parent.t == s.t
                   for s in got), name
    probes = _by(spans, "probe")
    solves = _by(spans, "solve")
    if strategy == "ours":
        # the first probe runs before round 0's span, the others queued
        # behind the previous round's update
        assert len(probes) == ROUNDS
        assert sum(p.parent is None for p in probes) == 1
        assert len(solves) == server.select_stats["solves"] >= 1
        assert len(solves) + server.select_stats["memo_hits"] == ROUNDS
        for s in solves:
            assert s.parent.name == "round" and s.parent.t == s.t
            assert s.thread.startswith("p1-solver")
    else:
        assert probes == [] and solves == []
    bwd = _by(spans, "scan_bwd")
    assert bwd
    for s in bwd:
        assert s.parent.name in ("update", "probe")
        assert s.t == s.parent.t
        assert s.parent.start_ns <= s.start_ns <= s.end_ns \
            <= s.parent.end_ns
        assert s.path.endswith(f"{s.parent.name}/scan_bwd")
    for s in spans:
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0
        # on the CPU no span records a device event
        assert s.device_ms is None


@pytest.mark.parametrize("strategy", ["ours", "top"])
def test_round_span_is_wall_s(runs, strategy):
    _, hist, spans, _ = runs[(strategy, True)]
    rounds = {s.t: s for s in _by(spans, "round")}
    for rec in hist.records:
        assert abs(rounds[rec.round].seconds - rec.wall_s) < 1e-6
        ticks = rounds[rec.round].ticks
        # the round loop's own thread is among the launching threads read
        assert any(tid == str(rounds[rec.round].tid) for tid in ticks)
        assert all(t1 >= t0 for _, t0, t1 in ticks.values())


def test_anchor_puts_a_span_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    tracer = tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("work"):
            torch.mm(a, b)
    tracing.disable()
    (work,) = tracer.collect()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    lo, hi = tracer.epoch_ns(work.start_ns), tracer.epoch_ns(work.end_ns)
    for e in mm:
        assert lo <= e.start_ns() <= e.start_ns() + e.duration_ns() <= hi
