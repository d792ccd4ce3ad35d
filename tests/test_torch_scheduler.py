"""The port's streaming RoundScheduler against the port's synchronous loop
and the JAX package's RoundScheduler, on the world of tests/test_scheduler.py:
reduced xlm-roberta (4 layers, d 32), 12 clients, cohort 4, τ 2, the
params crossing through ``repro_torch.bridge``.  Cohorts and masks exact,
losses and params within 1e-5."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.api.task import DirichletTaskConfig as JDirCfg
from repro.api.task import DirichletTokenMixtureTask as JDirTask
from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro_torch.api.experiment import Experiment
from repro_torch.api.strategy import Strategy
from repro_torch.api.task import DirichletTaskConfig as TDirCfg
from repro_torch.api.task import DirichletTokenMixtureTask as TDirTask
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.scheduler import RoundScheduler
from repro_torch.core.server import FLServer as TServer
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model as tmodel

ATOL = 1e-5
TASK = dict(n_clients=12, n_classes=10, seq_len=8, samples_per_client=16,
            skew="label", objective="classification")


@pytest.fixture(scope="module")
def world():
    jc = jcfg.reduced(jcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jm, tm, jp, host


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tdata(tm):
    return tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))


def _jdata(jm):
    return jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))


def _fl(mod, **kw):
    base = dict(n_clients=12, cohort_size=4, rounds=5, local_steps=2,
                lr=0.01, batch_size=4, strategy="ours", budget=2, lam=1.0,
                seed=17)
    base.update(kw)
    return mod.FLConfig(**base)


def _records_equal(h_a, h_b, atol=ATOL):
    assert len(h_a.records) == len(h_b.records)
    for ra, rb in zip(h_a.records, h_b.records):
        assert ra.round == rb.round
        np.testing.assert_array_equal(ra.cohort, rb.cohort)
        np.testing.assert_array_equal(ra.mask_matrix, rb.mask_matrix)
        assert ra.uploaded_params == rb.uploaded_params
        assert ra.train_loss == pytest.approx(rb.train_loss, abs=atol)
        assert ra.test_loss == pytest.approx(rb.test_loss, abs=atol)
        assert ra.test_acc == pytest.approx(rb.test_acc, abs=1e-6)


def _param_err(a, b) -> float:
    """Largest |a − b| over a torch tree and a torch or JAX tree."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_param_err(a[k], b[k]) for k in a)
    bb = b.detach().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float32)
    return float(np.abs(a.detach().numpy() - bb).max())


# ---------------------------------------------------------------------------
# depth × selection period: the port's pipeline against its synchronous loop
# and against the reference's RoundScheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_runs(world):
    """The port's synchronous loop at each selection period, run once."""
    _, tm, _, host = world
    runs = {}
    for period in (1, 2):
        data = _tdata(tm)
        params, hist = TServer(tm, _fl(tcfg, selection_period=period), data,
                               pipeline=False).run(
                                   params_to_torch(host, "cpu"))
        runs[period] = (params, hist, data.stream_positions())
    return runs


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("period", [1, 2])
def test_pipelined_matches_synchronous_and_reference(world, sync_runs,
                                                     depth, period):
    jm, tm, jp, host = world
    data_p, data_j = _tdata(tm), _jdata(jm)
    srv = TServer(tm, _fl(tcfg, selection_period=period), data_p,
                  pipeline_depth=depth)
    assert srv.pipeline and srv.pipeline_depth == depth
    p_pipe, h_pipe = srv.run(params_to_torch(host, "cpu"))
    p_sync, h_sync, positions = sync_runs[period]
    jsrv = JServer(jm, _fl(jcfg, selection_period=period), data_j,
                   pipeline_depth=depth)
    p_ref, h_ref = jsrv.run(jp)
    _records_equal(h_pipe, h_sync)
    _records_equal(h_pipe, h_ref)
    assert _param_err(p_pipe, p_sync) < ATOL
    assert _param_err(p_pipe, p_ref) < ATOL
    # the per-client streams were drawn exactly as often as synchronously
    np.testing.assert_array_equal(data_p.stream_positions(), positions)
    np.testing.assert_array_equal(data_p.stream_positions(),
                                  data_j.stream_positions())
    assert srv.select_stats == jsrv.select_stats


@pytest.mark.parametrize("strategy", ["top", "rgn"])
def test_probe_free_and_score_strategies(world, strategy):
    """No host solve (positional "top") or a device-scored one ("rgn"):
    still a pure scheduling change, equal to the reference's pipeline."""
    jm, tm, jp, host = world
    kw = dict(rounds=4, local_steps=1, strategy=strategy, seed=23)
    p_pipe, h_pipe = TServer(tm, _fl(tcfg, **kw), _tdata(tm),
                             pipeline_depth=3).run(
                                 params_to_torch(host, "cpu"))
    p_sync, h_sync = TServer(tm, _fl(tcfg, **kw), _tdata(tm),
                             pipeline=False).run(params_to_torch(host, "cpu"))
    p_ref, h_ref = JServer(jm, _fl(jcfg, **kw), _jdata(jm),
                           pipeline_depth=3).run(jp)
    _records_equal(h_pipe, h_sync)
    _records_equal(h_pipe, h_ref)
    assert _param_err(p_pipe, p_sync) < ATOL
    assert _param_err(p_pipe, p_ref) < ATOL


def test_dirichlet_hooks_match_reference(world):
    """Availability 0.5 and stragglers 0.25 at depth 2: the hooks consume
    the server rng at plan time exactly as the reference's do."""
    jm, tm, jp, host = world
    cfg = dict(n_clients=12, n_topics=10, vocab_size=tm.cfg.vocab_size,
               seq_len=8, samples_per_client=16, availability=0.5,
               straggler_rate=0.25, seed=5)
    t_task, j_task = TDirTask(TDirCfg(**cfg)), JDirTask(JDirCfg(**cfg))
    kw = dict(rounds=4, seed=7)
    p_got, h_got = TServer(tm, _fl(tcfg, **kw), t_task,
                           pipeline_depth=2).run(params_to_torch(host, "cpu"))
    p_ref, h_ref = JServer(jm, _fl(jcfg, **kw), j_task,
                           pipeline_depth=2).run(jp)
    _records_equal(h_got, h_ref)
    assert _param_err(p_got, p_ref) < ATOL
    assert any(len(r.cohort) < 4 for r in h_got.records)   # hooks acted
    for r in h_got.records:
        assert set(r.cohort.tolist()) <= set(
            t_task.available_pool(r.round).tolist())
    np.testing.assert_array_equal(t_task.stream_positions(),
                                  j_task.stream_positions())


def test_experiment_pipeline_depth_knob(world):
    _, tm, _, host = world
    exp = Experiment(tm, _tdata(tm), "ours", rounds=3, cohort_size=4,
                     local_steps=1, batch_size=4, budget=2, lam=1.0,
                     seed=3, pipeline_depth=3, device="cpu")
    assert exp.build().pipeline_depth == 3 and exp.fl.seed == 3
    _, hist = exp.run(params_to_torch(host, "cpu"))
    assert len(hist.records) == 3


def test_depth_validation(world):
    _, tm, _, _ = world
    fl = _fl(tcfg, rounds=1)
    with pytest.raises(ValueError, match="pipeline_depth"):
        TServer(tm, fl, _tdata(tm), pipeline_depth=0)
    with pytest.raises(ValueError, match="depth"):
        RoundScheduler(TServer(tm, fl, _tdata(tm)), depth=0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        TServer(tm, fl, _tdata(tm), checkpoint_every=0)
    with pytest.raises(ValueError, match="solver_deadline_s"):
        TServer(tm, fl, _tdata(tm), solver_deadline_s=0.0)


# ---------------------------------------------------------------------------
# verbose, wall_s, the solver thread
# ---------------------------------------------------------------------------

def test_verbose_prints_every_round_once(world, capsys):
    _, tm, _, host = world
    fl = _fl(tcfg, rounds=3, local_steps=1, seed=29)
    _, h_quiet = TServer(tm, fl, _tdata(tm), pipeline_depth=2).run(
        params_to_torch(host, "cpu"), verbose=False)
    capsys.readouterr()
    _, h_verb = TServer(tm, fl, _tdata(tm), pipeline_depth=2).run(
        params_to_torch(host, "cpu"), verbose=True)
    out = capsys.readouterr().out
    printed = [ln for ln in out.splitlines() if ln.startswith("[round")]
    assert [int(ln.split("]")[0].split()[-1]) for ln in printed] == [0, 1, 2]
    _records_equal(h_verb, h_quiet, atol=0.0)


def test_wall_s_is_host_time(world):
    """Per-round host times are disjoint parts of the run, the end-of-run
    drain excluded: their sum never exceeds the elapsed time."""
    _, tm, _, host = world
    server = TServer(tm, _fl(tcfg, rounds=4, local_steps=1, seed=31),
                     _tdata(tm), pipeline_depth=2)
    params = params_to_torch(host, "cpu")
    t0 = time.time()
    _, hist = server.run(params)
    elapsed = time.time() - t0
    walls = [r.wall_s for r in hist.records]
    assert all(np.isfinite(w) and w >= 0 for w in walls)
    assert sum(walls) <= elapsed + 1e-6


class _Failing(Strategy):
    name = "test_failing"
    host = True
    probe_requirements = frozenset({"grad_sq_norms"})

    def select(self, probe, budgets, ctx):
        if ctx.round == 1:
            raise RuntimeError("solver failed in round 1")
        masks = np.zeros((probe.n, probe.L), np.float32)
        masks[:, -1] = 1.0
        return masks


def test_solver_thread_exception_surfaces(world):
    """An exception in the background (P1) solve is raised by run; nothing
    falls back to another path."""
    _, tm, _, host = world
    server = TServer(tm, _fl(tcfg, rounds=3, local_steps=1), _tdata(tm),
                     strategy=_Failing())
    with pytest.raises(RuntimeError, match="solver failed in round 1"):
        server.run(params_to_torch(host, "cpu"))


class _Slow(Strategy):
    name = "test_slow"
    host = True
    probe_requirements = frozenset({"grad_sq_norms"})

    def select(self, probe, budgets, ctx):
        if ctx.round == 1:
            time.sleep(2.5)
        masks = np.zeros((probe.n, probe.L), np.float32)
        masks[:, -1] = 1.0
        return masks


def test_solver_deadline_falls_back_to_warm_rows(world):
    """A solve that misses ``solver_deadline_s`` leaves its round on the
    cohort's warm rows (zeros for unseen members), counted in
    ``select_stats["solver_timeouts"]``; the late solve still lands."""
    _, tm, _, host = world
    server = TServer(tm, _fl(tcfg, rounds=3, local_steps=1), _tdata(tm),
                     strategy=_Slow(), solver_deadline_s=1.0)
    _, hist = server.run(params_to_torch(host, "cpu"))
    # round 1 misses; round 2's solve queues behind it on the one solver
    # thread and may miss too
    assert server.select_stats["solver_timeouts"] in (1, 2)
    assert len(hist.records) == 3
    seen = set(hist.records[0].cohort.tolist())
    late = hist.records[1]
    for cid, row in zip(late.cohort, late.mask_matrix):
        want = np.zeros(server.L, np.float32)
        if cid in seen:
            want[-1] = 1.0
        np.testing.assert_array_equal(row, want)
    # the late solves landed: round 1's cohort has its solved warm rows
    rows, valid = server.state.warm_rows(late.cohort)
    assert valid.all() and (rows[:, -1] == 1.0).all()


@pytest.mark.parametrize("cut", [None, 1])
def test_raw_calls_match_materialising_wrappers(world, cut):
    """The scheduler's ``*_raw`` calls return tensors; the synchronous
    wrappers are those tensors on the host, and the update-then-probe call
    is the two calls one after the other."""
    from repro_torch.core.client import Client, HostCopy
    from repro_torch.core.strategies import PROBE_KEYS
    _, tm, _, host = world
    data = _tdata(tm)
    client = Client(tm)
    params = params_to_torch(host, "cpu")
    cohort = np.arange(4)
    batches = {k: torch.from_numpy(v) for k, v in
               data.cohort_batches(cohort, 4, 2).items()}
    probe_b = {k: torch.from_numpy(v) for k, v in
               data.cohort_batches(cohort[:3], 4, 1).items()}
    masks = np.zeros((4, tm.n_selectable), np.float32)
    masks[:, 1:3] = 1.0
    sizes = data.sizes[cohort]
    p_raw, l_raw = client.cohort_update_raw(params, batches, masks, sizes,
                                            0.01, cut)
    assert isinstance(l_raw, torch.Tensor)
    p_w, l_w = client.cohort_update(params, batches, masks, sizes, 0.01,
                                    cut)
    np.testing.assert_array_equal(l_w, l_raw.numpy())
    assert _param_err(p_raw, p_w) == 0.0
    p_f, l_f, s_f = client.probe_update_cohort_raw(
        params, batches, masks, sizes, 0.01, probe_b, PROBE_KEYS, None,
        cut=cut)
    s_two = client.probe_cohort_raw(p_raw, probe_b, PROBE_KEYS)
    assert _param_err(p_f, p_raw) == 0.0
    assert torch.equal(l_f, l_raw)
    got = HostCopy(s_f).to_numpy()
    for k, v in client.probe_cohort(p_raw, probe_b, PROBE_KEYS).items():
        np.testing.assert_array_equal(got[k], v)
        assert torch.equal(s_f[k], s_two[k])
    test = {k: torch.from_numpy(v) for k, v in data.test_batch().items()}
    loss, acc = client.evaluate_raw(p_raw, test)
    assert (loss.item(), acc.item()) == client.evaluate(p_raw, test)


def test_parity_under_fast_thread_switching(world):
    """The main thread plans and samples while the solver thread writes the
    stats and warm-mask caches: with the interpreter switching threads
    every microsecond, a race on the gated cache reads would change a
    plan.  Depth 4 at selection period 2 reads the cache most."""
    import sys
    _, tm, _, host = world
    fl = _fl(tcfg, selection_period=2, rounds=6, local_steps=1, seed=41)
    _, h_sync = TServer(tm, fl, _tdata(tm), pipeline=False).run(
        params_to_torch(host, "cpu"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        _, h_pipe = TServer(tm, fl, _tdata(tm), pipeline_depth=4).run(
            params_to_torch(host, "cpu"))
        assert time.time() - t0 < 300
    finally:
        sys.setswitchinterval(old)
    _records_equal(h_pipe, h_sync)
