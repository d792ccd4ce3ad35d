"""The port's fault harness (``repro_torch.faults`` and its consumers)
against the JAX package's, on the worlds of tests/test_faults.py: reduced
xlm-roberta (2 layers, d 32, 8 clients, cohort 3, τ 2), plus reduced
TinyLlama and Mamba2 for the guarded round step, the params crossing
through ``repro_torch.bridge``.

Tolerances: fault schedules, cohorts, masks, ``ok`` rows, counters and
summaries exactly (summary floats within 1e-5); the guarded step's params
within 1e-5 of the reference's; a whole run's params within 2e-4, the
reference's own tolerance between its engines.  Everything runs on the
CPU through the kernels' plain versions."""
import math
import os
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api.task import ChaosTask as JChaosTask
from repro.api.task import DirichletTaskConfig as JDirCfg
from repro.api.task import DirichletTokenMixtureTask as JDirTask
from repro.ckpt import verify_checkpoint as jverify
from repro.configs import base as jcfg
from repro.core import aggregation as jagg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.faults import FaultInjector as JInjector
from repro.faults import FaultPlan as JPlan
from repro.faults import TransientFault as JTransientFault
from repro.models import model as jmodel
from repro_torch.api import ChaosTask, Experiment
from repro_torch.api.task import DirichletTaskConfig as TDirCfg
from repro_torch.api.task import DirichletTokenMixtureTask as TDirTask
from repro_torch.bridge import params_to_torch
from repro_torch.ckpt import (latest_intact_step, save_checkpoint,
                              verify_checkpoint)
from repro_torch.configs import base as tcfg
from repro_torch.core import aggregation as tagg
from repro_torch.core.server import FLServer, History, RoundRecord
from repro_torch.data import synthetic as tsyn
from repro_torch.faults import (CKPT_CORRUPT_KINDS, CORRUPT_CODES,
                                FaultInjector, FaultPlan, TransientFault,
                                coerce_injector)
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_leaves

STEP_ATOL = 1e-5
RUN_ATOL = 2e-4
TASK = dict(n_clients=8, n_classes=10, seq_len=8, samples_per_client=16,
            skew="label", objective="classification")
CHAOS = dict(seed=5, death_rate=0.4, corrupt_rate=0.4,
             corrupt_kinds=("nan", "inf"))
# the CHAOS plan plus solver stalls and dispatch failures
CHAOS_ALL = dict(CHAOS, stall_rate=0.3, dispatch_fail_rate=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _worlds(arch, n_layers, d_model):
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=n_layers,
                      d_model=d_model)
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=n_layers,
                      d_model=d_model)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, _f32(jp)


@pytest.fixture(scope="module")
def world():
    return _worlds("xlm_roberta_base", 2, 32)


def _tdata(tm):
    return tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))


def _jdata(jm):
    return jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))


def _fl(mod, **kw):
    base = dict(n_clients=8, cohort_size=3, rounds=4, local_steps=2,
                lr=0.01, batch_size=4, strategy="ours", budget=1, lam=1.0,
                seed=0)
    base.update(kw)
    return mod.FLConfig(**base)


def _tp(host):
    return params_to_torch(host, "cpu")


def _param_err(a, b) -> float:
    """Largest |a − b| over a torch tree and a torch or JAX tree."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_param_err(a[k], b[k]) for k in a)
    bb = b.detach().float().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float32)
    return float(np.abs(a.detach().float().numpy() - bb).max())


def _params_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _same_float(va, vb, atol):
    if va is None or vb is None:
        return va is None and vb is None
    if math.isnan(va) or math.isnan(vb):
        return math.isnan(va) and math.isnan(vb)
    return abs(va - vb) <= atol


def _records_equal(h_a, h_b, atol=1e-5, bitwise=False):
    """NaN-aware record comparison (wall_s excluded: host telemetry)."""
    assert len(h_a.records) == len(h_b.records)
    for ra, rb in zip(h_a.records, h_b.records):
        assert ra.round == rb.round
        np.testing.assert_array_equal(ra.cohort, rb.cohort)
        np.testing.assert_array_equal(ra.mask_matrix, rb.mask_matrix)
        assert ra.uploaded_params == rb.uploaded_params
        for fld in ("train_loss", "test_loss", "test_acc"):
            va, vb = getattr(ra, fld), getattr(rb, fld)
            if bitwise and not (math.isnan(va) and math.isnan(vb)):
                assert va == vb, (fld, va, vb)
            else:
                assert _same_float(va, vb, atol), (fld, va, vb)


def _summaries_equal(sa, sb, atol=1e-5):
    assert set(sa) == set(sb)
    for k in sa:
        if isinstance(sa[k], float) or isinstance(sb[k], float):
            assert _same_float(sa[k], sb[k], atol), (k, sa[k], sb[k])
        else:
            assert sa[k] == sb[k], (k, sa[k], sb[k])


# ---------------------------------------------------------------------------
# the injector: byte-equal schedules, the same plan validation
# ---------------------------------------------------------------------------

PLANS = {
    "chaos": CHAOS_ALL,
    "all_kinds": dict(death_rate=0.25, corrupt_rate=0.5,
                      corrupt_kinds=("nan", "inf", "explode"),
                      stall_rate=0.3, dispatch_fail_rate=0.5,
                      dispatch_fail_count=2),
    "serve": dict(upload_fail_rate=0.3, slot_fault_rate=0.05),
    "saturated": dict(death_rate=1.0, corrupt_rate=1.0, stall_rate=1.0,
                      dispatch_fail_rate=1.0, upload_fail_rate=1.0,
                      slot_fault_rate=1.0, corrupt_kinds=("explode",)),
    "disabled": dict(CHAOS_ALL, enabled=False, upload_fail_rate=0.5,
                     slot_fault_rate=0.5),
}


def _schedule(inj, transient, n=5, rounds=6, slots=4):
    """Every hook's draws over ``rounds`` rounds, and the stats after."""
    out = []
    for t in range(rounds):
        survivors, codes = inj.round_faults(t, n)
        failed = []
        for attempt in range(4):
            try:
                inj.maybe_fail_dispatch(t, attempt)
                failed.append(False)
            except transient:
                failed.append(True)
        try:
            inj.maybe_fail_upload(t)
            upload = False
        except transient:
            upload = True
        out.append((survivors.tobytes(), codes.tobytes(),
                    inj.solver_stalls(t), inj.dispatch_failures(t),
                    tuple(failed), upload,
                    inj.slot_faults(t, slots).tobytes()))
    return out, dict(inj.stats)


@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_injector_schedules_are_byte_equal(name, seed):
    kw = dict(PLANS[name], seed=seed)
    got = _schedule(FaultInjector(FaultPlan(**kw)), TransientFault)
    want = _schedule(JInjector(JPlan(**kw)), JTransientFault)
    assert got == want
    if name == "disabled":
        assert all(v == 0 for v in got[1].values())


BAD_PLANS = [dict(death_rate=1.5), dict(corrupt_rate=-0.1),
             dict(slot_fault_rate=2.0), dict(corrupt_kinds=("zero",)),
             dict(corrupt_rate=0.5, corrupt_kinds=()),
             dict(ckpt_corrupt_kind="erase"), dict(max_dispatch_retries=-1),
             dict(dispatch_fail_count=0), dict(explode_scale=0.0),
             dict(explode_scale=math.inf)]


@pytest.mark.parametrize("kw", BAD_PLANS)
def test_fault_plan_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        JPlan(**kw)
    with pytest.raises(ValueError):
        FaultPlan(**kw)


def test_disabled_injector_draws_nothing():
    inj = FaultInjector(FaultPlan(enabled=False, death_rate=1.0,
                                  corrupt_rate=1.0, stall_rate=1.0,
                                  dispatch_fail_rate=1.0))
    survivors, codes = inj.round_faults(0, 5)
    np.testing.assert_array_equal(survivors, np.ones(5, np.float32))
    np.testing.assert_array_equal(codes, np.zeros(5, np.int32))
    assert not inj.solver_stalls(0)
    assert inj.dispatch_failures(0) == 0
    inj.maybe_fail_dispatch(0, 0)        # must not raise
    assert all(v == 0 for v in inj.stats.values())


def test_fault_draws_independent_of_call_order():
    a, b = (FaultInjector(FaultPlan(seed=9, death_rate=0.5,
                                    corrupt_rate=0.5)) for _ in range(2))
    fwd = [a.round_faults(t, 6) for t in range(4)]
    a_stalls = [a.solver_stalls(t) for t in range(4)]
    rev = [b.round_faults(t, 6) for t in reversed(range(4))][::-1]
    for (s1, c1), (s2, c2) in zip(fwd, rev):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(c1, c2)
    assert a_stalls == [b.solver_stalls(t) for t in range(4)]


def test_coerce_injector():
    assert coerce_injector(None) is None
    inj = FaultInjector(FaultPlan())
    assert coerce_injector(inj) is inj
    assert isinstance(coerce_injector(FaultPlan(seed=3)), FaultInjector)
    with pytest.raises(TypeError):
        coerce_injector(JPlan())          # the reference's plan is no plan
    assert CORRUPT_CODES == {"clean": 0, "nan": 1, "inf": 2, "explode": 3}


# ---------------------------------------------------------------------------
# the aggregation helpers against the reference's, code by code
# ---------------------------------------------------------------------------

def _stacked_tree(rng, n=4, big_row=None):
    tree = {"blocks": {"w": rng.standard_normal((n, 3, 5, 4)),
                       "b": rng.standard_normal((n, 3, 4))},
            "embed": np.zeros((n, 6, 4))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    if big_row is not None:              # finite, but Σx² overflows f32
        tree["blocks"]["w"][big_row] = 1e20
    return tree


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(a), tree)


def _tree_bits_equal(ttree, jtree):
    for k in jtree:
        if isinstance(jtree[k], dict):
            _tree_bits_equal(ttree[k], jtree[k])
        else:
            np.testing.assert_array_equal(ttree[k].numpy(),
                                          np.asarray(jtree[k]))


@pytest.mark.parametrize("max_sq", [math.inf, 50.0])
@pytest.mark.parametrize("code", [0, 1, 2, 3])
def test_helpers_equal_reference(code, max_sq):
    rng = np.random.RandomState(code)
    host = _stacked_tree(rng)
    codes = np.array([0, code, 0, code], np.int32)
    scale = 1e3
    jt = jagg.corrupt_delta_rows(host, codes, scale)
    tt = tagg.corrupt_delta_rows(_torch_tree(host), codes, scale)
    _tree_bits_equal(tt, jt)
    jok = np.asarray(jagg.finite_row_mask(jt, max_sq))
    tok = tagg.finite_row_mask(tt, max_sq)
    assert tok.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), jok)
    if code in (1, 2):
        assert jok[1] == 0 and jok[3] == 0
    survivors = np.array([1, 1, 0, 1], np.float32)
    ok = jok * survivors
    _tree_bits_equal(tagg.zero_delta_rows(tt, torch.tensor(ok)),
                     jagg.zero_delta_rows(jt, ok))


def test_helpers_work_in_place_and_keep_clean_rows():
    host = _stacked_tree(np.random.RandomState(3))
    tt = _torch_tree(host)
    w = tt["blocks"]["w"]
    out = tagg.corrupt_delta_rows(tt, np.array([0, 3, 1, 2]), 10.0)
    assert out["blocks"]["w"] is w
    np.testing.assert_array_equal(w[0].numpy(), host["blocks"]["w"][0])
    np.testing.assert_array_equal(w[1].numpy(),
                                  host["blocks"]["w"][1] * np.float32(10.0))
    assert torch.isnan(w[2]).all() and torch.isinf(w[3]).all()
    # the zero rows of frozen groups are filled too
    assert torch.isnan(tt["embed"][2]).all()
    assert torch.isinf(tt["embed"][3]).all()
    tagg.zero_delta_rows(tt, torch.tensor([1.0, 1.0, 0.0, 0.0]))
    assert out["blocks"]["w"] is w
    assert (w[2:] == 0).all() and (tt["embed"][2:] == 0).all()


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
def test_finite_guard_catches_a_single_bad_entry(bad):
    """One non-finite entry in an otherwise finite row quarantines it."""
    host = _stacked_tree(np.random.RandomState(4))
    host["blocks"]["b"][1, 2, 3] = bad
    host["embed"][3, 5, 0] = bad
    jok = np.asarray(jagg.finite_row_mask(host, math.inf))
    tok = tagg.finite_row_mask(_torch_tree(host), math.inf).numpy()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tok, [1.0, 0.0, 1.0, 0.0])


@pytest.mark.parametrize("max_sq,keep", [(math.inf, 1.0), (1e30, 0.0)])
def test_overflowing_square_sum_edge(max_sq, keep):
    """A finite row whose Σx² overflows f32 to inf: kept under the default
    infinite threshold (inf ≤ inf), quarantined under a finite one — the
    two predicates stay apart, in both packages."""
    host = _stacked_tree(np.random.RandomState(5), big_row=2)
    jok = np.asarray(jagg.finite_row_mask(host, max_sq))
    tok = tagg.finite_row_mask(_torch_tree(host), max_sq).numpy()
    np.testing.assert_array_equal(tok, jok)
    assert tok[2] == keep and tok[0] == 1.0


# ---------------------------------------------------------------------------
# the guarded round step against the reference's, on three families
# ---------------------------------------------------------------------------

STEP_WORLDS = {
    "xlm_roberta_base": (2, 32, dict(seq_len=8, n_classes=10,
                                     skew="label",
                                     objective="classification")),
    "tinyllama_1_1b": (2, 32, dict(seq_len=8, skew="feature",
                                   objective="lm")),
    "mamba2_370m": (2, 32, dict(seq_len=32, skew="feature",
                                objective="lm")),
}


@pytest.fixture(scope="module")
def step_worlds():
    return {}


def _step_world(cache, arch):
    if arch not in cache:
        n_layers, d_model, task = STEP_WORLDS[arch]
        jm, tm, jp, host = _worlds(arch, n_layers, d_model)
        data = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
            n_clients=8, vocab_size=jm.cfg.vocab_size,
            samples_per_client=16, **task))
        cohort = np.array([1, 4, 6, 2])
        batches = data.cohort_batches(cohort, 4, 2)
        L = tm.n_selectable
        masks = np.zeros((4, L), np.float32)
        masks[0, 0] = masks[1, L - 1] = masks[2, :] = masks[3, 0] = 1
        cache[arch] = (jm, tm, jp, host, batches, masks,
                       data.sizes[cohort].astype(np.float32))
    return cache[arch]


def _patterns(n):
    alt = (np.arange(n) % 2).astype(np.float32)
    return {
        "zeros": (np.zeros(n, np.float32), np.zeros(n, np.int32), 123.0,
                  456.0),
        "ones": (np.ones(n, np.float32), np.full(n, 3, np.int32), 123.0,
                 math.inf),
        "alternating": (alt, (alt * 3).astype(np.int32), 123.0, 456.0),
        # exploded rows over the norm threshold, clean rows under it
        "explode_threshold": (np.ones(n, np.float32),
                              (alt * 3).astype(np.int32), 1e6, 1e6),
    }


@pytest.mark.parametrize("pattern", ["zeros", "ones", "alternating",
                                     "explode_threshold"])
@pytest.mark.parametrize("arch", sorted(STEP_WORLDS))
def test_guarded_step_matches_reference(step_worlds, arch, pattern):
    jm, tm, jp, host, batches, masks, sizes = _step_world(step_worlds, arch)
    from repro.core.client import Client as JClient
    from repro_torch.core.client import Client as TClient
    survivors, codes, scale, max_sq = _patterns(len(masks))[pattern]
    jparams, jlosses, jok = JClient(jm).cohort_update_guarded(
        jp, batches, masks, sizes, 0.01, survivors, codes, scale, max_sq)
    tbatches = {k: torch.from_numpy(v) for k, v in batches.items()}
    tparams, tlosses, tok = TClient(tm).cohort_update_guarded(
        _tp(host), tbatches, masks, sizes, 0.01, survivors, codes, scale,
        max_sq)
    np.testing.assert_array_equal(tok, np.asarray(jok))
    if pattern == "explode_threshold":
        np.testing.assert_array_equal(tok, 1.0 - (codes == 3))
    assert _param_err(tparams, jparams) < STEP_ATOL
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-5,
                               atol=1e-6)


def test_guarded_step_without_faults_is_the_dense_step(step_worlds):
    _, tm, _, host, batches, masks, sizes = _step_world(step_worlds,
                                                        "tinyllama_1_1b")
    from repro_torch.core.client import Client as TClient
    client, n = TClient(tm), len(masks)
    tbatches = {k: torch.from_numpy(v) for k, v in batches.items()}
    p_guard, l_guard, ok = client.cohort_update_guarded(
        _tp(host), tbatches, masks, sizes, 0.01, np.ones(n, np.float32),
        np.zeros(n, np.int32), 1e30, math.inf)
    p_dense, l_dense = client.cohort_update(_tp(host), tbatches, masks,
                                            sizes, 0.01, cut=None)
    np.testing.assert_array_equal(ok, np.ones(n, np.float32))
    _params_equal(p_guard, p_dense)
    np.testing.assert_array_equal(l_guard, l_dense)


def test_client_death_matches_survivor_subset(world):
    """Death only: the guarded step's params equal the dense round run over
    exactly the surviving rows."""
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm))
    params = _tp(host)
    plan = srv.plan_round(0)
    sampled = srv.sample_round(plan)
    masks = srv.select_round(plan, srv.probe_round(params, sampled))
    n = len(plan.cohort)
    survivors = np.ones(n, np.float32)
    survivors[0] = 0.0
    p_guard, _, ok = srv.client.cohort_update_guarded(
        params, sampled.update_batches, masks, plan.sizes, srv.fl.lr,
        survivors, np.zeros(n, np.int32), 1e30, math.inf)
    np.testing.assert_array_equal(ok, survivors)
    idx = np.flatnonzero(survivors > 0)
    sub = {k: v[idx] for k, v in sampled.update_batches.items()}
    p_ref, _ = srv.client.cohort_update(params, sub, masks[idx],
                                        plan.sizes[idx], srv.fl.lr)
    assert _param_err(p_guard, p_ref) < STEP_ATOL


def test_all_quarantined_round_leaves_params_bitexact(world):
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm),
                   faults=FaultPlan(seed=1, corrupt_rate=1.0,
                                    corrupt_kinds=("nan",)))
    params = _tp(host)
    plan = srv.plan_round(0)
    sampled = srv.sample_round(plan)
    masks = srv.select_round(plan, srv.probe_round(params, sampled))
    new_params, losses = srv.update_round(params, sampled, masks)
    _params_equal(new_params, params)
    assert np.isnan(losses).all()
    assert srv.select_stats["quarantined_rows"] == len(plan.cohort)


def test_norm_threshold_quarantines_exploding_rows(world):
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm),
                   faults=FaultPlan(seed=2, corrupt_rate=1.0,
                                    corrupt_kinds=("explode",),
                                    explode_scale=1e6, max_delta_sq=1.0))
    params = _tp(host)
    plan = srv.plan_round(0)
    sampled = srv.sample_round(plan)
    masks = srv.select_round(plan, srv.probe_round(params, sampled))
    new_params, _ = srv.update_round(params, sampled, masks)
    _params_equal(new_params, params)


# ---------------------------------------------------------------------------
# whole runs against the reference: the synchronous loop, the scheduler at
# depths 1 and 4, the sequential engine
# ---------------------------------------------------------------------------

ENGINES = [("vectorized", False, 1), ("vectorized", True, 1),
           ("vectorized", True, 4), ("sequential", False, 1)]


def _servers(world, engine, pipeline, depth, faults, **kw):
    jm, tm, _, _ = world
    ts = FLServer(tm, _fl(tcfg, **kw), _tdata(tm), engine=engine,
                  pipeline=pipeline, pipeline_depth=depth,
                  faults=None if faults is None else FaultPlan(**faults))
    js = JServer(jm, _fl(jcfg, **kw), _jdata(jm), engine=engine,
                 pipeline=pipeline, pipeline_depth=depth,
                 faults=None if faults is None else JPlan(**faults))
    return ts, js


@pytest.mark.parametrize("engine,pipeline,depth", ENGINES)
def test_faulty_run_matches_reference(world, engine, pipeline, depth):
    _, _, jp, host = world
    ts, js = _servers(world, engine, pipeline, depth, CHAOS_ALL)
    tp, th = ts.run(_tp(host))
    jpp, jh = js.run(jp)
    _records_equal(th, jh, atol=RUN_ATOL)
    _summaries_equal(th.summary(), jh.summary(), atol=RUN_ATOL)
    assert ts.select_stats == js.select_stats
    assert ts._injector.stats == js._injector.stats
    assert ts.select_stats["dead_clients"] > 0
    assert ts.select_stats["quarantined_rows"] > 0
    assert ts.select_stats["solver_timeouts"] > 0
    assert ts.select_stats["dispatch_retries"] > 0
    assert _param_err(tp, jpp) < RUN_ATOL


def test_guarded_engines_agree_under_faults(world):
    _, tm, _, host = world
    outs = []
    for engine in ("vectorized", "sequential"):
        srv = FLServer(tm, _fl(tcfg), _tdata(tm), engine=engine,
                       faults=FaultPlan(**CHAOS))
        outs.append(srv.run(_tp(host)))
    _records_equal(outs[0][1], outs[1][1], atol=RUN_ATOL)
    assert _param_err(outs[0][0], outs[1][0]) < RUN_ATOL


@pytest.mark.parametrize("engine,pipeline,depth", ENGINES)
def test_fault_schedule_replays_deterministically(world, engine, pipeline,
                                                  depth):
    _, tm, _, host = world
    runs = []
    for _ in range(2):
        srv = FLServer(tm, _fl(tcfg), _tdata(tm), engine=engine,
                       pipeline=pipeline, pipeline_depth=depth,
                       faults=FaultPlan(**CHAOS))
        p, h = srv.run(_tp(host))
        runs.append((p, h, dict(srv.select_stats), dict(srv._injector.stats)))
    _records_equal(runs[0][1], runs[1][1], bitwise=True)
    _params_equal(runs[0][0], runs[1][0])
    assert runs[0][2] == runs[1][2] and runs[0][3] == runs[1][3]
    assert runs[0][2]["dead_clients"] > 0


@pytest.mark.parametrize("engine,pipeline,depth", ENGINES)
def test_disabled_injector_bit_identical(world, engine, pipeline, depth):
    _, tm, _, host = world
    outs = []
    for faults in (None, FaultPlan(enabled=False, **CHAOS_ALL)):
        srv = FLServer(tm, _fl(tcfg), _tdata(tm), engine=engine,
                       pipeline=pipeline, pipeline_depth=depth,
                       faults=faults)
        outs.append(srv.run(_tp(host)) + (dict(srv.select_stats),))
    _records_equal(outs[0][1], outs[1][1], bitwise=True)
    _params_equal(outs[0][0], outs[1][0])
    assert outs[0][2] == outs[1][2]


# ---------------------------------------------------------------------------
# solver stalls and dispatch failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 4])
def test_solver_stall_falls_back_and_completes(world, depth):
    _, _, jp, host = world
    plan = dict(seed=3, stall_rate=1.0)
    ts, js = _servers(world, "vectorized", True, depth, plan)
    _, hist = ts.run(_tp(host))
    _, jhist = js.run(jp)
    assert len(hist.records) == ts.fl.rounds
    assert ts.select_stats["solver_timeouts"] == ts.fl.rounds
    assert ts._injector.stats["stalls"] == ts.fl.rounds
    _records_equal(hist, jhist, atol=RUN_ATOL)
    assert ts.select_stats == js.select_stats


def test_dispatch_retry_recovers(world):
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm),
                   faults=FaultPlan(seed=4, dispatch_fail_rate=1.0,
                                    dispatch_fail_count=2,
                                    max_dispatch_retries=3))
    _, hist = srv.run(_tp(host))
    assert len(hist.records) == srv.fl.rounds
    assert srv.select_stats["dispatch_retries"] == 2 * srv.fl.rounds


@pytest.mark.parametrize("pipeline", [False, True])
def test_dispatch_retry_exhaustion_raises(world, pipeline):
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm), pipeline=pipeline,
                   faults=FaultPlan(seed=4, dispatch_fail_rate=1.0,
                                    dispatch_fail_count=5,
                                    max_dispatch_retries=2))
    with pytest.raises(TransientFault):
        srv.run(_tp(host))
    assert srv.select_stats["dispatch_retries"] == 3


def test_only_the_ports_transient_fault_is_retried(world):
    """Any other exception out of the round step propagates at once, the
    reference's TransientFault included."""
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm),
                   faults=FaultPlan(seed=4, dispatch_fail_rate=1.0,
                                    max_dispatch_retries=3))
    calls = []

    def failing(*args):
        calls.append(1)
        raise JTransientFault("not the port's")
    srv.client.cohort_update_guarded = failing
    with pytest.raises(JTransientFault):
        srv.run(_tp(host), rounds=1)
    assert len(calls) == 1
    # the injected failure before the call was retried once
    assert srv.select_stats["dispatch_retries"] == 1


def test_real_solver_deadline_degrades(world):
    """A wall-clock deadline the solve cannot meet (each solve made to take
    0.3 s, so the miss does not hang on the host's speed): the rounds run
    on the fallback masks and the run completes every round."""
    _, tm, _, host = world
    srv = FLServer(tm, _fl(tcfg), _tdata(tm), pipeline_depth=2,
                   solver_deadline_s=1e-9)
    select = srv.select_round

    def slow_select(plan, stats):
        time.sleep(0.3)
        return select(plan, stats)
    srv.select_round = slow_select
    _, hist = srv.run(_tp(host))
    assert len(hist.records) == srv.fl.rounds
    assert srv.select_stats["solver_timeouts"] > 0


# ---------------------------------------------------------------------------
# self-healing checkpoints
# ---------------------------------------------------------------------------

def _experiment(tm, task, ckpt_dir, rounds, **kw):
    return Experiment(tm, task, strategy="ours", cohort_size=3, rounds=rounds,
                      local_steps=2, lr=0.01, batch_size=4, budget=1,
                      lam=1.0, seed=0, checkpoint_dir=ckpt_dir,
                      checkpoint_every=2, device="cpu", **kw)


def _dirichlet(mod_cfg=TDirCfg, mod_task=TDirTask):
    return mod_task(mod_cfg(n_clients=8, n_topics=4, vocab_size=128,
                            seq_len=8, samples_per_client=16,
                            test_samples=32, seed=0))


@pytest.mark.parametrize("kind", CKPT_CORRUPT_KINDS)
def test_both_packages_detect_the_ports_damage(tmp_path, kind):
    tree = {"a": torch.arange(4096, dtype=torch.float32).reshape(64, 64),
            "b": {"c": torch.ones(2048, dtype=torch.int32)}}
    d = str(tmp_path / kind)
    path = save_checkpoint(d, 1, tree)
    assert verify_checkpoint(d, 1) == (True, "ok")
    assert jverify(d, 1)[0]
    FaultInjector.corrupt_checkpoint_dir(path, kind)
    for verify in (verify_checkpoint, jverify):
        ok, why = verify(d, 1)
        assert not ok and why
    step, skipped = latest_intact_step(d)
    assert step is None and skipped and skipped[0][0] == 1


@pytest.mark.parametrize("kind", CKPT_CORRUPT_KINDS)
def test_corrupt_latest_checkpoint_auto_resumes(world, tmp_path, kind):
    _, tm, _, _ = world
    ckpt = str(tmp_path / "ckpt")
    exp = _experiment(tm, _dirichlet(), ckpt, rounds=6)
    params0 = exp.init_params()
    exp.run(params0, rounds=6)
    FaultInjector.corrupt_checkpoint_dir(
        os.path.join(ckpt, "step_00000006"), kind)
    exp2 = _experiment(tm, _dirichlet(), ckpt, rounds=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, hist = exp2.run(params0, rounds=8)
    assert any("corrupt checkpoint" in str(w.message) for w in caught)
    assert exp2.server.select_stats["ckpt_fallbacks"] == 1
    assert [r.round for r in hist.records] == list(range(8))
    ref = _experiment(tm, _dirichlet(), str(tmp_path / "ref"), rounds=8)
    _, h_ref = ref.run(params0, rounds=8)
    _records_equal(hist, h_ref)


def test_all_checkpoints_corrupt_resumes_from_scratch(world, tmp_path):
    _, tm, _, _ = world
    ckpt = str(tmp_path / "ckpt")
    exp = _experiment(tm, _dirichlet(), ckpt, rounds=4)
    params0 = exp.init_params()
    _, h_first = exp.run(params0, rounds=4)
    for d in os.listdir(ckpt):
        if d.startswith("step_"):
            FaultInjector.corrupt_checkpoint_dir(os.path.join(ckpt, d),
                                                 "manifest")
    exp2 = _experiment(tm, _dirichlet(), ckpt, rounds=4)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        _, hist = exp2.run(params0, rounds=4)
    assert len(hist.records) == 4       # a full re-run from round 0
    _records_equal(hist, h_first)


def test_injected_checkpoint_corruption_counted(world, tmp_path):
    _, tm, _, _ = world
    ckpt = str(tmp_path / "ckpt")
    exp = _experiment(tm, _dirichlet(), ckpt, rounds=4,
                      faults=FaultPlan(seed=11, ckpt_corrupt_rate=1.0,
                                       ckpt_corrupt_kind="bitflip"))
    _, hist = exp.run(exp.init_params(), rounds=4)
    assert len(hist.records) == 4
    assert exp.server._injector.stats["ckpt_corruptions"] == 2
    for step in (2, 4):
        assert not verify_checkpoint(ckpt, step)[0]
        assert not jverify(ckpt, step)[0]


# ---------------------------------------------------------------------------
# plan-stage chaos: ChaosTask
# ---------------------------------------------------------------------------

def test_chaos_task_outside_listed_rounds_is_transparent(world):
    _, tm, _, host = world
    p_plain, h_plain = FLServer(tm, _fl(tcfg), _tdata(tm),
                                pipeline_depth=2).run(_tp(host))
    p_chaos, h_chaos = FLServer(tm, _fl(tcfg), ChaosTask(_tdata(tm)),
                                pipeline_depth=2).run(_tp(host))
    _records_equal(h_plain, h_chaos, bitwise=True)
    _params_equal(p_plain, p_chaos)


def test_all_straggler_rounds_degrade_and_count(world):
    jm, tm, jp, host = world
    srv = FLServer(tm, _fl(tcfg), ChaosTask(_tdata(tm),
                                            all_straggler_rounds=(1, 2)),
                   pipeline_depth=4)
    jsrv = JServer(jm, _fl(jcfg), JChaosTask(_jdata(jm),
                                             all_straggler_rounds=(1, 2)),
                   pipeline_depth=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p, hist = srv.run(_tp(host))
        jpp, jhist = jsrv.run(jp)
    assert len(hist.records) == srv.fl.rounds
    assert srv.select_stats["all_straggler_rounds"] == 2
    assert srv.select_stats == jsrv.select_stats
    assert any("drop_stragglers" in str(w.message) for w in caught)
    _records_equal(hist, jhist)
    assert _param_err(p, jpp) < RUN_ATOL


def test_empty_pool_mid_pipeline_fails_clean_checkpoint_survives(world,
                                                                 tmp_path):
    _, tm, _, _ = world
    ckpt = str(tmp_path / "ckpt")
    chaos = ChaosTask(_dirichlet(), empty_pool_rounds=(3,))
    exp = _experiment(tm, chaos, ckpt, rounds=6, pipeline_depth=4)
    params0 = exp.init_params()
    with pytest.raises(ValueError, match="empty pool"):
        exp.run(params0, rounds=6)
    assert verify_checkpoint(ckpt, 2) == (True, "ok")
    exp2 = _experiment(tm, _dirichlet(), ckpt, rounds=6, pipeline_depth=4)
    _, hist = exp2.run(params0, rounds=6)
    assert [r.round for r in hist.records] == list(range(6))


def test_chaos_task_hooks_equal_reference():
    t_task = ChaosTask(_dirichlet(), empty_pool_rounds=(1,),
                       all_straggler_rounds=(2,))
    j_task = JChaosTask(_dirichlet(JDirCfg, JDirTask),
                        empty_pool_rounds=(1,), all_straggler_rounds=(2,))
    for t in range(4):
        rt, rj = np.random.RandomState(t), np.random.RandomState(t)
        a, b = t_task.available_clients(t, rt), j_task.available_clients(t,
                                                                        rj)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        cohort = np.arange(5)
        np.testing.assert_array_equal(t_task.drop_stragglers(t, cohort, rt),
                                      j_task.drop_stragglers(t, cohort, rj))
    np.testing.assert_array_equal(t_task.sizes, j_task.sizes)
    tb = t_task.cohort_batches(np.array([0, 3]), 4, 2)
    jb = j_task.cohort_batches(np.array([0, 3]), 4, 2)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(t_task.stream_positions(),
                                  j_task.stream_positions())


# ---------------------------------------------------------------------------
# History.summary NaN containment
# ---------------------------------------------------------------------------

def _rec(t, loss, acc):
    return RoundRecord(round=t, test_loss=loss, test_acc=acc,
                       train_loss=loss, mask_matrix=np.ones((2, 2)),
                       cohort=np.arange(2), union_frac=1.0,
                       uploaded_params=10, wall_s=0.0)


def test_summary_excludes_nonfinite_rounds():
    h = History(records=[_rec(0, 1.0, 0.5), _rec(1, float("nan"), 0.9),
                         _rec(2, 0.8, 0.6), _rec(3, float("inf"), 0.1)])
    s = h.summary()
    assert s["rounds"] == 4 and s["nonfinite_rounds"] == 2
    assert s["final_loss"] == 0.8 and s["best_acc"] == 0.6
    assert s["uploaded_params_total"] == 40


def test_summary_all_poisoned():
    s = History(records=[_rec(0, float("nan"), float("nan"))]).summary()
    assert s["nonfinite_rounds"] == 1
    assert s["final_loss"] is None and s["best_acc"] is None
    assert History().summary()["nonfinite_rounds"] == 0
