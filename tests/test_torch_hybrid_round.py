"""The port's hybrid family (reduced zamba2: 3 Mamba2 blocks and the shared
attention+MLP block, d_model 32, seq 64) through its entry points against
the JAX package's on shared weights: two rounds of Experiment("ours"),
synchronous and through the round scheduler at depth 1, against the
reference's FLServer (the dense program: the hybrid has no prefix cut);
a guarded round under client death and NaN/Inf deltas, so the shared
block's unstacked leaves go through the in-place fault helpers; SlotServer
in shared and dense mode against ``repro.launch.serve``; and the refusals
(the mask-aware engine, delta serving, the families still unported).

Tolerances: f32 throughout; cohorts, masks, fault counters and token ids
exactly; losses within 1e-4 and params within atol 1e-5 (sums in another
order)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.faults import FaultPlan as JPlan
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.api.experiment import Experiment
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.server import FLServer
from repro_torch.data import synthetic as tsyn
from repro_torch.faults import FaultPlan
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import DeltaOverlay

ATOL = 1e-5
LOSS_ATOL = 1e-4
SEQ = 64
TASK = dict(n_clients=8, seq_len=SEQ, samples_per_client=8, skew="label",
            objective="lm")
FL = dict(cohort_size=3, local_steps=2, lr=0.01, batch_size=2, budget=2,
          lam=1.0, seed=3)
# one guarded round: two of the three rows die or turn NaN/Inf (seed
# chosen so that round 0 has both a death and a corrupted row)
FAULTS = dict(seed=1, death_rate=0.4, corrupt_rate=0.4,
              corrupt_kinds=("nan", "inf"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    rt = dict(remat=False, seq_chunk=16)
    jc = jcfg.reduced(jcfg.get_arch("zamba2_7b"), n_layers=2, d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("zamba2_7b"), n_layers=2, d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(**rt))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(**rt), device="cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jm, tm, jp, host


def _tp(host):
    return params_to_torch(host, "cpu")


def _tdata(tm):
    return tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))


def _jdata(jm):
    return jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))


def _max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    return float(np.abs(a.detach().float().numpy()
                        - np.asarray(b, np.float32)).max())


def _records_match(h_got, h_want):
    assert len(h_got.records) == len(h_want.records)
    for rg, rw in zip(h_got.records, h_want.records):
        np.testing.assert_array_equal(rg.cohort, rw.cohort)
        np.testing.assert_array_equal(rg.mask_matrix, rw.mask_matrix)
        assert rg.train_loss == pytest.approx(rw.train_loss, abs=LOSS_ATOL)
        assert rg.test_loss == pytest.approx(rw.test_loss, abs=LOSS_ATOL)


@pytest.fixture(scope="module")
def reference_run(world):
    jm, _, jp, _ = world
    js = JServer(jm, jcfg.FLConfig(n_clients=TASK["n_clients"], rounds=2,
                                   strategy="ours", **FL), _jdata(jm),
                 pipeline=False)
    assert not js.mask_aware
    return js.run(jp)


@pytest.mark.parametrize("way", [dict(pipeline=False),
                                 dict(pipeline=True, pipeline_depth=1)],
                         ids=["synchronous", "depth1"])
def test_rounds_match_reference(world, reference_run, way):
    """Two rounds of Experiment("ours"): the dense program (every
    selectable layer differentiated, the shared block's row included),
    the probe's per-layer norms, (P1) selection and Eq.(5)-(7)."""
    _, tm, _, host = world
    p_want, h_want = reference_run
    exp = Experiment(tm, _tdata(tm), "ours", rounds=2, device="cpu",
                     **way, **FL)
    p_got, h_got = exp.run(_tp(host))
    assert not exp.server.mask_aware
    assert exp.server._cut_for(h_got.records[0].mask_matrix) is None
    _records_match(h_got, h_want)
    # some client selected the shared block in some round
    assert any(r.mask_matrix[:, -1].any() for r in h_got.records)
    assert _max_err(p_got, p_want) < ATOL


def test_guarded_round_matches_reference(world):
    """One round under client death and NaN/Inf deltas: the guarded step
    corrupts, guards and zeroes the stacked deltas in place (the shared
    block's unstacked leaves among them) and reweights the survivors."""
    jm, tm, jp, host = world
    fl = dict(n_clients=TASK["n_clients"], rounds=1, strategy="ours", **FL)
    ts = FLServer(tm, tcfg.FLConfig(**fl), _tdata(tm), pipeline=False,
                  faults=FaultPlan(**FAULTS))
    js = JServer(jm, jcfg.FLConfig(**fl), _jdata(jm), pipeline=False,
                 faults=JPlan(**FAULTS))
    p_got, h_got = ts.run(_tp(host))
    p_want, h_want = js.run(jp)
    np.testing.assert_array_equal(h_got.records[0].cohort,
                                  h_want.records[0].cohort)
    np.testing.assert_array_equal(h_got.records[0].mask_matrix,
                                  h_want.records[0].mask_matrix)
    assert ts.select_stats == js.select_stats
    assert ts.select_stats["dead_clients"] > 0
    assert ts.select_stats["quarantined_rows"] > 0
    assert np.isfinite(h_got.records[0].test_loss)
    assert h_got.records[0].test_loss == pytest.approx(
        h_want.records[0].test_loss, abs=LOSS_ATOL)
    assert all(torch.isfinite(v).all() for v in p_got["shared_attn"].values())
    assert _max_err(p_got, p_want) < ATOL


def test_mask_aware_engine_is_refused(world):
    _, tm, _, _ = world
    fl = tcfg.FLConfig(n_clients=TASK["n_clients"], **FL)
    with pytest.raises(ValueError, match="prefix-cut"):
        FLServer(tm, fl, _tdata(tm), mask_aware=True)
    with pytest.raises(ValueError, match="prefix-cut"):
        Experiment(tm, _tdata(tm), "ours", mask_aware=True, device="cpu",
                   **FL).build()


def _requests(mod, vocab, users):
    rng = np.random.RandomState(1)
    return [mod.Request(i, rng.randint(0, vocab, 4).tolist(), 5,
                        user_id=(i % users if users else -1))
            for i in range(7)]


@pytest.mark.parametrize("mode", ["shared", "dense"])
def test_slot_server_generates_reference_tokens(world, mode):
    """7 requests through 3 slots with staggered refills (conv and state
    rows and the shared block's position rows reset between requests; in
    dense mode each slot holds a user's private copy, the shared block
    included): the reference's token ids."""
    jm, tm, jp, host = world
    tp = _tp(host)
    users = 3 if mode == "dense" else 0
    jstore = tstore = None
    if users:
        jstore = jserve.demo_store(jm, jp, users=3, layers_per_user=2, seed=0)
        tstore = tserve.demo_store(tm, tp, users=3, layers_per_user=2, seed=0)
    jdone, jstats = jserve.SlotServer(jm, jp, 3, 16, mode=mode,
                                      store=jstore).run(
        _requests(jserve, jm.cfg.vocab_size, users))
    srv = tserve.SlotServer(tm, tp, 3, 16, mode=mode, store=tstore,
                            device="cpu")
    assert set(srv.cache) == {"blocks", "shared_attn"}
    tdone, tstats = srv.run(_requests(tserve, tm.cfg.vocab_size, users))
    assert [(r.rid, r.generated) for r in tdone] == \
        [(r.rid, r.generated) for r in jdone]
    assert tstats["steps"] == jstats["steps"]
    assert tstats["gen_tokens"] == jstats["gen_tokens"] == 35


def test_delta_mode_is_refused(world):
    _, tm, _, host = world
    tp = _tp(host)
    store = tserve.demo_store(tm, tp, users=2, layers_per_user=1, seed=0)
    with pytest.raises(ValueError, match="delta-decode"):
        tserve.SlotServer(tm, tp, 2, 8, mode="delta", store=store,
                          device="cpu")
    with pytest.raises(ValueError, match="delta-decode"):
        DeltaOverlay(tm, 2, device="cpu")
    with pytest.raises(ValueError, match="delta-decode"):
        tm.decode_step(tp, torch.zeros(2, dtype=torch.long),
                       torch.tensor(0, dtype=torch.int32),
                       tm.init_cache(2, 4), delta={})


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "whisper_medium"])
def test_other_families_still_raise(arch):
    """The two families this test once held as unported both build now,
    each with its two selectable segments in the reference's key order:
    moe (``dense0``, ``blocks``) and audio (``enc_blocks``, ``blocks``,
    with the encoder's norm; tied embeddings, no head)."""
    cfg = tcfg.reduced(tcfg.get_arch(arch))
    model = tmodel.Model(cfg, tcfg.RuntimeConfig(remat=False), device="cpu")
    want = {"moe": ["embed", "dense0", "blocks", "final_norm", "head"],
            "audio": ["embed", "enc_blocks", "blocks", "enc_norm",
                      "final_norm"]}[cfg.family]
    assert list(model.init(0)) == want
    assert [s.path for s in tmodel.layer_layout(cfg)] == [
        k for k in want if k in ("dense0", "enc_blocks", "blocks")]


def test_full_config_builds_on_the_cpu_at_its_layout():
    """``Model(get_arch("zamba2_7b"), device="cpu")`` is the hybrid facade
    at full width; its cache layout (13 shared-block sites, 81 Mamba2
    rows) comes from the config without allocating weights."""
    m = tmodel.Model(tcfg.get_arch("zamba2_7b"), device="cpu")
    assert m.n_selectable == 82
    segs = tmodel.layer_layout(m.cfg)
    assert [(s.path, s.count) for s in segs] == [("blocks", 81),
                                                 ("shared_attn", 1)]
    cache = tmodel.Model(tcfg.reduced(tcfg.get_arch("zamba2_7b"),
                                      n_layers=12, d_model=32),
                         device="cpu").init_cache(2, 8, per_slot=True)
    assert cache["blocks"]["state"].shape[0] == 13
    assert cache["shared_attn"]["pos"].shape == (6, 2, 8)
