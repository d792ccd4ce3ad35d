"""The port's moe family (reduced deepseek: ``dense0`` + 2 moe blocks, MLA,
4 experts top-2 and one shared expert, d_model 32, seq 32) through its
entry points against the JAX package's on shared weights: two rounds of
Experiment("ours"), synchronous and through the round scheduler at depth
1, against the reference's FLServer (the mask-aware engine: a cut at 0
keeps both segments, at 1 omits ``dense0``); one "top" round whose cut
falls inside ``blocks`` (``dense0`` frozen and omitted, the first
``blocks`` row frozen); SlotServer in shared and dense mode against
``repro.launch.serve``; delta mode refused; a checkpoint of the moe tree
crossing between the packages both ways.

Tolerances: f32 throughout; cohorts, masks and token ids exactly; losses
within 1e-4 and params within atol 1e-5 (sums in another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.api.experiment import Experiment
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.server import FLServer
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import DeltaOverlay

ATOL = 1e-5
LOSS_ATOL = 1e-4
SEQ = 32
TASK = dict(n_clients=8, seq_len=SEQ, samples_per_client=8, skew="label",
            objective="lm")
FL = dict(cohort_size=3, local_steps=2, lr=0.01, batch_size=2, budget=2,
          lam=1.0, seed=3)


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
    jc = jcfg.reduced(jcfg.get_arch("deepseek_v2_lite_16b"), n_layers=3,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("deepseek_v2_lite_16b"), n_layers=3,
                      d_model=32)
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


def _fl(mod, **kw):
    return mod.FLConfig(**{**dict(n_clients=TASK["n_clients"], rounds=2,
                                  strategy="ours", **FL), **kw})


def _max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max())


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
    js = JServer(jm, _fl(jcfg), _jdata(jm), pipeline=False)
    assert js.mask_aware
    return js.run(jp)


@pytest.mark.parametrize("way", [dict(pipeline=False),
                                 dict(pipeline=True, pipeline_depth=1)],
                         ids=["synchronous", "depth1"])
def test_rounds_match_reference(world, reference_run, way):
    """Two rounds of Experiment("ours"): the probe's per-layer norms over
    dense0 and blocks, (P1) selection, the mask-aware update at each
    round's cut (the routers' aux loss in every loss) and Eq.(5)-(7)."""
    _, tm, _, host = world
    p_want, h_want = reference_run
    exp = Experiment(tm, _tdata(tm), "ours", rounds=2, device="cpu",
                     **way, **FL)
    p_got, h_got = exp.run(_tp(host))
    assert exp.server.mask_aware
    _records_match(h_got, h_want)
    assert _max_err(p_got, p_want) < ATOL


def test_top_round_cuts_inside_blocks(world):
    """One "top" round at budget 1: every client trains the last layer, so
    the cut is 2, inside ``blocks``: ``dense0`` is frozen and left out of
    the trainable rows, ``blocks`` row 0 frozen, row 1 trained."""
    jm, tm, jp, host = world
    fl = dict(FL, budget=1)
    js = JServer(jm, _fl(jcfg, rounds=1, strategy="top", budget=1),
                 _jdata(jm), pipeline=False)
    p_want, h_want = js.run(jp)
    exp = Experiment(tm, _tdata(tm), "top", rounds=1, device="cpu",
                     pipeline=False, **fl)
    srv = exp.build()
    cut = srv._cut_for(np.asarray(h_want.records[0].mask_matrix))
    assert cut == 2
    tr = tmodel.trainable_rows(_tp(host), cut, tm.cfg)
    assert list(tr) == ["blocks"]
    assert tr["blocks"]["moe_router"].shape[0] == 1
    p_got, h_got = exp.run(_tp(host))
    _records_match(h_got, h_want)
    assert _max_err(p_got, p_want) < ATOL
    assert _max_err(p_got["dense0"], host["dense0"]) == 0.0
    assert _max_err({k: v[:1] for k, v in p_got["blocks"].items()},
                    {k: v[:1] for k, v in host["blocks"].items()}) == 0.0
    assert _max_err({k: v[1:] for k, v in p_got["blocks"].items()},
                    {k: v[1:] for k, v in host["blocks"].items()}) > 0


def _requests(mod, vocab, users):
    rng = np.random.RandomState(1)
    return [mod.Request(i, rng.randint(0, vocab, 4).tolist(), 5,
                        user_id=(i % users if users else -1))
            for i in range(7)]


@pytest.mark.parametrize("mode", ["shared", "dense"])
def test_slot_server_generates_reference_tokens(world, mode):
    """7 requests through 3 slots with staggered refills (the latent rows'
    positions reset between requests; the step's tokens share the
    routers' capacity; in dense mode each slot holds a user's private
    copy, built in place in its bank entry): the reference's token ids."""
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
    assert set(srv.cache) == {"dense0", "blocks"}
    tdone, tstats = srv.run(_requests(tserve, tm.cfg.vocab_size, users))
    assert [(r.rid, r.generated) for r in tdone] == \
        [(r.rid, r.generated) for r in jdone]
    assert tstats["steps"] == jstats["steps"]
    assert tstats["gen_tokens"] == jstats["gen_tokens"] == 35


def test_delta_mode_is_refused(world):
    """Capacity dropping couples a batch's slots, so moe has no per-slot
    delta decode: every delta entry point refuses it, as the reference's
    ``supports_delta_decode`` does."""
    jm, tm, _, host = world
    assert not jmodel.supports_delta_decode(jm.cfg)
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


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_between_the_packages(world, reference_run,
                                                 tmp_path, writer):
    """One package runs round 0 and checkpoints the moe tree (dense0 and
    blocks) at the boundary; the other restores it and runs round 1: the
    same records and params as the reference's two straight rounds."""
    jm, tm, jp, host = world
    p_want, h_want = reference_run
    d = str(tmp_path / "ckpt")
    kw = dict(pipeline=False, checkpoint_dir=d, checkpoint_every=1)
    jsrv = JServer(jm, _fl(jcfg), _jdata(jm), **kw)
    tsrv = FLServer(tm, _fl(tcfg), _tdata(tm), **kw)
    if writer == "port":
        tsrv.run(_tp(host), rounds=1)
        p_mid, start, hist = jsrv.restore_state(jp)
        assert start == 1
        p_got, h_got = jsrv.run(p_mid, start=start, history=hist)
        p_got = jax.tree.map(np.asarray, p_got)
    else:
        jsrv.run(jp, rounds=1)
        p_mid, start, hist = tsrv.restore_state(_tp(host))
        assert start == 1
        assert set(p_mid) == {"embed", "dense0", "blocks", "final_norm",
                              "head"}
        p_got, h_got = tsrv.run(p_mid, start=start, history=hist)
    _records_match(h_got, h_want)
    assert _max_err(p_got, p_want) < ATOL
