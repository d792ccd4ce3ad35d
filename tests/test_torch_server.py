"""The port's FLServer and Experiment against the JAX package's on the
world of tests/test_round_engine.py: reduced xlm-roberta, 12 clients,
cohort 4, τ 2, budget 2, 2 rounds, the synchronous loop."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro_torch.api.experiment import Experiment
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.server import FLServer as TServer
from repro_torch.data import synthetic as tsyn
from repro_torch.faults import FaultPlan
from repro_torch.models import model as tmodel

TASK = dict(n_clients=12, n_classes=10, seq_len=8, samples_per_client=16,
            skew="label", objective="classification")
FL = dict(n_clients=12, cohort_size=4, rounds=2, local_steps=2, lr=0.01,
          batch_size=4, strategy="ours", budget=2, lam=1.0, seed=3)


@pytest.fixture(scope="module")
def world():
    jc = jcfg.reduced(jcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jm, tm, jp, host


def _max_err(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    return float(np.abs(a.detach().numpy() - np.asarray(b, np.float32)).max())


def _tree_err(a, b):
    """Largest |a − b| over two torch trees."""
    if isinstance(a, dict):
        return max(_tree_err(a[k], b[k]) for k in a)
    return float((a - b).abs().max())


def _port_run(tm, host, engine="vectorized", **kw):
    data = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    server = TServer(tm, tcfg.FLConfig(**FL), data, engine=engine,
                     pipeline=False, **kw)
    params, hist = server.run(params_to_torch(host, "cpu"))
    return params, hist, server, data


def _assert_same_rounds(h_got, h_want, loss_tol=1e-4):
    assert len(h_got.records) == len(h_want.records) == FL["rounds"]
    for rg, rw in zip(h_got.records, h_want.records):
        np.testing.assert_array_equal(rg.cohort, rw.cohort)
        np.testing.assert_array_equal(rg.mask_matrix, rw.mask_matrix)
        assert rg.uploaded_params == rw.uploaded_params
        assert rg.union_frac == rw.union_frac
        assert rg.train_loss == pytest.approx(rw.train_loss, abs=loss_tol)
        assert rg.test_loss == pytest.approx(rw.test_loss, abs=loss_tol)
        assert rg.test_acc == pytest.approx(rw.test_acc, abs=1e-6)


def test_two_rounds_match_reference(world):
    """Cohorts, masks and uploads exactly; losses within 1e-4; params within
    atol 1e-5 — the mask-aware vectorized engine on both sides."""
    jm, tm, jp, host = world
    jdata = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))
    jserver = JServer(jm, jcfg.FLConfig(**FL), jdata, pipeline=False)
    assert jserver.mask_aware
    p_want, h_want = jserver.run(jp)
    p_got, h_got, tserver, tdata = _port_run(tm, host)
    assert tserver.mask_aware
    _assert_same_rounds(h_got, h_want)
    assert _max_err(p_got, p_want) < 1e-5
    np.testing.assert_array_equal(tdata.stream_positions(),
                                  jdata.stream_positions())
    for k in tserver.select_stats:
        assert tserver.select_stats[k] == jserver.select_stats[k], k
    assert h_got.summary()["uploaded_params_total"] == \
        h_want.summary()["uploaded_params_total"]
    np.testing.assert_array_equal(h_got.selection_heatmap(),
                                  h_want.selection_heatmap())


def test_sequential_and_vectorized_engines_agree(world):
    _, tm, _, host = world
    p_vec, h_vec, _, _ = _port_run(tm, host, "vectorized")
    p_seq, h_seq, sseq, _ = _port_run(tm, host, "sequential")
    assert not sseq.mask_aware
    _assert_same_rounds(h_seq, h_vec)
    assert _tree_err(p_seq, p_vec) < 1e-5


def test_experiment_matches_server_run(world):
    _, tm, _, host = world
    p_srv, h_srv, _, _ = _port_run(tm, host)
    data = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    fl = {k: v for k, v in FL.items() if k not in ("n_clients", "strategy")}
    exp = Experiment(tm, data, "ours", pipeline=False, device="cpu", **fl)
    p_exp, h_exp = exp.run(params_to_torch(host, "cpu"))
    _assert_same_rounds(h_exp, h_srv, loss_tol=0.0)
    assert _tree_err(p_exp, p_srv) == 0.0
    assert exp.fl.n_clients == 12 and exp.fl.strategy == "ours"


def test_unported_features_raise(world, tmp_path):
    """Every model family is ported; what the reference cannot run stays
    refused: whisper's per-slot decode (the reference's fails in its
    cross-attention) and its delta decode.  Fault injection is ported (a
    fault plan is taken, anything else is rejected as the reference
    rejects it); the scheduler (the vectorized engine's default),
    checkpoints and pretraining run."""
    _, tm, _, host = world
    data = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    fl = tcfg.FLConfig(**FL)
    params = params_to_torch(host, "cpu")
    whisper = tmodel.Model(tcfg.reduced(tcfg.get_arch("whisper_medium")),
                           tcfg.RuntimeConfig(remat=False), device="cpu")
    wp = whisper.init(0)
    with pytest.raises(ValueError, match="one shared position"):
        whisper.decode_step(wp, torch.zeros(2, dtype=torch.long),
                            torch.zeros(2, dtype=torch.int32),
                            whisper.init_cache(2, 4, per_slot=True))
    with pytest.raises(ValueError, match="delta-decode"):
        whisper.decode_step(wp, torch.zeros(2, dtype=torch.long),
                            torch.tensor(0, dtype=torch.int32),
                            whisper.init_cache(2, 4), delta={})
    with pytest.raises(TypeError, match="FaultPlan"):
        TServer(tm, fl, data, faults=object())
    with pytest.raises(TypeError, match="FaultPlan"):
        Experiment(tm, data, "ours", device="cpu", faults=object()).build()
    assert TServer(tm, fl, data, faults=FaultPlan())._faults_active
    server = TServer(tm, fl, data, checkpoint_dir=str(tmp_path / "c"))
    assert server.pipeline and server.engine == "vectorized"
    _, hist = server.run(params, 1)                    # the scheduler
    assert len(hist.records) == 1
    exp = Experiment(tm.cfg, data, "ours", pretrain_steps=1, device="cpu")
    assert exp.pretrain_steps == 1
    # the sequential oracle never engages the scheduler
    _, hist = TServer(tm, fl, data, engine="sequential").run(params, 1)
    assert len(hist.records) == 1


def test_entry_points_default_to_cuda(world):
    _, tm, _, _ = world
    data = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    if torch.cuda.is_available():
        assert Experiment(tm.cfg, data, "ours").model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Experiment(tm.cfg, data, "ours")
