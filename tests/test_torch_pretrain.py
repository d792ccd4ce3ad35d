"""The port's optimizers and pretraining against the JAX package's: sgd,
adamw, apply_updates and cosine_schedule on the same numpy inputs (f32
within 1e-6, bf16 exact), pretrain on a reduced model (params within
1e-5) and Experiment(pretrain_steps=…)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.api.experiment import Experiment as JExperiment
from repro.configs import base as jcfg
from repro.data import synthetic as jsyn
from repro.data.pretrain import pretrain as jpretrain
from repro.models import model as jmodel
from repro_torch import optim as topt
from repro_torch.api.experiment import Experiment as TExperiment
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pretrain import pretrain as tpretrain
from repro_torch.models import model as tmodel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"a": {"w": (3, 5), "b": (5,)}, "c": (2, 2, 4)}
STEPS = 4


def _tree(rng, dtype):
    def make(shape):
        return rng.randn(*shape).astype(np.float32)
    out = {"a": {k: make(s) for k, s in SHAPES["a"].items()},
           "c": make(SHAPES["c"])}
    return out, dtype


def _to_j(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_t(tree, dtype):
    return params_to_torch(tree, "cpu", dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, exact):
    leaves_g = jax.tree.leaves(jax.tree.map(_np, got,
                                            is_leaf=torch.is_tensor))
    leaves_w = jax.tree.leaves(jax.tree.map(_np, want))
    assert len(leaves_g) == len(leaves_w)
    for g, w in zip(leaves_g, leaves_w):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _run(opt_t, opt_j, dtype_name):
    """STEPS updates of both optimizers on the same params and gradients."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    rng = np.random.RandomState(0)
    host, _ = _tree(rng, dtype_name)
    pt, pj = _to_t(host, td), _to_j(host, jd)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    exact = dtype_name == "bfloat16"
    for _ in range(STEPS):
        g, _ = _tree(rng, dtype_name)
        ut, st = opt_t.update(_to_t(g, td), st, pt)
        uj, sj = opt_j.update(_to_j(g, jd), sj, pj)
        _close(ut, uj, exact)
        pt, pj = topt.apply_updates(pt, ut), jopt.apply_updates(pj, uj)
        _close(pt, pj, exact)
    return st, sj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(dtype, momentum):
    st, sj = _run(topt.sgd(0.05, momentum), jopt.sgd(0.05, momentum), dtype)
    if momentum:
        _close(st["mu"], sj["mu"], dtype == "bfloat16")
    else:
        assert st == {} and sj == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference(dtype, weight_decay):
    st, sj = _run(topt.adamw(3e-3, weight_decay=weight_decay),
                  jopt.adamw(3e-3, weight_decay=weight_decay), dtype)
    # f32 moments on both sides, whatever the params' dtype
    for name in ("m", "v"):
        for leaf in jax.tree.leaves(st[name], is_leaf=torch.is_tensor):
            assert leaf.dtype == torch.float32
        _close(st[name], sj[name], exact=False)
    assert st["t"].dtype == torch.int32 and int(st["t"]) == int(sj["t"])
    assert st["t"].device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_rounds_like_reference(dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.RandomState(1)
    p, _ = _tree(rng, dtype)
    u = jax.tree.map(lambda a: a * 1e-3, _tree(rng, dtype)[0])
    got = topt.apply_updates(_to_t(p, td), params_to_torch(u, "cpu"))
    want = jopt.apply_updates(_to_j(p, jd), _to_j(u, jnp.float32))
    _close(got, want, exact=True)


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_schedule_matches_reference(warmup):
    lt, lj = topt.cosine_schedule(0.1, 40, warmup), \
        jopt.cosine_schedule(0.1, 40, warmup)
    for step in (0, 1, 3, 5, 6, 17, 39, 40, 55):
        got, want = lt(step), lj(step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), abs=1e-6)


# ---------------------------------------------------------------------------
# pretraining on a reduced model
# ---------------------------------------------------------------------------

TASK = dict(n_clients=8, n_classes=10, seq_len=8, samples_per_client=16,
            skew="label", objective="classification", seed=2)


@pytest.fixture(scope="module")
def world():
    jc = jcfg.reduced(jcfg.get_arch("xlm_roberta_base"), n_layers=2,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("xlm_roberta_base"), n_layers=2,
                      d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jm, tm, jp, host


def _max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    return float(np.abs(a.detach().numpy() - np.asarray(b)).max())


def test_pretrain_matches_reference(world):
    jm, tm, jp, host = world
    jdata = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))
    tdata = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    start = params_to_torch(host, "cpu")
    got = tpretrain(tm, start, tdata, steps=5, lr=3e-3, batch_size=16)
    want = jpretrain(jm, jp, jdata, steps=5, lr=3e-3, batch_size=16)
    assert _max_err(got, want) < 1e-5
    assert _max_err(got, jp) > 1e-3          # it trained
    assert _max_err(start, jp) == 0.0        # params are never written
    # both drew the pretraining corpus from the same stream position
    np.testing.assert_array_equal(tdata.pretrain_batch(4)["tokens"],
                                  jdata.pretrain_batch(4)["tokens"])


def test_experiment_pretrain_steps_gives_reference_params(world):
    """Experiment(pretrain_steps=3).init_params(): the reference's params
    from the same initial params (the port's init draws from torch's
    generator, so both start from the reference's init)."""
    jm, tm, jp, host = world
    kw = dict(pretrain_steps=3, pretrain_lr=1e-3, cohort_size=4, seed=0)
    jexp = JExperiment(jm, jsyn.SyntheticFederatedData(
        jsyn.FederatedTaskConfig(vocab_size=jm.cfg.vocab_size, **TASK)),
        "ours", **kw)
    texp = TExperiment(tm, tsyn.SyntheticFederatedData(
        tsyn.FederatedTaskConfig(vocab_size=tm.cfg.vocab_size, **TASK)),
        "ours", device="cpu", **kw)
    tm_init = tm.init
    tm.init = lambda seed: params_to_torch(host, "cpu")
    try:
        got = texp.init_params()
    finally:
        tm.init = tm_init
    want = jexp.init_params()
    assert _max_err(got, want) < 1e-5
    assert _max_err(got, jp) > 1e-4
