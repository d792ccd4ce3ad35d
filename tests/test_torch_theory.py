"""The port's §4.1 theory quantities (repro_torch.core.theory) against the
JAX package's (repro.core.theory) on the same parameters and numpy-seeded
batches: global and per-client gradients, κ_l, σ_l, E_t1, E_t2 (with and
without the population embedding) and the Theorem 4.7 right-hand side, for
reduced xlm-roberta (the fixture of tests/test_theory.py), reduced
TinyLlama (LM) and reduced Mamba2; then tests/test_theory.py's qualitative
checks on the port."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import theory as jtheory
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import theory
from repro_torch.core.masks import per_layer_sq_norms, union_mask
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_leaves

GRAD_TOL = 1e-5          # atol and rtol of every gradient leaf
REL_TOL = 1e-5           # relative tolerance of κ, σ, E_t1, E_t2

# (arch, n_layers, d_model, batch, seq, seq_chunk)
WORLDS = {
    "xlmr": ("xlm_roberta_base", 4, 64, 8, 16, 16),
    "tinyllama": ("tinyllama_1_1b", 3, 64, 4, 16, 16),
    "mamba2": ("mamba2_370m", 3, 64, 4, 32, 32),
}
_CACHE: dict = {}


def _batch(cfg, rng, B, S):
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.task == "classification":
        b["label"] = rng.randint(0, cfg.n_classes, (B,)).astype(np.int32)
    return b


def world(name):
    """Both models, the same params, client batches, α, the minibatches
    and full batch of σ, and the reference's quantities (computed once)."""
    if name in _CACHE:
        return _CACHE[name]
    arch, n_layers, d, B, S, chunk = WORLDS[name]
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=chunk))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=chunk),
                      device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), "cpu")
    rng = np.random.RandomState(3)
    batches = [_batch(jc, rng, B, S) for _ in range(4)]
    alpha = np.array([0.1, 0.2, 0.3, 0.4])
    minis = [_batch(jc, rng, B // 2, S) for _ in range(3)]
    full = _batch(jc, rng, 2 * B, S)
    gg = jtheory.global_gradient(jm, jp, batches, alpha)
    cg = jtheory.per_client_gradients(jm, jp, batches)
    ref = {"gg": gg, "cg": cg,
           "kappa": jtheory.kappa_per_layer(jm, gg, cg),
           "sigma": jtheory.sigma_per_layer(jm, jp, minis, full)}
    w = dict(jm=jm, tm=tm, jp=jp, tp=tp, batches=batches, alpha=alpha,
             minis=minis, full=full, ref=ref,
             gg=theory.global_gradient(tm, tp, batches, alpha),
             cg=theory.per_client_gradients(tm, tp, batches))
    _CACHE[name] = w
    return w


def _assert_tree_close(got, want, path=()):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], path + (k,))
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=GRAD_TOL,
                               rtol=GRAD_TOL, err_msg=str(path))


def _rel(got, want):
    np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=0)


@pytest.mark.parametrize("name", list(WORLDS))
def test_gradients_match_reference(name):
    w = world(name)
    _assert_tree_close(w["gg"], w["ref"]["gg"])
    assert all(t.dtype == torch.float32 for t in tree_leaves(w["gg"]))
    for got, want in zip(w["cg"], w["ref"]["cg"]):
        _assert_tree_close(got, want)


@pytest.mark.parametrize("name", list(WORLDS))
def test_kappa_and_sigma_match_reference(name):
    w = world(name)
    _rel(theory.kappa_per_layer(w["tm"], w["gg"], w["cg"]), w["ref"]["kappa"])
    _rel(theory.sigma_per_layer(w["tm"], w["tp"], w["minis"], w["full"]),
         w["ref"]["sigma"])


@pytest.mark.parametrize("name", list(WORLDS))
def test_e_t1_matches_reference(name):
    w = world(name)
    L = w["tm"].n_selectable
    for union in (np.zeros(L, np.float32), np.ones(L, np.float32),
                  (np.arange(L) % 2).astype(np.float32),
                  np.eye(L, dtype=np.float32)[0]):
        _rel(theory.e_t1(w["tm"], w["gg"], union),
             jtheory.e_t1(w["jm"], w["ref"]["gg"], union))


@pytest.mark.parametrize("name", list(WORLDS))
def test_e_t2_matches_reference(name):
    w = world(name)
    L = w["tm"].n_selectable
    kappa = w["ref"]["kappa"]
    rng = np.random.RandomState(5)
    masks = (rng.rand(3, L) < 0.5).astype(np.float32)
    masks[0, 0] = 1.0
    sizes = np.array([10.0, 20.0, 40.0])
    _rel(theory.e_t2(masks, sizes, kappa), jtheory.e_t2(masks, sizes, kappa))
    pop = np.array([0.05, 0.1, 0.15, 0.2, 0.2, 0.3])
    idx = np.array([4, 0, 2])
    _rel(theory.e_t2(masks, sizes, kappa, population_alpha=pop,
                     cohort_idx=idx),
         jtheory.e_t2(masks, sizes, kappa, population_alpha=pop,
                      cohort_idx=idx))


@pytest.mark.parametrize("T,e1,e2", [(1, 0.0, 0.0), (100, 3.5, 1.25),
                                     (10000, 50.0, 0.0)])
def test_theorem_rhs_matches_reference(T, e1, e2):
    kw = dict(f0=2.3, f_star=0.4, eta=0.01, gamma=2.0, T=T, sigma_sq=0.07,
              e1_sum=e1, e2_sum=e2)
    assert theory.theorem_4_7_rhs(**kw) == jtheory.theorem_4_7_rhs(**kw)


def test_theorem_rhs_refuses_large_lr():
    kw = dict(f0=2.0, f_star=0.5, eta=1.0, gamma=1.0, T=10, sigma_sq=0.1,
              e1_sum=0.0, e2_sum=0.0)
    with pytest.raises(AssertionError):
        jtheory.theorem_4_7_rhs(**kw)
    with pytest.raises(ValueError, match="learning rate too large"):
        theory.theorem_4_7_rhs(**kw)


# -- tests/test_theory.py's qualitative checks, on the port -----------------

@pytest.fixture(scope="module")
def setup():
    w = world("xlmr")
    return w["tm"], w["tp"], w["batches"], w["alpha"], w["gg"], w["cg"]


def test_e_t1_zero_when_all_selected(setup):
    model, params, batches, alpha, gg, cg = setup
    assert theory.e_t1(model, gg, np.ones(4, np.float32)) == 0.0


def test_e_t1_monotone_in_selection(setup):
    model, params, batches, alpha, gg, cg = setup
    full = theory.e_t1(model, gg, np.zeros(4, np.float32))
    partial = theory.e_t1(model, gg, np.array([1, 0, 0, 0], np.float32))
    assert full >= partial >= 0.0


def test_e_t2_zero_for_full_cohort_uniform(setup):
    model, params, batches, alpha, gg, cg = setup
    kappa = theory.kappa_per_layer(model, gg, cg)
    val = theory.e_t2(np.ones((4, 4), np.float32), alpha * 100, kappa)
    assert val < 1e-6


def test_e_t2_positive_for_partial_cohort(setup):
    model, params, batches, alpha, gg, cg = setup
    kappa = theory.kappa_per_layer(model, gg, cg)
    masks = np.array([[1, 1, 0, 0], [1, 0, 1, 0]], np.float32)
    val = theory.e_t2(masks, np.array([10.0, 20.0]), kappa,
                      population_alpha=alpha, cohort_idx=np.array([0, 1]))
    assert val > 0.0


def test_kappa_nonnegative_and_bounding(setup):
    model, params, batches, alpha, gg, cg = setup
    kappa = theory.kappa_per_layer(model, gg, cg)
    assert np.all(kappa >= 0)
    for g_i in cg:
        sq = per_layer_sq_norms(theory.layer_diff(model, gg, g_i),
                                model.cfg).numpy()
        assert np.all(np.sqrt(sq) <= kappa + 1e-5)


def test_theorem_rhs_structure():
    base = dict(f0=2.0, f_star=0.5, eta=0.01, gamma=1.0, sigma_sq=0.1)
    r_small = theory.theorem_4_7_rhs(**base, T=100, e1_sum=0.0, e2_sum=0.0)
    r_big_e = theory.theorem_4_7_rhs(**base, T=100, e1_sum=50.0, e2_sum=50.0)
    assert r_big_e > r_small
    r_long = theory.theorem_4_7_rhs(**base, T=10000, e1_sum=0.0, e2_sum=0.0)
    assert r_long < r_small


def test_error_floor_tracks_selection_quality(setup):
    model, params, batches, alpha, gg, cg = setup
    sq = per_layer_sq_norms(gg, model.cfg).numpy()
    best, worst = np.argmax(sq), np.argmin(sq)
    kappa = theory.kappa_per_layer(model, gg, cg)
    sizes = alpha * 100

    def floor(layer):
        masks = np.zeros((4, 4), np.float32)
        masks[:, layer] = 1
        return (theory.e_t1(model, gg, union_mask(masks))
                + theory.e_t2(masks, sizes, kappa))

    assert floor(best) < floor(worst)


def test_kernel_mode_routes_the_norms(setup, monkeypatch):
    """``mode`` reaches the per-layer norms: ``"torch"`` and the default
    agree on the CPU, and ``"cuda"`` takes the kernel wrapper (its plain
    version stands in for the kernel here) with one launch per leaf."""
    from repro_torch.kernels import layer_grad_norm as lgn
    from repro_torch.kernels import ops
    model, params, batches, alpha, gg, cg = setup
    union = np.array([1, 0, 0, 1], np.float32)
    want = theory.e_t1(model, gg, union)
    assert theory.e_t1(model, gg, union, mode="torch") == want
    monkeypatch.setattr(lgn, "layer_sq_norms_2d", lgn.layer_sq_norms_2d_torch)
    before = ops.LAUNCHES["layer_grad_norm"]
    assert theory.e_t1(model, gg, union, mode="cuda") == want
    assert ops.LAUNCHES["layer_grad_norm"] - before == len(gg["blocks"])
