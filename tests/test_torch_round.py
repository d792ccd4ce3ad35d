"""The port's round math (repro_torch.core: masks, aggregation, Client)
against the JAX package's on the same parameters, masks and batches, on
the reduced xlm-roberta classifier of tests/test_round_engine.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import aggregation as jagg
from repro.core import masks as jM
from repro.core.client import Client as JClient
from repro.data.synthetic import FederatedTaskConfig, SyntheticFederatedData
from repro.models import model as jmodel
from repro_torch.api.strategy import get_strategy
from repro_torch.bridge import params_to_numpy, params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import aggregation as tagg
from repro_torch.core import masks as tM
from repro_torch.core.client import Client as TClient
from repro_torch.models import model as tmodel

LR = 0.01
ATOL = 1e-5


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
    data = SyntheticFederatedData(FederatedTaskConfig(
        n_clients=12, n_classes=10, vocab_size=jc.vocab_size, seq_len=8,
        samples_per_client=16, skew="label", objective="classification"))
    cohort = np.arange(4)
    batches = data.cohort_batches(cohort, 4, 2)
    return dict(jm=jm, tm=tm, jp=jp, host=host, data=data, cohort=cohort,
                batches=batches, sizes=data.sizes[cohort],
                jclient=JClient(jm), tclient=TClient(tm))


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _tp(host):
    return params_to_torch(host, "cpu")


def _max_err(a, b):
    """Largest |a − b| over two trees (torch or JAX leaves)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())


# ---------------------------------------------------------------------------
# core/masks
# ---------------------------------------------------------------------------

def test_weights_layer_selected_by_none():
    masks = np.array([[1, 0, 1], [1, 0, 0]], np.float32)
    sizes = np.array([7.0, 13.0])
    W = tM.aggregation_weights(masks, sizes).numpy()
    assert np.all(np.isfinite(W))
    np.testing.assert_array_equal(W[:, 1], 0.0)
    np.testing.assert_array_equal(W, np.asarray(jM.aggregation_weights(
        masks, sizes)))


def test_weights_single_selector_gets_full_weight():
    masks = np.array([[0, 1], [1, 1], [0, 1]], np.float32)
    sizes = np.array([1.0, 99.0, 5.0])
    W = tM.aggregation_weights(masks, sizes).numpy()
    np.testing.assert_allclose(W[:, 0], [0.0, 1.0, 0.0])


def test_weights_renormalize_over_selectors_as_reference():
    rng = np.random.RandomState(0)
    masks = (rng.rand(5, 6) > 0.4).astype(np.float32)
    masks[0] = 1.0
    sizes = rng.randint(1, 100, 5).astype(np.float32)
    W = tM.aggregation_weights(masks, sizes).numpy()
    np.testing.assert_allclose(W.sum(0), 1.0, atol=1e-6)
    np.testing.assert_allclose(W, np.asarray(jM.aggregation_weights(
        masks, sizes)), rtol=1e-6)
    alpha = sizes / sizes.sum()
    np.testing.assert_allclose(
        tM.chi_divergence(torch.from_numpy(W), alpha).numpy(),
        np.asarray(jM.chi_divergence(jnp.asarray(W), alpha)), rtol=1e-5)


def test_host_mask_helpers_match_reference(world):
    L = 4
    for masks in (np.zeros((3, L), np.float32),
                  np.array([[0, 0, 1, 0], [0, 1, 0, 1]], np.float32)):
        assert tM.first_trainable_layer(masks) == \
            jM.first_trainable_layer(masks)
        np.testing.assert_array_equal(tM.union_mask(masks),
                                      jM.union_mask(masks))
    np.testing.assert_array_equal(tM.mask_from_indices([1, 3], L),
                                  jM.mask_from_indices([1, 3], L))
    np.testing.assert_array_equal(
        tM.count_layer_params(_tp(world["host"]), world["tm"].cfg),
        jM.count_layer_params(world["jp"], world["jm"].cfg))


def test_per_layer_stats_and_norms_match_reference(world):
    rng = np.random.RandomState(4)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                     world["host"])
    cfg_j, cfg_t = world["jm"].cfg, world["tm"].cfg
    want = jM.per_layer_stats(jax.tree.map(jnp.asarray, g), cfg_j)
    got = tM.per_layer_stats(_tp(g), cfg_t)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(
        tM.per_layer_sq_norms(_tp(g), cfg_t).numpy(),
        np.asarray(jM.per_layer_sq_norms(jax.tree.map(jnp.asarray, g), cfg_j,
                                         mode="jnp")), rtol=1e-5)


# ---------------------------------------------------------------------------
# core/aggregation
# ---------------------------------------------------------------------------

def test_apply_layer_mask_zeroes_unselected(world):
    tp = _tp(world["host"])
    out = tmodel.apply_layer_mask(tp, torch.tensor([1.0, 0.0, 1.0, 1.0]),
                                  world["tm"].cfg)
    for name, leaf in out["blocks"].items():
        assert float(leaf[1].abs().max()) == 0.0, name
        assert torch.equal(leaf[0], tp["blocks"][name][0])
    assert float(out["embed"]["tok"].abs().max()) == 0.0


def test_aggregate_weighted_mean(world):
    """Eq.(5): a layer selected by clients {0,1} with d = (1, 3) gets
    w = ¼, ¾; a layer nobody selected gets 0."""
    cfg = world["tm"].cfg
    tp = _tp(world["host"])
    ones = jax.tree.map(torch.ones_like, tp)
    twos = jax.tree.map(lambda x: 2 * torch.ones_like(x), tp)
    masks = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    out = tagg.aggregate([ones, twos], masks, np.array([1.0, 3.0]), cfg)
    b = out["blocks"]["attn_wq"]
    np.testing.assert_allclose(b[0].numpy(), 0.25 * 1 + 0.75 * 2)
    np.testing.assert_allclose(b[1].numpy(), 1.0)
    np.testing.assert_allclose(b[2].numpy(), 0.0)
    assert float(out["embed"]["tok"].abs().max()) == 0.0


def _rand_like(tree, rng):
    return jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.mark.parametrize("cut", [0, 2, 3])
def test_suffix_aggregation_and_apply_match_reference(world, cut):
    cfg_j, cfg_t = world["jm"].cfg, world["tm"].cfg
    rng = np.random.RandomState(cut)
    n = 3
    suffix = jax.tree.map(np.asarray,
                          jmodel.trainable_slice(world["host"], cut, cfg_j))
    deltas = jax.tree.map(
        lambda a: rng.standard_normal((n,) + a.shape).astype(np.float32),
        suffix)
    masks = np.array([[0, 1, 1, 1], [0, 0, 1, 1], [0, 0, 0, 1]], np.float32)
    masks[:, :cut] = 0.0
    sizes = np.array([4.0, 12.0, 9.0])
    jW = jM.aggregation_weights(masks, sizes)
    want_u = jagg.aggregate_stacked_suffix(jax.tree.map(jnp.asarray, deltas),
                                           jW, cut, cfg_j)
    got_u = tagg.aggregate_stacked_suffix(
        _tp(deltas), tM.aggregation_weights(masks, sizes), cut, cfg_t)
    assert _max_err(got_u, want_u) < 1e-6
    want_p = jagg.apply_update_suffix(world["jp"], want_u, LR, cut, cfg_j)
    tp = _tp(world["host"])
    got_p = tagg.apply_update_suffix(tp, got_u, LR, cut, cfg_t)
    assert _max_err(got_p, want_p) < 1e-6
    # frozen groups and frozen rows pass through untouched
    assert got_p["embed"]["tok"] is tp["embed"]["tok"]
    for name, leaf in got_p["blocks"].items():
        assert torch.equal(leaf[:cut], tp["blocks"][name][:cut])


def test_aggregate_stacked_matches_sequential_and_reference(world):
    cfg_j, cfg_t = world["jm"].cfg, world["tm"].cfg
    rng = np.random.RandomState(0)
    deltas = [_rand_like(world["host"], rng) for _ in range(3)]
    masks = np.array([[1, 1, 0, 0], [1, 0, 1, 0], [0, 0, 1, 1]], np.float32)
    sizes = np.array([4.0, 12.0, 9.0])
    seq = tagg.aggregate([_tp(d) for d in deltas], masks, sizes, cfg_t)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *deltas)
    vec = tagg.aggregate_stacked(_tp(stacked),
                                 tM.aggregation_weights(masks, sizes), cfg_t)
    assert _max_err(seq, vec) < 1e-5
    want = jagg.aggregate_stacked(jax.tree.map(jnp.asarray, stacked),
                                  jM.aggregation_weights(masks, sizes), cfg_j)
    assert _max_err(vec, want) < 1e-5
    new = tagg.apply_update(_tp(world["host"]), vec, 0.5)
    assert _max_err(new, jagg.apply_update(world["jp"], want, 0.5)) < 1e-5


# ---------------------------------------------------------------------------
# core/client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reqs,strategy", [
    (("grad_sq_norms",), None),
    (("grad_sq_norms", "param_sq_norms", "grad_means", "grad_vars"), None),
    (("grad_sq_norms", "param_sq_norms"), "rgn"),
])
def test_probe_cohort_matches_reference(world, reqs, strategy):
    from repro.api.strategy import get_strategy as jget
    pb = world["data"].cohort_batches(np.arange(5, 8), 4, 2)
    jfn = jget(strategy).device_score_fn() if strategy else None
    tfn = get_strategy(strategy).device_score_fn() if strategy else None
    want = world["jclient"].probe_cohort(world["jp"], pb, reqs, jfn)
    got = world["tclient"].probe_cohort(_tp(world["host"]), _t(pb), reqs,
                                        tfn)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (3, 4) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("cut", [None, 0, 2, 4])
def test_cohort_update_matches_reference(world, cut):
    L = 4
    masks = np.array([[0, 1, 1, 0], [0, 0, 1, 1], [1, 0, 0, 1],
                      [0, 0, 1, 0]], np.float32)
    if cut is not None:
        masks[:, :cut] = 0.0
    want_p, want_l = world["jclient"].cohort_update(
        world["jp"], world["batches"], masks, world["sizes"], LR, cut=cut)
    got_p, got_l = world["tclient"].cohort_update(
        _tp(world["host"]), _t(world["batches"]), masks, world["sizes"], LR,
        cut=cut)
    assert _max_err(got_p, want_p) < ATOL
    np.testing.assert_allclose(got_l, want_l, atol=ATOL)
    if cut == L:
        assert _max_err(got_p, world["host"]) == 0.0


def test_masked_equals_dense_at_every_cut_in_the_port(world):
    client = world["tclient"]
    L = 4
    tb = _t(world["batches"])
    for cut in range(L + 1):
        masks = np.zeros((4, L), np.float32)
        masks[:, cut:] = 1.0
        masks[1, cut:cut + 1] = 0.0            # rows differ above the cut
        p_d, l_d = client.cohort_update(_tp(world["host"]), tb, masks,
                                        world["sizes"], LR)
        p_m, l_m = client.cohort_update(_tp(world["host"]), tb, masks,
                                        world["sizes"], LR, cut=cut)
        assert _max_err(p_d, p_m) < ATOL, f"cut={cut}"
        np.testing.assert_allclose(l_m, l_d, atol=ATOL)


def test_local_update_and_evaluate_match_reference(world):
    mask = np.array([0, 1, 0, 1], np.float32)
    b0 = jax.tree.map(lambda x: x[0], world["batches"])
    want_d, want_l = world["jclient"].local_update(world["jp"], b0, mask, LR)
    got_d, got_l = world["tclient"].local_update(_tp(world["host"]), _t(b0),
                                                 mask, LR)
    assert _max_err(got_d, want_d) < ATOL
    assert got_l == pytest.approx(want_l, abs=ATOL)
    test = world["data"].test_batch(32)
    wl, wa = world["jclient"].evaluate(world["jp"], test)
    tl, ta = world["tclient"].evaluate(_tp(world["host"]), _t(test))
    assert tl == pytest.approx(wl, abs=ATOL) and ta == wa


def test_cohort_update_leaves_global_params_intact(world):
    """The τ loop's first input is a view of the global params; the
    out-of-place update must never write through it."""
    tp = _tp(world["host"])
    before = params_to_numpy(tp)
    world["tclient"].cohort_update(tp, _t(world["batches"]),
                                   np.ones((4, 4), np.float32),
                                   world["sizes"], LR, cut=0)
    assert _max_err(tp, before) == 0.0
