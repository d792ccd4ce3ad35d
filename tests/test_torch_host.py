"""The port's host side (numpy copies: data/synthetic, core/solver,
core/strategies, api/strategy, core/state) against the JAX package's:
byte-identical data streams, identical masks from identical inputs,
exact state round trips."""
import numpy as np
import pytest

from repro.api import strategy as jstrat
from repro.core import solver as jsolver
from repro.core import state as jstate
from repro.core.strategies import ProbeReport as JReport
from repro.data import synthetic as jsyn
from repro_torch.api import strategy as tstrat
from repro_torch.core import solver as tsolver
from repro_torch.core import state as tstate
from repro_torch.core.strategies import ProbeReport as TReport
from repro_torch.data import synthetic as tsyn

TASKS = {
    "label-cls": dict(skew="label", objective="classification"),
    "feature-cls": dict(skew="feature", objective="classification"),
    "label-lm": dict(skew="label", objective="lm"),
    "feature-lm": dict(skew="feature", objective="lm"),
    "patches-cls": dict(skew="feature", objective="classification",
                        modality="patches"),
}


def _assert_batches_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("task", sorted(TASKS))
def test_synthetic_streams_are_byte_identical(task):
    kw = dict(n_clients=10, vocab_size=64, seq_len=12, samples_per_client=16,
              test_samples=24, seed=5, **TASKS[task])
    j = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(**kw))
    t = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(**kw))
    np.testing.assert_array_equal(t.sizes, j.sizes)
    np.testing.assert_array_equal(t.alpha, j.alpha)
    rng = np.random.RandomState(0)
    for _ in range(3):
        cohort = rng.choice(10, size=4, replace=False)
        _assert_batches_equal(t.cohort_batches(cohort, 3, 2),
                              j.cohort_batches(cohort, 3, 2))
        _assert_batches_equal(t.test_batch(), j.test_batch())
        _assert_batches_equal(t.test_batch(8), j.test_batch(8))
    np.testing.assert_array_equal(t.stream_positions(), j.stream_positions())


def _probe(n=5, L=6, seed=0):
    rng = np.random.RandomState(seed)
    stats = {"grad_sq_norms": rng.rand(n, L).astype(np.float32) * 3,
             "param_sq_norms": rng.rand(n, L).astype(np.float32) + 0.5,
             "grad_means": rng.randn(n, L).astype(np.float32) * 0.1,
             "grad_vars": rng.rand(n, L).astype(np.float32) + 0.1}
    return stats


@pytest.mark.parametrize("name", jstrat.strategy_names())
@pytest.mark.parametrize("warm", [False, True])
def test_every_strategy_gives_identical_masks(name, warm):
    assert tstrat.strategy_names() == jstrat.strategy_names()
    stats = _probe()
    n, L = stats["grad_sq_norms"].shape
    budgets = np.array([1, 2, 3, 2, 4])
    init = None
    if warm:
        init = np.zeros((n, L), np.float32)
        init[:, :2] = 1.0
    ids = np.array([3, 9, 1, 7, 4])
    jctx = jstrat.SelectionContext(client_ids=ids, round=2, lam=0.5,
                                   n_layers=L, init=init)
    tctx = tstrat.SelectionContext(client_ids=ids, round=2, lam=0.5,
                                   n_layers=L, init=init)
    js, ts = jstrat.get_strategy(name), tstrat.get_strategy(name)
    assert (ts.host, ts.probe_requirements, ts.memoizable_select) == \
        (js.host, js.probe_requirements, js.memoizable_select)
    want = js.select(JReport(**stats), budgets, jctx)
    got = ts.select(TReport(**stats), budgets, tctx)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mixture_strategy_gives_identical_masks():
    stats = _probe(seed=3)
    budgets = np.array([2, 2, 1, 3, 2])
    ids = np.array([0, 1, 2, 3, 4])
    assign = {0: "top", 1: "snr", 2: "ours", 3: "rgn"}
    jm = jstrat.MixtureStrategy(assign, default="bottom")
    tm = tstrat.MixtureStrategy(assign, default="bottom")
    assert tm.probe_requirements == jm.probe_requirements
    assert (tm.host, tm.memoizable_select) == (jm.host, jm.memoizable_select)
    want = jm.select(JReport(**stats), budgets,
                     jstrat.SelectionContext(client_ids=ids, lam=1.0))
    got = tm.select(TReport(**stats), budgets,
                    tstrat.SelectionContext(client_ids=ids, lam=1.0))
    np.testing.assert_array_equal(got, want)


def test_unknown_strategy_names_the_registered_ones():
    with pytest.raises(tstrat.UnknownStrategyError, match="ours"):
        tstrat.get_strategy("ourz")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solvers_match_reference(seed):
    rng = np.random.RandomState(seed)
    G = rng.rand(6, 8)
    budgets = rng.randint(0, 5, 6)
    costs = rng.rand(8) + 0.5
    for lam in (0.0, 0.3, 5.0):
        jm_, jo, ji = jsolver.solve_icm(G, budgets, lam, costs=costs)
        tm_, to, ti = tsolver.solve_icm(G, budgets, lam, costs=costs)
        np.testing.assert_array_equal(tm_, jm_)
        assert (to, ti) == (jo, ji)
    np.testing.assert_array_equal(tsolver.solve_unified(G, budgets),
                                  jsolver.solve_unified(G, budgets))
    np.testing.assert_array_equal(tsolver.greedy_rows(G, budgets),
                                  jsolver.greedy_rows(G, budgets))


def _exercise(store, ids_rounds):
    rng = np.random.RandomState(0)
    for t, ids in enumerate(ids_rounds):
        store.set_warm_rows(ids, (rng.rand(len(ids), store.L) > 0.5)
                            .astype(np.float32), t=t)
        store.set_stat_rows(ids, {"grad_sq_norms": rng.rand(len(ids),
                                                            store.L)})
        if t == 1:
            store.clear_stats()


def test_client_state_store_round_trips_and_matches_reference():
    rounds = [np.array([1, 4, 7]), np.array([2, 4]), np.array([0, 9, 7])]
    j, t = jstate.ClientStateStore(10, 5), tstate.ClientStateStore(10, 5)
    _exercise(j, rounds)
    _exercise(t, rounds)
    jd, td = j.state_dict(), t.state_dict()
    assert sorted(td) == sorted(jd)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    back = tstate.ClientStateStore(10, 5)
    back.load_state_dict(td)
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(v, td[k], err_msg=k)
    ids = np.array([9, 7, 0])
    np.testing.assert_array_equal(back.stat_rows(ids)["grad_sq_norms"],
                                  t.stat_rows(ids)["grad_sq_norms"])
    rows, valid = back.warm_rows(ids)
    np.testing.assert_array_equal(rows, j.warm_rows(ids)[0])
    assert valid.all() and not back.warm_rows([5])[1].any()
    np.testing.assert_array_equal(back.missing_stats(np.arange(10)),
                                  j.missing_stats(np.arange(10)))


def test_stream_state_and_rng_helpers_round_trip():
    s = tstate.ClientStreamState(6, lambda i: 100 + i)
    for i in (4, 1, 4):
        s.rng(i).random_sample(3)
        s.advance(i, 3)
    d = s.state_dict()
    back = tstate.ClientStreamState(6, lambda i: 100 + i)
    back.load_state_dict(d)
    np.testing.assert_array_equal(back.positions, s.positions)
    np.testing.assert_array_equal(back.touched(), [1, 4])
    for i in (1, 4):
        assert back.rng(i).randint(1 << 30) == s.rng(i).randint(1 << 30)
    r = np.random.RandomState(3)
    r.randn(5)
    arrs = tstate.rng_state_to_arrays(r)
    jarrs = jstate.rng_state_to_arrays(r)
    for k in jarrs:
        np.testing.assert_array_equal(arrs[k], jarrs[k])
    r2 = tstate.rng_state_from_arrays(arrs)
    assert r2.rand() == r.rand()
    assert tstate.sub_state({"a/x": 1, "b/y": 2}, "a/") == {"x": 1}
