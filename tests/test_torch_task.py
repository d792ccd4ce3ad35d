"""The port's DirichletTokenMixtureTask and SyntheticFederatedData extras
(pretrain_batch, client_batch, state_dict) against the JAX package's: the
same seeds give byte-equal batches, pools, keep-masks and state."""
import numpy as np
import pytest

from repro.api.task import DirichletTaskConfig as JCfg
from repro.api.task import DirichletTokenMixtureTask as JTask
from repro.data import synthetic as jsyn
from repro_torch.api.task import DirichletTaskConfig as TCfg
from repro_torch.api.task import DirichletTokenMixtureTask as TTask
from repro_torch.api.task import Task
from repro_torch.data import synthetic as tsyn


DIR = dict(n_clients=16, n_topics=6, vocab_size=97, seq_len=12,
           samples_per_client=20, test_samples=40, seed=3,
           availability=0.5, straggler_rate=0.25)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("objective", ["classification", "lm"])
def test_dirichlet_batches_byte_equal(objective):
    t, j = TTask(TCfg(objective=objective, **DIR)), \
        JTask(JCfg(objective=objective, **DIR))
    assert isinstance(t, Task)
    np.testing.assert_array_equal(t.sizes, j.sizes)
    np.testing.assert_array_equal(t.alpha, j.alpha)
    np.testing.assert_array_equal(t.client_topic_p, j.client_topic_p)
    cohort = np.array([3, 0, 11, 3])
    _equal(t.cohort_batches(cohort, 4, 2), j.cohort_batches(cohort, 4, 2))
    _equal(t.client_batch(5, 3), j.client_batch(5, 3))
    _equal(t.client_batches(7, 2, 3), j.client_batches(7, 2, 3))
    _equal(t.pretrain_batch(8), j.pretrain_batch(8))
    _equal(t.test_batch(), j.test_batch())
    _equal(t.test_batch(10), j.test_batch(10))
    np.testing.assert_array_equal(t.stream_positions(), j.stream_positions())
    with pytest.raises(ValueError, match="held-out"):
        t.test_batch(DIR["test_samples"] + 1)


def test_dirichlet_pools_and_keep_masks_byte_equal():
    t, j = TTask(TCfg(**DIR)), JTask(JCfg(**DIR))
    rt, rj = np.random.RandomState(9), np.random.RandomState(9)
    for r in range(6):
        np.testing.assert_array_equal(t.available_pool(r),
                                      j.available_pool(r))
        np.testing.assert_array_equal(t.available_clients(r, rt),
                                      j.available_clients(r, rj))
        cohort = t.available_pool(r)[:4]
        np.testing.assert_array_equal(t.drop_stragglers(r, cohort, rt),
                                      j.drop_stragglers(r, cohort, rj))
    full = dict(DIR, availability=1.0, straggler_rate=0.0)
    t_full = TTask(TCfg(**full))
    assert t_full.available_clients(0, rt) is None
    assert t_full.drop_stragglers(0, np.arange(4), rt).all()


def test_dirichlet_state_dict_round_trip():
    """state_dict equals the reference's; a fresh task loaded from it draws
    what the original draws next."""
    t, j = TTask(TCfg(**DIR)), JTask(JCfg(**DIR))
    for task in (t, j):
        task.cohort_batches(np.array([1, 4, 9]), 4, 2)
        task.pretrain_batch(5)
    sd = t.state_dict()
    _equal(sd, j.state_dict())
    fresh = TTask(TCfg(**DIR))
    fresh.load_state_dict(sd)
    _equal(fresh.cohort_batches(np.array([4, 2]), 3, 2),
           t.cohort_batches(np.array([4, 2]), 3, 2))
    _equal(fresh.pretrain_batch(6), t.pretrain_batch(6))
    np.testing.assert_array_equal(fresh.stream_positions(),
                                  t.stream_positions())


SYN = dict(n_clients=10, n_classes=5, vocab_size=64, seq_len=6,
           samples_per_client=12, test_samples=20, seed=4)


@pytest.mark.parametrize("skew,objective", [("label", "classification"),
                                            ("feature", "lm")])
def test_synthetic_pretrain_batch_and_state_byte_equal(skew, objective):
    cfg = dict(SYN, skew=skew, objective=objective)
    t = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(**cfg))
    j = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(**cfg))
    # the pretraining stream is its own: drawing from it first leaves the
    # held-out set as it is
    _equal(t.pretrain_batch(7), j.pretrain_batch(7))
    _equal(t.test_batch(), j.test_batch())
    _equal(t.client_batch(2, 3), j.client_batch(2, 3))
    t.cohort_batches(np.array([1, 6]), 4, 2)
    j.cohort_batches(np.array([1, 6]), 4, 2)
    _equal(t.pretrain_batch(9), j.pretrain_batch(9))
    sd = t.state_dict()
    _equal(sd, j.state_dict())
    fresh = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(**cfg))
    fresh.load_state_dict(sd)
    _equal(fresh.pretrain_batch(4), t.pretrain_batch(4))
    _equal(fresh.cohort_batches(np.array([6, 0]), 2, 3),
           t.cohort_batches(np.array([6, 0]), 2, 3))
    _equal(fresh.test_batch(), j.test_batch())
