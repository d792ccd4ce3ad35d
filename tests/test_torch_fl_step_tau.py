"""The port's distributed round steps beyond the plain τ = 1 case, on gloo
worlds of 4 processes, against the reference's single-host round computed
with JAX on one device (see tests/test_torch_fl_step.py):

* τ = 3 local steps over the static union ``sel_idx = (1, 3)``
  (``make_fl_train_step_tau``, the reference test's masks, sizes and lr)
  against ``Client._local_update`` per client → ``aggregate`` →
  ``apply_update``, on (data 4, model 1) and (pod 2, data 2, model 1);
* the ``sel_upload`` step (only the selected rows through the
  differentiable gather) against the plain step and the oracle;
* the hybrid's unstacked ``shared_attn`` and moe's ``dense0`` segments;
* the step under ``remat`` (the per-layer gather inside the checkpointed
  block, so it runs again in the backward);
* the client-state store's rows placed by ``warm_rows_device`` driving
  the step exactly as host masks do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_world
from repro.configs.base import RuntimeConfig, get_arch, reduced
from repro.core import aggregation as agg
from repro.core.client import Client
from repro.models.model import Model, apply_layer_mask

TOL, TAU_TOL = 3e-5, 5e-5
MASKS = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 0, 1]],
                 np.float32)
# heterogeneous masks within the static union {1, 3}
TAU_MASKS = np.array([[0, 1, 0, 1], [0, 0, 0, 1], [0, 1, 0, 0],
                      [0, 1, 0, 1]], np.float32)
SIZES = np.array([10., 20., 30., 40.], np.float32)
LR, TAU_LR, TAU, SEL = 0.1, 0.05, 3, (1, 3)
DATA4 = dict(data=4, model=1)


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def reference(arch: str, layers: int = 4):
    cfg = reduced(get_arch(arch), n_layers=layers, d_model=64)
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))
    return cfg, model, model.init(jax.random.PRNGKey(0))


def step_oracle(cfg, model, params, tokens):
    grad = jax.jit(jax.grad(model.loss))
    deltas = [apply_layer_mask(grad(params, {"tokens": tokens[i]}),
                               MASKS[i], cfg) for i in range(4)]
    update = agg.aggregate(deltas, jnp.asarray(MASKS), jnp.asarray(SIZES),
                           cfg)
    return _host(agg.apply_update(params, update, LR))


@pytest.fixture(scope="module")
def worlds():
    cfg, model, params = reference("tinyllama_1_1b")
    host = _host(params)
    key = jax.random.PRNGKey(7)
    tokens = np.asarray(jax.random.randint(key, (4, 2, 16), 0,
                                           cfg.vocab_size), np.int32)
    tau_tokens = np.asarray(jax.random.randint(key, (4, TAU, 2, 16), 0,
                                               cfg.vocab_size), np.int32)
    client = Client(model)
    deltas = [client._local_update(params, {"tokens": tau_tokens[i]},
                                   TAU_MASKS[i], TAU_LR)[0]
              for i in range(4)]
    tau_ref = _host(agg.apply_update(params, agg.aggregate(
        deltas, jnp.asarray(TAU_MASKS), jnp.asarray(SIZES), cfg), TAU_LR))
    refs = {"dense": step_oracle(cfg, model, params, tokens),
            "tau": tau_ref}
    step = dict(kind="fl_step", arch="tinyllama_1_1b", params=host,
                zero3=True, batch={"tokens": tokens}, masks=MASKS,
                sizes=SIZES, lr=LR)
    tau = dict(kind="fl_step_tau", arch="tinyllama_1_1b", params=host,
               zero3=True, batch={"tokens": tau_tokens}, masks=TAU_MASKS,
               sizes=SIZES, lr=TAU_LR, tau=TAU, sel_idx=SEL)
    cases = {"tau": tau, "plain": step,
             "sel_upload": dict(step, sel_upload=True, sel_idx=(0, 1, 3)),
             "remat": dict(step, remat=True),
             "store_rows": dict(step, kind="store_rows",
                                cohort=[17, 4_242, 73_291, 99_999])}
    for arch, layers, key_ in (("zamba2_7b", 2, "hybrid"),
                               ("deepseek_v2_lite_16b", 4, "moe")):
        c, m, p = reference(arch, layers)
        assert c.n_selectable_layers() == 4
        refs[key_] = step_oracle(c, m, p, tokens)
        refs[key_ + "_init"] = _host(p)
        cases[key_] = dict(step, arch=arch, layers=layers, params=_host(p))
    names = list(cases)
    ranks = run_world(4, DATA4, [cases[k] for k in names])
    runs = {k: [r[i] for r in ranks] for i, k in enumerate(names)}
    runs["tau_pod"] = [r[0] for r in run_world(
        4, dict(pod=2, data=2, model=1), [tau])]
    return dict(refs=refs, runs=runs, host=host)


@pytest.mark.parametrize("run", ["tau", "tau_pod"])
def test_fl_step_tau_matches_single_host(worlds, run):
    for res in worlds["runs"][run]:
        assert max_err(res["full"], worlds["refs"]["tau"]) < TAU_TOL
        assert np.isfinite(res["loss"]) and res["union_frac"] == 0.5
    # the rows outside the union do not move
    full = worlds["runs"][run][0]["full"]["blocks"]
    for nm, leaf in full.items():
        np.testing.assert_array_equal(leaf[[0, 2]],
                                      worlds["host"]["blocks"][nm][[0, 2]])


def test_fl_step_tau_updates_through_the_masked_update_path(worlds):
    """Each local step applies the R selected rows of every block leaf in
    one ``ops.masked_sgd_update`` call (the plain version here; the
    ``masked_update`` kernel on the card); the upload is one
    reduce-scatter per sharded block leaf."""
    for res in worlds["runs"]["tau"]:
        n_leaves = len(worlds["host"]["blocks"])
        sharded = 6          # attn wq, wk, wv, wo; mlp wi, wo
        assert res["collectives"]["reduce_scatter"] == sharded
        # all-gathers: the R rows once, embed and head once, and per local
        # step each of the L − R other rows
        assert res["collectives"]["all_gather"] == (
            sharded + 2 + TAU * (4 - len(SEL)) * sharded)
        assert res["collectives"]["all_reduce"] == (
            1 + (n_leaves - sharded) + 2)
        assert res["launches"]["masked_update"] == 0   # CPU: plain version


@pytest.mark.parametrize("run", ["plain", "sel_upload", "remat"])
def test_fl_step_variants_match_single_host(worlds, run):
    for res in worlds["runs"][run]:
        assert max_err(res["full"], worlds["refs"]["dense"]) < TOL


def test_sel_upload_equals_the_plain_step(worlds):
    """Only the selected rows cross the backward collective, and the
    result is the plain step's."""
    for sel, plain in zip(worlds["runs"]["sel_upload"],
                          worlds["runs"]["plain"]):
        assert max_err(sel["full"], plain["full"]) <= 1e-6
        # one reduce-scatter of the R selected rows per sharded block
        # leaf, against one per leaf and layer
        assert sel["collectives"]["reduce_scatter"] == 6
        assert plain["collectives"]["reduce_scatter"] == 4 * 6


def test_remat_gathers_each_layer_again_in_the_backward(worlds):
    for plain, remat in zip(worlds["runs"]["plain"], worlds["runs"]["remat"]):
        extra = remat["collectives"]["all_gather"] \
            - plain["collectives"]["all_gather"]
        assert extra == plain["collectives"]["reduce_scatter"]
        assert max_err(remat["full"], plain["full"]) <= 1e-6


@pytest.mark.parametrize("family", ["hybrid", "moe"])
def test_fl_step_matches_single_host_other_segments(worlds, family):
    """zamba2's shared_attn (mask column 3, scaled by its one weight) and
    deepseek's dense0 (mask column 0, gathered whole) through the step."""
    ref = worlds["refs"][family]
    seg = "shared_attn" if family == "hybrid" else "dense0"
    for res in worlds["runs"][family]:
        assert max_err(res["full"], ref) < TOL
    init = worlds["refs"][family + "_init"]
    assert max_err(worlds["runs"][family][0]["full"][seg], init[seg]) > 1e-6


def test_store_rows_drive_the_step_exactly(worlds):
    for r, res in enumerate(worlds["runs"]["store_rows"]):
        assert res["valid"].all()
        np.testing.assert_array_equal(res["rows"], MASKS[r:r + 1])
        assert res["rows_equal"] and res["err"] == 0.0
