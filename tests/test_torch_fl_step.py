"""The port's distributed τ = 1 round step (repro_torch.sharding.fl_step)
against the reference's single-host round, on gloo worlds of 4 processes.

The oracle is what ``tests/test_fl_distributed.py`` holds the reference's
sharded step to, computed here with JAX on one device: ``jax.grad`` of
``Model.loss`` per client → ``apply_layer_mask`` → ``aggregate`` →
``apply_update``.  The configs, batches, masks, sizes and learning rate
are that test's own; params come from the reference's ``init_params``
through numpy.  Each mesh layout is one world (tests/_torch_dist.py)
running all its cases; every world has a join timeout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_world
from repro.configs.base import RuntimeConfig, get_arch, reduced
from repro.core import aggregation as agg
from repro.models.model import Model, apply_layer_mask

TOL = 3e-5
MASKS = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 0, 1]],
                 np.float32)
SIZES = np.array([10., 20., 30., 40.], np.float32)
LR = 0.1
LAYOUTS = {"data4_model1": dict(data=4, model=1),
           "data2_model2": dict(data=2, model=2),
           "pod2_data2_model1": dict(pod=2, data=2, model=1)}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def reference_world(arch: str):
    cfg = reduced(get_arch(arch), n_layers=4, d_model=64)
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))
    params = model.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(7), (4, 2, 16), 0,
                                cfg.vocab_size)
    return cfg, model, params, np.asarray(tokens, np.int32)


def oracle(cfg, model, params, tokens, clients: int):
    """The single-host round over the first ``clients`` cohort members."""
    grad = jax.jit(jax.grad(model.loss))
    deltas = [apply_layer_mask(grad(params, {"tokens": tokens[i]}),
                               MASKS[i], cfg) for i in range(clients)]
    update = agg.aggregate(deltas, jnp.asarray(MASKS[:clients]),
                           jnp.asarray(SIZES[:clients]), cfg)
    return _host(agg.apply_update(params, update, LR))


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def clients_of(layout: dict) -> int:
    return layout.get("pod", 1) * layout["data"]


def step_case(arch, params, tokens, clients, zero3, **kw):
    return dict(kind="fl_step", arch=arch, params=params, zero3=zero3,
                batch={"tokens": tokens[:clients]}, masks=MASKS[:clients],
                sizes=SIZES[:clients], lr=LR, **kw)


@pytest.fixture(scope="module")
def dense():
    """Each layout's world runs the dense step with and without ZeRO-3;
    the (data 4, model 1) world also runs the ssm step."""
    cfg, model, params, tokens = reference_world("tinyllama_1_1b")
    host = _host(params)
    refs = {n: oracle(cfg, model, params, tokens, n) for n in (2, 4)}
    scfg, smodel, sparams, stokens = reference_world("mamba2_370m")
    refs["ssm"] = oracle(scfg, smodel, sparams, stokens, 4)
    runs = {}
    for name, layout in LAYOUTS.items():
        n = clients_of(layout)
        cases = [step_case("tinyllama_1_1b", host, tokens, n, z)
                 for z in (True, False)]
        if name == "data4_model1":
            cases.append(step_case("mamba2_370m", _host(sparams), stokens, 4,
                                   True))
        runs[name] = run_world(4, layout, cases)
    return dict(cfg=cfg, host=host, refs=refs, runs=runs)


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fl_step_matches_single_host_dense(dense, layout, zero3):
    ranks = dense["runs"][layout]
    ref = dense["refs"][clients_of(LAYOUTS[layout])]
    for r in ranks:
        res = r[0 if zero3 else 1]
        err = max_err(res["full"], ref)
        assert err < TOL, (layout, zero3, res["coords"], err)
    # the step moved the selected layers: the check is not vacuous
    assert max_err(ranks[0][0]["full"], dense["host"]) > 1e-4


@pytest.mark.parametrize("zero3", [True, False])
def test_model_coordinates_hold_bit_equal_shards(dense, zero3):
    """Each client's compute is replicated over 'model': the two model
    coordinates of a data coordinate store the same bits."""
    ranks = dense["runs"]["data2_model2"]
    by_data = {}
    for r in ranks:
        res = r[0 if zero3 else 1]
        by_data.setdefault(res["coords"]["data"], []).append(res)
    assert sorted(by_data) == [0, 1]
    for pair in by_data.values():
        assert sorted(p["coords"]["model"] for p in pair) == [0, 1]
        a, b = (jax.tree.leaves(p["local"]) for p in pair)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_zero3_shards_are_the_data_slices(dense):
    """With zero3 each data coordinate stores its own slice of a sharded
    leaf (wq is split on its last dim); without, every rank holds all."""
    for r in dense["runs"]["data4_model1"]:
        res3, res = r[:2]
        d = res3["coords"]["data"]
        wq = res3["full"]["blocks"]["attn_wq"]
        width = wq.shape[-1] // 4
        np.testing.assert_array_equal(
            res3["local"]["blocks"]["attn_wq"],
            wq[..., d * width:(d + 1) * width])
        assert res["local"]["blocks"]["attn_wq"].shape == wq.shape


def test_fl_step_collectives_follow_the_structure(dense):
    """zero3 on (data 4, model 1), tinyllama's 4 layers: one all-gather
    per sharded leaf of the non-hooked groups (embed, head) and per
    sharded block leaf and layer; one reduce-scatter per sharded block
    leaf and layer (the frozen groups have no backward); all-reduces for
    Eq.(7)'s denominators, the replicated block leaves' residual sums and
    the two metrics."""
    specs = _specs(dense["host"], dict(data=4, model=1))
    sharded = [nm for nm, s in specs["blocks"].items()
               if "data" in _flat_names(s)]
    replicated = len(specs["blocks"]) - len(sharded)
    rest = sum("data" in _flat_names(s) for k, g in specs.items()
               if k != "blocks" for s in jax.tree.leaves(
                   g, is_leaf=lambda x: isinstance(x, tuple)))
    want = {"all_gather": rest + 4 * len(sharded),
            "reduce_scatter": 4 * len(sharded),
            "all_reduce": 1 + replicated + 2}
    for r in dense["runs"]["data4_model1"]:
        assert r[0]["collectives"] == want


def _specs(host, layout):
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.sharding import rules
    cfg = treduced(tget("tinyllama_1_1b"), n_layers=4, d_model=64)
    return rules.params_pytree_specs(cfg, host, zero3=True,
                                     mesh_shape=layout)


def _flat_names(spec):
    out = []
    for e in spec:
        out += list(e) if isinstance(e, tuple) else [e]
    return out


def test_fl_step_matches_single_host_ssm(dense):
    for r in dense["runs"]["data4_model1"]:
        assert max_err(r[2]["full"], dense["refs"]["ssm"]) < TOL
        assert np.isfinite(r[2]["loss"]) and r[2]["union_frac"] == 0.75
