"""The port's partition rules (repro_torch.sharding.rules), meta-device
input specs (repro_torch.launch.specs) and the model's ``layer_hook``
against the reference's, in one process.

Rules: every architecture of the port's configs at full shapes (the
reference's ``jax.eval_shape`` of ``init_params``), on the meshes
{data 16, model 16}, {data 4, model 2} and {pod 2, data 16, model 16},
with and without ZeRO-3, leaf by leaf; the reference's rules read only a
mesh's ``shape`` and ``axis_names``, so a plain stand-in serves both.
Specs: shapes and dtypes of each family's train, prefill, decode and FL
round inputs.  The hook: an identity hook is bit-equal to none, and a
grad-scale hook scales each layer's gradient as the reference's
``forward_seq(layer_hook=…)`` does, within 1e-5 (dense, ssm, and
whisper's ``enc_blocks``), with remat off and on.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.sharding import fl_step as jfl
from repro.sharding import rules as jrules
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as tmodel
from repro_torch.sharding import fl_step as tfl
from repro_torch.sharding import rules as trules

MESHES = {"data16_model16": {"data": 16, "model": 16},
          "data4_model2": {"data": 4, "model": 2},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}
FAMILIES = ("tinyllama_1_1b", "paligemma_3b", "mamba2_370m", "zamba2_7b",
            "deepseek_v2_lite_16b", "whisper_medium")
GRAD_TOL = 1e-5


def _mesh(shape: dict):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, path + (k,))]
    return [(path, tree)]


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


def _full_shapes(name: str):
    cfg = jcfg.get_arch(name)
    return jax.eval_shape(lambda k: jmodel.init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", tcfg.all_arch_names(include_paper=True))
def test_param_specs_match_reference(arch):
    shapes = _full_shapes(arch)
    jc, tc = jcfg.get_arch(arch), tcfg.get_arch(arch)
    n_sharded = 0
    for mesh_shape in MESHES.values():
        for zero3 in (True, False):
            want = _jflat(jrules.params_pytree_specs(
                jc, shapes, zero3=zero3, mesh_shape=mesh_shape))
            got = dict(_flat(trules.params_pytree_specs(
                tc, shapes, zero3=zero3, mesh_shape=mesh_shape)))
            assert list(got) == list(want)
            for path, spec in got.items():
                assert isinstance(spec, trules.Spec)
                assert tuple(spec) == tuple(want[path]), (path, mesh_shape)
                assert (trules.zero3_gather_axis(spec)
                        == jrules.zero3_gather_axis(want[path]))
                n_sharded += trules.zero3_gather_axis(spec) is not None
    assert n_sharded > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_and_serve_specs_match_reference(arch):
    jc = jcfg.get_arch(arch)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig())
    for name, mesh_shape in MESHES.items():
        mesh = _mesh(mesh_shape)
        for batch in (32, 3):
            cache = jax.eval_shape(lambda: jm.init_cache(batch, 4096))
            want = _jflat(jrules.cache_specs(jc, cache, mesh, batch))
            got = dict(_flat(trules.cache_specs(tcfg.get_arch(arch), cache,
                                                mesh, batch)))
            assert list(got) == list(want)
            assert all(tuple(got[p]) == tuple(want[p]) for p in got), name
            assert (tuple(trules.batch_spec_serve(mesh, batch))
                    == tuple(jrules.batch_spec_serve(mesh, batch)))
        assert (tuple(trules.batch_spec_train(mesh))
                == tuple(jrules.batch_spec_train(mesh)))
        assert trules.client_axes(mesh) == jrules.client_axes(mesh)


def test_spec_normalises_like_partition_spec():
    P = jax.sharding.PartitionSpec
    for entries in ((("data",), None), (("pod", "data"), None),
                    (None, ("model", "data")), ("model",), ()):
        assert tuple(trules.Spec(*entries)) == tuple(P(*entries))


def test_local_shard_slices_the_client_axes_only():
    mesh = SimpleNamespace(
        shape={"pod": 2, "data": 2, "model": 2},
        axis_names=("pod", "data", "model"),
        size=lambda axes: int(np.prod([{"pod": 2, "data": 2,
                                        "model": 2}[a] for a in axes])),
        index=lambda axes: {("data",): 1, ("pod", "data"): 3}[tuple(axes)])
    leaf = torch.arange(4 * 8).reshape(4, 8)
    # a tensor-parallel + ZeRO dim: the slice along 'data', whole over model
    got = trules.local_shard(leaf, trules.Spec(None, ("model", "data")), mesh)
    assert torch.equal(got, leaf[:, 4:])
    # a batch over both client axes: the 4th of four rows
    got = trules.local_shard(leaf, trules.Spec(("pod", "data")), mesh)
    assert torch.equal(got, leaf[3:4])
    # model only: replicated
    got = trules.local_shard(leaf, trules.Spec(None, "model"), mesh)
    assert got is leaf


def _same_layout(got, want):
    """Meta tensors against ShapeDtypeStructs: paths, shapes, dtypes."""
    g, w = dict(_flat(got)), _jflat(want)
    assert sorted(g) == sorted(w)
    for p in g:
        assert g[p].device.type == "meta"
        assert tuple(g[p].shape) == tuple(w[p].shape), p
        assert str(g[p].dtype).replace("torch.", "") == str(w[p].dtype), p


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_reference(arch):
    jc, tc = jcfg.get_arch(arch), tcfg.get_arch(arch)
    mesh = _mesh(MESHES["data16_model16"])
    shapes = jcfg.INPUT_SHAPES
    assert {k: dataclasses.astuple(v) for k, v in tcfg.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in shapes.items()}
    tshape = tcfg.INPUT_SHAPES
    _same_layout(tspecs.train_batch_specs(tc, tshape["train_4k"], mesh),
                 jspecs.train_batch_specs(jc, shapes["train_4k"], mesh))
    _same_layout(tspecs.prefill_batch_specs(tc, tshape["prefill_32k"]),
                 jspecs.prefill_batch_specs(jc, shapes["prefill_32k"]))
    L = jc.n_selectable_layers()
    tb, tm_, ts, tl = tspecs.fl_round_specs(tc, tshape["train_4k"], mesh, L)
    jb, jm_, js, jl = jspecs.fl_round_specs(jc, shapes["train_4k"], mesh, L)
    _same_layout({"b": tb, "m": tm_, "s": ts, "l": tl},
                 {"b": jb, "m": jm_, "s": js, "l": jl})
    small = dataclasses.replace(shapes["decode_32k"], seq_len=256)
    tsmall = dataclasses.replace(tshape["decode_32k"], seq_len=256)
    tt, tp, tcache = tspecs.decode_specs(
        tmodel.Model(tc, tcfg.RuntimeConfig(), device="cpu"), tsmall)
    jt, jp, jcache = jspecs.decode_specs(
        jmodel.Model(jc, jcfg.RuntimeConfig()), small)
    _same_layout({"t": tt, "p": tp, "c": tcache},
                 {"t": jt, "p": jp, "c": jcache})
    assert tspecs.n_clients_on(mesh) == jspecs.n_clients_on(mesh) == 16


def test_tp_constraints_raise():
    """Tensor parallelism over 'model' is ported for the language models
    of every family: asking for it on a classifier (here XLM-R) raises
    rather than replicating silently."""
    cfg = tcfg.reduced(tcfg.get_arch("xlm_roberta_base"), n_layers=2,
                       d_model=32)
    model = tmodel.Model(cfg, tcfg.RuntimeConfig(tp_constraints=True),
                         device="cpu")
    mesh = _mesh({"data": 1, "model": 1})
    from repro_torch.sharding import serve
    for make in (tfl.make_fl_train_step, serve.make_prefill_step,
                 serve.make_serve_step):
        with pytest.raises(ValueError, match="tensor parallelism"):
            make(model, mesh)
    with pytest.raises(ValueError, match="tensor parallelism"):
        tfl.make_fl_train_step_tau(model, mesh, sel_idx=(0,), tau=2)


@pytest.mark.parametrize("local_dispatch", [False, True])
def test_serve_keeps_a_capacity_routed_batch_whole(local_dispatch):
    """A moe model routing over the whole batch keeps it, and its caches,
    whole on every rank (its rows compete for the experts' capacity);
    with per-sample routing, and for other families, the serve layout is
    the reference's rules."""
    from repro_torch.sharding import serve
    mesh = _mesh(MESHES["data4_model2"])
    rt = tcfg.RuntimeConfig(moe_local_dispatch=local_dispatch)
    for arch in ("deepseek_v2_lite_16b", "tinyllama_1_1b"):
        tc = tcfg.get_arch(arch)
        model = tmodel.Model(tc, rt, device="cpu")
        whole = arch.startswith("deepseek") and not local_dispatch
        cache = jax.eval_shape(lambda: jmodel.Model(
            jcfg.get_arch(arch), jcfg.RuntimeConfig()).init_cache(32, 64))
        rules_c = dict(_flat(trules.cache_specs(tc, cache, mesh, 32)))
        got_c = dict(_flat(serve._cache_specs(model, cache, mesh, 32)))
        got_b = serve.batch_spec(model, mesh, 32)
        if not whole:
            assert got_b == trules.batch_spec_serve(mesh, 32)
            assert got_c == rules_c
            continue
        assert got_b == trules.Spec(None)
        assert any(trules.shard_dim(s)[0] is not None
                   for s in rules_c.values())
        for path, spec in got_c.items():
            assert trules.shard_dim(spec) == (None, ())
            # the model-axis entries stay as the rules lay them
            assert [e for e in spec if e is not None] == [
                e for e in rules_c[path] if e is not None and e != "data"]


# ---------------------------------------------------------------------------
# layer_hook
# ---------------------------------------------------------------------------

HOOK_CASES = {"dense": ("tinyllama_1_1b", 3, 32),
              "ssm": ("mamba2_370m", 3, 64),
              "audio": ("whisper_medium", 2, 32)}


@functools.lru_cache(maxsize=None)
def _hook_world(kind: str):
    """The reference side of a hook case, built once per family: the
    reduced model, params, a batch, per-(segment, layer) scales and the
    gradient of the loss under the reference's grad-scale hook."""
    arch, layers, d = HOOK_CASES[kind]
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=layers, d_model=d)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=1024))
    jp = jm.init(jax.random.PRNGKey(1))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.RandomState(5)
    seq = 64 if kind == "ssm" else 8
    batch = {"tokens": rng.randint(0, jc.vocab_size,
                                   (2, seq)).astype(np.int32)}
    if kind == "audio":
        batch["frames"] = rng.standard_normal(
            (2, jc.enc_seq, jc.d_model)).astype(np.float32)
    # a distinct scale per (segment, layer), none of them 1
    scales = {seg: 0.5 + 0.25 * np.arange(n, dtype=np.float32)
              for seg, n in (("blocks", jc.n_layers),
                             ("enc_blocks", jc.n_enc_layers))}

    def jhook(p, idx, segment):
        c = jnp.asarray(scales[segment])[idx]
        return jax.tree.map(lambda x: jfl.gscale(x, c), p)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jbatch, layer_hook=jhook)))(jp)
    jloss = float(jax.jit(jm.loss)(jp, jbatch))
    return host, batch, scales, jax.tree.map(np.asarray, jg), jloss


def _torch_model(kind: str, remat: bool = False):
    arch, layers, d = HOOK_CASES[kind]
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=layers, d_model=d)
    return tmodel.Model(tc, tcfg.RuntimeConfig(remat=remat, seq_chunk=1024),
                        device="cpu")


def _torch_grads(tm, host, batch, hook):
    p = params_to_torch(host, "cpu")
    segs = [k for k in ("blocks", "enc_blocks") if k in p]
    wrt = {k: {n: t.requires_grad_() for n, t in p[k].items()} for k in segs}
    loss = tm.loss({**p, **wrt}, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                   layer_hook=hook)
    flat = [t for k in segs for t in wrt[k].values()]
    gs = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {k: {n: next(gs).numpy() for n in wrt[k]}
                           for k in segs}


@pytest.mark.parametrize("kind", list(HOOK_CASES))
def test_identity_hook_is_bit_equal_to_none(kind):
    host, batch, _, _, _ = _hook_world(kind)
    tm = _torch_model(kind)
    seen = []

    def hook(p, idx, segment):
        seen.append((segment, idx))
        return p
    loss0, g0 = _torch_grads(tm, host, batch, None)
    loss1, g1 = _torch_grads(tm, host, batch, hook)
    assert torch.equal(loss0, loss1)
    for seg in g0:
        for n in g0[seg]:
            np.testing.assert_array_equal(g0[seg][n], g1[seg][n])
    want = [("blocks", i) for i in range(tm.cfg.n_layers)]
    if kind == "audio":
        want = [("enc_blocks", i) for i in range(tm.cfg.n_enc_layers)] + want
    assert seen == want


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", list(HOOK_CASES))
def test_gscale_hook_scales_gradients_like_reference(kind, remat):
    host, batch, scales, jg, jloss = _hook_world(kind)
    tm = _torch_model(kind, remat)

    def thook(p, idx, segment):
        c = torch.tensor(scales[segment][idx])
        return {n: tfl.gscale(x, c) for n, x in p.items()}

    tloss, tg = _torch_grads(tm, host, batch, thook)
    _, plain = _torch_grads(tm, host, batch, None)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    for seg, leaves in tg.items():
        for n, g in leaves.items():
            np.testing.assert_allclose(g, jg[seg][n], atol=GRAD_TOL,
                                       rtol=1e-4, err_msg=f"{seg}/{n}")
            # each layer's gradient is its plain one times its scale
            c = scales[seg].reshape((-1,) + (1,) * (g.ndim - 1))
            np.testing.assert_allclose(g, plain[seg][n] * c,
                                       atol=GRAD_TOL, rtol=1e-4)
