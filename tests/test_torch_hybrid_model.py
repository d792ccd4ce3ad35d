"""The port's hybrid family (reduced zamba2: 3 Mamba2 blocks = one group of
2 plus a tail of 1, the shared attention+MLP block after the group, d_model
32, 4 SSD heads of P 16, state 16, chunk 32, 4 attention heads of 8 over 2
kv heads, sliding window 16) against the JAX package's on shared weights:
init layout and rules (the shared leaves unstacked), the bridge, the
forward and loss at seq 64 (the window binds and the state crosses a
chunk; also at 5 layers: two groups plus a tail), every leaf's gradient,
decode against the sequence forward and the reference's decode (shared
and per-slot positions), the cache reset, and the core helpers' shared-row
branches.

Tolerances: f32 throughout; losses rtol 1e-5, gradients atol 1e-5 / rtol
1e-4 (sums in another order), decode logits atol/rtol 1e-4 (the
reference's own decode check uses 2e-3); the helpers' sums 1e-5 relative;
cohorts, masks and token ids exactly."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import aggregation as jagg
from repro.core import masks as jmasks
from repro.models import model as jmodel
from repro_torch.bridge import params_to_numpy, params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import aggregation as tagg
from repro_torch.core import masks as tmasks
from repro_torch.models import model as tmodel

LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
DECODE_TOL = 1e-4
SEQ = 64                       # two chunks of 32; the window (16) binds


def _host(tree):
    """Leaves (JAX or torch) to f32 numpy, keeping key order."""
    return {k: _host(v) if isinstance(v, dict)
            else v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def _pair(n_layers: int):
    rt = dict(remat=False, seq_chunk=16)
    jc = jcfg.reduced(jcfg.get_arch("zamba2_7b"), n_layers=n_layers,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("zamba2_7b"), n_layers=n_layers,
                      d_model=32)
    return (jmodel.Model(jc, jcfg.RuntimeConfig(**rt)),
            tmodel.Model(tc, tcfg.RuntimeConfig(**rt), device="cpu"))


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
    jm, tm = _pair(2)
    jp = jm.init(jax.random.PRNGKey(1))
    tokens = np.random.RandomState(7).randint(
        0, jm.cfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jm, tm, jp, _host(jp), tokens


@pytest.fixture(scope="module")
def world5(world):
    """The 5-layer model: two groups of 2 (two applications of the shared
    block) and a tail of 1, on the world's tokens."""
    jm, tm = _pair(4)
    assert tm.cfg.n_layers == 5
    jp = jm.init(jax.random.PRNGKey(2))
    return jm, tm, jp, _host(jp), world[4]


def _tp(host):
    return params_to_torch(host, "cpu")


def _max_err(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max())


def _layout(tree):
    """Paths, shapes and types in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}/{p}", s, d) for p, s, d in _layout(v)]
        else:
            out.append((k, tuple(v.shape), str(v.dtype).replace("torch.", "")))
    return out


def test_reduced_config_shape(world):
    _, tm, _, _, _ = world
    c = tm.cfg
    assert (c.family, c.n_layers, c.attn_every, c.sliding_window) == \
        ("hybrid", 3, 2, 16)
    assert (c.d_inner // c.resolved_ssm_heads, c.ssm_state, c.ssm_chunk) == \
        (16, 16, 32)
    assert tm.n_selectable == 4
    assert [(s.path, s.count) for s in tmodel.layer_layout(c)] == \
        [("blocks", 3), ("shared_attn", 1)]
    assert not tmodel.supports_prefix_cut(c)
    assert not tmodel.supports_delta_decode(c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_rules_match_reference(world, dtype):
    """Same paths, shapes, types and key order, the shared block's leaves
    unstacked; every shared leaf N(0, 0.02), its norms too: the zeros rule
    fires on the bare name ``ln`` only, and the leaves are prefixed."""
    jm, tm, _, _, _ = world
    jc = dataclasses.replace(jm.cfg, dtype=dtype)
    tc = dataclasses.replace(tm.cfg, dtype=dtype)
    # eager: a jitted init would return its dicts in sorted-key order
    jp = jmodel.Model(jc, jm.runtime).init(jax.random.PRNGKey(1))
    tp = tmodel.Model(tc, tm.runtime, device="cpu").init(1)
    assert _layout(tp) == _layout(jp)
    assert list(tp) == ["embed", "blocks", "shared_attn", "final_norm"]
    shared_shapes = {k: tuple(v.shape) for k, v in tp["shared_attn"].items()}
    assert shared_shapes == tmodel._block_shapes(tc, "attn_mlp_shared")
    for shared in (_host(jp["shared_attn"]), _host(tp["shared_attn"])):
        for k, v in shared.items():
            assert 0.01 < v.std() < 0.03, k


def test_full_width_layout_is_zamba2_7b():
    """The full config's shapes and parameter counts, from the layout
    alone (nothing is allocated)."""
    cfg = tcfg.get_arch("zamba2_7b")
    blocks = tmodel._block_shapes(cfg, "ssm")
    shared = tmodel._block_shapes(cfg, "attn_mlp_shared")
    per_block = sum(math.prod(s) for s in blocks.values())
    assert per_block == 77_978_064 and blocks["ssm_in_proj"] == (3584, 14576)
    assert sum(math.prod(s) for s in shared.values()) == 205_528_064
    assert shared["mlp_wi"] == (3584, 28672)
    assert cfg.n_layers // cfg.attn_every == 13 and cfg.n_layers % 6 == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_exactly(world, dtype):
    _, _, jp, _, _ = world
    host = _host(jax.tree.map(lambda a: a.astype(dtype), jp))
    tp = params_to_torch(host, "cpu", getattr(torch, dtype))
    assert all(t.dtype == getattr(torch, dtype)
               for t in tp["shared_attn"].values())
    assert tp["shared_attn"]["mlp_wi"].dim() == 2
    back = params_to_numpy(tp)
    assert _layout(back) == _layout(host)
    assert _max_err(back, host) == 0.0


@pytest.mark.parametrize("n_layers", [2, 4])
def test_forward_and_loss_match_reference(request, n_layers):
    """Hidden states and the loss at seq 64; ``n_layers`` 2 builds the
    3-layer model (one group and a tail), 4 the 5-layer one (two groups,
    two applications of the shared block, and a tail)."""
    jm, tm, jp, host, tokens = request.getfixturevalue(
        "world" if n_layers == 2 else "world5")
    jb = {"tokens": jnp.asarray(tokens)}
    jh, _, _ = jax.jit(jm.forward_seq)(jp, jb)
    tp = _tp(host)
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        th, aux, prefix_len = tm.forward_seq(tp, tb)
        loss = tm.loss(tp, tb)
    assert prefix_len == 0 and float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(jax.jit(jm.loss)(jp, jb)),
                               rtol=LOSS_RTOL)


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("n_layers", [2, 4])
def test_every_leaf_gradient_matches_reference(request, n_layers):
    """jax.grad of the loss against torch.autograd over every leaf: the
    Mamba2 stack, the shared block (one application at 3 layers, its
    gradient summed over two at 5), the embedding and the final norm."""
    jm, tm, jp, host, tokens = request.getfixturevalue(
        "world" if n_layers == 2 else "world5")
    want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {"tokens": jnp.asarray(tokens)})
    tp = _requires_grad(_tp(host))
    loss = tm.loss(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    leaves = _leaves(tp)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = _leaves(_host(want_g))
    assert set(got) == set(want)
    assert any(k.startswith("shared_attn/") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_prefix_cut_is_refused(world):
    """A trainable slice raises, as the reference's forward_seq does: the
    shared block runs interleaved through the whole depth."""
    jm, tm, jp, host, tokens = world
    tp = _tp(host)
    tr = tmodel.trainable_rows(tp, 1, tm.cfg)
    with pytest.raises(ValueError, match="prefix-cut"):
        tm.loss(tp, {"tokens": torch.from_numpy(tokens)}, trainable=tr,
                cut=1)
    with pytest.raises(ValueError, match="prefix-cut"):
        jm.loss(jp, {"tokens": jnp.asarray(tokens)},
                trainable=jmodel.trainable_slice(jp, 1, jm.cfg), cut=1)


def _seq_logits(tm, tp, tokens):
    with torch.no_grad():
        h, _, _ = tm.forward_seq(tp, {"tokens": torch.from_numpy(tokens)})
        return tm._head(tp, h)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_forward_seq_and_reference(world, per_slot):
    """Token-by-token decode (the recurrent state and the shared block's
    windowed KV row) against the sequence forward (the scan, the flash
    path) in the port, and against the reference's decode step by step,
    with one shared position or a (B,) per-slot position vector."""
    jm, tm, jp, host, tokens = world
    tp = _tp(host)
    want = _seq_logits(tm, tp, tokens)
    cache = tm.init_cache(2, SEQ, per_slot=per_slot)
    jcache = jm.init_cache(2, SEQ, per_slot=per_slot)
    assert _layout(cache) == _layout(jcache)
    jdecode = jax.jit(jm.decode_step)
    got, ref = [], []
    for t in range(SEQ):
        pos = (torch.full((2,), t, dtype=torch.int32) if per_slot
               else torch.tensor(t, dtype=torch.int32))
        logits, cache = tm.decode_step(tp, torch.from_numpy(tokens[:, t]),
                                       pos, cache)
        got.append(logits)
        jl, jcache = jdecode(jp, jnp.asarray(tokens[:, t]),
                             jnp.asarray(pos.numpy()), jcache)
        ref.append(np.asarray(jl))
    got = torch.stack(got, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    np.testing.assert_allclose(got.numpy(), np.stack(ref, 1), atol=ATOL,
                               rtol=RTOL)
    assert _max_err(cache, _host(jcache)) < ATOL


def test_reset_slot_walks_the_shared_cache(world):
    """A refill empties the slot's position rows in ``shared_attn`` as well
    as its conv and state rows, in the serving and the stacked layouts,
    as the reference's reset does."""
    jm, tm, _, _, _ = world
    cache = tm.init_cache(3, 8, per_slot=True)
    for seg in cache.values():
        for leaf in seg.values():
            leaf.fill_(1)
    tm.reset_slot(cache, 1)
    imax = torch.iinfo(torch.int32).max
    pos = cache["shared_attn"]["pos"]
    assert (pos[:, 1] == imax).all() and (pos[:, [0, 2]] == 1).all()
    for name in ("conv", "state"):
        leaf = cache["blocks"][name]
        assert not leaf[:, 1].any() and leaf[:, 0].all() and leaf[:, 2].all()
    assert cache["shared_attn"]["k"].all()          # k/v stay
    jc = jm.init_cache(3, 8, per_slot=True)
    jc = jax.tree.map(lambda a: jnp.ones_like(a), jc)
    jc = jm.reset_slot(jc, 1)
    assert _max_err(cache, _host(jc)) == 0.0
    stacked = {seg: {k: v.transpose(0, 1).clone() for k, v in leaves.items()}
               for seg, leaves in tm.init_cache(3, 8, per_slot=True).items()}
    for seg in stacked.values():
        for leaf in seg.values():
            leaf.fill_(1)
    tm.reset_slot(stacked, 2, stacked=True)
    assert (stacked["shared_attn"]["pos"][2] == imax).all()
    assert (stacked["shared_attn"]["pos"][:2] == 1).all()
    assert not stacked["blocks"]["state"][2].any()


# ---------------------------------------------------------------------------
# core helpers: the shared block's one row
# ---------------------------------------------------------------------------

def _rand_tree(host, seed):
    rng = np.random.RandomState(seed)
    return {k: _rand_tree(v, seed + 1) if isinstance(v, dict)
            else rng.standard_normal(v.shape).astype(np.float32)
            for k, v in host.items()}


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


def test_layer_norms_and_stats_match_reference(world):
    jm, tm, _, host, _ = world
    g = _rand_tree(host, 3)
    want = np.asarray(jmasks.per_layer_sq_norms(g, jm.cfg, mode="jnp"))
    got = tmasks.per_layer_sq_norms(_tp(g), tm.cfg).numpy()
    assert got.shape == (tm.n_selectable,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    shared = sum(float((v.astype(np.float64) ** 2).sum())
                 for v in g["shared_attn"].values())
    np.testing.assert_allclose(got[-1], shared, rtol=1e-5)
    for t, j in zip(tmasks.layer_grad_stats(_tp(g), tm.cfg),
                    jmasks.per_layer_stats(g, jm.cfg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_array_equal(tmasks.count_layer_params(_tp(host), tm.cfg),
                                  jmasks.count_layer_params(host, jm.cfg))


def test_mask_scale_and_aggregate_match_reference(world):
    """apply_layer_mask, scale_by_layer, aggregate_stacked (a 3-client
    cohort, the shared block's (n,)-weight branch) and the Eq.(6) apply at
    cut 0 over the unstacked shared leaves, against the reference."""
    jm, tm, _, host, _ = world
    cfg = tm.cfg
    g = _rand_tree(host, 5)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want = _host(jmodel.apply_layer_mask(g, jnp.asarray(mask), jm.cfg))
    got = tmodel.apply_layer_mask(_tp(g), torch.from_numpy(mask), cfg)
    assert _max_err(got, want) == 0.0
    scale = np.array([0.5, 2.0, 0.0, 3.0], np.float32)
    want = _host(jagg.scale_by_layer(g, jnp.asarray(scale), jm.cfg))
    assert _max_err(tagg.scale_by_layer(_tp(g), torch.from_numpy(scale),
                                        cfg), want) == 0.0
    sel = ("blocks", "shared_attn")
    deltas = _stack([{k: _rand_tree(host, 10 + i)[k] for k in sel}
                     for i in range(3)])
    masks = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [1, 1, 0, 0]], np.float32)
    sizes = np.array([3.0, 5.0, 2.0], np.float32)
    w = jmasks.aggregation_weights(jnp.asarray(masks), jnp.asarray(sizes))
    want = _host(jagg.aggregate_stacked(deltas, w, jm.cfg))
    tw = tmasks.aggregation_weights(masks, sizes)
    got = tagg.aggregate_stacked(_tp(deltas), tw, cfg)
    assert {k: tuple(v.shape) for k, v in got["shared_attn"].items()} == \
        {k: v.shape for k, v in host["shared_attn"].items()}
    assert _max_err(got, want) < 1e-5
    params = {k: host[k] for k in sel}
    want = _host(jagg.apply_update(params, want, 0.1))
    new = tagg.apply_suffix_update(_tp(params), got, 0.1, 0, cfg)
    assert _max_err(new, want) < 1e-5


def test_fault_helpers_on_the_shared_leaves(world):
    """The in-place fault helpers over a stacked cohort tree whose
    shared leaves are (n, …) copies of unstacked leaves: the same rows as
    the reference's out-of-place ones."""
    _, _, _, host, _ = world
    sel = ("blocks", "shared_attn")
    deltas = _stack([{k: _rand_tree(host, 20 + i)[k] for k in sel}
                     for i in range(3)])
    codes = np.array([0, 1, 3], np.int32)
    want = _host(jagg.corrupt_delta_rows(deltas, codes, 1e3))
    got = tagg.corrupt_delta_rows(_tp(deltas), codes, 1e3)
    for k in sel:
        for name in want[k]:
            np.testing.assert_array_equal(got[k][name].numpy(),
                                          want[k][name], err_msg=name)
    ok = tagg.finite_row_mask(got, float("inf"))
    want_ok = np.asarray(jagg.finite_row_mask(want, float("inf")))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    tagg.zero_delta_rows(got, ok)
    assert not got["shared_attn"]["mlp_wi"][1].any()
    assert got["shared_attn"]["mlp_wi"][0].abs().sum() > 0
