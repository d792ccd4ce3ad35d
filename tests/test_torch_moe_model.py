"""The port's moe family through ``models/model.py`` against the JAX
package's ``Model`` on shared weights: the reduced deepseek (3 layers:
``dense0`` + 2 moe blocks, MLA ranks 64/16/32/32, 4 experts top-2 and one
shared expert, d_model 32) and the reduced grok (3 moe blocks, GQA 4/2,
head dim 64, gelu, no shared expert, logit softcap 30), seq 32 by query
chunks of 16.

The layout and the two-segment prefix cuts, init shapes, key order and
rules, the full DeepSeek-V2-Lite layout's sizes, the forward's hidden
state, aux loss and loss, every gradient on the dense path and at cuts 1
and 2 (deepseek: at ``dense0``'s end and inside ``blocks``), decode
against the sequence forward and the reference's decode (shared and
per-slot positions, capacity factor 8), the cache reset, the per-layer
norms over both segments, and the parameter counts.

Tolerances: f32 throughout; losses and aux rtol 1e-5, hidden states and
gradients atol 1e-5 / rtol 1e-4 (sums in another order), decode logits
against the sequence forward atol/rtol 1e-4 (the reference's own check
uses 2e-3); layouts, cuts and counts exactly."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import masks as jmasks
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import masks as tmasks
from repro_torch.models import model as tmodel

LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
DECODE_TOL = 1e-4
SEQ = 32
ARCHS = ["deepseek_v2_lite_16b", "grok_1_314b"]


def _host(tree):
    """Leaves (JAX or torch) to f32 numpy, keeping key order."""
    return {k: _host(v) if isinstance(v, dict)
            else v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def _layout(tree):
    """Paths, shapes and types in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}/{p}", s, d) for p, s, d in _layout(v)]
        else:
            out.append((k, tuple(v.shape), str(v.dtype).replace("torch.", "")))
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str, **cfg_kw):
    rt = dict(remat=False, seq_chunk=16)
    jc = dataclasses.replace(jcfg.reduced(jcfg.get_arch(arch), n_layers=3,
                                          d_model=32), **cfg_kw)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_arch(arch), n_layers=3,
                                          d_model=32), **cfg_kw)
    return (jmodel.Model(jc, jcfg.RuntimeConfig(**rt)),
            tmodel.Model(tc, tcfg.RuntimeConfig(**rt), device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    jm, tm = _pair(request.param)
    jp = jm.init(jax.random.PRNGKey(1))
    tokens = np.random.RandomState(7).randint(
        0, jm.cfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jm, tm, jp, _host(jp), tokens


def _tp(host):
    return params_to_torch(host, "cpu")


def test_layout_and_prefix_cuts_match_reference():
    """deepseek's dense0 precedes blocks in mask order: a cut inside blocks
    freezes and omits dense0, a cut at 1 (dense0's end) omits it too, cut
    0 keeps both (the reference's tests/test_masked_engine.py cases)."""
    jm, tm = _pair("deepseek_v2_lite_16b")
    jc, tc = jm.cfg, tm.cfg
    assert [(s.path, s.count) for s in tmodel.layer_layout(tc)] == \
        [(s.path, s.count) for s in jmodel.layer_layout(jc)] == \
        [("dense0", 1), ("blocks", 2)]
    assert tmodel.supports_prefix_cut(tc) and not \
        tmodel.supports_delta_decode(tc)
    for cut in range(4):
        assert tmodel.segment_prefix_cuts(cut, tc) == \
            jmodel.segment_cuts(cut, jc)
    assert tmodel.segment_prefix_cuts(2, tc) == {"dense0": 1, "blocks": 1}
    tp = tm.init(0)
    jp = jm.init(jax.random.PRNGKey(0))
    for cut in range(4):
        tr = tmodel.trainable_rows(tp, cut, tc)
        jtr = jmodel.trainable_slice(jp, cut, jc)
        assert list(tr) == list(jtr)
        assert _layout(tr) == _layout(jtr)
    assert "dense0" not in tmodel.trainable_rows(tp, 1, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_rules_match_reference(arch, dtype):
    """Same paths, shapes, types and key order (embed, dense0, blocks,
    final_norm, head); every stacked leaf N(0, 0.02), the prefixed norms
    (``attn_ln``, ``attn_kv_ln``, ``moe_ln``, ``mlp_ln``) too, since the
    zeros rule fires on the bare name ``ln`` only; final_norm zeros."""
    jm, tm = _pair(arch, dtype=dtype)
    # eager: a jitted init would return its dicts in sorted-key order
    jp = jm.init(jax.random.PRNGKey(1))
    tp = tm.init(1)
    assert _layout(tp) == _layout(jp)
    want_keys = (["embed", "dense0", "blocks", "final_norm", "head"]
                 if arch.startswith("deepseek") else
                 ["embed", "blocks", "final_norm"])
    assert list(tp) == want_keys
    for path in ("dense0", "blocks"):
        for k, v in _host(tp.get(path, {})).items():
            assert 0.01 < v.std() < 0.03, (path, k)
    assert not tp["final_norm"].any()


def test_full_width_layout_is_deepseek_v2_lite():
    """DeepSeek-V2-Lite-16B from its shapes alone (nothing allocated): the
    dense0 MLP 11 264 wide, one moe layer 584.8 M params (MLA 13.8 M, the
    routed experts' ``moe_wi_e`` 369.1 M a row), 15.71 B in all."""
    cfg = tcfg.get_arch("deepseek_v2_lite_16b")
    moe = tmodel._block_shapes(cfg, "moe")
    dense0 = tmodel._block_shapes(cfg, "moe_dense0")
    assert dense0["mlp_wi"] == (2048, 2 * 11264)
    assert moe["moe_wi_e"] == (64, 2048, 2816)
    assert math.prod(moe["moe_wi_e"]) == 369_098_752
    per_moe = sum(math.prod(s) for s in moe.values())
    per_dense0 = sum(math.prod(s) for s in dense0.values())
    mla = sum(math.prod(s) for k, s in moe.items() if k.startswith("attn_"))
    assert per_moe == 584_847_872 and mla == 13_765_120
    total = (per_dense0 + 26 * per_moe + 2 * 102400 * 2048 + 2048)
    assert per_dense0 == 82_973_184 and total == 15_708_450_304
    want = {k: v for k, v in jmodel._block_shapes(
        jcfg.get_arch("deepseek_v2_lite_16b"), "moe").items()}
    assert moe == want


def test_forward_and_loss_match_reference(world):
    """Hidden states, the summed aux loss and the loss at seq 32 (MLA and
    grok's attention by query chunks of 16 in the reference; the flash
    path for grok in the port)."""
    jm, tm, jp, host, tokens = world
    jb = {"tokens": jnp.asarray(tokens)}
    jh, jaux, _ = jax.jit(jm.forward_seq)(jp, jb)
    tp = _tp(host)
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        th, aux, prefix_len = tm.forward_seq(tp, tb)
        loss = tm.loss(tp, tb)
    assert prefix_len == 0 and aux.item() > 0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), float(jax.jit(jm.loss)(jp, jb)),
                               rtol=LOSS_RTOL)


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


@pytest.mark.parametrize("cut", [None, 1, 2], ids=["dense", "cut1", "cut2"])
def test_every_gradient_matches_reference(world, cut):
    """The loss and every differentiated leaf's gradient against
    ``jax.grad``: the dense path over the whole tree, or the mask-aware
    path over ``trainable_rows`` at the cut (the frozen prefix under
    no_grad in the port, under stop_gradient in the reference; its rows'
    aux loss still counts)."""
    jm, tm, jp, host, tokens = world
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if cut is None:
        want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
        tp = _requires_grad(_tp(host))
        loss = tm.loss(tp, tb)
        wrt = tp
    else:
        jtr = jmodel.trainable_slice(jp, cut, jm.cfg)
        want_loss, want_g = jax.jit(jax.value_and_grad(
            lambda tr: jm.loss(jp, jb, trainable=tr, cut=cut)))(jtr)
        tp = _tp(host)
        wrt = _requires_grad(tmodel.trainable_rows(tp, cut, tm.cfg))
        loss = tm.loss(tp, tb, trainable=wrt, cut=cut)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    leaves = _leaves(wrt)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                               allow_unused=True)))
    want = _leaves(_host(want_g))
    assert set(got) == set(want)
    assert any(k.startswith("blocks/moe_router") for k in got)
    for k in want:
        g = got[k]
        g = np.zeros_like(want[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def _seq_logits(tm, tp, tokens):
    with torch.no_grad():
        h, _, _ = tm.forward_seq(tp, {"tokens": torch.from_numpy(tokens)})
        return tm._head(tp, h)


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_seq_and_reference(arch, per_slot):
    """Token-by-token decode (MLA's absorbed matmuls over the latent cache,
    or grok's KV cache; the routers' capacity over the step's 2 tokens)
    against the sequence forward in the port and the reference's decode
    step by step, at capacity factor 8 (dropless, so prefill and decode
    route alike, as tests/test_decode_consistency.py sets it)."""
    jm, tm = _pair(arch, capacity_factor=8.0)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = _tp(_host(jp))
    steps = 16
    tokens = np.random.RandomState(8).randint(
        0, jm.cfg.vocab_size, (2, steps)).astype(np.int32)
    want = _seq_logits(tm, tp, tokens)
    cache = tm.init_cache(2, steps, per_slot=per_slot)
    jcache = jm.init_cache(2, steps, per_slot=per_slot)
    assert _layout(cache) == _layout(jcache)
    jdecode = jax.jit(jm.decode_step)
    got, ref = [], []
    for t in range(steps):
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
    got_c, want_c = _leaves(cache), _leaves(_host(jcache))
    assert set(got_c) == set(want_c)
    for path, b in want_c.items():
        np.testing.assert_allclose(got_c[path].float().numpy(), b,
                                   atol=ATOL, rtol=RTOL, err_msg=path)


def test_reset_slot_walks_both_segments():
    """A refill empties the slot's position rows in dense0 and blocks, as
    the reference's reset does; the latent rows stay."""
    jm, tm = _pair("deepseek_v2_lite_16b")
    cache = tm.init_cache(3, 8, per_slot=True)
    assert set(cache) == {"dense0", "blocks"}
    assert set(cache["blocks"]) == {"ckv", "krope", "pos"}
    for seg in cache.values():
        for leaf in seg.values():
            leaf.fill_(1)
    tm.reset_slot(cache, 1)
    imax = torch.iinfo(torch.int32).max
    for seg in cache.values():
        assert (seg["pos"][:, 1] == imax).all()
        assert (seg["pos"][:, [0, 2]] == 1).all() and seg["ckv"].all()
    jc = jax.tree.map(jnp.ones_like, jm.init_cache(3, 8, per_slot=True))
    got, want = _leaves(cache), _leaves(_host(jm.reset_slot(jc, 1)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(), want[k])


def _rand_tree(host, seed):
    rng = np.random.RandomState(seed)
    return {k: _rand_tree(v, seed + 1) if isinstance(v, dict)
            else rng.standard_normal(v.shape).astype(np.float32)
            for k, v in host.items()}


def test_layer_norms_and_counts_match_reference(world):
    """The probe's per-layer ‖g‖² over both segments (dense0's row first),
    the per-layer parameter counts, and the total and active parameter
    counts."""
    jm, tm, jp, host, _ = world
    g = _rand_tree(host, 3)
    want = np.asarray(jmasks.per_layer_sq_norms(g, jm.cfg, mode="jnp"))
    got = tmasks.per_layer_sq_norms(_tp(g), tm.cfg).numpy()
    assert got.shape == (tm.n_selectable,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(tmasks.count_layer_params(_tp(host), tm.cfg),
                                  jmasks.count_layer_params(host, jm.cfg))
    tp = _tp(host)
    assert tmodel.count_params(tp) == jmodel.count_params(jp)
    assert tmodel.count_active_params(tm.cfg, tp) == \
        jmodel.count_active_params(jm.cfg, jp)
    assert tmodel.count_active_params(tm.cfg, tp) < tmodel.count_params(tp)
