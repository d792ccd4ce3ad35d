"""The port's training forward and loss (repro_torch.models) against
``jax.value_and_grad(Model.loss)`` on the same parameters and batches: the
dense path and the mask-aware split at cut 0, L/2 and L, for the reduced
xlm-roberta classifier and the reduced TinyLlama LM."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.models import model as tmodel

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4

# (arch, n_layers, d_model, batch, seq, seq_chunk, remat_scores)
WORLDS = {
    "xlmr": ("xlm_roberta_base", 4, 32, 3, 8, 16, False),
    "tinyllama": ("tinyllama_1_1b", 3, 64, 2, 16, 16, False),
    # seq 32 over chunks of 16 reaches attend_chunked (with per-chunk remat)
    "tinyllama_chunked": ("tinyllama_1_1b", 3, 64, 2, 32, 16, True),
}
_CACHE: dict = {}


def _world(name):
    if name in _CACHE:
        return _CACHE[name]
    arch, n_layers, d, B, S, chunk, remat_scores = WORLDS[name]
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    jrt = jcfg.RuntimeConfig(remat=False, seq_chunk=chunk,
                             remat_scores=remat_scores)
    trt = tcfg.RuntimeConfig(remat=remat_scores, seq_chunk=chunk,
                             remat_scores=remat_scores)
    jm, tm = jmodel.Model(jc, jrt), tmodel.Model(tc, trt, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.RandomState(7)
    batch = {"tokens": rng.randint(0, jc.vocab_size, (B, S)).astype(np.int32)}
    if jc.task == "classification":
        batch["label"] = rng.randint(0, jc.n_classes, (B,)).astype(np.int32)
    w = (jm, tm, jp, host, batch)
    _CACHE[name] = w
    return w


def _tp(host):
    return params_to_torch(host, "cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got: dict, want: dict, path=()):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], path + (k,))
        else:
            np.testing.assert_allclose(
                got[k].detach().numpy(), np.asarray(want[k], np.float32),
                atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=str(path + (k,)))


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


def _grads(loss, wrt):
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(wrt)
    it = iter(torch.autograd.grad(loss, leaves))

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(wrt)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_dense_loss_and_every_grad_leaf(world):
    jm, tm, jp, host, batch = _world(world)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tp = _requires_grad(_tp(host))
    loss = tm.loss(tp, _tbatch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_tree_close(_grads(loss, tp), want_g)


@pytest.mark.parametrize("world", ["xlmr", "tinyllama"])
@pytest.mark.parametrize("where", ["0", "L/2", "L"])
def test_masked_split_loss_and_grads(world, where):
    jm, tm, jp, host, batch = _world(world)
    L = jm.n_selectable
    cut = {"0": 0, "L/2": L // 2, "L": L}[where]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tr0 = jmodel.trainable_slice(jp, cut, jm.cfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda t: jm.loss(jp, jb, trainable=t, cut=cut)))(tr0)
    tp = _tp(host)
    tr = _requires_grad(tmodel.trainable_slice(tp, cut, tm.cfg))
    assert jax.tree.map(np.shape, tr0) == {
        k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tr.items()}
    loss = tm.loss(tp, _tbatch(batch), trainable=tr, cut=cut)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    if tr:
        _assert_tree_close(_grads(loss, tr), want_g)
    else:
        assert cut == L and not loss.requires_grad


@pytest.mark.parametrize("world", ["xlmr", "tinyllama"])
def test_frozen_prefix_rows_get_no_gradient(world):
    """At a cut inside the stack the global params (embedding included)
    get no gradient at all: the prefix runs without a graph and the suffix
    reads the trainable slice, not the params."""
    _, tm, _, host, batch = _world(world)
    cut = tm.n_selectable // 2
    tp = _requires_grad(_tp(host))
    tr = _requires_grad(tmodel.trainable_slice(tp, cut, tm.cfg))
    loss = tm.loss(tp, _tbatch(batch), trainable=tr, cut=cut)
    leaves = [tp["embed"]["tok"], *tp["blocks"].values()]
    assert all(g is None for g in torch.autograd.grad(
        loss, leaves, retain_graph=True, allow_unused=True))
    g_tr = _grads(loss, tr)
    assert all(g.shape[0] == tm.n_selectable - cut
               for g in g_tr["blocks"].values())


@pytest.mark.parametrize("chunk", [8, 1024])
def test_lm_cross_entropy_both_branches_match_reference(chunk):
    """``_lm_ce`` by chunks (a sequence that is a longer multiple of the
    chunk) and in one piece, against the reference's."""
    jm, tm, jp, host, _ = _world("tinyllama")
    rng = np.random.RandomState(11)
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    targets = rng.randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jm._lm_ce(jp, jnp.asarray(h), jnp.asarray(targets), chunk=chunk)
    got = tm._lm_ce(_tp(host), torch.from_numpy(h),
                    torch.from_numpy(targets), chunk=chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_chunked_attention_matches_full():
    """attend_chunked equals attend_full on the same inputs."""
    from repro_torch.models import blocks as tblocks
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.standard_normal((2, 32, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, 8)).astype(np.float32))
    pos = torch.arange(32, dtype=torch.int32)
    for causal, window, prefix in [(True, 0, 0), (True, 8, 0), (True, 0, 5),
                                   (False, 0, 0)]:
        full = tblocks.attend_full(q, k, v, tblocks._mask_bias(
            pos, pos, causal=causal, window=window, prefix_len=prefix), 0.3)
        chunked = tblocks.attend_chunked(
            q, k, v, q_positions=pos, k_positions=pos, causal=causal,
            window=window, prefix_len=prefix, chunk=8, scale=0.3)
        torch.testing.assert_close(chunked, full, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [4, 1024])
def test_cross_attention_matches_reference(chunk):
    """``attention_fwd(cross_kv=…)`` on a TinyLlama attention row (GQA,
    RoPE on q only) over 12 given keys, by query chunks of 4 and in one
    piece, against the reference's on the same inputs."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks as tblocks
    jm, tm, _, host, _ = _world("tinyllama")
    layer = {n[5:]: a[0] for n, a in host["blocks"].items()
             if n.startswith("attn_")}
    rng = np.random.RandomState(13)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    kh, hd = tm.cfg.n_kv_heads, tm.cfg.resolved_head_dim
    k, v = (rng.standard_normal((2, 12, kh, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(8, dtype=np.int32)
    want, _ = jblocks.attention_fwd(
        {n: jnp.asarray(a) for n, a in layer.items()}, jnp.asarray(x),
        jm.cfg, positions=jnp.asarray(pos),
        cross_kv=(jnp.asarray(k), jnp.asarray(v)), causal=False,
        seq_chunk=chunk)
    got = tblocks.attention_fwd(
        {n: torch.from_numpy(a.copy()) for n, a in layer.items()},
        torch.from_numpy(x), tm.cfg, positions=torch.from_numpy(pos),
        cross_kv=(torch.from_numpy(k), torch.from_numpy(v)), causal=False,
        seq_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def test_classifier_attends_bidirectionally():
    """The xlm-r classifier's forward is not causal: changing the last
    token changes the first position's hidden state."""
    _, tm, _, host, batch = _world("xlmr")
    tp = _tp(host)
    b2 = {k: v.copy() for k, v in batch.items()}
    b2["tokens"][:, -1] = (b2["tokens"][:, -1] + 1) % tm.cfg.vocab_size
    with torch.no_grad():
        h1 = tm.forward_seq(tp, _tbatch(batch))[0]
        h2 = tm.forward_seq(tp, _tbatch(b2))[0]
    assert not torch.allclose(h1[:, 0], h2[:, 0])
