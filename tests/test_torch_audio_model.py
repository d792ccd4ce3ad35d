"""The port's audio family (whisper) through ``models/model.py`` and
``models/blocks.py`` against the JAX package's ``Model`` on shared weights:
the reduced whisper-medium (2 encoder and 2 decoder layers, d_model 32,
GQA 4/2 heads of 8, d_ff 128, enc_seq 16), decoder seq 8.

The two-segment layout (``enc_blocks`` then ``blocks``) and its prefix
cuts, init shapes, key order and rules, the full whisper-medium layout's
sizes from its shapes, cross-attention (``make_cross_kv`` and
``attention_fwd(cross_kv=…)``, in one piece and by query chunks), the
forward's hidden state and loss, every gradient on the dense path and at
cuts 1 (mid-encoder), 2 (the boundary) and 3 (deep), with and without
remat, decode over a cross cache filled from the encoder, the refusals
and the cache reset, the per-layer norms and the parameter counts.

Tolerances: f32 throughout; losses rtol 1e-5, outputs and gradients atol
1e-5 / rtol 1e-4 (sums in another order), decode logits against the
sequence forward 1e-4 (the reference's own check uses 2e-3); layouts,
cuts and counts exactly."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import masks as jmasks
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import masks as tmasks
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel

LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
DECODE_TOL = 1e-4
SEQ = 8
ARCH = "whisper_medium"


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


def _pair(seq_chunk: int = 1024, remat: bool = False, **cfg_kw):
    jc = dataclasses.replace(jcfg.reduced(jcfg.get_arch(ARCH), n_layers=2,
                                          d_model=32), **cfg_kw)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_arch(ARCH), n_layers=2,
                                          d_model=32), **cfg_kw)
    return (jmodel.Model(jc, jcfg.RuntimeConfig(remat=False,
                                                seq_chunk=seq_chunk)),
            tmodel.Model(tc, tcfg.RuntimeConfig(remat=remat,
                                                seq_chunk=seq_chunk),
                         device="cpu"))


def _batch(cfg, seed: int = 7, b: int = 2):
    rng = np.random.RandomState(seed)
    return {"frames": rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.randint(0, cfg.vocab_size,
                                  (b, SEQ)).astype(np.int32)}


@pytest.fixture(scope="module")
def world():
    jm, tm = _pair()
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, tm, jp, _host(jp), _batch(jm.cfg)


def _tp(host):
    return params_to_torch(host, "cpu")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_layout_and_prefix_cuts_match_reference():
    """The encoder precedes the decoder in mask order: a cut inside it
    splits ``enc_blocks``, a cut at its end omits it from the trainable
    rows, a deep cut splits ``blocks`` (the cuts of the reference's
    tests/test_masked_engine.py whisper case)."""
    jm, tm = _pair()
    jc, tc = jm.cfg, tm.cfg
    n_enc, L = tc.n_enc_layers, tm.n_selectable
    assert (n_enc, L) == (2, 4)
    assert [(s.path, s.count) for s in tmodel.layer_layout(tc)] == \
        [(s.path, s.count) for s in jmodel.layer_layout(jc)] == \
        [("enc_blocks", 2), ("blocks", 2)]
    assert tmodel.supports_prefix_cut(tc) and not \
        tmodel.supports_delta_decode(tc)
    for cut in range(L + 1):
        assert tmodel.segment_prefix_cuts(cut, tc) == \
            jmodel.segment_cuts(cut, jc)
    assert tmodel.segment_prefix_cuts(1, tc) == {"enc_blocks": 1,
                                                 "blocks": 0}
    assert tmodel.segment_prefix_cuts(L - 1, tc) == {"enc_blocks": 2,
                                                     "blocks": 1}
    tp = tm.init(0)
    jp = jm.init(jax.random.PRNGKey(0))
    for cut in (0, 1, n_enc, L - 1):
        tr = tmodel.trainable_rows(tp, cut, tc)
        jtr = jmodel.trainable_slice(jp, cut, jc)
        assert list(tr) == list(jtr)
        assert _layout(tr) == _layout(jtr)
    assert list(tmodel.trainable_rows(tp, n_enc, tc)) == ["blocks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_rules_match_reference(dtype):
    """Same paths, shapes and types as ``jax.eval_shape`` of the
    reference's ``init_params``, in the eager init's key order (embed
    {tok, frame_proj}, enc_blocks, blocks, enc_norm, final_norm; tied
    embeddings, no head); every stacked leaf N(0, 0.02), the prefixed
    norms too (the zeros rule fires on the bare name ``ln`` only), the
    projections too; both norms zeros."""
    jm, tm = _pair(dtype=dtype)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jm.cfg, k),
                            jax.random.PRNGKey(1))
    tp = tm.init(1)
    assert sorted(_layout(tp)) == sorted(_layout(shapes))
    assert _layout(tp) == _layout(jm.init(jax.random.PRNGKey(1)))
    assert list(tp) == ["embed", "enc_blocks", "blocks", "enc_norm",
                        "final_norm"]
    assert list(tp["embed"]) == ["tok", "frame_proj"]
    assert sorted(tp["blocks"]) == list(tp["blocks"])
    assert {k[len("xattn_"):] for k in tp["blocks"]
            if k.startswith("xattn_")} == {"ln", "wq", "wk", "wv", "wo"}
    for path in ("enc_blocks", "blocks", "embed"):
        for k, v in _host(tp[path]).items():
            assert 0.01 < v.std() < 0.03, (path, k)
    assert not tp["enc_norm"].any() and not tp["final_norm"].any()


def test_full_width_layout_is_whisper_medium():
    """whisper-medium from its shapes alone (nothing allocated): an
    encoder block 12.58 M params, a decoder block 16.78 M (its
    cross-attention 4.20 M), 704 765 952 selectable in 48 mask entries,
    758 926 336 in all with the tied 51 865 × 1024 embedding, the frame
    projection and the two norms."""
    cfg = tcfg.get_arch(ARCH)
    enc = tmodel._block_shapes(cfg, "dense")
    dec = tmodel._block_shapes(cfg, "encdec")
    jc = jcfg.get_arch(ARCH)
    assert enc == jmodel._block_shapes(jc, "dense")
    assert dec == jmodel._block_shapes(jc, "encdec")
    per_enc = sum(math.prod(s) for s in enc.values())
    per_dec = sum(math.prod(s) for s in dec.values())
    xattn = sum(math.prod(s) for k, s in dec.items()
                if k.startswith("xattn_"))
    assert (per_enc, per_dec, xattn) == (12_584_960, 16_780_288, 4_195_328)
    assert len(enc) == 8 and len(dec) == 13
    selectable = cfg.n_enc_layers * per_enc + cfg.n_layers * per_dec
    d = cfg.d_model
    total = selectable + cfg.vocab_size * d + d * d + 2 * d
    assert selectable == 704_765_952 and total == 758_926_336
    assert cfg.n_selectable_layers() == 48 and cfg.tie_embeddings
    assert [(s.path, s.count) for s in tmodel.layer_layout(cfg)] == \
        [("enc_blocks", 24), ("blocks", 24)]


@pytest.mark.parametrize("seq_chunk,extra", [
    (1024, {}),
    (4, {}),
    (4, {"qkv_bias": True, "rope_theta": 10000.0}),
], ids=["full", "chunked", "chunked_bias_rope"])
def test_cross_attention_matches_reference(seq_chunk, extra):
    """``make_cross_kv`` and ``attention_fwd(cross_kv=…)`` against the
    reference's on one decoder row: in one piece (seq_chunk 1024) and by
    query chunks of 4 (S 8 over Se 16), and with the bias and RoPE
    branches (q's bias and RoPE only; k and v used as given)."""
    jm, tm = _pair(seq_chunk, **extra)
    cfg = jm.cfg
    rng = np.random.RandomState(5)
    jp = jm.init(jax.random.PRNGKey(4))
    host = _host(jp)
    if cfg.qkv_bias:           # the init's biases are zeros: make them count
        for name in ("xattn_bq", "xattn_bk", "xattn_bv"):
            host["blocks"][name] = rng.standard_normal(
                host["blocks"][name].shape).astype(np.float32) * 0.1
    row = {k[len("xattn_"):]: v[0] for k, v in host["blocks"].items()
           if k.startswith("xattn_")}
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    jrow = {k: jnp.asarray(v) for k, v in row.items()}
    trow = {k: torch.from_numpy(v.copy()) for k, v in row.items()}
    jk, jv = jblocks.make_cross_kv(jrow, jnp.asarray(enc), cfg)
    tk, tv = tblocks.make_cross_kv(trow, torch.from_numpy(enc), tm.cfg)
    assert tuple(tk.shape) == (2, cfg.enc_seq, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)
    pos = np.arange(SEQ, dtype=np.int32)
    want, _ = jblocks.attention_fwd(jrow, jnp.asarray(x), cfg,
                                    positions=jnp.asarray(pos),
                                    cross_kv=(jk, jv), causal=False,
                                    seq_chunk=seq_chunk)
    got = tblocks.attention_fwd(trow, torch.from_numpy(x), tm.cfg,
                                positions=torch.from_numpy(pos),
                                cross_kv=(tk, tv), causal=False,
                                seq_chunk=seq_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_forward_and_loss_match_reference(world):
    """Hidden states, aux loss (zero) and loss: the encoder over 16
    frames, the decoder's causal self-attention (the flash path's plain
    version in the port) and cross-attention over 8 tokens."""
    jm, tm, jp, host, batch = world
    jh, jaux, jprefix = jax.jit(jm.forward_seq)(jp, _jb(batch))
    tp = _tp(host)
    with torch.no_grad():
        th, aux, prefix_len = tm.hidden_seq(tp, _tb(batch))
        loss = tm.seq_loss(tp, _tb(batch))
        enc = tm.encode(tp, _tb(batch)["frames"])
    assert prefix_len == jprefix == 0 and aux.item() == float(jaux) == 0.0
    assert tuple(th.shape) == (2, SEQ, jm.cfg.d_model)
    assert tuple(enc.shape) == (2, jm.cfg.enc_seq, jm.cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(loss.item(),
                               float(jax.jit(jm.loss)(jp, _jb(batch))),
                               rtol=LOSS_RTOL)


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("cut", [None, 1, 2, 3],
                         ids=["dense", "cut1", "cut2", "cut3"])
def test_every_gradient_matches_reference(world, cut, remat):
    """The loss and every differentiated leaf's gradient against
    ``jax.grad``: the dense path over the whole tree, or the mask-aware
    path over ``trainable_rows`` at cut 1 (mid-encoder: the encoder's
    trainable row gets its gradient through every decoder row's cross
    k/v), 2 (the boundary: the encoder frozen and run without a graph)
    and 3 (deep).  With remat each row is recomputed in the backward and
    the decoder rows read ``enc_out`` as a closed-over tensor."""
    jm, _, jp, host, batch = world
    _, tm = _pair(remat=remat)
    jb, tb = _jb(batch), _tb(batch)
    if cut is None:
        want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
        wrt = _requires_grad(_tp(host))
        loss = tm.seq_loss(wrt, tb)
    else:
        jtr = jmodel.trainable_slice(jp, cut, jm.cfg)
        want_loss, want_g = jax.jit(jax.value_and_grad(
            lambda tr: jm.loss(jp, jb, trainable=tr, cut=cut)))(jtr)
        tp = _tp(host)
        wrt = _requires_grad(tmodel.trainable_rows(tp, cut, tm.cfg))
        loss = tm.seq_loss(tp, tb, trainable=wrt, cut=cut)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    leaves = _leaves(wrt)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                               allow_unused=True)))
    want = _leaves(_host(want_g))
    assert set(got) == set(want)
    if cut in (None, 1):
        assert any(k.startswith("enc_blocks/") for k in got)
    for k in want:
        g = got[k]
        g = np.zeros_like(want[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    if cut is not None:
        for k in ("blocks/xattn_wk", "blocks/xattn_wv"):
            assert np.abs(got[k].numpy()).max() > 0, k


def test_frozen_encoder_runs_without_a_graph(world):
    """At a cut at or past the encoder's end its output carries no graph
    (the rows ran under no_grad); below it, it does."""
    _, tm, _, host, batch = world
    tp = _tp(host)
    frames = _tb(batch)["frames"]
    n_enc = tm.cfg.n_enc_layers
    for cut, graph in ((n_enc, False), (tm.n_selectable - 1, False),
                       (1, True)):
        tr = _requires_grad(tmodel.trainable_rows(tp, cut, tm.cfg))
        cuts = tmodel.segment_prefix_cuts(cut, tm.cfg)
        enc = tm.encode(tp, frames, trainable=tr.get("enc_blocks", {}),
                        cut=cuts["enc_blocks"])
        assert (enc.grad_fn is not None) == graph, cut


def _fill_cross(model, params, cache, frames):
    """The cross cache from the encoder, row by row through
    ``make_cross_kv``, as the reference's tests/test_decode_consistency.py
    fills it (neither package has an encoder-prefill entry point)."""
    enc = model.encode(params, frames)
    for li in range(model.cfg.n_layers):
        row = {k[len("xattn_"):]: v[li] for k, v in params["blocks"].items()
               if k.startswith("xattn_")}
        k, v = tblocks.make_cross_kv(row, enc, model.cfg)
        cache["cross_kv"]["k"][li] = k
        cache["cross_kv"]["v"][li] = v
    return cache


def _jfill_cross(jm, jp, cache, frames):
    """The same in the reference, as its decode-consistency test does it."""
    cfg = jm.cfg
    e = frames.astype(jp["embed"]["frame_proj"].dtype) @ \
        jp["embed"]["frame_proj"]
    e = e + jblocks.sinusoid_positions(jnp.arange(cfg.enc_seq),
                                       cfg.d_model).astype(e.dtype)
    for li in range(cfg.n_enc_layers):
        p = jax.tree.map(lambda a: a[li], jp["enc_blocks"])
        e, _ = jmodel._dense_block_fwd(
            p, e, cfg, positions=jnp.arange(cfg.enc_seq, dtype=jnp.int32),
            causal=False, window=0, prefix_len=0, seq_chunk=1024)
    enc = jblocks.rms_norm(e, jp["enc_norm"], cfg.norm_eps)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[li], jp["blocks"])
        k, v = jblocks.make_cross_kv(jmodel._take(p, "xattn_"), enc, cfg)
        ks.append(k)
        vs.append(v)
    cache["cross_kv"]["k"] = jnp.stack(ks)
    cache["cross_kv"]["v"] = jnp.stack(vs)
    return cache


def test_decode_matches_forward_seq_and_reference(world):
    """Token-by-token decode (each decoder row's self-attention over its
    KV row, its cross-attention over the cross cache) over a cross cache
    filled from the port's own encoder, against the port's sequence
    forward and against the reference's decode over the cache filled
    from its encoder, step by step; the caches alike after the run."""
    jm, tm, jp, host, batch = world
    tp = _tp(host)
    frames, tokens = batch["frames"], batch["tokens"]
    with torch.no_grad():
        h, _, _ = tm.hidden_seq(tp, _tb(batch))
        want = tm._head(tp, h)
    cache = tm.init_cache(2, SEQ)
    jcache = jm.init_cache(2, SEQ)
    assert _layout(cache) == _layout(jcache)
    assert tuple(cache["cross_kv"]["k"].shape) == (
        jm.cfg.n_layers, 2, jm.cfg.enc_seq, jm.cfg.n_kv_heads,
        jm.cfg.resolved_head_dim)
    with torch.no_grad():
        cache = _fill_cross(tm, tp, cache, torch.from_numpy(frames))
    jcache = _jfill_cross(jm, jp, jcache, jnp.asarray(frames))
    np.testing.assert_allclose(cache["cross_kv"]["k"].numpy(),
                               np.asarray(jcache["cross_kv"]["k"]),
                               atol=ATOL, rtol=RTOL)
    jdecode = jax.jit(jm.decode_step)
    got, ref = [], []
    for t in range(SEQ):
        pos = torch.tensor(t, dtype=torch.int32)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tokens[:, t]),
                                       pos, cache)
        got.append(logits)
        jl, jcache = jdecode(jp, jnp.asarray(tokens[:, t]), jnp.int32(t),
                             jcache)
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


def test_per_slot_decode_refused_and_reset_slot_keeps_cross_kv(world):
    """A per-slot position vector is refused (the reference's per-slot
    whisper decode fails in its cross-attention); a refill empties the
    slot's position rows in ``blocks`` and leaves ``cross_kv`` as it was,
    as the reference's reset does."""
    jm, tm, _, host, _ = world
    tp = _tp(host)
    cache = tm.init_cache(3, 8, per_slot=True)
    assert set(cache) == {"blocks", "cross_kv"}
    assert set(cache["cross_kv"]) == {"k", "v"}
    with pytest.raises(ValueError, match="one shared position"):
        tm.decode_step(tp, torch.zeros(3, dtype=torch.long),
                       torch.zeros(3, dtype=torch.int32), cache)
    for seg in cache.values():
        for leaf in seg.values():
            leaf.fill_(1)
    tm.reset_slot(cache, 1)
    imax = torch.iinfo(torch.int32).max
    assert (cache["blocks"]["pos"][:, 1] == imax).all()
    assert (cache["blocks"]["pos"][:, [0, 2]] == 1).all()
    assert (cache["cross_kv"]["k"] == 1).all()
    assert (cache["cross_kv"]["v"] == 1).all()
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
    """The probe's per-layer ‖g‖² over both segments (the encoder's rows
    first), the per-layer parameter counts and the total count."""
    jm, tm, jp, host, _ = world
    g = _rand_tree(host, 3)
    want = np.asarray(jmasks.per_layer_sq_norms(g, jm.cfg, mode="jnp"))
    got = tmasks.per_layer_sq_norms(_tp(g), tm.cfg).numpy()
    assert got.shape == (tm.n_selectable,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    counts = tmasks.count_layer_params(_tp(host), tm.cfg)
    np.testing.assert_array_equal(counts,
                                  jmasks.count_layer_params(host, jm.cfg))
    assert counts[0] < counts[-1]             # the decoder rows hold xattn_
    tp = _tp(host)
    assert tmodel.count_params(tp) == jmodel.count_params(jp)
