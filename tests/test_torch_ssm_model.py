"""The port's ssm family (reduced Mamba2: 3 layers, d_model 32, 4 SSD heads
of 16, state 16, chunk 32) against the JAX package's on shared weights:
init layout and rules, the bridge, loss and gradients (dense and
mask-aware), decode against the sequence forward, SlotServer token ids, and
two rounds of Experiment("ours") plus a round with a frozen prefix.

Tolerances: f32 throughout; losses rtol 1e-5, gradients and params atol
1e-5 / rtol 1e-4 (sums in another order), decode logits against the
sequence forward atol/rtol 1e-4 (the reference's own check uses 2e-3);
cohorts, masks and token ids exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro_torch.api.experiment import Experiment
from repro_torch.bridge import params_to_numpy, params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel
from repro_torch.serve import DeltaOverlay

LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
SEQ = 64                       # two chunks of 32: the state crosses one
# the leaves whose reference rules (A_log, D, ln) never fire under "ssm_"
SMALL_NORMAL = ("ssm_A_log", "ssm_D", "ssm_ln", "ssm_gate_ln", "ssm_conv_b")


def _host(tree):
    """Leaves (JAX or torch) to f32 numpy, keeping key order."""
    return {k: _host(v) if isinstance(v, dict)
            else v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in tree.items()}


@pytest.fixture(scope="module")
def world():
    jc = jcfg.reduced(jcfg.get_arch("mamba2_370m"), n_layers=3, d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("mamba2_370m"), n_layers=3, d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    host = _host(jp)
    tokens = np.random.RandomState(7).randint(
        0, jc.vocab_size, (2, SEQ)).astype(np.int32)
    return jm, tm, jp, host, tokens


def _tp(host):
    return params_to_torch(host, "cpu")


def _max_err(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b) or set(a) == set(b)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_rules_match_reference(world, dtype):
    """Same paths, shapes, types and key order; and the reference's rules
    as they act under the ``ssm_`` prefix: A_log, D, both norms and the conv
    bias N(0, 0.02), dt_bias zeros, so A = −exp(A_log) ≈ −1."""
    jm, tm, _, _, _ = world
    jc = dataclasses.replace(jm.cfg, dtype=dtype)
    tc = dataclasses.replace(tm.cfg, dtype=dtype)
    # eager: a jitted init would return its dicts in sorted-key order
    jp = jmodel.Model(jc, jm.runtime).init(jax.random.PRNGKey(1))
    tp = tmodel.Model(tc, tm.runtime, device="cpu").init(1)
    assert _layout(tp) == _layout(jp)
    for blocks in (jp["blocks"], tp["blocks"]):
        b = _host(blocks)
        assert not b["ssm_dt_bias"].any()
        small = np.concatenate([b[k].ravel() for k in SMALL_NORMAL])
        for k in SMALL_NORMAL:
            assert b[k].any() and np.abs(b[k]).max() < 0.15, k
        assert 0.015 < small.std() < 0.025
        A = -np.exp(b["ssm_A_log"])
        assert np.all((A > -1.2) & (A < -0.85))


def test_init_stacked_rules_pinned():
    """The port's init_stacked on the reference's rule names: zeros for
    ``b*``, ``ln`` and ``*_bias``; the unprefixed ``A_log``/``D`` get no
    rule of their own (the reference's fire only on those exact names)."""
    gen = torch.Generator().manual_seed(0)
    p = tblocks.init_stacked(gen, {"bq": (4,), "ln": (4,), "dt_bias": (4,),
                                   "ssm_A_log": (64,), "ssm_D": (64,),
                                   "ssm_ln": (64,), "w": (64,)}, 2,
                             torch.float32, "cpu")
    for k in ("bq", "ln", "dt_bias"):
        assert not p[k].any(), k
    for k in ("ssm_A_log", "ssm_D", "ssm_ln", "w"):
        assert p[k].any() and float(p[k].abs().max()) < 0.15, k
    jp = jblocks.init_stacked(jax.random.PRNGKey(0), {"A_log": (64,),
                                                      "ssm_A_log": (64,)},
                              2, jnp.float32)
    assert float(jnp.min(jp["A_log"])) >= 0.0          # log U[1, 16)
    assert float(jnp.max(jnp.abs(jp["ssm_A_log"]))) < 0.15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_exactly(world, dtype):
    _, _, jp, _, _ = world
    host = _host(jax.tree.map(lambda a: a.astype(dtype), jp))
    tp = params_to_torch(host, "cpu", getattr(torch, dtype))
    assert all(t.dtype == getattr(torch, dtype)
               for t in tp["blocks"].values())
    back = params_to_numpy(tp)
    assert _layout(back) == _layout(host)
    assert _max_err(back, host) == 0.0
    assert "head" not in tp and list(tp["embed"]) == ["tok"]


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


def _grads(loss, wrt: dict) -> dict:
    names = list(wrt)
    return dict(zip(names, torch.autograd.grad(loss, [wrt[n] for n in names])))


def _assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_dense_loss_and_block_grads_match_reference(world):
    jm, tm, jp, host, tokens = world
    jb = {"tokens": jnp.asarray(tokens)}
    want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tp = _tp(host)
    tp["blocks"] = _requires_grad(tp["blocks"])
    loss = tm.loss(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_close(_grads(loss, tp["blocks"]), want_g["blocks"])


@pytest.mark.parametrize("cut", [1, 2])
def test_masked_loss_equals_dense_and_grads_match_reference(world, cut):
    jm, tm, jp, host, tokens = world
    jb = {"tokens": jnp.asarray(tokens)}
    tr0 = jmodel.trainable_slice(jp, cut, jm.cfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda t: jm.loss(jp, jb, trainable=t, cut=cut)))(tr0)
    tp = _tp(host)
    tb = {"tokens": torch.from_numpy(tokens)}
    tr = {"blocks": _requires_grad(
        tmodel.trainable_slice(tp, cut, tm.cfg)["blocks"])}
    loss = tm.loss(tp, tb, trainable=tr, cut=cut)
    with torch.no_grad():
        dense = tm.loss(tp, tb)
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    g = _grads(loss, tr["blocks"])
    assert all(v.shape[0] == tm.n_selectable - cut for v in g.values())
    _assert_close(g, want_g["blocks"])


def _seq_logits(tm, tp, tokens):
    with torch.no_grad():
        h, _, _ = tm.forward_seq(tp, {"tokens": torch.from_numpy(tokens)})
        return tm._head(tp, h)


def test_decode_matches_forward_seq_and_reference(world):
    """Token-by-token decode (the recurrent state) against the chunked
    sequence forward (the scan) in the port, and against the reference's
    decode step by step."""
    jm, tm, jp, host, tokens = world
    tp = _tp(host)
    want = _seq_logits(tm, tp, tokens)
    cache = tm.init_cache(2, SEQ)
    assert _layout(cache) == _layout(jm.init_cache(2, SEQ))
    jcache = jm.init_cache(2, SEQ)
    jdecode = jax.jit(jm.decode_step)
    got, ref = [], []
    for t in range(SEQ):
        logits, cache = tm.decode_step(
            tp, torch.from_numpy(tokens[:, t]),
            torch.tensor(t, dtype=torch.int32), cache)
        got.append(logits)
        jl, jcache = jdecode(jp, jnp.asarray(tokens[:, t]), jnp.int32(t),
                             jcache)
        ref.append(np.asarray(jl))
    got = torch.stack(got, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.stack(ref, 1), atol=ATOL,
                               rtol=RTOL)
    assert _max_err(cache, _host(jcache)) < ATOL


def test_reset_slot_zeroes_conv_and_state_rows(world):
    _, tm, _, _, _ = world
    cache = tm.init_cache(3, 8)
    for leaf in cache["blocks"].values():
        leaf.fill_(1.0)
    tm.reset_slot(cache, 1)
    for leaf in cache["blocks"].values():
        assert not leaf[:, 1].any() and leaf[:, 0].all() and leaf[:, 2].all()
    stacked = {"blocks": {k: v.transpose(0, 1).clone()
                          for k, v in tm.init_cache(3, 8)["blocks"].items()}}
    for leaf in stacked["blocks"].values():
        leaf.fill_(1.0)
    tm.reset_slot(stacked, 2, stacked=True)
    for leaf in stacked["blocks"].values():
        assert not leaf[2].any() and leaf[:2].all()


def _requests(mod, vocab, users):
    rng = np.random.RandomState(1)
    return [mod.Request(i, rng.randint(0, vocab, 4).tolist(), 5,
                        user_id=(i % users if users else -1))
            for i in range(7)]


@pytest.mark.parametrize("mode", ["shared", "dense"])
def test_slot_server_generates_reference_tokens(world, mode):
    """7 requests through 3 slots with staggered refills (so conv and state
    rows are reset between requests): the reference's token ids."""
    jm, tm, jp, host, _ = world
    tp = _tp(host)
    users = 3 if mode == "dense" else 0
    jstore = tstore = None
    if users:
        jstore = jserve.demo_store(jm, jp, users=3, layers_per_user=2, seed=0)
        tstore = tserve.demo_store(tm, tp, users=3, layers_per_user=2, seed=0)
    jdone, jstats = jserve.SlotServer(jm, jp, 3, 16, mode=mode,
                                      store=jstore).run(
        _requests(jserve, jm.cfg.vocab_size, users))
    tdone, tstats = tserve.SlotServer(tm, tp, 3, 16, mode=mode, store=tstore,
                                      device="cpu").run(
        _requests(tserve, tm.cfg.vocab_size, users))
    assert [(r.rid, r.generated) for r in tdone] == \
        [(r.rid, r.generated) for r in jdone]
    assert tstats["steps"] == jstats["steps"]
    assert tstats["gen_tokens"] == jstats["gen_tokens"] == 35


def test_delta_mode_is_refused_for_ssm(world):
    _, tm, _, host, _ = world
    tp = _tp(host)
    assert not tmodel.supports_delta_decode(tm.cfg)
    with pytest.raises(ValueError, match="delta-decode"):
        DeltaOverlay(tm, 3, device="cpu")
    with pytest.raises(ValueError, match="delta-decode"):
        tm.decode_step(tp, torch.zeros(2, dtype=torch.long),
                       torch.tensor(0, dtype=torch.int32),
                       tm.init_cache(2, 4), delta={})


TASK = dict(n_clients=8, seq_len=SEQ, samples_per_client=8, skew="label",
            objective="lm")
FL = dict(cohort_size=3, local_steps=2, lr=0.01, batch_size=2, budget=1,
          lam=1.0, seed=3)


@pytest.mark.parametrize("strategy,rounds", [("ours", 2), ("top", 1)])
def test_rounds_match_reference(world, strategy, rounds):
    """Experiment(…, pipeline=False) against the reference's FLServer:
    cohorts and masks exactly, losses within 1e-4, params within atol
    1e-5.  "top" (budget 1) selects the last layer only, so the round runs
    the mask-aware engine with a frozen 2-layer prefix."""
    jm, tm, jp, host, _ = world
    jdata = jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))
    jserver = JServer(jm, jcfg.FLConfig(n_clients=TASK["n_clients"],
                                        rounds=rounds, strategy=strategy,
                                        **FL), jdata, pipeline=False)
    p_want, h_want = jserver.run(jp)
    tdata = tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))
    exp = Experiment(tm, tdata, strategy, rounds=rounds, pipeline=False,
                     device="cpu", **FL)
    p_got, h_got = exp.run(_tp(host))
    assert exp.server.mask_aware and jserver.mask_aware
    assert len(h_got.records) == len(h_want.records) == rounds
    for rg, rw in zip(h_got.records, h_want.records):
        np.testing.assert_array_equal(rg.cohort, rw.cohort)
        np.testing.assert_array_equal(rg.mask_matrix, rw.mask_matrix)
        assert rg.train_loss == pytest.approx(rw.train_loss, abs=1e-4)
        assert rg.test_loss == pytest.approx(rw.test_loss, abs=1e-4)
    if strategy == "top":
        cut = int(np.flatnonzero(h_got.records[0].mask_matrix.sum(0))[0])
        assert cut == tm.n_selectable - 1
    assert _max_err(p_got, p_want) < ATOL
