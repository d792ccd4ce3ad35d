"""The dense family's sequence attention through the port's flash path:
``Model.forward_seq``, ``Model.loss`` and the gradients of every block leaf
against the JAX ``Model`` (which runs ``attend_full``) on the same
parameters and numpy-seeded batches, in f32 within 1e-5; and that the
no-cache path goes through ``ops.flash_attention`` at positions
``arange(S)`` while decode does not.

Worlds: reduced TinyLlama (causal LM, 4 q heads over 2 kv heads), the same
with a 16-token sliding window (seq 40, so the window masks), and reduced
XLM-R (bidirectional classifier)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel

TOL = 1e-5

# (arch, n_layers, d_model, window, batch, seq)
WORLDS = {
    "tinyllama": ("tinyllama_1_1b", 3, 64, 0, 2, 40),
    "tinyllama_window16": ("tinyllama_1_1b", 3, 64, 16, 2, 40),
    "xlmr": ("xlm_roberta_base", 4, 32, 0, 3, 24),
}
_CACHE: dict = {}


def _world(name):
    if name in _CACHE:
        return _CACHE[name]
    arch, n_layers, d, window, B, S = WORLDS[name]
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=n_layers, d_model=d)
    if window:
        jc, tc = jc.with_sliding_window(window), tc.with_sliding_window(window)
    # seq_chunk above S: the reference attends with attend_full
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=1024))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False), device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.RandomState(11)
    batch = {"tokens": rng.randint(0, jc.vocab_size, (B, S)).astype(np.int32)}
    if jc.task == "classification":
        batch["label"] = rng.randint(0, jc.n_classes, (B,)).astype(np.int32)
    _CACHE[name] = (jm, tm, jp, host, batch)
    return _CACHE[name]


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_forward_seq_matches_reference(world):
    jm, tm, jp, host, batch = _world(world)
    want, _, _ = jax.jit(jm.forward_seq)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _, _ = tm.forward_seq(params_to_torch(host, "cpu"),
                                   _tbatch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_loss_and_every_block_grad_match_reference(world):
    jm, tm, jp, host, batch = _world(world)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda blk: jm.loss({**jp, "blocks": blk}, jb)))(jp["blocks"])
    tp = params_to_torch(host, "cpu")
    wrt = {k: v.detach().clone().requires_grad_()
           for k, v in tp["blocks"].items()}
    loss = tm.loss({**tp, "blocks": wrt}, _tbatch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    grads = torch.autograd.grad(loss, list(wrt.values()))
    assert set(wrt) == set(want_g)
    for name, g in zip(wrt, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def _spy(monkeypatch):
    """Record every ops.flash_attention call (mode, causal, window) and
    every plain backward."""
    calls, bwd = [], []
    fwd_fn, bwd_fn = tops.flash_attention, tfa.flash_attention_bwd_torch

    def fwd(q, k, v, *, causal=True, window=0, mode=None):
        calls.append((mode, causal, window, tuple(q.shape)))
        return fwd_fn(q, k, v, causal=causal, window=window, mode=mode)

    def back(*a, **kw):
        bwd.append(1)
        return bwd_fn(*a, **kw)
    monkeypatch.setattr(tops, "flash_attention", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_torch", back)
    return calls, bwd


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sequence_attention_goes_through_flash(monkeypatch, world):
    """One ops.flash_attention call per layer per forward (causal for the
    LM, bidirectional for the classifier, the config's window), one plain
    backward per layer per backward."""
    _, tm, _, host, batch = _world(world)
    calls, bwd = _spy(monkeypatch)
    tp = params_to_torch(host, "cpu")
    wrt = {k: v.detach().clone().requires_grad_()
           for k, v in tp["blocks"].items()}
    loss = tm.loss({**tp, "blocks": wrt}, _tbatch(batch))
    torch.autograd.grad(loss, list(wrt.values()))
    cfg = tm.cfg
    B, S = batch["tokens"].shape
    want = (None, cfg.task == "lm", cfg.sliding_window,
            (B, S, cfg.n_heads, cfg.resolved_head_dim))
    assert calls == [want] * cfg.n_layers
    assert len(bwd) == cfg.n_layers


def test_kernel_mode_torch_reaches_flash(monkeypatch):
    _, tm, _, host, batch = _world("tinyllama")
    calls, _ = _spy(monkeypatch)
    plain = tmodel.Model(tm.cfg, tm.runtime, device="cpu",
                         kernel_mode="torch")
    with torch.no_grad():
        plain.forward_seq(params_to_torch(host, "cpu"), _tbatch(batch))
    assert [c[0] for c in calls] == ["torch"] * tm.cfg.n_layers


def test_flash_branch_sees_arange_positions(monkeypatch):
    """The kernel derives positions from indices: forward_seq must hand the
    no-cache branch positions 0 … S−1."""
    _, tm, _, host, batch = _world("tinyllama_window16")
    seen = []
    fn = tblocks.attention_fwd

    def spy(p, x, cfg, **kw):
        seen.append((kw["positions"].clone(), kw.get("cache")))
        return fn(p, x, cfg, **kw)
    monkeypatch.setattr(tblocks, "attention_fwd", spy)
    with torch.no_grad():
        tm.forward_seq(params_to_torch(host, "cpu"), _tbatch(batch))
    S = batch["tokens"].shape[1]
    assert len(seen) == tm.cfg.n_layers
    for pos, cache in seen:
        assert cache is None
        assert torch.equal(pos, torch.arange(S, dtype=torch.int32))


def test_decode_does_not_take_flash(monkeypatch):
    """Decode attends over its KV cache with attend_full, as the
    reference."""
    _, tm, _, host, batch = _world("tinyllama")
    calls, _ = _spy(monkeypatch)
    tp = params_to_torch(host, "cpu")
    cache = tm.init_cache(2, 8)
    with torch.no_grad():
        for t in range(3):
            logits, cache = tm.decode_step(
                tp, torch.from_numpy(batch["tokens"][:, t]),
                torch.tensor(t, dtype=torch.int32), cache)
    assert calls == [] and torch.isfinite(logits).all()


def test_prefix_lm_keeps_the_reference_path(monkeypatch):
    """prefix_len > 0 (the vlm prefix-LM, which the kernel's mask lacks)
    does not reach the flash path; the same layer without a prefix does,
    and the bidirectional prefix changes the output."""
    calls, _ = _spy(monkeypatch)
    tc = tcfg.reduced(tcfg.get_arch("tinyllama_1_1b"), n_layers=1,
                      d_model=64)
    p = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    layer = {n[5:]: a[0] for n, a in p["blocks"].items()
             if n.startswith("attn_")}
    x = torch.randn((2, 12, 64), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(12, dtype=torch.int32)
    out = tblocks.attention_fwd(layer, x, tc, positions=pos, prefix_len=4)
    assert calls == [] and out.shape == x.shape
    no_prefix = tblocks.attention_fwd(layer, x, tc, positions=pos)
    assert len(calls) == 1 and not torch.allclose(out, no_prefix)
