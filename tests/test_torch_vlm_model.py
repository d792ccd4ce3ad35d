"""The port's vlm family through ``models/model.py`` against the JAX
package's ``Model`` on shared weights from the reference's
``init_params``: reduced PaliGemma (2 layers, d_model 32, MQA 4/1 of 64,
GeGLU, tied vocabulary, 8 stub patch tokens before 16 text tokens, the
prefix attending bidirectionally) and reduced CLIP ViT-B/32 (2 layers,
d_model 32, MHA 4/4, plain GELU, 8 patch tokens pooled into a 10-class
head).

PaliGemma: the loss (over the text positions only), every gradient, the
prefill's last-position logits (``logits_seq`` with the prefix) and
greedy decode of a prompt fed a token a step (neither package's decode
takes the prefix: its cache holds the text tokens).  CLIP: the loss on
labels and the pooled logits.

Tolerances: f32 throughout; losses rtol 1e-5, logits and gradients atol
1e-5 / rtol 1e-4 (sums in another order); decode tokens exactly.
"""
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
ATOL, RTOL = 1e-5, 1e-4
TEXT, BATCH = 16, 2
PROMPT, STEPS = 4, 6


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str):
    rt = dict(remat=False, seq_chunk=16)
    jc = jcfg.reduced(jcfg.get_arch(arch), n_layers=2, d_model=32)
    tc = tcfg.reduced(tcfg.get_arch(arch), n_layers=2, d_model=32)
    return (jmodel.Model(jc, jcfg.RuntimeConfig(**rt)),
            tmodel.Model(tc, tcfg.RuntimeConfig(**rt), device="cpu"))


@pytest.fixture(scope="module", params=["paligemma_3b", "clip_vit_b32"])
def world(request):
    jm, tm = _pair(request.param)
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = jm.cfg
    rng = np.random.RandomState(29)
    batch = {"patches": rng.randn(BATCH, cfg.n_prefix_tokens,
                                  cfg.d_model).astype(np.float32)}
    if cfg.task == "lm":
        batch["tokens"] = rng.randint(0, cfg.vocab_size,
                                      (BATCH, TEXT)).astype(np.int32)
    else:
        batch["label"] = rng.randint(0, cfg.n_classes,
                                     (BATCH,)).astype(np.int32)
    return jm, tm, jp, _host(jp), batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_the_reduced_configs_are_the_vlm_family():
    """PaliGemma is a prefix-LM with a tied head and MQA; CLIP a pooled
    classifier; both prepend their stub patches through ``patch_proj``."""
    pali, clip = (_pair(a)[1].cfg for a in ("paligemma_3b", "clip_vit_b32"))
    assert (pali.family, pali.task, pali.n_heads, pali.n_kv_heads) == \
        ("vlm", "lm", 4, 1) and pali.tie_embeddings
    assert (clip.family, clip.task, clip.n_classes) == \
        ("vlm", "classification", 10)
    assert pali.n_prefix_tokens == clip.n_prefix_tokens == 8


def test_loss_and_hidden_state_match_reference(world):
    """The loss (PaliGemma: over the text positions only, the prefix's
    hidden states excluded; CLIP: cross-entropy of the pooled logits) and
    the hidden state with its prefix length."""
    jm, tm, jp, host, batch = world
    tp = params_to_torch(host, "cpu")
    jh, _, jprefix = jax.jit(jm.forward_seq)(jp, _jax_batch(batch))
    with torch.no_grad():
        th, _, prefix = tm.hidden_seq(tp, _torch_batch(batch))
        loss = tm.loss(tp, _torch_batch(batch))
    assert prefix == int(jprefix) == jm.cfg.n_prefix_tokens
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=RTOL)
    want = float(jax.jit(jm.loss)(jp, _jax_batch(batch)))
    np.testing.assert_allclose(loss.item(), want, rtol=LOSS_RTOL)
    if jm.cfg.task == "lm":
        # the loss is the text's: a change in the prefix's last hidden row
        # alone (its logits would predict the first text token) moves nothing
        text_h = th[:, prefix:]
        ce = tm.loss_from_hidden(tp, torch.cat([th[:, :prefix] + 1.0,
                                                text_h], 1),
                                 torch.zeros(()), prefix,
                                 _torch_batch(batch))
        assert ce.item() == loss.item()


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}


def test_every_gradient_matches_reference(world):
    """Every leaf's gradient of the loss: the blocks', the final norm's,
    ``patch_proj``'s and (PaliGemma) the tied ``tok``'s, which the text
    embedding and the head both read; CLIP's head, and zero for its
    ``tok``, which nothing reads (a classifier has no text)."""
    jm, tm, jp, host, batch = world
    jg = _leaves(_host(jax.jit(jax.grad(jm.loss))(jp, _jax_batch(batch))))
    tp = _requires_grad(params_to_torch(host, "cpu"))
    loss = tm.loss(tp, _torch_batch(batch))
    flat = _leaves(tp)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), allow_unused=True)))
    assert set(grads) == set(jg)
    unused = {p for p, g in grads.items() if g is None}
    assert unused == (set() if jm.cfg.task == "lm" else {"embed/tok"})
    for path, g in grads.items():
        got = np.zeros_like(jg[path]) if g is None else g.numpy()
        np.testing.assert_allclose(got, jg[path], atol=ATOL, rtol=RTOL,
                                   err_msg=path)
    assert np.abs(jg["embed/patch_proj"]).max() > 1e-4


def test_prefill_logits_match_reference(world):
    """``logits_seq``: PaliGemma's last-position logits over prefix and
    text, CLIP's pooled class logits."""
    jm, tm, jp, host, batch = world
    tp = params_to_torch(host, "cpu")
    with torch.no_grad():
        got = tm.logits_seq(tp, _torch_batch(batch))
    want = np.asarray(jax.jit(jm.logits_seq)(jp, _jax_batch(batch)))
    width = jm.cfg.vocab_size if jm.cfg.task == "lm" else jm.cfg.n_classes
    assert got.shape == want.shape == (BATCH, width)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_paligemma_decode_matches_reference():
    """After a prefix prefill, greedy decode of a 4-token prompt fed a
    token a step and 6 generated tokens: every step's logits and the
    tokens against the reference's ``decode_step``, and the cache."""
    jm, tm = _pair("paligemma_3b")
    jp = jm.init(jax.random.PRNGKey(4))
    tp = params_to_torch(_host(jp), "cpu")
    cfg = jm.cfg
    rng = np.random.RandomState(30)
    prompt = rng.randint(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    patches = rng.randn(BATCH, cfg.n_prefix_tokens,
                        cfg.d_model).astype(np.float32)
    with torch.no_grad():
        pre = tm.logits_seq(tp, {"tokens": torch.from_numpy(prompt),
                                 "patches": torch.from_numpy(patches)})
    np.testing.assert_allclose(pre.numpy(), np.asarray(jax.jit(
        jm.logits_seq)(jp, {"tokens": jnp.asarray(prompt),
                            "patches": jnp.asarray(patches)})),
        atol=ATOL, rtol=RTOL)
    total = PROMPT + STEPS
    cache, jcache = tm.init_cache(BATCH, total), jm.init_cache(BATCH, total)
    jdecode = jax.jit(jm.decode_step)
    tok = jtok = prompt[:, 0]
    got, want = [], []
    for t in range(total - 1):
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok),
                                       torch.tensor(t, dtype=torch.int32),
                                       cache)
        jl, jcache = jdecode(jp, jnp.asarray(jtok), jnp.int32(t), jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {t}")
        nxt = logits.argmax(-1).to(torch.int32).numpy()
        jnxt = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        tok = prompt[:, t + 1] if t + 1 < PROMPT else nxt
        jtok = prompt[:, t + 1] if t + 1 < PROMPT else jnxt
        if t + 1 >= PROMPT:
            got.append(nxt)
            want.append(jnxt)
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    got_c, want_c = _leaves(cache), _leaves(_host(jcache))
    assert set(got_c) == set(want_c)
    for path, b in want_c.items():
        np.testing.assert_allclose(got_c[path].float().numpy(), b, atol=ATOL,
                                   rtol=RTOL, err_msg=path)


def test_clip_is_a_classifier_without_text():
    """CLIP's batch has patches and labels only, its hidden state is the
    projected patches through the blocks (no token embedding), and
    ``init_params`` gives it a head of ``n_classes`` columns."""
    jm, tm = _pair("clip_vit_b32")
    tp = tm.init(0)
    assert tp["head"].shape == (tm.cfg.d_model, tm.cfg.n_classes)
    assert set(tp["embed"]) == set(_host(jm.init(jax.random.PRNGKey(0)))[
        "embed"])
    assert tm.cfg.rope_theta == 0.0 and tm.cfg.mlp_act == "gelu_plain"
