"""Mesh serving of the port (repro_torch.sharding.serve) against the
reference's single-device ``Model.logits_seq`` and ``Model.decode_step``,
on a gloo world of 4 processes over (data 2, model 2).

Params come from the reference's ``init_params`` through numpy and are
stored by the training rules (ZeRO-3 over ``data``, gathered a layer at a
time through ``layer_hook``); a batch of 4 splits over the two data
coordinates, a batch of 3 (which does not divide) stays whole on every
rank.  Decode feeds a 4-token prompt one token a step, then 6 greedy
tokens.  Mamba2 (conv and state caches), DeepSeek (``dense0`` gathered
whole, the moe ``blocks`` rows through the hook, MLA's latent caches) and
Zamba2 (the shared block gathered whole, its kv cache beside the Mamba2
rows') decode in the same world.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_world
from repro.configs.base import RuntimeConfig, get_arch, reduced
from repro.models.model import Model

TOL = 1e-5
PROMPT, STEPS = 4, 6
FAMILIES = {"ssm": "mamba2_370m", "moe": "deepseek_v2_lite_16b",
            "hybrid": "zamba2_7b"}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def reference_decode(model, params, prompt):
    B = prompt.shape[0]
    cache = model.init_cache(B, PROMPT + STEPS)
    step = jax.jit(model.decode_step)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for t in range(PROMPT + STEPS - 1):
        logits, cache = step(params, tok, jnp.int32(t), cache)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        tok = jnp.asarray(prompt[:, t + 1]) if t + 1 < PROMPT else nxt
        if t + 1 >= PROMPT:
            out.append(np.asarray(nxt))
    return np.stack(out, 1), np.asarray(logits, np.float32)


@pytest.fixture(scope="module")
def served():
    cfg = reduced(get_arch("tinyllama_1_1b"), n_layers=4, d_model=64)
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))
    params = model.init(jax.random.PRNGKey(0))
    host = _host(params)
    rng = np.random.RandomState(3)
    refs, cases = {}, []
    for B in (4, 3):
        tokens = rng.randint(0, cfg.vocab_size, (B, 16)).astype(np.int32)
        prompt = rng.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        refs[B] = dict(
            logits=np.asarray(model.logits_seq(params, {"tokens": tokens}),
                              np.float32),
            decode=reference_decode(model, params, prompt))
        for zero3 in (True, False):
            cases.append(dict(kind="prefill", arch="tinyllama_1_1b",
                              params=host, zero3=zero3, tokens=tokens))
            cases.append(dict(kind="decode", arch="tinyllama_1_1b",
                              params=host, zero3=zero3, prompt=prompt,
                              steps=STEPS))
    for family, arch in FAMILIES.items():
        fmodel = Model(reduced(get_arch(arch), n_layers=4, d_model=64),
                       RuntimeConfig(remat=False, seq_chunk=16))
        fparams = fmodel.init(jax.random.PRNGKey(0))
        prompt = rng.randint(0, fmodel.cfg.vocab_size,
                             (4, PROMPT)).astype(np.int32)
        refs[family] = reference_decode(fmodel, fparams, prompt)
        cases.append(dict(kind="decode", arch=arch, params=_host(fparams),
                          zero3=True, prompt=prompt, steps=STEPS))
    ranks = run_world(4, dict(data=2, model=2), cases)
    return dict(refs=refs, ranks=ranks)


def _case(B, zero3, kind):
    return (0 if B == 4 else 4) + (0 if zero3 else 2) + (kind == "decode")


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("B", [4, 3])
def test_mesh_prefill_matches_logits_seq(served, B, zero3):
    ref = served["refs"][B]["logits"]
    for r in served["ranks"]:
        res = r[_case(B, zero3, "prefill")]
        rows = res["rows"]
        # a batch of 4 splits over the data axis; 3 stays whole
        want = ([2 * res["coords"]["data"], 2 * res["coords"]["data"] + 1]
                if B == 4 else [0, 1, 2])
        assert rows.tolist() == want
        np.testing.assert_allclose(res["logits"], ref[rows], atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("B", [4, 3])
def test_mesh_decode_matches_decode_step(served, B, zero3):
    tokens, logits = served["refs"][B]["decode"]
    for r in served["ranks"]:
        res = r[_case(B, zero3, "decode")]
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows], atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_decode_other_families_match_decode_step(served, family):
    """The hook in the Mamba2, hybrid and moe decode loops gathers each
    ``blocks`` row: the same tokens and logits as the reference's
    single-device decode.  Mamba2 and Zamba2 run this rank's half of the
    batch; deepseek's routers share their capacity across the batch, so
    every rank runs all of it (``serve.batch_spec``)."""
    tokens, logits = served["refs"][family]
    for r in served["ranks"]:
        res = r[8 + list(FAMILIES).index(family)]
        rows = res["rows"]
        d = res["coords"]["data"]
        assert rows.tolist() == ([2 * d, 2 * d + 1] if family != "moe"
                                 else [0, 1, 2, 3])
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows], atol=TOL,
                                   rtol=0)
