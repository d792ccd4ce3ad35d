"""Tensor parallelism over ``model`` for the vlm family's language model
(``RuntimeConfig(tp_constraints=True)``: PaliGemma's prefix-LM blocks
split as the dense family's, its one kv head shared, its projector
``patch_proj`` all-gathered whole on every rank, the tied vocabulary
split) against the reference's single-host round and single-device
serving, on gloo worlds of 4 processes (tests/_torch_dist.py).

As in tests/test_torch_tensor_parallel_moe.py the oracle is the reference
computed with JAX on one device.  Reduced PaliGemma: 3 layers, d_model 64,
4 query heads and 1 kv head of 64 (``"kv_shared"`` at 2 and 4), GeGLU,
a tied vocabulary of 512 (split at 2 and 4), 8 stub patch tokens before
24 text tokens (32 positions: the prefix-LM attends by query chunks of
16); with 2 heads at 4 ranks attention is ``"replicated"``.  Two worlds:

* (data 2, model 2): the τ = 1 step, ``sel_upload``, τ = 2, prefill with
  the prefix, 8 greedy decode steps, the storage round trip and the
  gradients of ``patch_proj`` and ``attn_ln``;
* (data 1, model 4): the τ = 1 step, prefill, decode and the gradients;
  with 2 heads (``"replicated"``): the τ = 1 step, prefill and the
  gradients.

Tolerances: 3e-5 for τ = 1 and ``sel_upload``, 5e-5 for τ = 2, 1e-5 for
the logits; decode tokens exactly.  The classifier (CLIP) and the audio
family are refused in tests/test_torch_tensor_parallel.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_world
from repro.configs.base import RuntimeConfig, get_arch, reduced
from repro.core import aggregation as agg
from repro.core.client import Client
from repro.models.model import Model, apply_layer_mask

TOL, TAU_TOL, SERVE_TOL = 3e-5, 5e-5, 1e-5
ARCH, LAYERS, TEXT = "paligemma_3b", 3, 24
# "h2": PaliGemma with 2 query heads, which 4 ranks do not divide
HEADS = {"h4": None, "h2": (2, 1)}
MESH = {"m2": dict(data=2, model=2), "m4": dict(data=1, model=4)}
MASKS = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
SIZES = np.array([10., 20.], np.float32)
SEL_IDX, SEL_MASKS = (1, 2), np.array([[0, 1, 1], [0, 0, 1]], np.float32)
LR, TAU_LR, TAU = 0.1, 0.05, 2
PROMPT, STEPS = 4, 8
RUNS = {("m2", "h4"): ("step", "sel_upload", "tau", "prefill", "decode",
                       "round_trip", "grads"),
        ("m4", "h4"): ("step", "prefill", "decode", "grads"),
        ("m4", "h2"): ("step", "prefill", "grads")}
MODES = {("m2", "h4"): "kv_shared", ("m4", "h4"): "kv_shared",
         ("m4", "h2"): "replicated"}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


@functools.cache
def _model(heads):
    cfg = reduced(get_arch(ARCH), n_layers=LAYERS, d_model=64)
    if HEADS[heads]:
        H, K = HEADS[heads]
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K)
    return Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))


_JITS = {}


def _jit(model, name, make):
    key = (id(model), name)
    if key not in _JITS:
        _JITS[key] = jax.jit(make())
    return _JITS[key]


def _one(batch, i):
    return {k: jnp.asarray(v[i]) for k, v in batch.items()}


def step_oracle(model, params, batch, masks, lr):
    cfg, n = model.cfg, masks.shape[0]
    grad = _jit(model, "grad", lambda: jax.grad(model.loss))
    deltas = [apply_layer_mask(grad(params, _one(batch, i)), masks[i], cfg)
              for i in range(n)]
    update = agg.aggregate(deltas, jnp.asarray(masks),
                           jnp.asarray(SIZES[:n]), cfg)
    return _host(agg.apply_update(params, update, lr))


def tau_oracle(model, params, batch, masks):
    client, n = Client(model), masks.shape[0]
    deltas = [client._local_update(params, _one(batch, i), masks[i],
                                   TAU_LR)[0] for i in range(n)]
    return _host(agg.apply_update(params, agg.aggregate(
        deltas, jnp.asarray(masks), jnp.asarray(SIZES[:n]), model.cfg),
        TAU_LR))


def decode_oracle(model, params, prompt):
    cache = model.init_cache(prompt.shape[0], PROMPT + STEPS)
    step = _jit(model, "decode", lambda: model.decode_step)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for t in range(PROMPT + STEPS - 1):
        logits, cache = step(params, tok, jnp.int32(t), cache)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        tok = jnp.asarray(prompt[:, t + 1]) if t + 1 < PROMPT else nxt
        if t + 1 >= PROMPT:
            out.append(np.asarray(nxt))
    return np.stack(out, 1), np.asarray(logits, np.float32)


def grads_oracle(model, params, batch):
    """The loss and the gradients of ``patch_proj`` and ``attn_ln``."""
    value, g = _jit(model, "vgrad", lambda: jax.value_and_grad(model.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(value),
            "grads": {"patch_proj": np.asarray(g["embed"]["patch_proj"],
                                               np.float32),
                      "attn_ln": np.asarray(g["blocks"]["attn_ln"],
                                            np.float32)}}


def _batch(rng, cfg, lead):
    return {"tokens": rng.randint(0, cfg.vocab_size,
                                  lead + (TEXT,)).astype(np.int32),
            "patches": rng.randn(*lead, cfg.n_prefix_tokens,
                                 cfg.d_model).astype(np.float32)}


def _cases(world, heads, rng):
    model = _model(heads)
    cfg = model.cfg
    params = model.init(jax.random.PRNGKey(0))
    host = _host(params)
    n = MESH[world]["data"]
    common = dict(arch=ARCH, layers=LAYERS, params=host, zero3=True, tp=True,
                  heads=HEADS[heads])
    batch = _batch(rng, cfg, (n, 2))
    step = dict(common, kind="fl_step", batch=batch, masks=MASKS[:n],
                sizes=SIZES[:n], lr=LR)
    cases, refs = {}, {}
    for run in RUNS[world, heads]:
        if run == "step":
            cases[run] = step
            refs[run] = step_oracle(model, params, batch, MASKS[:n], LR)
        elif run == "sel_upload":
            cases[run] = dict(step, masks=SEL_MASKS[:n], sel_upload=True,
                              sel_idx=SEL_IDX)
            refs[run] = step_oracle(model, params, batch, SEL_MASKS[:n], LR)
        elif run == "tau":
            tau_batch = _batch(rng, cfg, (n, TAU, 2))
            cases[run] = dict(step, kind="fl_step_tau", batch=tau_batch,
                              masks=SEL_MASKS[:n], lr=TAU_LR, tau=TAU,
                              sel_idx=SEL_IDX)
            refs[run] = tau_oracle(model, params, tau_batch, SEL_MASKS[:n])
        elif run == "prefill":
            seqs = _batch(rng, cfg, (4,))
            cases[run] = dict(common, kind="prefill", **seqs)
            refs[run] = np.asarray(_jit(model, "prefill", lambda: (
                model.logits_seq))(params, {k: jnp.asarray(v)
                                            for k, v in seqs.items()}),
                np.float32)
        elif run == "decode":
            prompt = rng.randint(0, cfg.vocab_size,
                                 (4, PROMPT)).astype(np.int32)
            cases[run] = dict(common, kind="decode", prompt=prompt,
                              steps=STEPS)
            refs[run] = decode_oracle(model, params, prompt)
        elif run == "round_trip":
            cases[run] = dict(common, kind="tp_round_trip")
        elif run == "grads":
            seqs = _batch(rng, cfg, (2,))
            cases[run] = dict(common, kind="tp_vlm_grads", batch=seqs)
            refs[run] = grads_oracle(model, params, seqs)
    return cases, refs, dict(cfg=cfg, host=host)


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.RandomState(29)
    out = {}
    for world in MESH:
        cases, refs, info = {}, {}, {}
        for heads in HEADS:
            if (world, heads) not in RUNS:
                continue
            c, r, i = _cases(world, heads, rng)
            cases.update({(heads, k): v for k, v in c.items()})
            refs.update({(heads, k): v for k, v in r.items()})
            info[heads] = i
        names = list(cases)
        ranks = run_world(4, MESH[world], [cases[k] for k in names])
        out[world] = dict(refs=refs, info=info,
                          runs={k: [r[i] for r in ranks]
                                for i, k in enumerate(names)})
    return out


def _held(kind):
    return [(w, h, r) for (w, h), runs in RUNS.items() for r in runs
            if r in kind]


@pytest.mark.parametrize("world,heads,run", _held(("step", "sel_upload")))
def test_tp_vlm_step_matches_single_host(worlds, world, heads, run):
    """The τ = 1 step (``sel_upload``: masks whose union is its rows
    ``SEL_IDX``) against the single-host round on the same masks; the
    embed group (``patch_proj``, the tied ``tok``) is not selectable and
    stays bit-unchanged."""
    w = worlds[world]
    host = w["info"][heads]["host"]
    for res in w["runs"][heads, run]:
        assert max_err(res["full"], w["refs"][heads, run]) < TOL, \
            (world, heads, run, res["coords"])
        assert np.isfinite(res["loss"])
        assert max_err(res["full"]["embed"], host["embed"]) == 0.0
    assert max_err(w["runs"][heads, run][0]["full"], host) > 1e-4


@pytest.mark.parametrize("world,heads,run", _held(("tau",)))
def test_tp_vlm_tau_matches_single_host(worlds, world, heads, run):
    """τ = 2 over the selected rows (``masked_update`` on the rank's model
    slices) against ``Client._local_update`` + aggregate; the rows outside
    the union and every other group stay bit-unchanged."""
    w = worlds[world]
    host = w["info"][heads]["host"]
    for res in w["runs"][heads, run]:
        assert max_err(res["full"], w["refs"][heads, run]) < TAU_TOL
        assert res["launches"]["masked_update"] == 0   # CPU: plain version
    full = w["runs"][heads, run][0]["full"]
    for nm, leaf in full["blocks"].items():
        np.testing.assert_array_equal(leaf[0], host["blocks"][nm][0])
    for key in host:
        if key != "blocks":
            assert max_err(full[key], host[key]) == 0.0, key
    assert max_err(full["blocks"], host["blocks"]) > 1e-4


@pytest.mark.parametrize("world,heads,run", _held(("prefill",)))
def test_tp_vlm_prefill_matches_logits_seq(worlds, world, heads, run):
    """Prefill of 4 rows of 8 patches + 24 tokens, split over ``data``:
    this rank's rows' last-position logits, whole over the vocabulary."""
    w = worlds[world]
    ref = w["refs"][heads, run]
    V = w["info"][heads]["cfg"].vocab_size
    for res in w["runs"][heads, run]:
        rows = res["rows"]
        assert res["logits"].shape == (4 // MESH[world]["data"], V)
        np.testing.assert_allclose(res["logits"], ref[rows], atol=SERVE_TOL,
                                   rtol=0)


@pytest.mark.parametrize("world,heads,run", _held(("decode",)))
def test_tp_vlm_decode_matches_decode_step(worlds, world, heads, run):
    tokens, logits = worlds[world]["refs"][heads, run]
    for res in worlds[world]["runs"][heads, run]:
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows],
                                   atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("world,heads,run", _held(("grads",)))
def test_tp_vlm_gradients_whole_on_every_rank(worlds, world, heads, run):
    """The loss is the single-host one and reads the text positions only
    (moving the prefix's hidden rows leaves it bit-equal); the gradient
    of the whole ``patch_proj`` a rank gathers is equal on every model
    rank and to the single-host one, and the rank keeps its own slice of
    it; ``attn_ln``'s is equal on every rank and to the single host's."""
    w = worlds[world]
    ref = w["refs"][heads, run]
    M = MESH[world]["model"]
    runs = w["runs"][heads, run]
    for res in runs:
        assert res["mode"] == MODES[world, heads]
        assert res["prefix_len"] == w["info"][heads]["cfg"].n_prefix_tokens
        assert abs(res["loss"] - ref["loss"]) < TOL
        assert res["moved_prefix_loss"] == res["loss"]
        g = res["grads"]
        for nm, want in (("patch_proj_whole", "patch_proj"),
                         ("attn_ln", "attn_ln")):
            np.testing.assert_array_equal(g[nm], runs[0]["grads"][nm])
            assert max_err(g[nm], ref["grads"][want]) < TOL, nm
        width = ref["grads"]["patch_proj"].shape[1] // M
        m = res["coords"]["model"]
        np.testing.assert_array_equal(
            g["patch_proj"], g["patch_proj_whole"][:, m * width:
                                                   (m + 1) * width])
    assert np.abs(ref["grads"]["patch_proj"]).max() > 1e-4


def test_tp_vlm_storage_round_trip_is_exact(worlds):
    """Shards → full is the full tree bit for bit; ``patch_proj`` is
    stored column-split by its spec (the rank's d/M columns, its model
    slice over ``data`` gathered back), the tied ``tok`` by vocabulary
    rows; attention runs ``"kv_shared"``, the one kv head's ``wk`` a
    contiguous half on each model coordinate."""
    w = worlds["m2"]
    host = w["info"]["h4"]["host"]
    M = MESH["m2"]["model"]
    for res in w["runs"]["h4", "round_trip"]:
        a, b = jax.tree.leaves(res["full"]), jax.tree.leaves(host)
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert res["mode"] == "kv_shared"
        m = res["coords"]["model"]
        sl = res["model_slice"]
        proj, tok = host["embed"]["patch_proj"], host["embed"]["tok"]
        wp, wt = proj.shape[1] // M, tok.shape[0] // M
        np.testing.assert_array_equal(sl["embed"]["patch_proj"],
                                      proj[:, m * wp:(m + 1) * wp])
        np.testing.assert_array_equal(sl["embed"]["tok"],
                                      tok[m * wt:(m + 1) * wt])
        wk = host["blocks"]["attn_wk"]
        half = wk.shape[-1] // M
        np.testing.assert_array_equal(sl["blocks"]["attn_wk"],
                                      wk[..., m * half:(m + 1) * half])


def test_tp_vlm_layouts_of_paligemma_3b():
    """PaliGemma-3B (8 query heads, 1 kv head of 256, vocabulary 257 216,
    GeGLU ff 16 384): ``"kv_shared"`` at 2, 4 and 8 (H/M query heads of
    the one kv head), ``"replicated"`` at 16; the vocabulary and the MLP
    split at every size."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.sharding import rules
    cfg = tget(ARCH)
    for M, mode in ((2, "kv_shared"), (4, "kv_shared"), (8, "kv_shared"),
                    (16, "replicated")):
        layout = rules.TPLayout(cfg, M)
        assert layout.mode == mode and layout.vocab_split, M
        want = (8 // M, 1) if mode == "kv_shared" else (8, 1)
        assert (layout.q_heads(M - 1)[1], layout.kv_heads(M - 1)[1]) == want
    assert cfg.vocab_size % 16 == 0 and cfg.d_ff % 16 == 0
