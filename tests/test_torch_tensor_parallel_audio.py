"""Tensor parallelism over ``model`` for the audio family
(``RuntimeConfig(tp_constraints=True)``: whisper's encoder and decoder
rows split by heads as dense blocks, its cross-attention by heads over
cross k/v built from an encoder output whole on every rank, its stub
``frame_proj`` all-gathered whole, the tied vocabulary split where it
divides) against the reference's single-host round and single-device
serving, on gloo worlds of 4 processes (tests/_torch_dist.py).

As in tests/test_torch_tensor_parallel_vlm.py the oracle is the reference
computed with JAX on one device.  Reduced whisper: 2 encoder rows over 16
stub frames and 4 decoder rows over 32 tokens (cross-attention by query
chunks of 16), d_model 64, 4 query heads and 2 kv heads of 16, a plain
GELU MLP of 256, a tied vocabulary of 512.  Two worlds:

* (data 2, model 2), ``"heads"`` with the vocabulary split: the τ = 1
  step over a mask with rows in both segments, ``sel_upload`` and τ = 2
  over ``blocks`` rows, prefill, 8 greedy decode steps over a cross cache
  filled from the encoder, each first with tensor parallelism off (the
  audio family's first mesh runs), then on; the storage round trip and
  every gradient;
* (data 1, model 4): ``"kv_shared"`` (one kv head between two ranks, in
  the cross cache too): the τ = 1 step, τ = 2, prefill, decode and every
  gradient; with 4 kv heads and a vocabulary of 514, which 4 does not
  divide, ``"heads"`` with the vocabulary whole, as at full width: the
  τ = 1 step, prefill and decode.

Tolerances: 3e-5 for τ = 1, ``sel_upload`` and the gradients, 5e-5 for
τ = 2, 1e-5 for the logits; decode tokens exactly.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from repro.configs.base import RuntimeConfig, get_arch, reduced
from repro.core import aggregation as agg
from repro.core.client import Client
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models.model import Model, apply_layer_mask

TOL, TAU_TOL, SERVE_TOL = 3e-5, 5e-5, 1e-5
ARCH, LAYERS, TEXT = "whisper_medium", 4, 32
# "k2": reduced whisper (4 heads, 2 kv heads, vocabulary 512); "k4": 4 kv
# heads and a vocabulary of 514, which 4 ranks do not divide
MODELS = {"k2": dict(heads=None, vocab=None),
          "k4": dict(heads=(4, 4), vocab=514)}
MESH = {"m2": dict(data=2, model=2), "m4": dict(data=1, model=4)}
# 2 encoder rows, then 4 decoder rows: mask columns 0–1 and 2–5
MASKS = np.array([[1, 0, 0, 1, 0, 1], [0, 1, 1, 0, 1, 1]], np.float32)
SIZES = np.array([10., 20.], np.float32)
SEL_IDX = (1, 3)                                 # blocks rows: columns 3, 5
SEL_MASKS = np.array([[0, 0, 0, 1, 0, 1], [0, 0, 0, 0, 0, 1]], np.float32)
LR, TAU_LR, TAU = 0.1, 0.05, 2
PROMPT, STEPS = 4, 8
# a run's name ending in "_plain": tensor parallelism off
RUNS = {("m2", "k2"): ("step_plain", "sel_upload_plain", "tau_plain",
                       "prefill_plain", "decode_plain", "step", "sel_upload",
                       "tau", "prefill", "decode", "round_trip", "grads"),
        ("m4", "k2"): ("step", "tau", "prefill", "decode", "grads"),
        ("m4", "k4"): ("step", "prefill", "decode")}
MODES = {("m2", "k2"): "heads", ("m4", "k2"): "kv_shared",
         ("m4", "k4"): "heads"}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


@functools.cache
def _model(name):
    cfg = reduced(get_arch(ARCH), n_layers=LAYERS, d_model=64)
    spec = MODELS[name]
    if spec["heads"]:
        cfg = dataclasses.replace(cfg, n_heads=spec["heads"][0],
                                  n_kv_heads=spec["heads"][1])
    if spec["vocab"]:
        cfg = dataclasses.replace(cfg, vocab_size=spec["vocab"])
    return Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))


_JITS = {}


def _jit(model, name, make):
    key = (id(model), name)
    if key not in _JITS:
        _JITS[key] = jax.jit(make())
    return _JITS[key]


def _one(batch, i):
    return {k: jnp.asarray(v[i]) for k, v in batch.items()}


def _value_and_grad(model):
    """The reference's loss and its gradient, one compile a model."""
    return _jit(model, "vgrad", lambda: jax.value_and_grad(model.loss))


def step_oracle(model, params, batch, masks, lr):
    cfg, n = model.cfg, masks.shape[0]
    grad = _value_and_grad(model)
    deltas = [apply_layer_mask(grad(params, _one(batch, i))[1], masks[i],
                               cfg) for i in range(n)]
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


def fill_cross(model, params, frames):
    """The reference's cross cache from its encoder, row by row through
    ``make_cross_kv``, as its tests/test_decode_consistency.py fills it
    (neither package has an encoder-prefill entry point)."""
    return _jit(model, "fill", lambda: functools.partial(
        _cross_kv, model.cfg))(params, frames)


def _cross_kv(cfg, params, frames):
    e = frames.astype(params["embed"]["frame_proj"].dtype) @ \
        params["embed"]["frame_proj"]
    e = e + jblocks.sinusoid_positions(jnp.arange(cfg.enc_seq),
                                       cfg.d_model).astype(e.dtype)
    for li in range(cfg.n_enc_layers):
        p = jax.tree.map(lambda a: a[li], params["enc_blocks"])
        e, _ = jmodel._dense_block_fwd(
            p, e, cfg, positions=jnp.arange(cfg.enc_seq, dtype=jnp.int32),
            causal=False, window=0, prefix_len=0, seq_chunk=1024)
    enc = jblocks.rms_norm(e, params["enc_norm"], cfg.norm_eps)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[li], params["blocks"])
        k, v = jblocks.make_cross_kv(jmodel._take(p, "xattn_"), enc, cfg)
        ks.append(k)
        vs.append(v)
    return {"k": jnp.stack(ks), "v": jnp.stack(vs)}


def decode_oracle(model, params, prompt, frames):
    """Greedy decode from ``prompt`` over the cross cache of ``frames``:
    the tokens, the last logits and the filled cross cache (full)."""
    cache = model.init_cache(prompt.shape[0], PROMPT + STEPS)
    cache["cross_kv"] = fill_cross(model, params, jnp.asarray(frames))
    cross = _host(cache["cross_kv"])
    step = _jit(model, "decode", lambda: model.decode_step)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for t in range(PROMPT + STEPS - 1):
        logits, cache = step(params, tok, jnp.int32(t), cache)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        tok = jnp.asarray(prompt[:, t + 1]) if t + 1 < PROMPT else nxt
        if t + 1 >= PROMPT:
            out.append(np.asarray(nxt))
    return np.stack(out, 1), np.asarray(logits, np.float32), cross


def grads_oracle(model, params, batch):
    """The loss and the gradient of every leaf (full)."""
    value, g = _value_and_grad(model)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), _host(g)


def _batch(rng, cfg, lead):
    return {"tokens": rng.randint(0, cfg.vocab_size,
                                  lead + (TEXT,)).astype(np.int32),
            "frames": rng.randn(*lead, cfg.enc_seq,
                                cfg.d_model).astype(np.float32)}


def _case(kind, model, params, common, n, rng):
    """One run's case (tensor parallelism on) and its oracle."""
    cfg = model.cfg
    batch = _batch(rng, cfg, (n, 2))
    step = dict(common, kind="fl_step", batch=batch, masks=MASKS[:n],
                sizes=SIZES[:n], lr=LR)
    if kind == "step":
        return step, step_oracle(model, params, batch, MASKS[:n], LR)
    if kind == "sel_upload":
        return (dict(step, masks=SEL_MASKS[:n], sel_upload=True,
                     sel_idx=SEL_IDX),
                step_oracle(model, params, batch, SEL_MASKS[:n], LR))
    if kind == "tau":
        tau_batch = _batch(rng, cfg, (n, TAU, 2))
        return (dict(step, kind="fl_step_tau", batch=tau_batch,
                     masks=SEL_MASKS[:n], lr=TAU_LR, tau=TAU,
                     sel_idx=SEL_IDX),
                tau_oracle(model, params, tau_batch, SEL_MASKS[:n]))
    if kind == "prefill":
        seqs = _batch(rng, cfg, (4,))
        return dict(common, kind="prefill", **seqs), np.asarray(
            _jit(model, "prefill", lambda: model.logits_seq)(
                params, {k: jnp.asarray(v) for k, v in seqs.items()}),
            np.float32)
    if kind == "decode":
        prompt = rng.randint(0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
        frames = rng.randn(4, cfg.enc_seq, cfg.d_model).astype(np.float32)
        tokens, logits, cross = decode_oracle(model, params, prompt, frames)
        return (dict(common, kind="decode", prompt=prompt, steps=STEPS,
                     cross_kv=cross), (tokens, logits))
    if kind == "round_trip":
        return dict(common, kind="tp_round_trip"), None
    seqs = _batch(rng, cfg, (2,))                           # "grads"
    loss, want = grads_oracle(model, params, seqs)
    return dict(common, kind="tp_audio_grads", batch=seqs, want=want), loss


@functools.cache
def _init(name):
    """Seeded params of the ``name`` model, drawn by the port's
    ``Model.init`` (the reference's paths, shapes and types; far quicker
    than the reference's eager init), as float32 numpy leaves."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.model import Model as TModel
    cfg = treduced(tget(ARCH), n_layers=LAYERS, d_model=64)
    spec = MODELS[name]
    if spec["heads"]:
        cfg = dataclasses.replace(cfg, n_heads=spec["heads"][0],
                                  n_kv_heads=spec["heads"][1])
    if spec["vocab"]:
        cfg = dataclasses.replace(cfg, vocab_size=spec["vocab"])
    return _host(params_to_numpy(TModel(cfg, device="cpu").init(0)))


def _cases(world, name, rng):
    model = _model(name)
    cfg = model.cfg
    host = _init(name)
    params = jax.tree.map(jnp.asarray, host)
    n = MESH[world]["data"]
    common = dict(arch=ARCH, layers=LAYERS, params=host, zero3=True,
                  **MODELS[name])
    made, cases, refs = {}, {}, {}
    for run in RUNS[world, name]:
        kind = run.split("_plain")[0]
        if kind not in made:        # one oracle for the plain and the split
            made[kind] = _case(kind, model, params, common, n, rng)
        case, refs[run] = made[kind]
        cases[run] = dict(case, tp=not run.endswith("_plain"))
    return cases, refs, dict(cfg=cfg, host=host)


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.RandomState(30)
    out = {}
    for world in MESH:
        cases, refs, info = {}, {}, {}
        for name in MODELS:
            if (world, name) not in RUNS:
                continue
            c, r, i = _cases(world, name, rng)
            cases.update({(name, k): v for k, v in c.items()})
            refs.update({(name, k): v for k, v in r.items()})
            info[name] = i
        keys = list(cases)
        ranks = run_world(4, MESH[world], [cases[k] for k in keys])
        out[world] = dict(refs=refs, info=info,
                          runs={k: [r[i] for r in ranks]
                                for i, k in enumerate(keys)})
    return out


def _held(*kinds):
    return [(w, m, r) for (w, m), runs in RUNS.items() for r in runs
            if r.split("_plain")[0] in kinds]


@pytest.mark.parametrize("world,name,run", _held("step", "sel_upload"))
def test_tp_audio_step_matches_single_host(worlds, world, name, run):
    """The τ = 1 step (its mask rows in both the encoder and the decoder)
    and ``sel_upload`` (masks whose union is the ``blocks`` rows
    SEL_IDX) against the single-host round on the same masks, with
    tensor parallelism off (``_plain``) and on; the embed group
    (``frame_proj``, the tied ``tok``) and ``enc_norm`` are not
    selectable and stay bit-unchanged."""
    w = worlds[world]
    host = w["info"][name]["host"]
    for res in w["runs"][name, run]:
        assert max_err(res["full"], w["refs"][name, run]) < TOL, \
            (world, name, run, res["coords"])
        assert np.isfinite(res["loss"])
        for key in ("embed", "enc_norm", "final_norm"):
            assert max_err(res["full"][key], host[key]) == 0.0, key
    full = w["runs"][name, run][0]["full"]
    assert max_err(full["blocks"], host["blocks"]) > 1e-4
    moved_enc = max_err(full["enc_blocks"], host["enc_blocks"])
    assert (moved_enc > 1e-4) == (run.split("_plain")[0] == "step")


@pytest.mark.parametrize("world,name,run", _held("tau"))
def test_tp_audio_tau_matches_single_host(worlds, world, name, run):
    """τ = 2 over the selected ``blocks`` rows (``masked_update`` on the
    rank's model slices; the ``enc_blocks`` rows viewed through their own
    specs at each local step) against ``Client._local_update`` +
    aggregate; the rows outside the union and every other group stay
    bit-unchanged."""
    w = worlds[world]
    host = w["info"][name]["host"]
    for res in w["runs"][name, run]:
        assert max_err(res["full"], w["refs"][name, run]) < TAU_TOL
        assert res["launches"]["masked_update"] == 0   # CPU: plain version
    full = w["runs"][name, run][0]["full"]
    for nm, leaf in full["blocks"].items():
        np.testing.assert_array_equal(leaf[0], host["blocks"][nm][0])
    for key in host:
        if key != "blocks":
            assert max_err(full[key], host[key]) == 0.0, key
    assert max_err(full["blocks"], host["blocks"]) > 1e-4


@pytest.mark.parametrize("world,name,run", _held("prefill"))
def test_tp_audio_prefill_matches_logits_seq(worlds, world, name, run):
    """Prefill of 4 rows of 16 frames + 32 tokens, split over ``data``:
    this rank's rows' last-position logits, whole over the vocabulary."""
    w = worlds[world]
    ref = w["refs"][name, run]
    V = w["info"][name]["cfg"].vocab_size
    for res in w["runs"][name, run]:
        rows = res["rows"]
        assert res["logits"].shape == (4 // MESH[world]["data"], V)
        np.testing.assert_allclose(res["logits"], ref[rows], atol=SERVE_TOL,
                                   rtol=0)


@pytest.mark.parametrize("world,name,run", _held("decode"))
def test_tp_audio_decode_matches_decode_step(worlds, world, name, run):
    """8 greedy steps after a prompt of 4 over the encoder-filled cross
    cache: the reference's tokens exactly, its last logits within 1e-5;
    each rank's cross cache holds its batch rows and, under tensor
    parallelism, its kv heads only (whole over the 16 frames)."""
    tokens, logits = worlds[world]["refs"][name, run]
    cfg = worlds[world]["info"][name]["cfg"]
    M = MESH[world]["model"] if not run.endswith("_plain") else 1
    kv = cfg.n_kv_heads // M if MODES[world, name] == "heads" else 1
    for res in worlds[world]["runs"][name, run]:
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows],
                                   atol=SERVE_TOL, rtol=0)
        want = (cfg.n_layers, len(rows), cfg.enc_seq, kv,
                cfg.resolved_head_dim)
        assert res["cross_kv_shapes"] == {"k": want, "v": want}


# the leaves whose gradient every model rank computes whole
REPLICATED = ("embed/frame_proj_whole", "enc_norm", "final_norm",
              "enc_blocks/attn_ln", "enc_blocks/mlp_ln", "blocks/attn_ln",
              "blocks/xattn_ln", "blocks/mlp_ln")


def _grad(res, path):
    if path == "embed/frame_proj_whole":
        return res["frame_proj_whole"]
    return res["grads"][path]


@pytest.mark.parametrize("world,name,run", _held("grads"))
def test_tp_audio_gradients_whole_on_every_rank(worlds, world, name, run):
    """The loss is the single-host one; the gradient of every stored leaf
    is the rank's storage of the single-host gradient (its slice of a
    split leaf: the encoder's and decoder's heads, cross-attention's
    too, the MLP's columns, the vocabulary's rows), and those of
    ``frame_proj`` (whole, as the rank gathers it), ``enc_norm``, the
    norms of both segments (``xattn_ln`` among them) and ``final_norm``
    are equal on every model rank: the one f on the encoder's output
    makes the encoder's gradients whole."""
    w = worlds[world]
    loss = w["refs"][name, run]
    runs = w["runs"][name, run]
    for res in runs:
        assert res["mode"] == MODES[world, name]
        assert res["vocab_split"] == (name == "k2")
        assert abs(res["loss"] - loss) < TOL
        assert set(res["want"]) == set(res["grads"])
        for path, want in res["want"].items():
            assert max_err(res["grads"][path], want) < TOL, path
        full = w["info"][name]["host"]["embed"]["frame_proj"]
        assert res["frame_proj_whole"].shape == full.shape
        assert max_err(res["frame_proj_whole"],
                       res["want_whole"]) < TOL
        for path in REPLICATED:
            np.testing.assert_array_equal(_grad(res, path),
                                          _grad(runs[0], path), path)
        m, M = res["coords"]["model"], MESH[world]["model"]
        width = full.shape[1] // M
        np.testing.assert_array_equal(
            res["grads"]["embed/frame_proj"],
            res["frame_proj_whole"][:, m * width:(m + 1) * width])
    assert np.abs(runs[0]["want"]["enc_norm"]).max() > 1e-4
    assert np.abs(runs[0]["want"]["embed/frame_proj"]).max() > 1e-4


def test_tp_audio_storage_round_trip_is_exact(worlds):
    """Shards → full is the full tree bit for bit; a rank's model slice
    (its shards gathered over ``data``) of each ``xattn_`` leaf is
    ``TPLayout.compute_slice``'s under ``"heads"`` (``wq`` / ``wk`` /
    ``wv`` the rank's heads on the last dim, ``wo`` its rows, ``ln``
    whole), as is each ``attn_`` leaf of both segments and the plain
    GELU MLP's contiguous columns; ``frame_proj`` is stored column-split,
    the tied ``tok`` by vocabulary rows."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.sharding import rules
    w = worlds["m2"]
    host = w["info"]["k2"]["host"]
    M = MESH["m2"]["model"]
    layout = rules.TPLayout(treduced(tget(ARCH), n_layers=LAYERS,
                                     d_model=64), M)
    assert layout.mode == "heads" and not layout.gated
    for res in w["runs"]["k2", "round_trip"]:
        a, b = jax.tree.leaves(res["full"]), jax.tree.leaves(host)
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert res["mode"] == "heads"
        m = res["coords"]["model"]
        sl = res["model_slice"]
        for seg in ("enc_blocks", "blocks"):
            for nm, leaf in host[seg].items():
                for i, row in enumerate(leaf):
                    want = layout.compute_slice(nm, torch.tensor(row), m)
                    np.testing.assert_array_equal(
                        sl[seg][nm][i], want.numpy(), err_msg=f"{seg}/{nm}")
        proj, tok = host["embed"]["frame_proj"], host["embed"]["tok"]
        wp, wt = proj.shape[1] // M, tok.shape[0] // M
        np.testing.assert_array_equal(sl["embed"]["frame_proj"],
                                      proj[:, m * wp:(m + 1) * wp])
        np.testing.assert_array_equal(sl["embed"]["tok"],
                                      tok[m * wt:(m + 1) * wt])


def test_tp_audio_compute_slices_of_the_cross_attention():
    """``TPLayout.compute_slice`` of each ``xattn_`` leaf, as of its
    ``attn_`` twin: under ``"kv_shared"`` (reduced whisper at 4: 4 query
    heads over 2 kv heads) the rank's query head of ``wq`` and rows of
    ``wo``, and the whole of its kv head of ``wk`` / ``wv``; ``xattn_ln``
    whole."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.sharding import rules
    cfg = treduced(tget(ARCH), n_layers=LAYERS, d_model=64)
    hd = cfg.resolved_head_dim
    layout = rules.TPLayout(cfg, 4)
    assert layout.mode == "kv_shared"
    wq = torch.arange(64 * 4 * hd).reshape(64, 4 * hd)
    wk = torch.arange(64 * 2 * hd).reshape(64, 2 * hd)
    wo = torch.arange(4 * hd * 64).reshape(4 * hd, 64)
    ln = torch.arange(64)
    for m, kv in ((0, 0), (1, 0), (2, 1), (3, 1)):
        for pre in ("attn_", "xattn_"):
            cs = layout.compute_slice
            assert torch.equal(cs(pre + "wq", wq, m),
                               wq[:, m * hd:(m + 1) * hd])
            assert torch.equal(cs(pre + "wk", wk, m),
                               wk[:, kv * hd:(kv + 1) * hd])
            assert torch.equal(cs(pre + "wv", wk, m),
                               wk[:, kv * hd:(kv + 1) * hd])
            assert torch.equal(cs(pre + "wo", wo, m),
                               wo[m * hd:(m + 1) * hd])
            assert torch.equal(cs(pre + "ln", ln, m), ln)


def _fake_mesh(M, m):
    """A (data 1, model M) mesh at model coordinate m, for the host-side
    rules."""
    return SimpleNamespace(
        shape={"data": 1, "model": M}, axis_names=("data", "model"),
        size=lambda axes: 1, index=lambda axes: 0,
        coord=lambda axis: m if axis == "model" else 0)


@pytest.mark.parametrize("heads,M,want", [
    ((4, 2), 2, "heads"), ((4, 2), 4, "kv_shared"), ((4, 4), 4, "heads")])
def test_tp_audio_cross_cache_narrowed_to_the_rank_kv_heads(heads, M, want):
    """``tp_shard_cache`` narrows whisper's cross cache (L, B, enc_seq,
    K, hd), laid out by the reference's ``cache_specs``, to the kv heads
    the rank computes, whole over the frames, as it narrows the
    self-attention rows: under ``"heads"`` its K/M heads, under
    ``"kv_shared"`` its one kv head, shared with the rank beside it."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.model import Model as TModel
    from repro_torch.sharding import rules
    cfg = dataclasses.replace(treduced(tget(ARCH), n_layers=2, d_model=64),
                              n_heads=heads[0], n_kv_heads=heads[1])
    layout = rules.TPLayout(cfg, M)
    assert layout.mode == want
    cache = TModel(cfg, device="cpu").init_cache(2, 8)
    for name in ("k", "v"):
        leaf = cache["cross_kv"][name]
        leaf.copy_(torch.arange(leaf.numel(), dtype=leaf.dtype)
                   .reshape(leaf.shape))
    c_specs = rules.cache_specs(cfg, cache, _fake_mesh(M, 0), 2)
    for m in range(M):
        got = rules.tp_shard_cache(cache, c_specs, _fake_mesh(M, m), layout)
        first, n = layout.kv_heads(m)
        assert n == (heads[1] // M if want == "heads" else 1)
        for name in ("k", "v"):
            assert torch.equal(got["cross_kv"][name],
                               cache["cross_kv"][name][:, :, :, first:
                                                       first + n])
            assert got["cross_kv"][name].shape[2] == cfg.enc_seq


def test_tp_audio_layouts_of_whisper_medium():
    """whisper-medium (16 query and 16 kv heads of 64, plain GELU MLP of
    4096, a tied vocabulary of 51 865 = 5 × 10 373): ``"heads"`` at 2, 4,
    8 and 16 (one head a rank at 16), the MLP split contiguously (not
    gated), the vocabulary whole at every size."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.sharding import rules
    cfg = tget(ARCH)
    for M in (2, 4, 8, 16):
        layout = rules.TPLayout(cfg, M)
        assert layout.mode == "heads" and not layout.gated
        assert not layout.vocab_split
        assert (layout.q_heads(M - 1), layout.kv_heads(M - 1)) == (
            ((M - 1) * 16 // M, 16 // M),) * 2
    assert cfg.vocab_size % 2 and cfg.d_ff % 16 == 0
