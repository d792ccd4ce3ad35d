"""Tensor parallelism over ``model`` for the dense family
(``RuntimeConfig(tp_constraints=True)``: ``sharding/rules.py``'s
``TPLayout``, ``sharding/tensor_parallel.py``, the models' parallel form)
against the reference's single-host round and single-device serving, on
gloo worlds of 4 processes (tests/_torch_dist.py).

The reference's ``tp_constraints=True`` only pins GSPMD layouts: its
values are the single-host round's, which is the oracle here (as in
tests/test_torch_fl_step.py), computed with JAX on one device.  One world
per layout:

* (data 2, model 2), reduced TinyLlama (H 4, K 2: heads split): the
  τ = 1 step with ZeRO-3 on and off and with ``sel_upload``, τ = 3, mesh
  prefill and 8 greedy decode steps, the storage round trip;
* (data 1, model 4), the same model (K 2 divides 4: one shared kv head per
  rank): the τ = 1 step, prefill and decode, the round trip;
* (data 2, model 2), reduced SmolLM with H 3, K 1 (3 heads do not split
  over 2: attention replicated, its gradient the rank's own slice, never
  the sum over ``model``): the τ = 1 step and decode, the round trip.
"""
import dataclasses
from types import SimpleNamespace

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
MASKS = np.array([[1, 0, 0, 1], [0, 1, 0, 1]], np.float32)
TAU_MASKS = np.array([[0, 1, 0, 1], [0, 0, 0, 1]], np.float32)
SIZES = np.array([10., 20.], np.float32)
LR, TAU_LR, TAU, SEL = 0.1, 0.05, 3, (1, 3)
PROMPT, STEPS = 4, 8
HEADS = {"heads": None, "kv_shared": None, "replicated": (3, 1)}
ARCH = {"heads": "tinyllama_1_1b", "kv_shared": "tinyllama_1_1b",
        "replicated": "smollm_360m"}
MESH = {"heads": dict(data=2, model=2), "kv_shared": dict(data=1, model=4),
        "replicated": dict(data=2, model=2)}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def reference(mode: str):
    cfg = reduced(get_arch(ARCH[mode]), n_layers=4, d_model=64)
    if HEADS[mode]:
        cfg = dataclasses.replace(cfg, n_heads=HEADS[mode][0],
                                  n_kv_heads=HEADS[mode][1])
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16))
    return cfg, model, model.init(jax.random.PRNGKey(0))


def step_oracle(cfg, model, params, tokens, masks, lr):
    n = masks.shape[0]
    grad = jax.jit(jax.grad(model.loss))
    deltas = [apply_layer_mask(grad(params, {"tokens": tokens[i]}),
                               masks[i], cfg) for i in range(n)]
    update = agg.aggregate(deltas, jnp.asarray(masks),
                           jnp.asarray(SIZES[:n]), cfg)
    return _host(agg.apply_update(params, update, lr))


def decode_oracle(model, params, prompt):
    cache = model.init_cache(prompt.shape[0], PROMPT + STEPS)
    step = jax.jit(model.decode_step)
    tok, out = jnp.asarray(prompt[:, 0]), []
    for t in range(PROMPT + STEPS - 1):
        logits, cache = step(params, tok, jnp.int32(t), cache)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        tok = jnp.asarray(prompt[:, t + 1]) if t + 1 < PROMPT else nxt
        if t + 1 >= PROMPT:
            out.append(np.asarray(nxt))
    return np.stack(out, 1), np.asarray(logits, np.float32)


def _cases(mode, cfg, host, rng):
    """The world's cases by name, and what each is held against."""
    n = MESH[mode]["data"]
    tokens = rng.randint(0, cfg.vocab_size, (n, 2, 16)).astype(np.int32)
    base = dict(kind="fl_step", arch=ARCH[mode], heads=HEADS[mode],
                params=host, zero3=True, tp=True,
                batch={"tokens": tokens}, masks=MASKS[:n],
                sizes=SIZES[:n], lr=LR)
    prompt = rng.randint(0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    seqs = rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    serve = dict(arch=ARCH[mode], heads=HEADS[mode], params=host,
                 zero3=True, tp=True)
    cases = {"step": base,
             "decode": dict(serve, kind="decode", prompt=prompt,
                            steps=STEPS),
             "round_trip": dict(serve, kind="tp_round_trip")}
    if mode != "replicated":
        cases["prefill"] = dict(serve, kind="prefill", tokens=seqs)
    if mode == "heads":
        tau_tokens = rng.randint(0, cfg.vocab_size,
                                 (n, TAU, 2, 16)).astype(np.int32)
        cases.update(
            step_no_zero3=dict(base, zero3=False),
            sel_upload=dict(base, sel_upload=True, sel_idx=(0, 1, 3)),
            tau=dict(base, kind="fl_step_tau", batch={"tokens": tau_tokens},
                     masks=TAU_MASKS, lr=TAU_LR, tau=TAU, sel_idx=SEL),
            round_trip_no_zero3=dict(serve, kind="tp_round_trip",
                                     zero3=False))
    return cases, dict(tokens=tokens, prompt=prompt, seqs=seqs,
                       tau_tokens=cases.get("tau", {}).get("batch"))


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.RandomState(11)
    out = {}
    for mode in HEADS:
        cfg, model, params = reference(mode)
        host = _host(params)
        cases, data = _cases(mode, cfg, host, rng)
        refs = {"step": step_oracle(cfg, model, params, data["tokens"],
                                    MASKS[:MESH[mode]["data"]], LR),
                "decode": decode_oracle(model, params, data["prompt"])}
        if "prefill" in cases:
            refs["prefill"] = np.asarray(
                model.logits_seq(params, {"tokens": data["seqs"]}),
                np.float32)
        if "tau" in cases:
            client = Client(model)
            toks = data["tau_tokens"]["tokens"]
            deltas = [client._local_update(params, {"tokens": toks[i]},
                                           TAU_MASKS[i], TAU_LR)[0]
                      for i in range(2)]
            refs["tau"] = _host(agg.apply_update(params, agg.aggregate(
                deltas, jnp.asarray(TAU_MASKS), jnp.asarray(SIZES), cfg),
                TAU_LR))
        names = list(cases)
        ranks = run_world(4, MESH[mode], [cases[k] for k in names])
        out[mode] = dict(cfg=cfg, host=host, refs=refs,
                         runs={k: [r[i] for r in ranks]
                               for i, k in enumerate(names)})
    return out


STEPS_HELD = [("heads", "step"), ("heads", "step_no_zero3"),
              ("heads", "sel_upload"), ("kv_shared", "step"),
              ("replicated", "step")]


@pytest.mark.parametrize("mode,run", STEPS_HELD)
def test_tp_step_matches_single_host(worlds, mode, run):
    w = worlds[mode]
    for res in w["runs"][run]:
        assert max_err(res["full"], w["refs"]["step"]) < TOL, \
            (mode, run, res["coords"])
        assert np.isfinite(res["loss"])
    # the step moved the selected layers: the check is not vacuous
    assert max_err(w["runs"][run][0]["full"], w["host"]) > 1e-4


def test_tp_tau_matches_single_host(worlds):
    w = worlds["heads"]
    for res in w["runs"]["tau"]:
        assert max_err(res["full"], w["refs"]["tau"]) < TAU_TOL
        assert res["union_frac"] == 0.5
    full = w["runs"]["tau"][0]["full"]["blocks"]
    for nm, leaf in full.items():          # rows outside the union stay
        np.testing.assert_array_equal(leaf[[0, 2]],
                                      w["host"]["blocks"][nm][[0, 2]])


def test_tp_steps_issue_model_axis_collectives(worlds):
    """Per layer the parallel form adds four all-reduces over ``model``
    (f's backward and g's forward, around attention and the MLP); the
    embedding, the cross-entropy's max and its (Σ exp, gold) sum, and the
    head's f add four more.  Under ``sel_upload`` and τ > 1 the Eq.(5)
    upload stays one reduce-scatter per sharded block leaf."""
    w = worlds["heads"]
    n_leaves = len(w["host"]["blocks"])
    sharded = 6
    step = w["runs"]["step"][0]["collectives"]
    assert step["all_reduce"] == (1 + (n_leaves - sharded) + 2
                                  + 4 * 4 + 4)
    assert step["reduce_scatter"] == 4 * sharded
    assert w["runs"]["sel_upload"][0]["collectives"]["reduce_scatter"] \
        == sharded
    tau = w["runs"]["tau"][0]["collectives"]
    assert tau["reduce_scatter"] == sharded
    # a local step: g after each of the 4 layers' sub-blocks, the
    # embedding and the cross-entropy (11) forward; f backward from the
    # lowest selected row up (rows 1-3) and at the head (7)
    assert tau["all_reduce"] == 1 + (n_leaves - sharded) + 2 + TAU * 18


@pytest.mark.parametrize("mode", list(HEADS))
def test_tp_decode_matches_decode_step(worlds, mode):
    tokens, logits = worlds[mode]["refs"]["decode"]
    for res in worlds[mode]["runs"]["decode"]:
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows],
                                   atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["heads", "kv_shared"])
def test_tp_prefill_matches_logits_seq(worlds, mode):
    ref = worlds[mode]["refs"]["prefill"]
    for res in worlds[mode]["runs"]["prefill"]:
        rows = res["rows"]
        d = res["coords"]["data"]
        assert rows.tolist() == ([2 * d, 2 * d + 1] if MESH[mode]["data"] == 2
                                 else [0, 1, 2, 3])
        assert res["logits"].shape == (len(rows), worlds[mode]["cfg"]
                                       .vocab_size)
        np.testing.assert_allclose(res["logits"], ref[rows],
                                   atol=SERVE_TOL, rtol=0)


def _by_data(runs):
    out = {}
    for res in runs:
        out.setdefault(res["coords"]["data"], {})[res["coords"]["model"]] \
            = res
    return out


@pytest.mark.parametrize("mode", list(HEADS))
def test_tp_norm_gradients_bit_equal_across_model_ranks(worlds, mode):
    """The norms are whole on every model rank and f all-reduces the
    gradient of their output, so every model rank computes the same
    gradient: the updated norms are bit-equal, and they moved."""
    w = worlds[mode]
    for ranks in _by_data(w["runs"]["step"]).values():
        first = ranks[0]["local"]["blocks"]
        for res in ranks.values():
            for nm in ("attn_ln", "mlp_ln"):
                np.testing.assert_array_equal(res["local"]["blocks"][nm],
                                              first[nm])
        assert max_err(first["mlp_ln"], w["host"]["blocks"]["mlp_ln"]) > 0


@pytest.mark.parametrize("mode", list(HEADS))
def test_tp_model_coordinates_hold_different_shards(worlds, mode):
    """Unlike tensor parallelism off, the model coordinates of a data
    coordinate store different slices, whose gather is the full leaf."""
    w = worlds[mode]
    for ranks in _by_data(w["runs"]["step"]).values():
        a, b = ranks[0]["local"], ranks[1]["local"]
        for nm in ("attn_wq", "attn_wo", "mlp_wi", "mlp_wo"):
            assert a["blocks"][nm].shape == b["blocks"][nm].shape
            assert not np.array_equal(a["blocks"][nm], b["blocks"][nm])
        assert not np.array_equal(a["embed"]["tok"], b["embed"]["tok"])


ROUND_TRIPS = [("heads", "round_trip"), ("heads", "round_trip_no_zero3"),
               ("kv_shared", "round_trip"), ("replicated", "round_trip")]


@pytest.mark.parametrize("mode,run", ROUND_TRIPS)
def test_tp_storage_round_trip_is_exact(worlds, mode, run):
    """Shards → full is the full tree bit for bit; the model slice of the
    gated ``mlp_wi`` is gate[:, m] | up[:, m], of ``attn_wq`` the heads of
    coordinate m, of ``tok`` its vocabulary rows."""
    w = worlds[mode]
    cfg, host = w["cfg"], w["host"]
    M = MESH[mode]["model"]
    for res in w["runs"][run]:
        assert res["mode"] == mode
        a, b = jax.tree.leaves(res["full"]), jax.tree.leaves(host)
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        m = res["coords"]["model"]
        sl = res["model_slice"]
        wi = host["blocks"]["mlp_wi"]
        ff = wi.shape[-1] // 2
        cols = np.r_[m * ff // M:(m + 1) * ff // M]
        np.testing.assert_array_equal(
            sl["blocks"]["mlp_wi"],
            np.concatenate([wi[..., cols], wi[..., ff + cols]], -1))
        np.testing.assert_array_equal(
            sl["blocks"]["mlp_wo"], host["blocks"]["mlp_wo"][:, cols])
        wq = host["blocks"]["attn_wq"]
        width = wq.shape[-1] // M
        np.testing.assert_array_equal(
            sl["blocks"]["attn_wq"], wq[..., m * width:(m + 1) * width])
        V = cfg.vocab_size // M
        np.testing.assert_array_equal(sl["embed"]["tok"],
                                      host["embed"]["tok"][m * V:(m + 1) * V])


def test_tp_compute_slices():
    """``TPLayout.compute_slice`` (what a model coordinate computes with)
    on each mode's layout: heads split, one shared kv head, or whole."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.sharding import rules
    import torch
    cfg = treduced(tget("tinyllama_1_1b"), n_layers=4, d_model=64)
    hd = cfg.resolved_head_dim
    wk = torch.arange(64 * 2 * hd).reshape(64, 2 * hd)
    heads, shared = rules.TPLayout(cfg, 2), rules.TPLayout(cfg, 4)
    assert (heads.mode, shared.mode) == ("heads", "kv_shared")
    assert torch.equal(heads.compute_slice("attn_wk", wk, 1), wk[:, hd:])
    for m, kv in ((0, 0), (1, 0), (2, 1), (3, 1)):
        assert shared.kv_heads(m) == (kv, 1)
        assert torch.equal(shared.compute_slice("attn_wk", wk, m),
                           wk[:, kv * hd:(kv + 1) * hd])
    rep = rules.TPLayout(dataclasses.replace(cfg, n_heads=3, n_kv_heads=1),
                         2)
    assert rep.mode == "replicated"
    one = torch.arange(64 * rep.cfg.resolved_head_dim).reshape(64, -1)
    assert torch.equal(rep.compute_slice("attn_wk", one, 1), one)


@pytest.mark.parametrize("arch,want", [
    ("tinyllama_1_1b", {1: "heads", 4: "heads", 16: "kv_shared"}),
    ("smollm_360m", {1: "heads", 5: "heads", 16: "replicated"}),
    ("codeqwen1_5_7b", {16: "heads"}), ("gemma_7b", {16: "heads"})])
def test_attention_mode_of_the_dense_family(arch, want):
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.sharding import rules
    for msz, mode in want.items():
        assert rules.attention_mode(tget(arch), msz) == mode


@pytest.mark.parametrize("arch,family", [
    ("clip_vit_b32", "vlm"), ("xlm_roberta_base", "dense")])
def test_tp_refused_for_other_families(arch, family):
    """The classifiers (CLIP of the vlm family, XLM-R of the dense one)
    raise, naming their family and themselves."""
    from repro_torch.configs.base import RuntimeConfig as TRuntime
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.model import Model as TModel
    from repro_torch.sharding import fl_step, serve
    model = TModel(treduced(tget(arch), n_layers=2, d_model=32),
                   TRuntime(tp_constraints=True), device="cpu")
    mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                           axis_names=("data", "model"))
    match = (f"tensor parallelism over the 'model' axis.*'{family}' "
             f"family's classifier {model.cfg.name}")
    for make in (fl_step.make_fl_train_step, serve.make_prefill_step,
                 serve.make_serve_step):
        with pytest.raises(ValueError, match=match):
            make(model, mesh)
    with pytest.raises(ValueError, match=match):
        fl_step.make_fl_train_step_tau(model, mesh, sel_idx=(0,), tau=2)


def test_tp_accepted_for_paligemma():
    """The vlm family's language model builds every tensor-parallel step,
    its prefix-LM attention ``"kv_shared"`` at 2 (one kv head); the steps
    themselves run in tests/test_torch_tensor_parallel_vlm.py."""
    from repro_torch.configs.base import RuntimeConfig as TRuntime
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.model import Model as TModel
    from repro_torch.sharding import fl_step, rules, serve
    model = TModel(treduced(tget("paligemma_3b"), n_layers=2, d_model=32),
                   TRuntime(tp_constraints=True), device="cpu")
    mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                           axis_names=("data", "model"),
                           group=lambda axes: None, coord=lambda axis: 1)
    for make in (fl_step.make_fl_train_step, serve.make_prefill_step,
                 serve.make_serve_step):
        assert callable(make(model, mesh))
    assert callable(fl_step.make_fl_train_step_tau(model, mesh, sel_idx=(0,),
                                                   tau=2))
    assert rules.TPLayout(model.cfg, 2).mode == "kv_shared"


def test_tp_accepted_for_whisper():
    """The audio family builds every tensor-parallel step: reduced
    whisper's self- and cross-attention ``"heads"`` at 2 (4 heads over 2
    kv heads), ``"kv_shared"`` at 4, its plain GELU MLP not gated; the
    steps themselves run in tests/test_torch_tensor_parallel_audio.py."""
    from repro_torch.configs.base import RuntimeConfig as TRuntime
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.models.model import Model as TModel
    from repro_torch.sharding import fl_step, rules, serve
    model = TModel(treduced(tget("whisper_medium"), n_layers=2, d_model=32),
                   TRuntime(tp_constraints=True), device="cpu")
    mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                           axis_names=("data", "model"),
                           group=lambda axes: None, coord=lambda axis: 1)
    for make in (fl_step.make_fl_train_step, serve.make_prefill_step,
                 serve.make_serve_step):
        assert callable(make(model, mesh))
    assert callable(fl_step.make_fl_train_step_tau(model, mesh, sel_idx=(0,),
                                                   tau=2))
    layout = rules.TPLayout(model.cfg, 2)
    assert layout.mode == "heads" and not layout.gated
    assert rules.TPLayout(model.cfg, 4).mode == "kv_shared"
