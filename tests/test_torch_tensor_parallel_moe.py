"""Tensor parallelism over ``model`` for the moe family
(``RuntimeConfig(tp_constraints=True)``: the routed experts split by
expert where the ``model`` size divides their number, else on ff; the
shared experts and DeepSeek's ``dense0`` MLP Megatron-split; the routers
whole on every rank; MLA split by heads over a latent whole on every
rank, replicated where the heads do not divide) against the reference's
single-host round and single-device serving, on gloo worlds of 4
processes (tests/_torch_dist.py).

As in tests/test_torch_tensor_parallel_ssm.py the oracle is the reference
computed with JAX on one device.  Two reduced models: DeepSeek-V2-Lite (3
layers: ``dense0`` and 2 ``blocks`` rows; 4 experts, top 2, one shared
expert; MLA with 4 heads, ``"heads"`` at 2 and 4: 2 and 1 heads a rank),
expert-parallel at 2 and 4 (2 and 1 experts a rank); Grok-1 with 3 experts (3 ``blocks`` rows, GQA
4/2 of 64, tied head with softcap), split on ff at 2 and 4, its attention
``"heads"`` at 2 and ``"kv_shared"`` at 4.  Two worlds:

* (data 2, model 2): DeepSeek's τ = 1 step with ``moe_local_dispatch``
  off and on, ``sel_upload``, τ = 2, prefill and 8 greedy decode steps
  (dispatch over the whole batch), the storage round trip and the
  routers' and MLA latent path's gradients; Grok's τ = 1 step,
  ``sel_upload``, τ = 2, prefill and decode (per-sample dispatch) and the
  round trip;
* (data 1, model 4): DeepSeek's τ = 1 step with per-sample dispatch,
  prefill and decode (per-sample dispatch) and the routers' and latent
  path's gradients; DeepSeek with 2 heads (MLA ``"replicated"``): its τ =
  1 step; Grok's τ = 1 step, ``sel_upload``, prefill and decode (whole
  batch) and the routers' gradients.

Unit tests without a world: the storage order of ``moe_wi_e``,
``moe_wi_s`` and ``dense0``'s ``mlp_wi``, the width of ``dense0``'s
slices, MLA's per-leaf head widths, the refusals, one moe block's
partials summed by hand in one process against the whole block in both
expert layouts, and one MLA sub-block's (sequence and absorbed decode).
"""
import dataclasses
import functools
import math

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
# (arch, layers, experts): DeepSeek's 3 layers are dense0 + 2 blocks rows;
# "deepseek_h2" is DeepSeek with 2 heads (HEADS), which 4 ranks do not divide
ARCH = {"deepseek": ("deepseek_v2_lite_16b", 3, 4),
        "grok": ("grok_1_314b", 3, 3),
        "deepseek_h2": ("deepseek_v2_lite_16b", 3, 4)}
HEADS = {"deepseek_h2": (2, 2)}
MESH = {"m2": dict(data=2, model=2), "m4": dict(data=1, model=4)}
MASKS = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
SIZES = np.array([10., 20.], np.float32)
# the selected rows of ``blocks`` (sel_upload, τ > 1) and masks whose union
# they are: DeepSeek's mask column 0 is dense0, its blocks rows start at 1
SEL = {"deepseek": ((0, 1), np.array([[0, 1, 1], [0, 0, 1]], np.float32)),
       "grok": ((1, 2), np.array([[0, 1, 1], [0, 0, 1]], np.float32))}
SEL["deepseek_h2"] = SEL["deepseek"]
LR, TAU_LR, TAU = 0.1, 0.05, 2
PROMPT, STEPS = 4, 8
# what each world runs of each model: the runs, and whether its serving
# (prefill, decode) dispatches per sample
RUNS = {("m2", "deepseek"): (("step", "step_local", "sel_upload", "tau",
                              "prefill", "decode", "round_trip", "grads"),
                             False),
        ("m2", "grok"): (("step", "sel_upload", "tau", "prefill", "decode",
                          "round_trip"), True),
        ("m4", "deepseek"): (("step_local", "prefill", "decode", "grads"),
                             True),
        ("m4", "grok"): (("step", "sel_upload", "prefill", "decode",
                          "grads"), False),
        ("m4", "deepseek_h2"): (("step",), False)}
REPLICATED = ("moe_router", "moe_ln", "attn_ln")
# the gradients a "grads" run returns: the routers' and (MLA) the latent
# path's, which every head of a rank reads
GRADS = ("moe_router", "moe_ln", "moe_wi_e")
LATENT = ("attn_ln", "attn_kv_ln", "attn_w_dkv", "attn_w_krope")


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def _cfg(family):
    arch, layers, experts = ARCH[family]
    cfg = reduced(get_arch(arch), n_layers=layers, d_model=64,
                  max_experts=experts)
    if family in HEADS:
        H, K = HEADS[family]
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K)
    return cfg


def _grad_names(family):
    return GRADS + (LATENT if family.startswith("deepseek") else ())


@functools.cache
def _models(family):
    """The reference's model with whole-batch and per-sample dispatch, one
    of each a model, so that both worlds reuse the oracles' compiles
    (:func:`_jit`)."""
    cfg = _cfg(family)
    return cfg, {local: Model(cfg, RuntimeConfig(
        remat=False, seq_chunk=16, moe_local_dispatch=local))
        for local in (False, True)}


_JITS = {}


def _jit(model, name, make):
    """``jax.jit(make())``, compiled once per model and name."""
    key = (id(model), name)
    if key not in _JITS:
        _JITS[key] = jax.jit(make())
    return _JITS[key]


def step_oracle(cfg, model, params, tokens, masks, lr):
    n = masks.shape[0]
    grad = _jit(model, "grad", lambda: jax.grad(model.loss))
    deltas = [apply_layer_mask(grad(params, {"tokens": tokens[i]}),
                               masks[i], cfg) for i in range(n)]
    update = agg.aggregate(deltas, jnp.asarray(masks),
                           jnp.asarray(SIZES[:n]), cfg)
    return _host(agg.apply_update(params, update, lr))


def tau_oracle(cfg, model, params, tokens, masks):
    client = Client(model)
    n = masks.shape[0]
    deltas = [client._local_update(params, {"tokens": tokens[i]}, masks[i],
                                   TAU_LR)[0] for i in range(n)]
    return _host(agg.apply_update(params, agg.aggregate(
        deltas, jnp.asarray(masks), jnp.asarray(SIZES[:n]), cfg), TAU_LR))


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


def grads_oracle(model, params, tokens, names):
    """The loss, the aux loss and the gradients of the ``blocks`` leaves
    ``names`` on one device."""
    def loss(p, tok):
        h, aux, prefix = model.forward_seq(p, {"tokens": tok})
        return model.loss_from_hidden(p, h, aux, prefix,
                                      {"tokens": tok}), aux
    (value, aux), g = _jit(model, "grads", lambda: jax.value_and_grad(
        loss, has_aux=True))(params, tokens)
    return {"loss": float(value), "aux": float(aux),
            "grads": {nm: np.asarray(g["blocks"][nm], np.float32)
                      for nm in names}}


def _family_cases(world, family, rng):
    """One model's cases in a world, by run name, and their oracles."""
    cfg, models = _models(family)
    params = models[False].init(jax.random.PRNGKey(0))
    host = _host(params)
    n = MESH[world]["data"]
    V = cfg.vocab_size
    arch, layers, experts = ARCH[family]
    runs, serve_local = RUNS[world, family]
    common = dict(arch=arch, layers=layers, experts=experts, params=host,
                  zero3=True, tp=True, heads=HEADS.get(family))
    tokens = rng.randint(0, V, (n, 2, 16)).astype(np.int32)
    step = dict(common, kind="fl_step", batch={"tokens": tokens},
                masks=MASKS[:n], sizes=SIZES[:n], lr=LR)
    sel_idx, sel_masks = SEL[family]
    cases, refs = {}, {}
    for run in runs:
        if run in ("step", "step_local"):
            local = run == "step_local"
            cases[run] = dict(step, local=local)
            refs[run] = step_oracle(cfg, models[local], params, tokens,
                                    MASKS[:n], LR)
        elif run == "sel_upload":
            cases[run] = dict(step, masks=sel_masks[:n], sel_upload=True,
                              sel_idx=sel_idx)
            refs[run] = step_oracle(cfg, models[False], params, tokens,
                                    sel_masks[:n], LR)
        elif run == "tau":
            tau_tokens = rng.randint(0, V, (n, TAU, 2, 16)).astype(np.int32)
            cases[run] = dict(step, kind="fl_step_tau",
                              batch={"tokens": tau_tokens},
                              masks=sel_masks[:n], lr=TAU_LR, tau=TAU,
                              sel_idx=sel_idx)
            refs[run] = tau_oracle(cfg, models[False], params, tau_tokens,
                                   sel_masks[:n])
        elif run == "prefill":
            seqs = rng.randint(0, V, (4, 16)).astype(np.int32)
            cases[run] = dict(common, kind="prefill", tokens=seqs,
                              local=serve_local)
            m = models[serve_local]
            refs[run] = np.asarray(_jit(m, "prefill", lambda: m.logits_seq)(
                params, {"tokens": seqs}), np.float32)
        elif run == "decode":
            prompt = rng.randint(0, V, (4, PROMPT)).astype(np.int32)
            cases[run] = dict(common, kind="decode", prompt=prompt,
                              steps=STEPS, local=serve_local)
            refs[run] = decode_oracle(models[serve_local], params, prompt)
        elif run == "round_trip":
            cases[run] = dict(common, kind="tp_round_trip")
        elif run == "grads":
            seqs = rng.randint(0, V, (2, 16)).astype(np.int32)
            cases[run] = dict(common, kind="tp_moe_grads", tokens=seqs,
                              names=_grad_names(family))
            refs[run] = grads_oracle(models[False], params, seqs,
                                     _grad_names(family))
    return cases, refs, dict(cfg=cfg, host=host)


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.RandomState(28)
    out = {}
    for world in MESH:
        cases, refs, info = {}, {}, {}
        for family in ARCH:
            if (world, family) not in RUNS:
                continue
            c, r, i = _family_cases(world, family, rng)
            cases.update({(family, k): v for k, v in c.items()})
            refs.update({(family, k): v for k, v in r.items()})
            info[family] = i
        names = list(cases)
        ranks = run_world(4, MESH[world], [cases[k] for k in names])
        out[world] = dict(refs=refs, info=info,
                          runs={k: [r[i] for r in ranks]
                                for i, k in enumerate(names)})
    return out


def _held(kind):
    return [(w, f, r) for (w, f), (runs, _) in RUNS.items() for r in runs
            if r in kind]


@pytest.mark.parametrize("world,family,run",
                         _held(("step", "step_local", "sel_upload")))
def test_tp_moe_step_matches_single_host(worlds, world, family, run):
    """The τ = 1 step (``step_local``: per-sample dispatch;
    ``sel_upload``: masks whose union is its ``sel_idx`` rows of
    ``blocks``) against the single-host round on the same masks."""
    w = worlds[world]
    for res in w["runs"][family, run]:
        assert max_err(res["full"], w["refs"][family, run]) < TOL, \
            (world, family, run, res["coords"])
        assert np.isfinite(res["loss"])
    # the step moved the selected layers: the check is not vacuous
    assert max_err(w["runs"][family, run][0]["full"],
                   w["info"][family]["host"]) > 1e-4


@pytest.mark.parametrize("world,family,run", _held(("tau",)))
def test_tp_moe_tau_matches_single_host(worlds, world, family, run):
    """τ = 2 over the selected ``blocks`` rows (``masked_update`` on the
    rank's model slices) against ``Client._local_update`` + aggregate;
    the rows outside the union and every other group stay bit-unchanged."""
    w = worlds[world]
    host = w["info"][family]["host"]
    sel_idx, _ = SEL[family]
    for res in w["runs"][family, run]:
        assert max_err(res["full"], w["refs"][family, run]) < TAU_TOL
    full = w["runs"][family, run][0]["full"]
    rest = [i for i in range(host["blocks"]["moe_ln"].shape[0])
            if i not in sel_idx]
    for nm, leaf in full["blocks"].items():
        np.testing.assert_array_equal(leaf[rest], host["blocks"][nm][rest])
    for key in host:
        if key != "blocks":
            assert max_err(full[key], host[key]) == 0.0, key
    assert max_err(full["blocks"], host["blocks"]) > 1e-4


@pytest.mark.parametrize("world,family,run", _held(("decode",)))
def test_tp_moe_decode_matches_decode_step(worlds, world, family, run):
    tokens, logits = worlds[world]["refs"][family, run]
    for res in worlds[world]["runs"][family, run]:
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows],
                                   atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("world,family,run", _held(("prefill",)))
def test_tp_moe_prefill_matches_logits_seq(worlds, world, family, run):
    """Prefill, its batch whole on every rank under whole-batch dispatch
    (the routers' capacity couples the rows) and split over ``data``
    under per-sample dispatch."""
    ref = worlds[world]["refs"][family, run]
    V = worlds[world]["info"][family]["cfg"].vocab_size
    local = RUNS[world, family][1]
    for res in worlds[world]["runs"][family, run]:
        rows = res["rows"]
        n = len(rows)
        assert n == (4 // MESH[world]["data"] if local else 4)
        assert res["logits"].shape == (n, V)
        np.testing.assert_allclose(res["logits"], ref[rows],
                                   atol=SERVE_TOL, rtol=0)


def _by_data(runs):
    out = {}
    for res in runs:
        out.setdefault(res["coords"]["data"], {})[res["coords"]["model"]] \
            = res
    return out


@pytest.mark.parametrize(
    "world,family,run", _held(("step", "step_local", "sel_upload", "tau")))
def test_tp_moe_replicated_leaves_equal_across_model_ranks(worlds, world,
                                                           family, run):
    """The routers, ``moe_ln`` and the attention norms, whole on every
    model rank, are bit-equal on every model rank after the step, and the
    routers of the selected rows moved."""
    w = worlds[world]
    host = w["info"][family]["host"]["blocks"]
    for ranks in _by_data(w["runs"][family, run]).values():
        first = ranks[0]["local"]["blocks"]
        for res in ranks.values():
            for nm in REPLICATED:
                np.testing.assert_array_equal(res["local"]["blocks"][nm],
                                              first[nm])
        assert max_err(first["moe_router"], host["moe_router"]) > 0


@pytest.mark.parametrize("world,family,run", _held(("grads",)))
def test_tp_moe_router_gradients_whole_on_every_rank(worlds, world, family,
                                                     run):
    """The gradients of the router and ``moe_ln`` are the same on every
    model rank and equal the single-host gradients; the loss and the aux
    loss are the single-host ones (the aux loss counted once: every rank
    computes it whole, and no f carries its gradient back M times); each
    rank's ``moe_wi_e`` gradient is its slice of the single-host one."""
    w = worlds[world]
    ref = w["refs"][family, run]
    cfg = w["info"][family]["cfg"]
    M = MESH[world]["model"]
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    from repro_torch.sharding import rules
    arch, layers, experts = ARCH[family]
    layout = rules.TPLayout(treduced(tget(arch), n_layers=layers,
                                     d_model=64, max_experts=experts), M)
    runs = w["runs"][family, run]
    for res in runs:
        assert abs(res["loss"] - ref["loss"]) < TOL
        assert abs(res["aux"] - ref["aux"]) < 1e-6 and ref["aux"] > 0
        for nm in ("moe_router", "moe_ln"):
            np.testing.assert_array_equal(res["grads"][nm],
                                          runs[0]["grads"][nm])
            assert max_err(res["grads"][nm], ref["grads"][nm]) < TOL, nm
        assert res["expert_parallel"] == (cfg.n_experts % M == 0)
        want = layout.to_storage_order(("blocks", "moe_wi_e"),
                                       ref["grads"]["moe_wi_e"])
        dim = 1 if layout.expert_parallel else 3
        width = want.shape[dim] // M
        m = res["coords"]["model"]
        want = np.take(want, np.arange(m * width, (m + 1) * width), dim)
        assert max_err(res["grads"]["moe_wi_e"], want) < TOL
    assert max_err(runs[0]["grads"]["moe_router"], 0 * ref["grads"][
        "moe_router"]) > 1e-3


@pytest.mark.parametrize("world,family,run",
                         [h for h in _held(("grads",))
                          if h[1].startswith("deepseek")])
def test_tp_mla_latent_gradients_whole_on_every_rank(worlds, world, family,
                                                     run):
    """MLA split by heads: the gradients of ``attn_ln`` and ``kv_ln``
    (whole on every rank) are equal on every model rank and equal the
    single-host ones; each rank's ``w_dkv`` / ``w_krope`` gradient, the
    own slice of the whole gathered latent's, is its model slice of the
    single-host gradient (the latent path's gradient counted once: a
    second f on its input would make it M times too large)."""
    w = worlds[world]
    ref = w["refs"][family, run]
    M = MESH[world]["model"]
    runs = w["runs"][family, run]
    for res in runs:
        m = res["coords"]["model"]
        for nm in ("attn_ln", "attn_kv_ln"):
            np.testing.assert_array_equal(res["grads"][nm],
                                          runs[0]["grads"][nm])
            assert max_err(res["grads"][nm], ref["grads"][nm]) < TOL, nm
        for nm in ("attn_w_dkv", "attn_w_krope"):
            full = ref["grads"][nm]
            width = full.shape[-1] // M
            want = full[..., m * width:(m + 1) * width]
            assert res["grads"][nm].shape == want.shape, nm
            assert max_err(res["grads"][nm], want) < TOL, nm
    for nm in LATENT:
        assert np.abs(ref["grads"][nm]).max() > 1e-4, nm


def test_tp_moe_model_coordinates_hold_different_experts(worlds):
    """At (data 2, model 2) DeepSeek's model coordinates store different
    experts (expert-parallel: 2 of 4 each, whole), Grok's all 3 experts on
    different ff columns."""
    M = MESH["m2"]["model"]
    for family in ("deepseek", "grok"):
        ranks = _by_data(worlds["m2"]["runs"][family, "step"])[0]
        a, b = ranks[0]["local"]["blocks"], ranks[1]["local"]["blocks"]
        for nm in ("moe_wi_e", "moe_wo_e"):
            assert a[nm].shape == b[nm].shape
            assert not np.array_equal(a[nm], b[nm])
        E = ARCH[family][2]
        assert a["moe_wi_e"].shape[1] == (E // M if family == "deepseek"
                                          else E)


@pytest.mark.parametrize("family", ["deepseek", "grok"])
def test_tp_moe_storage_round_trip_is_exact(worlds, family):
    """Shards → full is the full tree bit for bit; model slice m of a
    gated ``moe_wi_e`` split on ff (Grok), of ``moe_wi_s`` and of
    ``dense0``'s ``mlp_wi`` is gate[…, m] | up[…, m]; an expert-parallel
    ``moe_wi_e`` (DeepSeek) is the rank's experts, in their own order;
    MLA's ``wq``, ``w_ukv`` and ``wo`` (DeepSeek, both segments) keep the
    contiguous split, which is the rank's whole heads, head-major, as
    ``compute_slice`` cuts them by each leaf's own head width."""
    w = worlds["m2"]
    cfg, host = w["info"][family]["cfg"], w["info"][family]["host"]
    M = MESH["m2"]["model"]
    for res in w["runs"][family, "round_trip"]:
        a, b = jax.tree.leaves(res["full"]), jax.tree.leaves(host)
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert res["mode"] == "heads"
        m = res["coords"]["model"]
        sl = res["model_slice"]

        def gated(full):
            ff = full.shape[-1] // 2
            w_ = ff // M
            return np.concatenate([full[..., m * w_:(m + 1) * w_],
                                   full[..., ff + m * w_:ff + (m + 1) * w_]],
                                  -1)
        wi_e = host["blocks"]["moe_wi_e"]
        if family == "deepseek":
            E = cfg.n_experts // M
            np.testing.assert_array_equal(sl["blocks"]["moe_wi_e"],
                                          wi_e[:, m * E:(m + 1) * E])
            np.testing.assert_array_equal(sl["blocks"]["moe_wi_s"],
                                          gated(host["blocks"]["moe_wi_s"]))
            np.testing.assert_array_equal(sl["dense0"]["mlp_wi"],
                                          gated(host["dense0"]["mlp_wi"]))
            import torch
            from repro_torch.sharding import rules
            layout = rules.TPLayout(_tcfg(family), M)
            for seg in ("dense0", "blocks"):
                for nm in ("attn_wq", "attn_w_ukv", "attn_wo"):
                    full = host[seg][nm]
                    want = np.stack([layout.compute_slice(
                        nm, torch.tensor(r), m).numpy() for r in full])
                    np.testing.assert_array_equal(sl[seg][nm], want)
        else:
            np.testing.assert_array_equal(sl["blocks"]["moe_wi_e"],
                                          gated(wi_e))


# ---------------------------------------------------------------------------
# Without a world
# ---------------------------------------------------------------------------

def _tcfg(family, **changes):
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    arch, layers, experts = ARCH[family]
    cfg = treduced(tget(arch), n_layers=layers, d_model=64,
                   max_experts=experts)
    return dataclasses.replace(cfg, **changes) if changes else cfg


@pytest.mark.parametrize("M", [2, 4])
def test_tp_moe_storage_order_round_trip(M):
    """``to_storage_order`` then ``from_storage_order`` is the identity
    for the gated leaves it reorders (Grok's ``moe_wi_e`` on ff,
    DeepSeek's ``moe_wi_s`` and ``dense0.mlp_wi``); an expert-parallel
    ``moe_wi_e`` keeps its order; ``compute_slice`` of the full leaf is
    the stored model slice m."""
    import torch
    from repro_torch.sharding import rules
    for family, path in (("grok", ("blocks", "moe_wi_e")),
                         ("deepseek", ("blocks", "moe_wi_s")),
                         ("deepseek", ("dense0", "mlp_wi")),
                         ("deepseek", ("blocks", "moe_wi_e"))):
        layout = rules.TPLayout(_tcfg(family), M)
        full = torch.arange(4 * 3 * 2 * 8 * M, dtype=torch.float32) \
            .reshape(4, 3, 2, 8 * M)
        stored = layout.to_storage_order(path, full)
        assert torch.equal(layout.from_storage_order(path, stored), full)
        if path == ("blocks", "moe_wi_e") and family == "deepseek":
            assert torch.equal(stored, full)
            continue
        w = full.shape[-1] // M
        for m in range(M):
            assert torch.equal(stored[..., m * w:(m + 1) * w],
                               layout.compute_slice(path[-1], full, m))


def test_tp_moe_dense0_slices_take_their_width_from_the_leaf():
    """``dense0``'s MLP is ``d_ff · (top_k + n_shared_experts)`` wide, not
    ``d_ff``: ``compute_slice`` of its ``mlp_wo`` and of a non-gated
    ``mlp_wi`` takes the 1/M of the leaf's own ff rows or columns."""
    import torch
    from repro_torch.models.moe import dense0_ff
    from repro_torch.sharding import rules
    cfg = _tcfg("deepseek")
    ff = dense0_ff(cfg)
    assert ff == cfg.d_ff * (cfg.top_k + cfg.n_shared_experts) != cfg.d_ff
    layout = rules.TPLayout(cfg, 4)
    wo = torch.arange(ff * 2, dtype=torch.float32).reshape(ff, 2)
    for m in range(4):
        assert torch.equal(layout.compute_slice("mlp_wo", wo, m),
                           wo[m * ff // 4:(m + 1) * ff // 4])
    plain = rules.TPLayout(_tcfg("deepseek", mlp_act="gelu_plain"), 4)
    wi = torch.arange(2 * ff, dtype=torch.float32).reshape(2, ff)
    assert torch.equal(plain.compute_slice("mlp_wi", wi, 3),
                       wi[:, 3 * ff // 4:])


def test_tp_moe_layouts_of_the_production_models():
    """At 16: DeepSeek-V2-Lite expert-parallel (4 of 64 experts a rank),
    MLA one head a rank, the vocabulary split; Grok-1 on ff (8 experts do not
    divide by 16), its attention ``"kv_shared"`` (48/8 heads), the
    vocabulary split; at 2 Grok is expert-parallel too."""
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.sharding import rules
    ds = rules.TPLayout(tget("deepseek_v2_lite_16b"), 16)
    assert ds.expert_parallel and ds.experts(3) == (12, 4)
    assert ds.mode == "heads" and ds.vocab_split
    assert ds.q_heads(3) == ds.kv_heads(3) == (3, 1)
    grok = rules.TPLayout(tget("grok_1_314b"), 16)
    assert not grok.expert_parallel and grok.experts(5) == (0, 8)
    assert grok.mode == "kv_shared" and grok.vocab_split
    assert (grok.q_heads(5), grok.kv_heads(5)) == ((15, 3), (2, 1))
    assert rules.TPLayout(tget("grok_1_314b"), 2).experts(1) == (4, 4)


@pytest.mark.parametrize("family,changes,M,numbers", [
    ("grok", dict(d_ff=250), 4, ("d_ff 250",)),
    ("deepseek", dict(d_ff=250), 4, ("d_ff·n_shared_experts 250",)),
    ("deepseek", dict(n_shared_experts=0, d_ff=257), 4,
     ("dense0's", "514"))], ids=["grok_ff", "shared", "dense0"])
def test_tp_moe_refuses_a_split_that_does_not_divide(family, changes, M,
                                                     numbers):
    """A split width that does not divide by the ``model`` size raises
    rather than falling back to a replicated leaf: the ff of experts split
    on ff, the shared experts' width, ``dense0``'s width."""
    from repro_torch.sharding import rules
    with pytest.raises(ValueError) as e:
        rules.TPLayout(_tcfg(family, **changes), M)
    for s in numbers:
        assert s in str(e.value)


def test_tp_moe_expert_parallel_needs_no_divisible_ff():
    """Expert-parallel experts are whole on their rank: their ff need not
    divide (DeepSeek without shared experts or ``dense0``)."""
    from repro_torch.sharding import rules
    layout = rules.TPLayout(_tcfg("deepseek", d_ff=250, n_shared_experts=0,
                                  first_dense=0), 4)
    assert layout.expert_parallel


@pytest.mark.parametrize("family,M,local", [
    ("deepseek", 2, False), ("deepseek", 4, True), ("grok", 2, True),
    ("grok", 4, False), ("grok4", 2, False)])
def test_tp_moe_block_partials_sum_to_the_whole_block(family, M, local):
    """One moe block's M coordinates computed in turn in one process
    (``compute_slice`` weights, a ``ModelAxis`` with identity f and g):
    the attention's partials summed (MLA: one whole copy), then the moe
    layer's (routed and shared experts) on the result, against the whole
    block (``_moe_block_fwd``): the output, the input's gradient and every
    leaf's, in f32.  DeepSeek is expert-parallel, Grok's 3 experts split
    on ff, and Grok with 4 experts at 2 is expert-parallel with GQA."""
    import torch
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import (_block_shapes, _moe_attention,
                                          _moe_block_fwd, _take)
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    cfg = (_tcfg("grok", n_experts=4) if family == "grok4"
           else _tcfg(family))
    layout = rules.TPLayout(cfg, M)
    assert layout.expert_parallel == (cfg.n_experts % M == 0)
    gen = torch.Generator().manual_seed(0)
    row = {k: torch.randn(s, generator=gen) * 0.3
           for k, s in _block_shapes(cfg, "moe").items()}
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    attn = dict(positions=torch.arange(16, dtype=torch.int32), window=0,
                seq_chunk=16)
    leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
    xin = x.clone().requires_grad_()
    want, _ = _moe_block_fwd(leaves, xin, cfg, moe_local=local, **attn)
    want_g = torch.autograd.grad(want, [xin, *leaves.values()], dy)

    leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
    xin = x.clone().requires_grad_()
    slices = [{k: layout.compute_slice(k, v, m) for k, v in leaves.items()}
              for m in range(M)]
    n = 1 if layout.mode == "replicated" else M
    h = xin + sum(_moe_attention(_take(slices[m], "attn_"), xin, cfg,
                                 tp=ModelAxis(layout, m), **attn)
                  for m in range(n))
    got = h + sum(tmoe.moe_fwd(_take(slices[m], "moe_"), h, cfg,
                               local_dispatch=local,
                               tp=ModelAxis(layout, m))[0]
                  for m in range(M))
    got_g = torch.autograd.grad(got, [xin, *leaves.values()], dy)
    pairs = zip(["out", "x", *leaves], [got.detach(), *got_g],
                [want.detach(), *want_g])
    for name, a, b in pairs:    # f32 sums in another order: relative to
        assert float((a - b).abs().max()) <= 5e-5 * float(b.abs().max()), \
            name                # the tensor's largest magnitude


def test_tp_mla_compute_slices_take_each_leafs_head_width():
    """MLA's three per-head widths (reduced: nope 32, rope 16, v 32):
    ``wq`` nope + rope = 48 a head, ``w_ukv`` nope + v = 64 (each head's
    [nope | v] side by side), ``wo``'s rows v = 32; the latent ``w_dkv``,
    ``w_krope`` and ``kv_ln`` whole.  Model coordinate m's slice is the
    columns (rows) of its heads, head-major, at 2 and 4; at 4 ranks of 2
    heads MLA falls back to ``"replicated"``."""
    import torch
    from repro_torch.models.mla import mla_param_shapes
    from repro_torch.sharding import rules
    cfg = _tcfg("deepseek")
    assert (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim) == (4, 32, 16, 32)
    widths = {"wq": 48, "w_ukv": 64, "wo": 32}
    shapes = mla_param_shapes(cfg)
    for M in (2, 4):
        layout = rules.TPLayout(cfg, M)
        assert layout.mode == "heads"
        assert {k: layout.head_width(k) for k in widths} == widths
        for leaf, shp in shapes.items():
            full = torch.arange(math.prod(shp), dtype=torch.float32) \
                .reshape(shp)
            for m in range(M):
                got = layout.compute_slice("attn_" + leaf, full, m)
                if leaf in ("ln", "kv_ln", "w_dkv", "w_krope"):
                    assert torch.equal(got, full), leaf
                    continue
                w, n = widths[leaf], cfg.n_heads // M
                heads = (full.reshape(-1, cfg.n_heads, w) if leaf != "wo"
                         else full.reshape(cfg.n_heads, w, -1))
                want = (heads[:, m * n:(m + 1) * n].reshape(full.shape[0], -1)
                        if leaf != "wo" else
                        heads[m * n:(m + 1) * n].reshape(-1, full.shape[1]))
                assert torch.equal(got, want), (leaf, M, m)
    two = rules.TPLayout(_tcfg("deepseek", n_heads=2, n_kv_heads=2), 4)
    assert two.mode == "replicated" and two.q_heads(3) == (0, 2)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("decode", [False, True], ids=["seq", "decode"])
def test_tp_mla_partials_sum_to_the_whole(M, decode):
    """One MLA sub-block's M coordinates in one process (``compute_slice``
    weights, a ``ModelAxis`` with identity f and g): the partials summed
    by hand against ``mla_fwd`` whole, in f32 — the sequence forward by
    query chunks (16 of 32) with the input's and every leaf's gradient,
    and the absorbed decode over a latent cache that every coordinate
    writes alike, token by token."""
    import torch
    from repro_torch.models import mla as tmla
    from repro_torch.models.mla import mla_param_shapes
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    cfg = _tcfg("deepseek")
    layout = rules.TPLayout(cfg, M)
    gen = torch.Generator().manual_seed(1)
    row = {k: torch.randn(s, generator=gen) * 0.3
           for k, s in mla_param_shapes(cfg).items()}
    S = 32
    x = torch.randn((2, S, cfg.d_model), generator=gen)
    pos = torch.arange(S, dtype=torch.int32)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    if not decode:
        dy = torch.randn(x.shape, generator=gen)
        leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
        xin = x.clone().requires_grad_()
        want = tmla.mla_fwd(leaves, xin, cfg, positions=pos, seq_chunk=16)
        want_g = torch.autograd.grad(want, [xin, *leaves.values()], dy)
        leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
        xin = x.clone().requires_grad_()
        got = sum(tmla.mla_fwd({k: layout.compute_slice("attn_" + k, v, m)
                                for k, v in leaves.items()}, xin, cfg,
                               positions=pos, seq_chunk=16,
                               tp=ModelAxis(layout, m)) for m in range(M))
        got_g = torch.autograd.grad(got, [xin, *leaves.values()], dy)
        for name, a, b in zip(["out", "x", *leaves], [got, *got_g],
                              [want, *want_g]):
            assert rel(a.detach(), b.detach()) <= 5e-5, name
        return

    def cache():
        return {"ckv": torch.zeros((2, S, cfg.kv_lora_rank)),
                "krope": torch.zeros((2, S, cfg.qk_rope_dim)),
                "pos": torch.full((S,), torch.iinfo(torch.int32).max,
                                  dtype=torch.int32)}
    whole, parts = cache(), [cache() for _ in range(M)]
    slices = [{k: layout.compute_slice("attn_" + k, v, m)
               for k, v in row.items()} for m in range(M)]
    for t in range(8):
        xt, p = x[:, t:t + 1], torch.tensor(t, dtype=torch.int32)
        want = tmla.mla_fwd(row, xt, cfg, positions=p[None], cache=whole,
                            cache_pos=p)
        got = sum(tmla.mla_fwd(slices[m], xt, cfg, positions=p[None],
                               cache=parts[m], cache_pos=p,
                               tp=ModelAxis(layout, m)) for m in range(M))
        assert rel(got, want) <= 5e-5, t
    for part in parts:
        for k in whole:
            assert torch.equal(part[k], whole[k]), k
