"""Tensor parallelism over ``model`` for the ssm and hybrid families
(``RuntimeConfig(tp_constraints=True)``: a Mamba2 block split by SSD
heads, B and C gathered over ``model``, the gate norm's statistic summed
over ``model``; the hybrid's shared block split as a dense block) against
the reference's single-host round and single-device serving, on gloo
worlds of 4 processes (tests/_torch_dist.py).

As in tests/test_torch_tensor_parallel.py the oracle is the reference
computed with JAX on one device.  Two worlds:

* (data 2, model 2): reduced Mamba2 (4 rows, 4 SSD heads of 32, one group
  of state 16: 2 heads a rank, B | C gathered) — the τ = 1 step with
  ZeRO-3 on and off and with ``sel_upload``, τ = 3, mesh prefill, 8 greedy
  decode steps and the storage round trip; reduced Zamba2 (3 Mamba2 rows
  and the shared block after the second; shared attention 4/2 heads:
  ``"heads"``) — the τ = 1 step with ZeRO-3 on and off and with
  ``sel_upload`` (its shared block unselected: that path trains only
  ``blocks`` rows), τ = 3, prefill, decode with the shared kv cache;
* (data 1, model 4): reduced Mamba2 with a vocabulary of 510 in both
  packages (1 head a rank; 510 does not divide by 4, so the embedding and
  the tied head are whole on every rank, as 50 280 is at 16) — τ = 1 with
  and without ``sel_upload``, prefill, decode, the round trip; reduced
  Zamba2, whose shared block is ``"kv_shared"`` (the unstacked leaves'
  ``view_row``) — τ = 1 with and without ``sel_upload``, prefill,
  decode.

Unit tests without a world: the storage order and its model slices, the
refusals, and one Mamba2 block's partials summed by hand in one process
(the gate norm's statistic given to each coordinate through a second
pass) against the whole block, gradients included.
"""
import dataclasses

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
ARCH = {"ssm": ("mamba2_370m", 4), "hybrid": ("zamba2_7b", 2)}
MESH = {"m2": dict(data=2, model=2), "m4": dict(data=1, model=4)}
VOCAB = {("m4", "ssm"): 510}
# Mamba2: 4 rows; Zamba2: 3 rows and the shared block (mask column 3)
MASKS = np.array([[1, 0, 0, 1], [0, 1, 0, 1]], np.float32)
SIZES = np.array([10., 20.], np.float32)
TAU_MASKS = {"ssm": np.array([[0, 1, 0, 1], [0, 0, 0, 1]], np.float32),
             "hybrid": np.array([[0, 1, 1, 0], [0, 0, 1, 0]], np.float32)}
SEL = {"ssm": (1, 3), "hybrid": (1, 2)}
# sel_upload trains only selected rows of ``blocks``: Mamba2's masks as the
# plain step's; the hybrid's leave its shared block (column 3) out
SEL_UPLOAD = {"ssm": (MASKS, (0, 1, 3)),
              "hybrid": (np.array([[1, 0, 1, 0], [0, 1, 0, 0]], np.float32),
                         (0, 1, 2))}
LR, TAU_LR, TAU = 0.1, 0.05, 3
PROMPT, STEPS = 4, 8
NARROWED = ("ssm_gate_ln", "ssm_A_log", "ssm_D", "ssm_dt_bias")


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def max_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(max_err(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def reference(world: str, family: str):
    arch, layers = ARCH[family]
    cfg = reduced(get_arch(arch), n_layers=layers, d_model=64)
    if (world, family) in VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=VOCAB[world, family])
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


def tau_oracle(cfg, model, params, tokens, masks):
    client = Client(model)
    deltas = [client._local_update(params, {"tokens": tokens[i]}, masks[i],
                                   TAU_LR)[0] for i in range(2)]
    return _host(agg.apply_update(params, agg.aggregate(
        deltas, jnp.asarray(masks), jnp.asarray(SIZES), cfg), TAU_LR))


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


def _family_cases(world, family, rng):
    """One family's cases in a world, by run name, and their oracles."""
    cfg, model, params = reference(world, family)
    host = _host(params)
    n = MESH[world]["data"]
    V = cfg.vocab_size
    arch, layers = ARCH[family]
    common = dict(arch=arch, layers=layers, vocab=VOCAB.get((world, family)),
                  params=host, zero3=True, tp=True)
    tokens = rng.randint(0, V, (n, 2, 16)).astype(np.int32)
    prompt = rng.randint(0, V, (4, PROMPT)).astype(np.int32)
    seqs = rng.randint(0, V, (4, 16)).astype(np.int32)
    step = dict(common, kind="fl_step", batch={"tokens": tokens},
                masks=MASKS[:n], sizes=SIZES[:n], lr=LR)
    cases = {"step": step,
             "prefill": dict(common, kind="prefill", tokens=seqs),
             "decode": dict(common, kind="decode", prompt=prompt,
                            steps=STEPS)}
    refs = {"step": step_oracle(cfg, model, params, tokens, MASKS[:n], LR),
            "prefill": np.asarray(model.logits_seq(params, {"tokens": seqs}),
                                  np.float32),
            "decode": decode_oracle(model, params, prompt)}
    if world == "m2":
        tau_tokens = rng.randint(0, V, (n, TAU, 2, 16)).astype(np.int32)
        cases["tau"] = dict(step, kind="fl_step_tau",
                            batch={"tokens": tau_tokens},
                            masks=TAU_MASKS[family], lr=TAU_LR, tau=TAU,
                            sel_idx=SEL[family])
        refs["tau"] = tau_oracle(cfg, model, params, tau_tokens,
                                 TAU_MASKS[family])
        cases["step_no_zero3"] = dict(step, zero3=False)
    sel_masks, sel_idx = SEL_UPLOAD[family]
    cases["sel_upload"] = dict(step, masks=sel_masks[:n], sel_upload=True,
                               sel_idx=sel_idx)
    refs["sel_upload"] = step_oracle(cfg, model, params, tokens,
                                     sel_masks[:n], LR)
    if family == "ssm":
        cases["round_trip"] = dict(common, kind="tp_round_trip")
        cases["block"] = dict(common, kind="tp_ssm_block", **_block_inputs(
            cfg, rng))
    return cases, refs, dict(cfg=cfg, host=host)


def _block_inputs(cfg, rng) -> dict:
    """A Mamba2 row, an input and a cotangent at magnitudes where the gate
    norm's statistic is far above its epsilon (so its gradient counts)."""
    from repro.models.ssd import mamba2_param_shapes
    row = {"ssm_" + k: (rng.randn(*s) * 0.3).astype(np.float32)
           for k, s in mamba2_param_shapes(cfg).items()}
    shape = (2, 32, cfg.d_model)
    return dict(row=row, x=rng.randn(*shape).astype(np.float32),
                dy=rng.randn(*shape).astype(np.float32))


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.RandomState(12)
    out = {}
    for world in MESH:
        cases, refs, info = {}, {}, {}
        for family in ARCH:
            c, r, i = _family_cases(world, family, rng)
            cases.update({(family, k): v for k, v in c.items()})
            refs.update({(family, k): v for k, v in r.items()})
            info[family] = i
        names = list(cases)
        ranks = run_world(4, MESH[world], [cases[k] for k in names])
        out[world] = dict(refs=refs, info=info, block=cases["ssm", "block"],
                          runs={k: [r[i] for r in ranks]
                                for i, k in enumerate(names)})
    return out


STEPS_HELD = [("m2", "ssm", "step"), ("m2", "ssm", "step_no_zero3"),
              ("m2", "ssm", "sel_upload"), ("m2", "hybrid", "step"),
              ("m2", "hybrid", "step_no_zero3"),
              ("m2", "hybrid", "sel_upload"),
              ("m4", "ssm", "step"), ("m4", "ssm", "sel_upload"),
              ("m4", "hybrid", "step"), ("m4", "hybrid", "sel_upload")]


@pytest.mark.parametrize("world,family,run", STEPS_HELD)
def test_tp_ssm_step_matches_single_host(worlds, world, family, run):
    """The step against the single-host round on its masks (``sel_upload``:
    masks whose union is its ``sel_idx``, the hybrid's shared block
    unselected, since that path trains only ``blocks`` rows)."""
    w = worlds[world]
    ref = w["refs"][family, "sel_upload" if run == "sel_upload" else "step"]
    for res in w["runs"][family, run]:
        assert max_err(res["full"], ref) < TOL, \
            (world, family, run, res["coords"])
        assert np.isfinite(res["loss"])
    # the step moved the selected layers: the check is not vacuous
    assert max_err(w["runs"][family, run][0]["full"],
                   w["info"][family]["host"]) > 1e-4


@pytest.mark.parametrize("family", list(ARCH))
def test_tp_ssm_tau_matches_single_host(worlds, family):
    w = worlds["m2"]
    host = w["info"][family]["host"]
    for res in w["runs"][family, "tau"]:
        assert max_err(res["full"], w["refs"][family, "tau"]) < TAU_TOL
        assert res["union_frac"] == 0.5
    full = w["runs"][family, "tau"][0]["full"]
    rest = [i for i in range(host["blocks"]["ssm_ln"].shape[0])
            if i not in SEL[family]]
    for nm, leaf in full["blocks"].items():     # rows outside the union stay
        np.testing.assert_array_equal(leaf[rest], host["blocks"][nm][rest])
    assert max_err(full["blocks"], host["blocks"]) > 1e-4


SERVED = [(w, f) for w in MESH for f in ARCH]


@pytest.mark.parametrize("world,family", SERVED)
def test_tp_ssm_decode_matches_decode_step(worlds, world, family):
    tokens, logits = worlds[world]["refs"][family, "decode"]
    for res in worlds[world]["runs"][family, "decode"]:
        rows = res["rows"]
        np.testing.assert_array_equal(res["tokens"], tokens[rows])
        np.testing.assert_allclose(res["logits"], logits[rows],
                                   atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("world,family", SERVED)
def test_tp_ssm_prefill_matches_logits_seq(worlds, world, family):
    ref = worlds[world]["refs"][family, "prefill"]
    V = worlds[world]["info"][family]["cfg"].vocab_size
    for res in worlds[world]["runs"][family, "prefill"]:
        rows = res["rows"]
        assert res["logits"].shape == (len(rows), V)
        np.testing.assert_allclose(res["logits"], ref[rows],
                                   atol=SERVE_TOL, rtol=0)


def _by_data(runs):
    out = {}
    for res in runs:
        out.setdefault(res["coords"]["data"], {})[res["coords"]["model"]] \
            = res
    return out


REPLICATED_HELD = [(w, f, r) for w, f, r in STEPS_HELD] + [
    ("m2", "ssm", "tau"), ("m2", "hybrid", "tau")]


@pytest.mark.parametrize("world,family,run", REPLICATED_HELD)
def test_tp_ssm_replicated_leaves_equal_across_model_ranks(worlds, world,
                                                           family, run):
    """Every leaf replicated over ``model`` — ``ssm_ln`` through f, and
    ``gate_ln``, ``A_log``, ``D``, ``dt_bias``, which a rank narrows to its
    channels or heads, through the gather of their gradient slices — is
    bit-equal on every model rank after the step, and the narrowed ones
    moved."""
    w = worlds[world]
    host = w["info"][family]["host"]["blocks"]
    for ranks in _by_data(w["runs"][family, run]).values():
        first = ranks[0]["local"]["blocks"]
        for res in ranks.values():
            for nm in ("ssm_ln",) + NARROWED:
                np.testing.assert_array_equal(res["local"]["blocks"][nm],
                                              first[nm])
        for nm in NARROWED:
            assert max_err(first[nm], host[nm]) > 0, nm


@pytest.mark.parametrize("world", list(MESH))
def test_tp_ssm_block_on_the_mesh_matches_the_whole_block(worlds, world):
    """One f32 Mamba2 block split over ``model`` on the mesh — B | C
    all-gathered (reduce-scatter backward), the gate norm's Σ y² summed
    over ``model`` both ways, ``gate_ln`` / ``A_log`` / ``D`` /
    ``dt_bias`` narrowed with their gradient slices gathered back, g —
    against the whole block (the port's own, on one process): the output,
    dx and every rank's leaf gradients (its storage slice of the whole
    gradient), within 5e-5 of each tensor's largest magnitude.  Unlike a
    step from the model's init, the activations here put the statistic far
    above the norm's epsilon, where a one-way sum parts by order 1."""
    import torch
    from repro_torch.models.model import _take
    from repro_torch.models.ssd import mamba2_fwd
    from repro_torch.sharding import rules
    cfg, M = _tcfg(), MESH[world]["model"]
    layout = rules.TPLayout(cfg, M)
    case = worlds[world]["block"]
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in case["row"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    y, _ = mamba2_fwd(_take(leaves, "ssm_"), x, cfg)
    out = x + y
    grads = torch.autograd.grad(out, [x, *leaves.values()],
                                torch.from_numpy(case["dy"]))
    want = {k: g[None] for k, g in zip(leaves, grads[1:])}
    specs = rules.params_pytree_specs(cfg, {"blocks": want}, zero3=False,
                                      mesh_shape=MESH[world])["blocks"]

    def close(a, b, what):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 5e-5 * np.abs(b).max(), what
    for res in worlds[world]["runs"]["ssm", "block"]:
        m = res["coords"]["model"]
        close(res["out"], out.detach().numpy(), "out")
        close(res["dx"], grads[0].numpy(), "dx")
        for k, g in want.items():
            full = layout.to_storage_order(("blocks", k), g)
            dim = rules.model_dim(specs[k])
            if dim is not None:
                w = full.shape[dim] // M
                full = full.narrow(dim, m * w, w)
            close(res["grads"][k], full[0].numpy(), k)


def test_tp_ssm_model_coordinates_hold_different_shards(worlds):
    """The model coordinates store different slices of the split Mamba2
    leaves (and of the vocabulary where it divides)."""
    for world in MESH:
        for ranks in _by_data(worlds[world]["runs"]["ssm", "step"]).values():
            a, b = ranks[0]["local"], ranks[1]["local"]
            for nm in ("ssm_in_proj", "ssm_out_proj", "ssm_conv_w"):
                assert a["blocks"][nm].shape == b["blocks"][nm].shape
                assert not np.array_equal(a["blocks"][nm], b["blocks"][nm])
            assert np.array_equal(a["embed"]["tok"], b["embed"]["tok"]) \
                == (world == "m4")


def test_tp_ssm_vocabulary_that_does_not_divide_is_replicated(worlds):
    """510 rows over 4 model ranks: ``embed.tok``'s spec drops ``model``,
    so every rank stores the whole table (ZeRO-3 over ``data`` of 1 leaves
    it whole too) and the tied head and the cross-entropy run whole."""
    w = worlds["m4"]
    for res in w["runs"]["ssm", "round_trip"]:
        assert res["local"]["embed"]["tok"].shape == (510, 64)
        np.testing.assert_array_equal(res["local"]["embed"]["tok"],
                                      w["info"]["ssm"]["host"]["embed"]["tok"])


@pytest.mark.parametrize("world", list(MESH))
def test_tp_ssm_storage_round_trip_is_exact(worlds, world):
    """Shards → full is the full tree bit for bit; the model slice m of
    ``ssm_in_proj`` is z_m | x_m | B_m | C_m | dt_m, of the conv x_m | B_m
    | C_m, of ``ssm_out_proj`` its rows of d_inner."""
    w = worlds[world]
    cfg, host = w["info"]["ssm"]["cfg"], w["info"]["ssm"]["host"]
    M = MESH[world]["model"]
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.resolved_ssm_heads
    for res in w["runs"]["ssm", "round_trip"]:
        a, b = jax.tree.leaves(res["full"]), jax.tree.leaves(host)
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        m = res["coords"]["model"]
        sl = res["model_slice"]["blocks"]

        def part(start, width):
            return np.r_[start + m * width // M:start + (m + 1) * width // M]
        cols = np.concatenate([part(0, di), part(di, di), part(2 * di, gn),
                               part(2 * di + gn, gn),
                               part(2 * di + 2 * gn, h)])
        np.testing.assert_array_equal(
            sl["ssm_in_proj"], host["blocks"]["ssm_in_proj"][..., cols])
        conv = np.concatenate([part(0, di), part(di, gn),
                               part(di + gn, gn)])
        for nm in ("ssm_conv_w", "ssm_conv_b"):
            np.testing.assert_array_equal(sl[nm],
                                          host["blocks"][nm][..., conv])
        np.testing.assert_array_equal(
            sl["ssm_out_proj"], host["blocks"]["ssm_out_proj"][:, part(0, di)])


# ---------------------------------------------------------------------------
# Without a world
# ---------------------------------------------------------------------------

def _tcfg(arch="mamba2_370m", **changes):
    from repro_torch.configs.base import get_arch as tget
    from repro_torch.configs.base import reduced as treduced
    cfg = treduced(tget(arch), n_layers=2, d_model=64)
    return dataclasses.replace(cfg, **changes) if changes else cfg


@pytest.mark.parametrize("M", [2, 4])
def test_tp_ssm_storage_order_round_trip(M):
    """``to_storage_order`` then ``from_storage_order`` is the identity,
    and model slice m of the stored ``in_proj`` is z_m | x_m | B_m | C_m
    | dt_m, what ``compute_slice`` takes apart again."""
    import torch
    from repro_torch.sharding import rules
    cfg = _tcfg()
    layout = rules.TPLayout(cfg, M)
    di, gn, h = layout.ssm_widths()
    W = 2 * di + 2 * gn + h
    full = torch.arange(3 * W, dtype=torch.float32).reshape(3, W)
    path = ("blocks", "ssm_in_proj")
    stored = layout.to_storage_order(path, full)
    assert torch.equal(layout.from_storage_order(path, stored), full)
    w = W // M
    for m in range(M):
        sl = stored[:, m * w:(m + 1) * w]
        dm, gm, hm = di // M, gn // M, h // M
        want = torch.cat([full[:, m * dm:(m + 1) * dm],
                          full[:, di + m * dm:di + (m + 1) * dm],
                          full[:, 2 * di + m * gm:2 * di + (m + 1) * gm],
                          full[:, 2 * di + gn + m * gm:
                               2 * di + gn + (m + 1) * gm],
                          full[:, 2 * di + 2 * gn + m * hm:
                               2 * di + 2 * gn + (m + 1) * hm]], 1)
        assert torch.equal(sl, want)
        got = layout.compute_slice("ssm_in_proj", full, m)
        assert torch.equal(got[:, :2 * dm], want[:, :2 * dm])
        assert torch.equal(got[:, 2 * dm:2 * dm + 2 * gn],
                           full[:, 2 * di:2 * di + 2 * gn])
    conv = torch.arange(di + 2 * gn, dtype=torch.float32)
    path = ("blocks", "ssm_conv_b")
    assert torch.equal(layout.from_storage_order(
        path, layout.to_storage_order(path, conv)), conv)


@pytest.mark.parametrize("changes,numbers", [
    (dict(ssm_heads=6), ("ssm_heads 6", "16")),
    (dict(ssm_state=10), ("ssm_heads 4", "ssm_state 10"))])
def test_tp_ssm_refuses_a_split_that_does_not_divide(changes, numbers):
    from repro_torch.sharding import rules
    cfg = _tcfg(**changes)
    with pytest.raises(ValueError) as e:
        rules.TPLayout(cfg, 4)
    for s in numbers:
        assert s in str(e.value)


@pytest.mark.parametrize("M,groups", [(2, 1), (4, 1), (4, 2)])
def test_tp_ssm_block_partials_sum_to_the_whole_block(M, groups):
    """One Mamba2 block's M coordinates computed in turn in one process
    (``compute_slice`` weights, a ``ModelAxis`` with identity f and g),
    the gate norm's statistic given to each coordinate as the sum of a
    first pass's statistics (so gradients flow through both passes), the
    partial outputs summed: the whole block's output, input gradient and
    every leaf's gradient in f32.  Two groups at M = 4 give each rank one
    head of its own group."""
    import torch
    from repro_torch.models import ssd as tssd
    from repro_torch.models.model import _block_shapes, _take
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    cfg = _tcfg(ssm_groups=groups)
    layout = rules.TPLayout(cfg, M)
    gen = torch.Generator().manual_seed(0)
    row = {k: (torch.randn(s, generator=gen) * 0.3)
           for k, s in _block_shapes(cfg, "ssm").items()}
    x = torch.randn((2, 32, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
    xin = x.clone().requires_grad_()
    want, _ = tssd.mamba2_fwd(_take(leaves, "ssm_"), xin, cfg)
    want_g = torch.autograd.grad(want, [xin, *leaves.values()], dy)

    leaves = {k: v.clone().requires_grad_() for k, v in row.items()}
    xin = x.clone().requires_grad_()
    stats = []

    def record(s):
        stats.append(s)
        return s
    slices = [{k: layout.compute_slice(k, v, m) for k, v in leaves.items()}
              for m in range(M)]
    for m in range(M):                        # pass 1: each statistic
        tssd.mamba2_fwd(_take(slices[m], "ssm_"), xin, cfg,
                        tp=ModelAxis(layout, m, reduce_stat=record))
    total = sum(stats)
    got = sum(tssd.mamba2_fwd(_take(slices[m], "ssm_"), xin, cfg,
                              tp=ModelAxis(layout, m,
                                           reduce_stat=lambda s: total))[0]
              for m in range(M))
    got_g = torch.autograd.grad(got, [xin, *leaves.values()], dy)
    pairs = zip(["out", "x", *leaves], [got.detach(), *got_g],
                [want.detach(), *want_g])
    for name, a, b in pairs:    # f32 sums in another order: relative to
        assert float((a - b).abs().max()) <= 5e-5 * float(b.abs().max()), \
            name                # the tensor's largest magnitude
