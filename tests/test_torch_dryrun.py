"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
``repro/launch/dryrun.py`` and against real worlds, on the CPU.

* host-side parity: ``pick_zero3``, ``window_for``, the parameter counts,
  tokens, model FLOPs, the ``opts`` naming with ``--sel-frac`` and the
  report's file name, for every assigned arch × shape × mesh, equal to the
  reference's (computed in a subprocess: importing the reference's dry run
  sets ``XLA_FLAGS`` for 512 host devices, which this worker must not
  inherit);
* the fake world against a real one: reduced TinyLlama and Mamba2 on a
  data 2 × model 2 mesh, the train step, prefill and decode run on rank 0
  of a fake world (meta) and of a gloo world of 4 (seeded CPU tensors),
  both on the kernels' plain versions: equal FLOPs, argument bytes and
  collectives by kind (counts and bytes), HBM traffic equal but for
  gloo's own copy of each reduce-scatter's result;
* the kernels' meta route: outputs of the plain route's shapes and types,
  the same launches and recorder reports as the CUDA route, and a CPU run
  that neither launches nor reports;
* the live-bytes tracker's peak on a hand-built program;
* the same with tensor parallelism over ``model`` (``tp_constraints``):
  TinyLlama's and Mamba2's three programs, and the moe family's train
  step, prefill and decode (DeepSeek's experts split by expert, Grok's on
  ff), fake world against gloo;
* full-width TinyLlama ``train_4k`` on the 16 × 16 fake world: argument
  bytes equal to rank 0's shards computed from the rules, collectives by
  kind derived from the layer layout; with ``--opt`` (tensor parallelism)
  the dense family's ``train_4k`` per device: FLOPs, useful share and
  argument bytes against the replicated step's;
* PaliGemma's and whisper's three programs and DeepSeek's train step
  (MLA split by heads) under tensor parallelism on the fake world: their
  model-axis collectives counted from the layout;
* the refusals: ``--opt`` on a classifier (XLM-R), a dry
  mesh inside an existing world, and the world torn down after a
  failure; the CLI's JSON.

Every fake or gloo world runs in a process of its own
(``tests/_torch_dist.py``): a process group is process-global.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from repro_torch.analysis import facts as tfacts
from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                      RuntimeConfig, get_arch)
from repro_torch.kernels import delta_matmul as dmm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import layer_grad_norm as lgn
from repro_torch.kernels import masked_update as mu
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun as D
from repro_torch.models.model import init_params
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map

from _torch_dist import run_dry, run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# (tp_constraints & the other --opt levers, sel_frac)
OPTS = ((False, 0.0), (False, 0.25), (True, 0.0), (True, 0.25))


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# host-side parity with the reference
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import json, sys
    from types import SimpleNamespace
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch import dryrun as D     # sets XLA_FLAGS: its own process
    from repro.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                    RuntimeConfig, get_arch)
    from repro.models.model import init_params
    meshes = json.loads(sys.argv[1])
    opts = json.loads(sys.argv[2])
    out = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_arch(arch)
        shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        # the reference's lower_pair, lines 114-127, as written there
        n_params = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes))
        if cfg.n_experts:
            expert_frac = cfg.top_k / cfg.n_experts
            e_sizes = sum(int(np.prod(l.shape))
                          for p, l in jax.tree_util.tree_flatten_with_path(
                              shapes)[0]
                          if any(str(getattr(q, "key", "")).endswith(
                              ("wi_e", "wo_e")) for q in p))
            n_active = int(n_params - e_sizes + e_sizes * expert_frac)
        else:
            n_active = n_params
        row = {"n_params": n_params, "n_active": n_active, "zero3": {},
               "shapes": {}, "names": {}}
        for mname, mshape in meshes.items():
            row["zero3"][mname] = bool(D.pick_zero3(
                cfg, SimpleNamespace(shape=mshape)))
        for sname, shape in INPUT_SHAPES.items():
            tokens = (shape.global_batch if shape.kind == "decode"
                      else shape.global_batch * shape.seq_len)
            factor = 6 if shape.kind == "train" else 2
            row["shapes"][sname] = {
                "window": D.window_for(cfg, shape), "tokens": tokens,
                "model_flops": factor * n_active * tokens}
        for opt, sel_frac in opts:
            runtime = RuntimeConfig()
            if opt:
                runtime = RuntimeConfig(tp_constraints=True,
                                        remat_scores=True,
                                        moe_local_dispatch=True,
                                        sel_upload=sel_frac > 0)
            sel_idx = None
            if sel_frac > 0:
                L = cfg.n_layers - cfg.first_dense
                R = max(1, int(round(L * sel_frac)))
                sel_idx = tuple(range(L - R, L))
            o = []
            if runtime.tp_constraints:
                o.append("tp")
            if runtime.remat_scores:
                o.append("rematsc")
            if runtime.sel_upload and sel_idx is not None:
                o.append(f"sel{len(sel_idx)}")
            if runtime.moe_local_dispatch:
                o.append("moelocal")
            suffix = ("__" + "-".join(o)) if o else ""
            row["names"][f"{opt}-{sel_frac}"] = {
                "opts": o, "sel_idx": sel_idx and list(sel_idx),
                "file": {m: f"{arch}__train_4k__{m}{suffix}.json"
                         for m in meshes}}
        out[arch] = row
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_host():
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(MESHES),
         json.dumps(OPTS)], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_host_side_matches_reference(arch, reference_host):
    want = reference_host[arch]
    cfg = get_arch(arch)
    n_params, n_active = D.param_counts(cfg)
    assert (n_params, n_active) == (want["n_params"], want["n_active"])
    for mname, mshape in MESHES.items():
        assert D.pick_zero3(cfg, SimpleNamespace(shape=mshape)) \
            == want["zero3"][mname], mname
    for sname, shape in INPUT_SHAPES.items():
        w = want["shapes"][sname]
        assert D.window_for(cfg, shape) == w["window"], sname
        assert D.tokens_of(shape) == w["tokens"], sname
        assert D.model_flops(shape, n_active) == w["model_flops"], sname
    for opt, sel_frac in OPTS:
        runtime = (RuntimeConfig(tp_constraints=True, remat_scores=True,
                                 moe_local_dispatch=True,
                                 sel_upload=sel_frac > 0)
                   if opt else RuntimeConfig())
        w = want["names"][f"{opt}-{sel_frac}"]
        sel_idx = D.sel_indices(cfg, sel_frac)
        assert (list(sel_idx) if sel_idx else None) == w["sel_idx"]
        opts = D.opts_of(runtime, sel_idx)
        assert opts == w["opts"]
        for m in MESHES:
            assert D.report_name(arch, "train_4k", m, opts) == w["file"][m]


# ---------------------------------------------------------------------------
# the fake world against a real (gloo) one
# ---------------------------------------------------------------------------

WORLD = {"data": 2, "model": 2}
SHAPES = {"train": ("train_4k", 32, 4, "train"),
          "prefill": ("prefill_32k", 32, 4, "prefill"),
          "decode": ("decode_32k", 64, 4, "decode")}
PAIRS = [(a, k) for a in ("tinyllama_1_1b", "mamba2_370m") for k in SHAPES]


def _facts_case(arch, kind, tp=False, **moe) -> dict:
    return {"kind": "dryrun_facts", "name": f"{arch}/{kind}", "arch": arch,
            "shape": SHAPES[kind], "zero3": True, "kernel_mode": "torch",
            "tp": tp, **moe}


TP_PAIRS = [(a, k) for a in ("tinyllama_1_1b", "mamba2_370m") for k in SHAPES]
# the moe family under --opt's dispatch (per sample), plain and under
# tensor parallelism: DeepSeek expert-parallel (4 experts over 2), Grok's 3
# experts split on ff
MOE_PAIRS = [("deepseek_v2_lite_16b", "train"),
             ("deepseek_v2_lite_16b", "prefill"), ("grok_1_314b", "train"),
             ("grok_1_314b", "decode")]
MOE_EXPERTS = {"deepseek_v2_lite_16b": 4, "grok_1_314b": 3}


def _moe_case(arch, kind, tp):
    return _facts_case(arch, kind, tp=tp, local=True,
                       experts=MOE_EXPERTS[arch])


@pytest.fixture(scope="module")
def worlds():
    """Rank 0's facts of each pair on the fake world and on gloo (PAIRS,
    then TP_PAIRS under tensor parallelism, then MOE_PAIRS plain and under
    it), and the gloo ranks' answer to a dry mesh asked for inside their
    world."""
    cases = ([_facts_case(a, k) for a, k in PAIRS]
             + [_facts_case(a, k, tp=True) for a, k in TP_PAIRS]
             + [_moe_case(a, k, tp) for tp in (False, True)
                for a, k in MOE_PAIRS])
    dry = run_dry(WORLD, cases)
    real = run_world(4, WORLD, cases + [{"kind": "dry_refused"}])
    return dry, real


@pytest.mark.parametrize("arch,kind", PAIRS)
def test_fake_world_matches_gloo(arch, kind, worlds):
    dry, real = worlds
    assert dry["error"] is None and not dry["initialized_after"]
    i = PAIRS.index((arch, kind))
    fake, gloo = dry["results"][i], real[0][i]
    assert real[0][i]["coords"] == {"data": 0, "model": 0}
    assert fake["zero3"] and gloo["zero3"]
    f, g = fake["facts"], gloo["facts"]
    assert f["flops"] > 0 and f["flops"] == g["flops"]
    assert f["arg_bytes"] == g["arg_bytes"]
    # gloo copies each reduce-scatter's result into its output when the
    # caller waits on it (an ATen ``copy_`` the audit sees: output bytes
    # read and written); the fake backend moves nothing
    rs_out = f["collective_by_kind"].get("reduce-scatter", 0) / WORLD["data"]
    assert f["hbm_bytes"] > 0 and g["hbm_bytes"] - f["hbm_bytes"] == 2 * rs_out
    assert f["collective_counts"] == g["collective_counts"]
    assert f["collective_by_kind"] == g["collective_by_kind"]
    assert f["collective_bytes"] == g["collective_bytes"]
    assert f["kernel_launches"] == g["kernel_launches"] == {}
    # ZeRO-3 storage: every program gathers; training reduce-scatters
    assert f["collective_counts"]["all-gather"] > 0
    assert ("reduce-scatter" in f["collective_counts"]) == (kind == "train")
    assert f["temp_bytes"] > 0 and g["temp_bytes"] == 0


def _held_tp(arch, kind, worlds, i=None, plain_i=None):
    dry, real = worlds
    assert dry["error"] is None
    if i is None:
        i = len(PAIRS) + TP_PAIRS.index((arch, kind))
        plain_i = PAIRS.index((arch, kind))
    f, g = dry["results"][i]["facts"], real[0][i]["facts"]
    plain = dry["results"][plain_i]["facts"]
    assert f["flops"] > 0 and f["flops"] == g["flops"]
    assert f["flops"] < plain["flops"]
    assert f["arg_bytes"] == g["arg_bytes"] < plain["arg_bytes"]
    assert f["collective_counts"] == g["collective_counts"]
    assert f["collective_by_kind"] == g["collective_by_kind"]
    assert f["collective_bytes"] == g["collective_bytes"]
    assert (f["collective_counts"]["all-reduce"]
            > plain["collective_counts"].get("all-reduce", 0))


@pytest.mark.parametrize("kind", list(SHAPES))
def test_fake_world_matches_gloo_tp(kind, worlds):
    """Tensor parallelism over ``model`` (reduced TinyLlama, heads split
    over 2): the fake world's FLOPs, argument bytes and collectives by
    kind are the gloo world's, and the model-axis all-reduces are there
    (f, g, the vocab-parallel embedding and cross-entropy)."""
    _held_tp("tinyllama_1_1b", kind, worlds)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_fake_world_matches_gloo_tp_mamba2(kind, worlds):
    """The same for reduced Mamba2 split by SSD heads over 2 (B | C
    all-gathered over ``model``, the gate norm's statistic all-reduced)."""
    _held_tp("mamba2_370m", kind, worlds)


@pytest.mark.parametrize("arch,kind", MOE_PAIRS)
def test_fake_world_matches_gloo_tp_moe(arch, kind, worlds):
    """The same for the moe family with per-sample dispatch, as ``--opt``
    runs it: DeepSeek's experts split by expert and MLA replicated (its
    leaves all-gathered over ``model``), Grok's experts on ff with its
    heads split; the plain program's counts fake against gloo too."""
    dry, real = worlds
    base = len(PAIRS) + len(TP_PAIRS)
    j = MOE_PAIRS.index((arch, kind))
    f, g = dry["results"][base + j]["facts"], real[0][base + j]["facts"]
    assert f["flops"] == g["flops"]
    assert f["collective_counts"] == g["collective_counts"]
    _held_tp(arch, kind, worlds, i=base + len(MOE_PAIRS) + j,
             plain_i=base + j)
    # MLA's leaves all-gathered over ``model``; serving gathers the
    # vocab-parallel logits
    tp = dry["results"][base + len(MOE_PAIRS) + j]["facts"]
    more = arch == "deepseek_v2_lite_16b" or kind != "train"
    assert (tp["collective_counts"]["all-gather"]
            > f["collective_counts"]["all-gather"]) == more


# PaliGemma (prefix-LM, one kv head: "kv_shared" at 2), DeepSeek (MLA
# split by heads) and whisper (2 encoder rows and 3 decoder rows, "heads"
# at 2 in self- and cross-attention, the vocabulary of 512 split) under
# tensor parallelism, 3 layers, on the fake world only
VLM_MLA = ([("paligemma_3b", k) for k in SHAPES]
           + [("deepseek_v2_lite_16b", "train")]
           + [("whisper_medium", k) for k in SHAPES])


@pytest.fixture(scope="module")
def vlm_mla():
    """Rank 0's facts of each VLM_MLA pair on the fake (2, 2) world, plain
    and under tensor parallelism (the moe one with per-sample
    dispatch)."""
    cases = [_facts_case(a, k, tp=tp, layers=3,
                         **({"local": True, "experts": 4}
                            if a.startswith("deepseek") else {}))
             for a, k in VLM_MLA for tp in (False, True)]
    dry = run_dry(WORLD, cases)
    assert dry["error"] is None and not dry["initialized_after"]
    return {pair: (dry["results"][2 * i]["facts"],
                   dry["results"][2 * i + 1]["facts"])
            for i, pair in enumerate(VLM_MLA)}


@pytest.mark.parametrize("arch,kind", VLM_MLA[:-len(SHAPES)])
def test_dry_run_tp_counts_of_paligemma_and_mla(arch, kind, vlm_mla):
    """Host-side counts of the split programs against the plain ones on
    the fake world: FLOPs and argument bytes down, the model-axis
    all-reduces there, and exactly the model-axis all-gathers the layout
    implies, per 3 rows: PaliGemma's ``wk`` and ``wv`` (its one kv head
    shared by 2 ranks: reduce-scatter backward) and ``patch_proj`` once a
    step, and the logits' gather when serving; DeepSeek's ``w_dkv`` and
    ``w_krope`` (MLA's latent, whole on every rank: own-slice backward, no
    reduce-scatter), no longer every attention leaf."""
    plain, tp = vlm_mla[arch, kind]
    rows = 3
    assert tp["flops"] < plain["flops"]
    assert tp["arg_bytes"] < plain["arg_bytes"]
    assert (tp["collective_counts"]["all-reduce"]
            > plain["collective_counts"].get("all-reduce", 0))
    more = tp["collective_counts"]["all-gather"] - \
        plain["collective_counts"]["all-gather"]
    more_rs = tp["collective_counts"].get("reduce-scatter", 0) - \
        plain["collective_counts"].get("reduce-scatter", 0)
    if arch == "paligemma_3b":
        assert more == 2 * rows + 1 + (kind != "train")
        assert more_rs == (2 * rows if kind == "train" else 0)
        return
    assert more == 2 * rows and more_rs == 0
    # the heads, experts and MLP split over 2; the routers, the latent
    # projections and the head's vocabulary remainder stay whole
    assert tp["flops"] <= 0.52 * plain["flops"]


@pytest.mark.parametrize("kind", list(SHAPES))
def test_dry_run_tp_counts_of_whisper(kind, vlm_mla):
    """Host-side counts of whisper's split programs (E = 2 encoder rows,
    D = 3 decoder rows, "heads" at 2) against the plain ones on the fake
    world: FLOPs halved but for the few whole leaves, argument bytes
    down; exactly the model-axis all-reduces the layout implies — g after
    each split sub-block (2 an encoder row, 3 a decoder row: self-,
    cross-attention, MLP), the vocab-parallel embedding's sum, and in
    training f's backward of each (as many), the one f on the encoder's
    output and the vocab-parallel cross-entropy's f, max and sums — and
    one more all-gather (``frame_proj`` whole once a step), two when
    serving (the logits); the ZeRO-3 reduce-scatters unchanged."""
    plain, tp = vlm_mla["whisper_medium", kind]
    E, D = 2, 3
    assert tp["flops"] < 0.52 * plain["flops"]
    assert tp["arg_bytes"] < 0.52 * plain["arg_bytes"]
    # the g's and the embedding's; decode runs no encoder row (its cross
    # cache is filled)
    g = 2 * E * (kind != "decode") + 3 * D + 1
    if kind == "train":
        g = 2 * g - 1 + 1 + 3              # f's, the encoder's f, the CE
    assert (tp["collective_counts"]["all-reduce"]
            - plain["collective_counts"].get("all-reduce", 0)) == g
    assert (tp["collective_counts"]["all-gather"]
            - plain["collective_counts"]["all-gather"]) == 1 + (
                kind != "train")
    assert tp["collective_counts"].get("reduce-scatter", 0) == \
        plain["collective_counts"].get("reduce-scatter", 0)


def test_dry_mesh_refused_inside_a_world(worlds):
    _, real = worlds
    for rank in real:
        got = rank[-1]
        assert "already runs a 'gloo' world of 4" in got["error"]
        assert got["backend"] == "gloo" and got["world"] == 4


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def launched(self, kernel, flops, weights, nbytes):
        self.calls.append((kernel, flops,
                           sum(w.numel() * w.element_size() for w in weights),
                           nbytes))


@pytest.fixture
def card_stubs(monkeypatch):
    """The launches replaced by the allocations the kernels make (their
    shared buffer helpers) on the CPU, so ``mode="cuda"`` reaches each
    wrapper's launch branch and reports what the card's would."""
    monkeypatch.setattr(fa, "flash_attention", fa.flash_attention_meta)
    monkeypatch.setattr(fa, "flash_attention_bwd", fa.flash_attention_bwd_meta)
    monkeypatch.setattr(ssd, "ssd_scan", ssd.ssd_scan_meta)
    monkeypatch.setattr(lgn, "layer_sq_norms_2d", lgn.layer_sq_norms_2d_meta)
    monkeypatch.setattr(mu, "masked_sgd_update_2d",
                        mu.masked_sgd_update_2d_meta)
    monkeypatch.setattr(dmm, "base_delta_matmul_2d",
                        dmm.base_delta_matmul_2d_meta)


def _drive(kernel: str, device: str, mode=None):
    """One call of ``kernel``'s wrapper at fixed shapes on ``device`` (the
    flash case runs its backward too); returns its outputs."""
    dev = torch.device(device)
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)
    if kernel == "flash_attention":
        q = rnd(2, 64, 4, 16, dtype=torch.bfloat16).requires_grad_()
        k, v = rnd(2, 64, 2, 16, dtype=torch.bfloat16), \
            rnd(2, 64, 2, 16, dtype=torch.bfloat16)
        out = ops.flash_attention(q, k, v, causal=True, window=16,
                                  mode=mode)
        (dq,) = torch.autograd.grad(out, q, torch.ones_like(out))
        return [out, dq]
    if kernel == "ssd_scan":
        b, s, h, p, n = 2, 64, 4, 16, 16
        return [ops.ssd(rnd(b, s, h, p, dtype=torch.bfloat16),
                        rnd(b, s, h).abs(), rnd(h), rnd(b, s, 1, n),
                        rnd(b, s, 1, n), rnd(h), chunk=16, mode=mode)]
    if kernel == "layer_grad_norm":
        return [ops.layer_grad_norms({"a": rnd(3, 5, 7), "b": rnd(3, 70000)},
                                     mode=mode)]
    if kernel == "masked_update":
        p = {"a": rnd(3, 5, 7, dtype=torch.bfloat16), "b": rnd(3, 11)}
        gr = {"a": rnd(3, 5, 7, dtype=torch.bfloat16), "b": rnd(3, 11)}
        out = ops.masked_sgd_update(p, gr, rnd(3), 0.1, mode=mode)
        return [out["a"], out["b"]]
    x, w = rnd(3, 1, 512), rnd(512, 40)
    dw = rnd(4, 512, 40)
    slots = torch.tensor([0, 2, -1, 1], dtype=torch.int32, device=dev)
    return [ops.base_delta_matmul(x, w, dw, slots, mode=mode)]


KERNELS = ("flash_attention", "ssd_scan", "layer_grad_norm",
           "masked_update", "base_delta_matmul")


@pytest.mark.parametrize("kernel", KERNELS)
def test_meta_route_matches_cuda_and_plain_routes(kernel, card_stubs,
                                                  monkeypatch):
    def run(device, mode=None):
        rec = _Recorder()
        monkeypatch.setattr(ops, "RECORDER", rec)
        ops.reset_launches()
        outs = _drive(kernel, device, mode)
        return outs, rec.calls, dict(ops.LAUNCHES)
    meta, meta_calls, meta_launches = run("meta")
    card, card_calls, card_launches = run("cpu", "cuda")
    plain, plain_calls, plain_launches = run("cpu")
    assert all(t.is_meta for t in meta)
    assert [(t.shape, t.dtype) for t in meta] \
        == [(t.shape, t.dtype) for t in plain]
    assert meta_calls == card_calls and meta_calls
    assert all(c[0].startswith(kernel.split("_attention")[0])
               for c in meta_calls)
    assert meta_launches == card_launches and meta_launches[kernel] > 0
    assert plain_calls == [] and not any(plain_launches.values())
    # bytes moved: each launch's inputs read once, outputs written once
    assert all(c[3] > 0 for c in meta_calls)


def test_meta_route_reports_the_bounds_work(card_stubs, monkeypatch):
    """The flash reports on meta carry ``flash_flops`` and the bytes of q,
    k, v, o and lse (forward), and of q, k, v, o, lse, dO, dq, dk, dv
    (backward)."""
    rec = _Recorder()
    monkeypatch.setattr(ops, "RECORDER", rec)
    _drive("flash_attention", "meta")
    B, S, H, K, D_ = 2, 64, 4, 2, 16
    bf, f32 = 2, 4
    q = B * S * H * D_ * bf
    kv = B * S * K * D_ * bf
    lse = B * H * S * f32
    assert rec.calls == [
        ("flash_attention", ops.flash_flops(B, H, D_, S, True, 16), 0,
         q + 2 * kv + q + lse),
        ("flash_attention_bwd",
         ops.flash_flops(B, H, D_, S, True, 16, backward=True), 0,
         q + 2 * kv + q + lse + q + q + 2 * kv)]


# ---------------------------------------------------------------------------
# the live-bytes tracker
# ---------------------------------------------------------------------------

def test_live_bytes_peak_on_a_hand_built_program():
    def prog(x):
        a = x.new_empty(1000)          # 4000 bytes
        b = x.new_empty(500)           # 2000: 6000 live
        del a                          # 2000
        c = x.new_empty(2000)          # 8000: 10000 live, the peak
        view = c[:10].view(2, 5)       # a view: no new storage
        del b                          # 8000
        return (view * 2).sum()        # 40 + 4 bytes: 8044
    f = tfacts.extract_facts("live", prog, (torch.empty(3, device="meta"),))
    assert f.temp_bytes == 10000
    f = tfacts.extract_facts("cpu", prog, (torch.empty(3),))
    assert f.temp_bytes == 0          # the CPU keeps no peak


def test_live_bytes_count_what_autograd_saves():
    """A tensor saved for the backward stays live after the forward drops
    its name; the peak holds it beside the gradient."""
    def prog(w):
        h = w * 2                      # 400 bytes, saved by exp
        y = h.exp()                    # 400, saved as exp's result
        del h
        loss = y.sum()                 # 4
        (g,) = torch.autograd.grad(loss, w)
        return g
    w = torch.empty(100, device="meta", requires_grad=True)
    f = tfacts.extract_facts("saved", prog, (w,))
    assert 1204 <= f.temp_bytes <= 2004


# ---------------------------------------------------------------------------
# full-width TinyLlama train_4k on the 16 × 16 fake world
# ---------------------------------------------------------------------------

TP_ARCHS = ("tinyllama_1_1b", "smollm_360m", "codeqwen1_5_7b", "gemma_7b")


@pytest.fixture(scope="module")
def full_width():
    """``train_4k`` on 16 × 16: TinyLlama as laid out by default, then the
    dense family with ``--opt`` (TP_ARCHS), then a planned failure."""
    return run_dry({"data": 16, "model": 16}, [
        {"kind": "dryrun_pair", "arch": "tinyllama_1_1b",
         "shape": "train_4k"}] + [
        {"kind": "dryrun_pair", "arch": a, "shape": "train_4k", "opt": True}
        for a in TP_ARCHS] + [
        {"kind": "fail", "message": "a planned failure"}])


def test_full_width_train_4k_argument_bytes(full_width):
    """Argument bytes = rank 0's shard of every param leaf (its spec's
    client-axis dim split over those axes) + its client's batch rows, mask
    row and size."""
    rep = full_width["results"][0]
    cfg = get_arch("tinyllama_1_1b")
    shape = INPUT_SHAPES["train_4k"]
    mesh_shape = {"data": 16, "model": 16}
    shapes = init_params(cfg, None, torch.device("meta"))
    specs = rules.params_pytree_specs(cfg, shapes, zero3=rep["zero3"],
                                      mesh_shape=mesh_shape)

    def shard_bytes(leaf, spec):
        """The leaf's bytes over the product of the client axes of the
        first spec entry naming any (``model`` holds a leaf whole)."""
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            axes = [a for a in names if a in ("pod", "data")]
            if axes:
                return (leaf.numel() // math.prod(mesh_shape[a] for a in axes)
                        * leaf.element_size())
        return leaf.numel() * leaf.element_size()
    total = sum(tree_leaves(tree_map(shard_bytes, shapes, specs)))
    clients = 16
    total += shape.global_batch // clients * shape.seq_len * 4   # tokens
    total += cfg.n_layers * 4 + 4                                # mask, size
    assert rep["memory"]["argument_bytes"] == total
    assert rep["n_chips"] == 256 and rep["mesh"] == "16x16"
    assert rep["unrolled_cost_analysis"]["arg_bytes"] == total


def test_full_width_train_4k_collectives(full_width):
    """TinyLlama's 2.2 GB over 16 model ranks stays under the ZeRO-3
    threshold, so the base is replicated: no all-gather, no reduce-scatter.
    All-reduces, per device: one for Eq.(7)'s (L,) f32 denominators, one
    per ``blocks`` leaf for its f32 gradient's Eq.(5) sum over ``data``
    (no gather to differentiate into a reduce-scatter), and two for the
    metrics (the f32 loss, the (L,) f32 mask union): 1 + 8 + 2 = 11, of
    4·(L + Σ blocks elements + 1 + L) bytes each device, × 256 devices in
    the report.  The kernels: each layer's flash forward twice (the
    forward, and its rerun under activation checkpointing), its backward
    once."""
    rep = full_width["results"][0]
    cfg = get_arch("tinyllama_1_1b")
    L = cfg.n_layers
    blocks = init_params(cfg, None, torch.device("meta"))["blocks"]
    assert not rep["zero3"]
    assert rep["collective_counts"] == {"all-reduce": 1 + len(blocks) + 2}
    per_device = 4 * (L + sum(t.numel() for t in blocks.values()) + 1 + L)
    assert rep["collective_by_kind"] == {"all-reduce": 256 * per_device}
    assert rep["collective_bytes"] == 256 * per_device
    assert rep["kernel_launches"] == {"flash_attention": 2 * L,
                                      "flash_attention_bwd": L}
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["model_flops"] == 6 * rep["n_active_params"] * rep["tokens"]
    assert rep["flops"] == rep["unrolled_cost_analysis"]["flops"] * 256
    assert 0 < rep["useful_flops_frac"] < 1


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_full_width_train_4k_tensor_parallel(full_width, arch):
    """``--opt`` splits each client's step over the 16 ranks of
    ``model``: rank 0 stores a 16th of the params (under an eighth of the
    replicated copy), the model-axis all-reduces are listed, and but for
    SmolLM (15 heads: attention replicated) the useful share of the
    per-device FLOPs is at least 0.5; TinyLlama's FLOPs are under an
    eighth of the replicated step's."""
    rep = full_width["results"][1 + TP_ARCHS.index(arch)]
    assert rep["opts"] == ["tp", "rematsc", "moelocal"]
    assert not rep["zero3"] and rep["n_chips"] == 256
    shapes = init_params(get_arch(arch), None, torch.device("meta"))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(shapes))
    assert rep["memory"]["argument_bytes"] <= nbytes / 8
    # f and g around each split sub-block: attention and the MLP, or the
    # MLP alone where attention is replicated
    split = 1 if arch == "smollm_360m" else 2
    assert rep["collective_counts"]["all-reduce"] > get_arch(
        arch).n_layers * 2 * split
    if arch == "smollm_360m":
        assert "all-gather" in rep["collective_counts"]  # attention leaves
        assert rep["useful_flops_frac"] > 0
        return
    assert rep["useful_flops_frac"] >= 0.5
    if arch == "tinyllama_1_1b":
        plain = full_width["results"][0]
        assert rep["flops"] <= plain["flops"] / 8
        assert rep["memory"]["argument_bytes"] <= 0.2e9
        assert rep["kernel_launches"] == plain["kernel_launches"]


def test_dry_world_torn_down_after_a_failure(full_width):
    assert "a planned failure" in full_width["error"]
    assert full_width["initialized_after"] is False


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, tmp) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp)], env=_env(), capture_output=True, text=True,
        timeout=300)


def test_cli_writes_the_named_report(tmp_path):
    r = _cli("--arch", "mamba2_370m", "--shape", "long_500k", tmp=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    path = tmp_path / "mamba2_370m__long_500k__16x16.json"
    rep = json.loads(path.read_text())
    assert rep["arch"] == "mamba2_370m" and rep["kind"] == "decode"
    assert set(rep["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert "compile_s" not in rep and rep["opts"] == []


def test_cli_opt_writes_the_tensor_parallel_report(tmp_path):
    """``--opt`` on the dense family builds the tensor-parallel programs
    and writes the report under the reference's name."""
    r = _cli("--arch", "tinyllama_1_1b", "--shape", "decode_32k", "--opt",
             tmp=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    path = tmp_path / ("tinyllama_1_1b__decode_32k__16x16__"
                       "tp-rematsc-moelocal.json")
    rep = json.loads(path.read_text())
    assert rep["opts"] == ["tp", "rematsc", "moelocal"]
    assert rep["collective_counts"]["all-reduce"] > 0


def test_cli_opt_raises_for_a_family_without_tensor_parallelism(tmp_path):
    """``--opt`` on a classifier (XLM-R, of the dense family) raises,
    naming it, and writes no report."""
    r = _cli("--arch", "xlm_roberta_base", "--shape", "train_4k",
             "--opt", tmp=tmp_path)
    assert r.returncode != 0
    assert "tensor parallelism over the 'model' axis" in r.stderr
    assert "'dense' family's classifier xlm-roberta-base" in r.stderr
    assert not list(tmp_path.iterdir())
