#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
source, all at once), then, failing with a non-zero exit on any mismatch:

1. prints the environment and the card's name and power limit;
2. holds each kernel against its plain PyTorch version at the shapes the
   main path gives it, and times kernel, plain version and the nearest
   PyTorch library call with CUDA events, beside the least time the card
   could take (its bound);
3. serves full-width TinyLlama-1.1B (22 layers, random weights, seed 0)
   through ``SlotServer`` in delta mode, counting kernel launches; repeats
   with the plain version forced, then in shared and dense mode;
4. checks, at reduced depth in f32, that delta-mode generations equal
   decoding each request alone against the user's materialised parameters;
5. holds the training kernels (``layer_grad_norm``, ``masked_update``)
   against their plain versions at TinyLlama's eight block leaves and
   times them likewise;
6. runs three rounds of Algorithm 1 ("ours": probe, (P1) select, masked
   τ-step update, Eq.(5)-(7) aggregate, eval) at full TinyLlama-1.1B width
   through ``Experiment.run``, counting kernel launches, then replays round
   0 stage by stage against the plain versions and the dense program;
7. checks, on reduced xlm-roberta in f32, that two rounds on the card and
   on the CPU choose the same cohorts and masks and reach the same params;
8. prints one JSON line of per-kernel results, the card's name and power
   limit, and a last JSON line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Exits non-zero without a
card, or when the port's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# Logits after 22 bf16 layers: kernel and plain version round each
# projection to bf16 after summing in different orders, and a one-ulp
# difference (2**-8 relative) in one layer's output carries into the next,
# so the two bf16 paths part by ~2% (norm-wise) with no fault in either.
# Both are held against the same step in f32: the kernel path's error may
# be at most E2E_ERR_RATIO times the plain path's.
E2E_ERR_RATIO = 1.5
REPS = 30


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from repro_torch.kernels import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        paths = list(ex.map(_build.compile_kernel, names))
    log(f"[build] {len(names)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s: {[p.name for p in paths]}")
    for p in paths:
        report = p.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {line.strip()}")


def time_ms(fn, flush) -> float:
    """Median time of ``fn`` on the card over REPS runs, each after a write
    of ``flush`` (larger than the 50 MB L2), as a decode step finds its
    weights cold."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(REPS):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def delta_mm_bound(B, d, f, n_active, xdt, wdt) -> tuple[float, str]:
    """Least time in ms for one base+delta projection: the larger of its
    bytes over HBM bandwidth and its operations over the peak rate of
    their type (the base product in the weights' type, corrections f32)."""
    import torch
    xs = torch.tensor([], dtype=xdt).element_size()
    ws = torch.tensor([], dtype=wdt).element_size()
    nbytes = d * f * ws + n_active * d * f * 4 + B * d * xs + B * f * xs
    t_bytes = nbytes / HBM_BYTES_PER_S
    wname = "bfloat16" if wdt == torch.bfloat16 else "float32"
    t_ops = (2 * B * d * f / PEAK_OPS_PER_S[wname]
             + 2 * n_active * d * f / PEAK_OPS_PER_S["float32"])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(card: str) -> dict:
    """Kernel vs plain version at TinyLlama's six projection shapes."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import delta_matmul as dmm
    from repro_torch.models.model import _block_shapes

    cfg = get_arch("tinyllama_1_1b")
    mats = [(name, shp) for name, shp in _block_shapes(cfg, "dense").items()
            if len(shp) == 2]
    B, C = 4, 4
    slots = torch.tensor([1, -1, 3, -1], dtype=torch.int32, device="cuda")
    n_active = 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def inputs(d, f, dt):
        x = torch.randn((B, d), generator=gen, device="cuda").to(dt)
        w = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(dt)
        dw = torch.randn((C, d, f), generator=gen, device="cuda") * 1e-3
        return x, w, dw

    cases = [(name, shp, torch.bfloat16, True) for name, shp in mats]
    cases += [("attn_wq/f32", dict(mats)["attn_wq"], torch.float32, False),
              ("ragged_f100", (cfg.d_model, 100), torch.bfloat16, False)]
    rows, max_err = [], 0.0
    for name, (d, f), dt, on_path in cases:
        x, w, dw = inputs(d, f, dt)
        got = dmm.base_delta_matmul_2d(x, w, dw, slots)
        want = dmm.base_delta_matmul_2d_torch(x, w, dw, slots)
        torch.cuda.synchronize()
        dtn = "bfloat16" if dt == torch.bfloat16 else "float32"
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=TOL[dtn],
                            rtol=TOL[dtn])
        log(f"[kernel] {name:12s} d={d:5d} f={f:5d} {dtn:8s} "
            f"max_abs_err={err:.3e} (tol {TOL[dtn]:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"kernel disagrees with its plain version at {name}")
        if not on_path:
            continue
        max_err = max(max_err, err)
        ms = time_ms(lambda: dmm.base_delta_matmul_2d(x, w, dw, slots), flush)
        plain_ms = time_ms(
            lambda: dmm.base_delta_matmul_2d_torch(x, w, dw, slots), flush)
        lib_ms = time_ms(lambda: torch.matmul(x, w), flush)
        bound, by = delta_mm_bound(B, d, f, n_active, dt, dt)
        rows.append({"leaf": name, "d": d, "f": f, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound, "bound_by": by})
        log(f"[kernel]   time {ms:.4f} ms | bound {bound:.4f} ms ({by}) | "
            f"plain {plain_ms:.4f} ms | torch.matmul x@w (base product "
            f"only) {lib_ms:.4f} ms   [{card}]")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[kernel] one layer's six projections: kernel {total['ms']:.4f} ms, "
        f"bound {total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"torch.matmul {total['library_ms']:.4f} ms   [{card}]")
    return {"rows": rows, "total": total, "max_abs_err": max_err}


def synthetic_store(model, users: int, layers_per_user: int, seed: int):
    """Per-user f32 delta rows on ``layers_per_user`` random layers, drawn
    on the card for those rows only.  (``demo_store`` draws noise for every
    layer of every leaf, about 4e9 numpy normals at full width.)"""
    import numpy as np
    import torch
    from repro_torch.models.model import _block_shapes
    from repro_torch.serve import DeltaRecord, DeltaStore

    cfg = model.cfg
    store = DeltaStore(cfg)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for uid in range(users):
        idx = np.sort(rng.choice(cfg.n_layers, size=layers_per_user,
                                 replace=False)).astype(np.int32)
        leaves = {name: (torch.randn((len(idx), *shp), generator=gen,
                                     device=model.device) * 0.01).cpu().numpy()
                  for name, shp in _block_shapes(cfg, "dense").items()}
        store.put(uid, DeltaRecord(layers=idx,
                                   segments={"blocks": (idx, leaves)}))
    return store


def requests(cfg, n, plen, max_new, users, seed=0):
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, cfg.vocab_size, plen).tolist(),
                        max_new, user_id=(i % users if users else -1))
            for i in range(n)]


def phase_serve(card: str) -> dict:
    """Full-width TinyLlama-1.1B serving in delta (kernel and plain), shared
    and dense mode."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serve import DeltaOverlay

    cfg = get_arch("tinyllama_1_1b")
    rt = RuntimeConfig(remat=False)
    model = Model(cfg, rt, device="cuda")
    plain = Model(cfg, rt, device="cuda", kernel_mode="torch")
    t0 = time.perf_counter()
    params = model.init(0)
    store = synthetic_store(model, users=4, layers_per_user=2, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params['blocks'].values()) / 1e9:.3f}e9 "
        f"block params in {cfg.dtype}; set-up {time.perf_counter() - t0:.1f} s")
    slots, n_req, plen, max_new = 4, 8, 8, 16
    max_seq = plen + max_new + 1

    # first-step logits: kernel vs plain version, four users resident
    ov = DeltaOverlay(model, slots, device="cuda")
    for s in range(slots):
        check(ov.try_admit(s, store.get(s)), "overlay admit failed")
    log(f"[serve] overlay capacity {slots}: "
        f"{sum(v.numel() for v in ov.leaves.values()) * 4 / 1e9:.2f} GB f32, "
        f"{ov.n_entries} entries live")
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.zeros(slots, dtype=torch.int32, device="cuda")
    ops.reset_launches()
    lk, _ = model.decode_step(params, toks, pos,
                              model.init_cache(slots, max_seq, per_slot=True),
                              delta=ov.device())
    first_launches = ops.LAUNCHES["base_delta_matmul"]
    lp, _ = plain.decode_step(params, toks, pos,
                              plain.init_cache(slots, max_seq, per_slot=True),
                              delta=ov.device())
    ref = Model(dataclasses.replace(cfg, dtype="float32"), rt, device="cuda",
                kernel_mode="torch")
    p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    l32, _ = ref.decode_step(p32, toks, pos,
                             ref.init_cache(slots, max_seq, per_slot=True),
                             delta=ov.device())
    del p32
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()
    err = (lk.float() - lp.float()).abs().max().item()
    err_k, err_p = rel(lk, l32), rel(lp, l32)
    log(f"[serve] first-step logits vs f32: kernel path {err_k:.3e}, plain "
        f"path {err_p:.3e} (relative; kernel at most {E2E_ERR_RATIO:g}x "
        f"plain); kernel vs plain {rel(lk, lp):.3e}, max_abs_err {err:.3e}; "
        f"argmax agree "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.2f}; "
        f"{first_launches} launches in one step")
    check(first_launches == cfg.n_layers * 6,
          f"one decode step made {first_launches} kernel launches, want "
          f"{cfg.n_layers * 6}")
    check(torch.isfinite(lk).all().item() and lk.shape == (slots,
                                                           cfg.vocab_size),
          "first-step logits not finite or of the wrong shape")
    check(err_k <= E2E_ERR_RATIO * err_p,
          "first-step logits: the kernel path is less accurate than the plain "
          "version's")
    del ov, lk, lp, l32
    torch.cuda.empty_cache()

    results = {}
    for label, mdl, mode in (("delta", model, "delta"),
                             ("delta_plain", plain, "delta"),
                             ("shared", model, "shared"),
                             ("dense", model, "dense")):
        srv = serve.SlotServer(mdl, params, slots, max_seq, mode=mode,
                               store=None if mode == "shared" else store,
                               device="cuda")
        reqs = requests(cfg, n_req, plen, max_new,
                        0 if mode == "shared" else 4)
        torch.cuda.synchronize()
        ops.reset_launches()
        done, stats = srv.run(reqs)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["base_delta_matmul"]
        check(len(done) == n_req and all(len(r.generated) == max_new
                                         for r in done),
              f"{label}: {len(done)} of {n_req} requests finished")
        want = stats["steps"] * cfg.n_layers * 6 if label == "delta" else 0
        check(launches == want, f"{label}: {launches} kernel launches over "
                                f"{stats['steps']} steps, want {want}")
        results[label] = {"stats": stats, "launches": launches,
                          "gen": {r.rid: r.generated for r in done}}
        log(f"[serve] {label:11s} {stats['steps']} steps, "
            f"{stats['gen_tokens']} tokens, {stats['tok_per_s']:.1f} tok/s, "
            f"{stats['wall_s'] * 1e3 / stats['steps']:.2f} ms/step, "
            f"{launches} kernel launches   [{card}]")
        del srv
        torch.cuda.empty_cache()
    a, b = results["delta"]["gen"], results["delta_plain"]["gen"]
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    log(f"[serve] delta tokens, kernel vs plain version: {same} of "
        f"{sum(len(v) for v in a.values())} equal (bf16: greedy decoding "
        f"may part after a near tie)")
    return results


def phase_exact(card: str) -> None:
    """Reduced depth, f32: delta-mode generations == each request decoded
    alone against the user's materialised private parameters."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = reduced(get_arch("tinyllama_1_1b"), n_layers=3, d_model=64)
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16),
                  device="cuda")
    params = model.init(0)
    store = serve.demo_store(model, params, users=3, layers_per_user=2,
                             seed=0)
    reqs = requests(cfg, 7, 4, 5, 3, seed=1)
    prompts = {r.rid: (list(r.prompt), r.user_id) for r in reqs}
    ops.reset_launches()
    done, stats = serve.SlotServer(model, params, 3, 16, mode="delta",
                                   store=store, device="cuda").run(reqs)
    check(ops.LAUNCHES["base_delta_matmul"] == stats["steps"] * 3 * 6,
          "reduced delta run did not go through the kernel")
    check(len(done) == 7, "reduced delta run lost requests")
    for r in done:
        prompt, uid = prompts[r.rid]
        private = store.materialize(params, uid)
        cache = model.init_cache(1, 16)
        out = []
        for t in range(len(prompt) + r.max_new - 1):
            cur = prompt[t] if t < len(prompt) else out[-1]
            logits, cache = model.decode_step(
                private, torch.tensor([cur], device="cuda"),
                torch.tensor(t, dtype=torch.int32, device="cuda"), cache)
            if t >= len(prompt) - 1:
                out.append(logits[0].argmax().item())
        check(r.generated == out,
              f"request {r.rid}: delta {r.generated} != alone {out}")
    log(f"[exact] reduced f32: 7 delta-mode generations equal decoding each "
        f"alone against its user's parameters ({stats['steps']} steps)")


# ---------------------------------------------------------------------------
# Training slice: layer_grad_norm and masked_update, one round of Algorithm 1
# ---------------------------------------------------------------------------

def stream_bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time in ms for a streaming pass: bytes over HBM bandwidth or
    its f32 operations over the f32 (non-tensor-core) peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_train_kernels(card: str) -> dict:
    """Both training kernels vs their plain versions at TinyLlama's eight
    block leaves (norms over L = 22 rows, the update over the 11 rows above
    a cut at 11 with a mixed 0/1 mask), plus an f32 case and ragged F."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import layer_grad_norm as lgn
    from repro_torch.kernels import masked_update as mu
    from repro_torch.models.model import _block_shapes

    cfg = get_arch("tinyllama_1_1b")
    leaves = [(name, math.prod(shp))
              for name, shp in sorted(_block_shapes(cfg, "dense").items())]
    L, L_upd, lr = cfg.n_layers, cfg.n_layers // 2, 0.01
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    mask = torch.tensor([float(i % 3 != 1) for i in range(L_upd)],
                        device="cuda")
    cases = [(name, F, torch.bfloat16, True) for name, F in leaves]
    cases += [("attn_wq/f32", dict(leaves)["attn_wq"], torch.float32, False),
              ("ragged_F5000", 5000, torch.bfloat16, False),
              ("ragged_F17", 17, torch.float32, False)]
    rows = {"layer_grad_norm": [], "masked_update": []}
    errs = {"layer_grad_norm": 0.0, "masked_update": 0.0}
    for name, F, dt, on_path in cases:
        es = torch.tensor([], dtype=dt).element_size()
        dtn = "bfloat16" if dt == torch.bfloat16 else "float32"
        g = torch.randn((L, F), generator=gen, device="cuda").to(dt)
        got = lgn.layer_sq_norms_2d(g)
        want = lgn.layer_sq_norms_2d_torch(g)
        again = lgn.layer_sq_norms_2d(g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=1e-5, atol=0.0)
        log(f"[train-kernel] layer_grad_norm {name:14s} L={L} F={F:9d} "
            f"{dtn:8s} max_abs_err={err:.3e} max_rel_err="
            f"{((got - want).abs() / want.abs()).max().item():.3e} "
            f"(rtol 1e-5) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"layer_grad_norm disagrees with its plain version at {name}")
        check(torch.equal(got, again), f"layer_grad_norm is not "
                                       f"deterministic at {name}")
        if on_path:
            errs["layer_grad_norm"] = max(errs["layer_grad_norm"], err)
            bound, by = stream_bound(L * F * es + 4 * L, 2 * L * F)
            r = {"leaf": name, "L": L, "F": F, "bound_ms": bound,
                 "bound_by": by,
                 "ms": time_ms(lambda: lgn.layer_sq_norms_2d(g), flush),
                 "plain_ms": time_ms(lambda: lgn.layer_sq_norms_2d_torch(g),
                                     flush),
                 "library_ms": time_ms(lambda: torch.linalg.vector_norm(
                     g, dim=1, dtype=torch.float32) ** 2, flush)}
            rows["layer_grad_norm"].append(r)
            log(f"[train-kernel]   time {r['ms']:.4f} ms | bound "
                f"{bound:.4f} ms ({by}) | kernel/bound {r['ms'] / bound:.2f} "
                f"| plain {r['plain_ms']:.4f} ms | torch.linalg.vector_norm"
                f"(g, dim=1, dtype=f32)**2 {r['library_ms']:.4f} ms   [{card}]")
        del g
        p = torch.randn((L_upd, F), generator=gen, device="cuda").to(dt)
        g = torch.randn((L_upd, F), generator=gen, device="cuda").to(dt)
        got = mu.masked_sgd_update_2d(p, g, mask, lr)
        want = mu.masked_sgd_update_2d_torch(p, g, mask, lr)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.equal(got, want)
        log(f"[train-kernel] masked_update   {name:14s} L={L_upd} F={F:9d} "
            f"{dtn:8s} max_abs_err={err:.3e} (must be 0) "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"masked_update differs from its plain version at {name}")
        if on_path:
            bound, by = stream_bound(L_upd * F * 3 * es + 4 * L_upd,
                                     2 * L_upd * F)
            scale = (-lr * mask)[:, None]
            r = {"leaf": name, "L": L_upd, "F": F, "bound_ms": bound,
                 "bound_by": by,
                 "ms": time_ms(lambda: mu.masked_sgd_update_2d(p, g, mask,
                                                               lr), flush),
                 "plain_ms": time_ms(lambda: mu.masked_sgd_update_2d_torch(
                     p, g, mask, lr), flush),
                 "library_ms": time_ms(lambda: torch.addcmul(p, g, scale),
                                       flush)}
            rows["masked_update"].append(r)
            log(f"[train-kernel]   time {r['ms']:.4f} ms | bound "
                f"{bound:.4f} ms ({by}) | kernel/bound {r['ms'] / bound:.2f} "
                f"| plain {r['plain_ms']:.4f} ms | torch.addcmul(p, g, "
                f"(-lr*m)[:, None]) (f32 out) {r['library_ms']:.4f} ms"
                f"   [{card}]")
        del p, g, got, want
    out = {}
    for kname, rs in rows.items():
        total = {k: sum(r[k] for r in rs)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[train-kernel] {kname}, all eight leaves: kernel "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, plain "
            f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} "
            f"ms   [{card}]")
        out[kname] = {"rows": rs, "total": total, "max_abs_err": errs[kname]}
    del flush
    torch.cuda.empty_cache()
    return out


def _round_experiment(cfg, task, model=None, **kw):
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig
    return Experiment(model if model is not None else cfg, task, "ours",
                      cohort_size=4, local_steps=2, batch_size=4, budget=2,
                      lam=1.0, lr=0.01, rounds=3, pipeline=False,
                      runtime=RuntimeConfig(remat=False, seq_chunk=128),
                      device="cuda", **kw)


def _tree_max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_tree_max_diff(a[k], b[k]) for k in a)
    return (a.float() - b.float()).abs().max().item()


def phase_round(card: str) -> dict:
    """Three rounds of Algorithm 1 ("ours") at full TinyLlama-1.1B width in
    bf16 through Experiment.run, counting kernel launches; then round 0
    again, stage by stage, against the plain versions and the dense
    program."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = get_arch("tinyllama_1_1b")
    task_cfg = FederatedTaskConfig(n_clients=16, vocab_size=cfg.vocab_size,
                                   seq_len=128, test_samples=32,
                                   objective="lm", skew="feature", seed=0)
    exp = _round_experiment(cfg, SyntheticFederatedData(task_cfg))
    fl, L = exp.fl, cfg.n_layers
    params = exp.init_params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, hist = exp.run(params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del final
    cuts = []
    for r in hist.records:
        cut = int(np.flatnonzero(r.mask_matrix.sum(0) > 0)[0]) \
            if r.mask_matrix.any() else L
        cuts.append(cut)
        log(f"[round] round {r.round}: cohort {r.cohort.tolist()} cut {cut} "
            f"selected {[np.flatnonzero(m).tolist() for m in r.mask_matrix]} "
            f"train_loss {r.train_loss:.6f} test_loss {r.test_loss:.6f} "
            f"{r.wall_s:.3f} s   [{card}]")
        check(all(math.isfinite(v) for v in (r.train_loss, r.test_loss)),
              f"round {r.round}: non-finite loss")
        check(np.all(r.mask_matrix.sum(1) <= fl.budget)
              and r.mask_matrix.shape == (fl.cohort_size, L),
              f"round {r.round}: masks break the budget")
    want = {"layer_grad_norm": len(hist.records) * fl.cohort_size * 8,
            "masked_update": sum(fl.cohort_size * fl.local_steps * 8
                                 for c in cuts if c < L),
            "base_delta_matmul": 0}
    log(f"[round] launches {launches}, want {want}")
    check(launches == want, "the round did not launch the training kernels "
                            "as often as its path requires")
    tokens = fl.cohort_size * fl.local_steps * fl.batch_size * 128
    log(f"[round] {len(hist.records)} rounds in {run_s:.3f} s; per round "
        f"{[round(r.wall_s, 3) for r in hist.records]} s; peak device memory "
        f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)   [{card}]")

    # round 0 again, stage by stage: kernels, plain versions, dense program
    task = SyntheticFederatedData(task_cfg)
    srv = _round_experiment(cfg, task).build()
    rt = RuntimeConfig(remat=False, seq_chunk=128)
    plain = _round_experiment(cfg, task, model=Model(
        cfg, rt, device="cuda", kernel_mode="torch")).build()
    dense = _round_experiment(cfg, task, mask_aware=False).build()
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    plan = srv.plan_round(0)
    sampled = srv.sample_round(plan)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    stats = srv.probe_round(params, sampled)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    masks = srv.select_round(plan, stats)
    marks.append(time.perf_counter())
    new_k, losses = srv.update_round(params, sampled, masks)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    test_loss, _ = srv.client.evaluate(new_k, srv._to_device(task.test_batch()))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    split = dict(zip(("plan+sample", "probe", "select", "update", "eval"),
                     np.diff(marks)))
    log(f"[round] timed round 0 (synchronised at stage boundaries): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"; {tokens / split['update']:.0f} trained tokens/s in the update "
        f"({tokens} tokens), {tokens / sum(split.values()):.0f} per round"
        f"   [{card}]")
    check(np.array_equal(masks, hist.records[0].mask_matrix),
          "round 0 replayed stage by stage chose other masks than the run")
    stats_p = plain.probe_round(params, sampled)
    masks_p = plain.select_round(plan, stats_p)
    rel = max(float(np.max(np.abs(stats_p[k] - stats[k]) / np.abs(stats[k])))
              for k in stats)
    log(f"[round] probe stats, kernels vs plain versions: max rel err "
        f"{rel:.3e} (rtol 1e-4); masks equal: "
        f"{bool(np.array_equal(masks_p, masks))}")
    check(rel <= 1e-4, "probe stats: kernel and plain versions disagree")
    check(np.array_equal(masks_p, masks), "plain-version probe stats chose "
                                          "other masks")
    new_p, losses_p = plain.update_round(params, sampled, masks)
    dp = _tree_max_diff(new_k, new_p)
    log(f"[round] update with the kernel run's masks, kernels vs plain "
        f"versions: max |Δparams| {dp:.3e} (bf16), losses "
        f"{np.abs(losses - losses_p).max():.3e}")
    del new_p
    torch.cuda.empty_cache()
    new_d, losses_d = dense.update_round(params, sampled, masks)
    log(f"[round] dense program (mask_aware=False) vs masked program, round "
        f"0: max |Δparams| {_tree_max_diff(new_k, new_d):.3e} (bf16), "
        f"losses {np.abs(losses - losses_d).max():.3e}, test loss "
        f"{test_loss:.6f}")
    return {"launches": launches, "run_s": run_s,
            "wall_s": [r.wall_s for r in hist.records], "split": split,
            "peak_gb": peak_gb, "tokens_per_round": tokens}


def phase_round_exact(card: str) -> None:
    """Reduced xlm-roberta in f32, 2 rounds: the same run on the card (the
    kernels) and on the CPU (the plain versions) gives the same cohorts
    and masks and params within atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("xlm_roberta_base"), n_layers=4, d_model=32)
    runs = {}
    for dev in ("cuda", "cpu"):
        task = SyntheticFederatedData(FederatedTaskConfig(
            n_clients=12, n_classes=10, vocab_size=cfg.vocab_size, seq_len=8,
            samples_per_client=16, skew="label", objective="classification"))
        exp = Experiment(cfg, task, "ours", cohort_size=4, rounds=2,
                         local_steps=2, lr=0.01, batch_size=4, budget=2,
                         lam=1.0, seed=3, pipeline=False, device=dev,
                         runtime=RuntimeConfig(remat=False, seq_chunk=16))
        params = tree_map(lambda t: t.to(dev),
                          Experiment(cfg, task, device="cpu").init_params())
        ops.reset_launches()
        final, hist = exp.run(params)
        runs[dev] = (tree_map(lambda t: t.cpu(), final), hist,
                     dict(ops.LAUNCHES))
    (pg, hg, lg), (pc, hc, lc) = runs["cuda"], runs["cpu"]
    check(lg["layer_grad_norm"] > 0 and lg["masked_update"] > 0
          and lc == {k: 0 for k in lc},
          f"reduced run: launches on the card {lg}, on the CPU {lc}")
    for rg, rc in zip(hg.records, hc.records):
        check(np.array_equal(rg.cohort, rc.cohort)
              and np.array_equal(rg.mask_matrix, rc.mask_matrix),
              f"reduced run, round {rg.round}: card and CPU chose other "
              f"cohorts or masks")
    err = _tree_max_diff(pg, pc)
    log(f"[round-exact] reduced xlm-r f32, 2 rounds: cohorts and masks "
        f"equal on card and CPU; max |Δparams| {err:.3e} (atol 1e-5); card "
        f"launches {lg}")
    check(err <= 1e-5, "reduced run: card and CPU params differ")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is missing beside this script: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    try:
        build_kernels()
        kern = phase_kernel(card)
        served = phase_serve(card)
        phase_exact(card)
        train = phase_train_kernels(card)
        rounds = phase_round(card)
        phase_round_exact(card)
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        return 1
    total = kern["total"]
    line = {"kernels": [{
        "name": "base_delta_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_matmul.cu",
        "replaces": "src/repro/kernels/delta_matmul.py:89",
        "launches": served["delta"]["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in kern["rows"]) else "operations"),
        "library_ms": total["library_ms"],
        "timed_as": "sum over one layer's six projections at B=4",
        "library_call": "torch.matmul(x, w), the base product only",
        "shapes": kern["rows"]}]}
    for name, rel, lib, timed in (
            ("layer_grad_norm", "layer_grad_norm.py:64",
             "torch.linalg.vector_norm(g, dim=1, dtype=float32)**2",
             "sum over the eight block leaves at L=22, one probe batch"),
            ("masked_update", "masked_update.py:40",
             "torch.addcmul(p, g, (-lr*m)[:, None]) (f32 output)",
             "sum over the eight block leaves at L=11, one local step")):
        t = train[name]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{rel}",
            "launches": rounds["launches"][name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["total"]["ms"], "plain_ms": t["total"]["plain_ms"],
            "bound_ms": t["total"]["bound_ms"],
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in t["rows"]) else "operations"),
            "library_ms": t["total"]["library_ms"],
            "timed_as": timed, "library_call": lib, "shapes": t["rows"]})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
