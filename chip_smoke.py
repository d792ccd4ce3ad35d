#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
source, all at once), then, failing with a non-zero exit on any mismatch:

1. prints the environment and the card's name and power limit, and runs
   the port's source linter over ``src/repro_torch`` (``phase_lint``: no
   finding);
2. holds ``ssd_scan`` against its plain version at Mamba2-370M's main-path
   shape (b 4, S 512, H 32, P 64, N 128, bf16), with a slowly decaying
   state, a single chunk, G = 4 and f32 inputs, checking each case's route
   (bf16 on the tensor-core kernel, f32 on the SIMT one), and times it
   beside its bound and the SIMT kernel on the same bf16 inputs;
3. holds ``delta_matmul`` against its plain version at TinyLlama's six
   projection shapes, f32, a ragged f, B 1, B 16 and a repeated slot (two
   launches bit for bit; the planner's grid logged), and times kernel,
   plain version and ``torch.matmul(x, w)`` with CUDA events, with 2 live
   entries and with none, beside the least time the card could take (its
   bound);
4. serves full-width TinyLlama-1.1B (22 layers, random weights, seed 0)
   through ``SlotServer`` in delta mode, counting kernel launches; repeats
   with the plain version forced, then in shared and dense mode (delta
   ms/step over shared ms/step logged);
5. checks, at reduced depth in f32, that delta-mode generations equal
   decoding each request alone against the user's materialised parameters;
6. holds the training kernels (``layer_grad_norm``, ``masked_update``)
   against their plain versions at TinyLlama's eight block leaves and
   times them likewise;
7. runs three rounds of Algorithm 1 ("ours": probe, (P1) select, masked
   τ-step update, Eq.(5)-(7) aggregate, eval) at full TinyLlama-1.1B width
   (seq_len 128, the attention through the flash kernels) through
   ``Experiment.run``, counting kernel launches per round and flash
   launches per stage, then replays round 0 stage by stage against the
   plain versions (both probes also held against an f32 probe) and the
   dense program;
8. checks, on reduced xlm-roberta in f32, that two rounds on the card and
   on the CPU choose the same cohorts and masks and reach the same params
   (its attention on the flash kernels' exact f32 SIMT route);
9. holds the training kernels at Mamba2-370M's nine block leaves (L = 48);
10. runs three "ours" rounds at full Mamba2-370M width (seq_len 512: four
    chunks) through ``Experiment.run``, counting ``ssd_scan`` (by route:
    every launch on the tensor cores), ``layer_grad_norm`` and
    ``masked_update`` launches against the round's structure, replays
    round 0 stage by stage (launches per stage) and against the plain
    versions, then runs one "top" round (cut 46: the
    mask-aware engine skips a 46-layer prefix);
11. profiles one full-width Mamba2 client step (fwd+bwd) with
    ``torch.profiler``: wall time, device busy share, the top kernels
    (and, after phase 14, one TinyLlama client step at seq_len 1024);
12. serves full-width Mamba2-370M in shared and dense mode, and holds the
    f32 sequence forward's logits over a 256-token prompt (the kernel, two
    chunks) against step-by-step decode (the recurrence);
13. holds the flash attention forward and backward kernels against their
    plain versions at one TinyLlama layer on the long round's batch (B 4,
    S 1024, H 32, K 4, D 64, bf16, causal), with f32 inputs, a 256 window,
    XLM-R's bidirectional heads, head dims 128 and 256, a ragged S, a head
    dim of 8, the seq-128 round's shapes and one model rank's share of
    the main layer at model 16 (2 query heads, 1 kv head: timed beside
    its bound, plain version and SDPA), two launches bit for bit,
    logging each case's route (bf16 at head dim 64 or 128 must take the
    tensor-core kernels) and dK/dV grid; times kernels (and each kernel's
    share), plain versions, the SIMT kernels on the same bf16 inputs, SDPA
    (its backward read three times) and ``blocks.attend_full`` (time and
    one layer's memory) beside the bound;
14. runs phase 7 again at seq_len 1024, TinyLlama's own context (every
    flash launch on the tensor-core route);
15. runs three "ours" rounds of TinyLlama at seq_len 1024 and of Mamba2 at
    512 three ways through ``Experiment.run`` — the synchronous loop and
    the round scheduler at depth 1 and 2 — checking equal cohorts and
    masks, params within ROUND_PARAM_ATOL and the same kernel launches;
    logs s/round, the device's busy share (a CUDA-only profiled run) and
    the host syncs of each round after the first;
16. pretrains full-width TinyLlama with AdamW (``data/pretrain.py``) for
    20 steps at the reference's batch of 64 × 128 tokens: the loss must
    fall; ms/step, peak memory, flash launches per step;
17. checkpoints a 4-round pipelined TinyLlama run every 2 rounds, flips a
    byte in the latest step, and resumes a fresh ``Experiment`` from the
    step before it: the same cohorts and masks, params within
    ROUND_PARAM_ATOL, ``ckpt_fallbacks`` 1; bytes and save, verify and
    restore times (the directory is deleted afterwards);
18. injects faults (``phase_faults``): three guarded TinyLlama rounds at
    seq_len 1024 under client death, NaN/Inf/exploding deltas, solver
    stalls and dispatch failures, synchronous and pipelined, against the
    injector's host replay (ok rows, counters, equal params, launches,
    at most one main-thread sync a round); round 0's inputs through the
    guarded step directly (no fault: bit-equal to the dense step; one dead
    row; all NaN: params unchanged; peak memory, the guard's time); a
    reduced f32 guarded run on card and CPU; a disabled injector against
    none (bit-equal params, s/round ratio); two guarded Mamba2-370M rounds
    at seq_len 512; delta-mode serving under upload failures and slot
    strikes (every request finishes with the fault-free tokens) and with
    every upload failing (no half-admitted user, requests dropped);
19. runs the hybrid family, Zamba2-7B: ``ssd_scan`` (N 64, 112 heads;
    bf16 on the tensor cores, f32 on SIMT), the flash kernels (D 112, MHA,
    window 4096 and 128, tensor cores) and ``layer_grad_norm`` (L 15 and
    the shared block's single rows) against their plain versions and
    timed; serves the full 81-layer model in shared and dense mode as a
    functional check (3 slots, KV rows sized to the 4096 window; delta
    mode refused), holds an f32 depth-15 forward against step-by-step
    decode; runs three "ours" rounds at full width and depth 15 (seq_len
    512), synchronous and at depth 1, with launches per round against its
    structure, a stage-by-stage and plain-version replay of round 0 (its
    update also with the shared block selected), one profiled client step
    and a reduced f32 card-vs-CPU run;
20. runs the moe family, DeepSeek-V2-Lite-16B: ``layer_grad_norm`` and
    ``masked_update`` against their plain versions and timed at its 23
    leaves (dense0's 10 at L 1, the moe blocks' 13 at L 3, up to 369.1 M
    elements a row); serves the full 27-layer model (31.4 GB in bf16) as
    a functional check, shared mode at 4 slots and at 1, dense mode at 1
    (the base and one private copy take 62.8 GB), latent rows sized to a
    4096 window, delta mode refused; holds an f32 depth-4 forward (MLA
    expanded) against step-by-step decode (MLA absorbed) at capacity
    factor 8; runs three "ours" rounds at full width and depth 4 (dense0
    + 3 moe blocks, seq_len 512), synchronous and at depth 1 (bit-equal
    params, launches per round against each round's cut), a stage-by-stage
    and plain-version replay of round 0 (the routers' aux loss and dropped
    fraction logged), a "top" round whose cut falls inside ``blocks``
    (``masked_update`` only on the trainable rows), one profiled client
    step and a reduced f32 card-vs-CPU run;
21. runs the audio family, whisper-medium, at full width and depth (24
    encoder and 24 decoder layers, 1500 frames, decoder seq_len 448): the
    flash kernels at the encoder's self-attention (S 1500, non-causal,
    MHA 16 × 64: a ragged last block) and the decoder's (S 448, causal) on
    the tensor-core route, and ``layer_grad_norm`` / ``masked_update`` at
    its 21 leaves (L 24 each), against their plain versions and timed
    beside bounds and the library; one step of Algorithm 1 composed from
    ``Client`` as the reference composes it (the probe, "ours" at budget
    2, the masked cohort update at the selected cut, then masked against
    dense at cuts 0, 12, 24 and 46), every run's launches against its
    structure (``masked_update`` only on the rows above the cut), round 0
    against the plain versions and an f32 probe, one profiled client step
    and a reduced f32 card-vs-CPU update; then an f32 forward against 64
    decode steps over a cross cache filled from the port's encoder, and
    the refused per-slot and delta decode;
22. runs examples/heterogeneous_budgets.py at full TinyLlama-1.1B width
    (``phase_theory``, bf16, seq 128, 16 clients, 30 pretraining steps):
    κ_l over 22 layers from 16 full-batch client gradients and the f32
    global gradient, E_t1 and E_t2 of "ours" and "top" (3 rounds each under
    the example's half-normal budgets), σ_l, the Theorem 4.7 right-hand
    side and the Table 3 costs; checks E_t1 = 0 at a full union and growing
    as it shrinks, κ_l above every client's deviation, E_t2 ≈ 0 for a full
    uniform cohort, the norm kernel against the plain route, a reduced f32
    world against the CPU; prints the peak memory;
23. runs ``phase_contracts``: three pipelined "ours" TinyLlama rounds to
    warm up, then the same under ``strict_region`` (sync-debug mode
    "error", the kernel-cache sentinel) at depth 1 and 4 with the warm
    run's summary; then the program auditor at full width (TinyLlama f32
    training at all 23 cuts, Mamba2-370M f32 at every sixth, TinyLlama bf16
    serving): no contract violation, the kernels' work reported to the
    audit (FLOPs series, cut-L / cut-0, delta weight bytes per (B, C)), and
    no budget failure against the committed card manifest
    (``analysis/budgets/h100_full_width.json``: FLOPs, weight, argument
    and temporary bytes, each kernel's launches; the largest drift per key
    and config printed), which must name each of three doctored entries;
24. runs ``phase_distributed``: a world of 1 on NCCL in this process (no
    fallback) and a (1, 1) mesh; through ``repro_torch.sharding`` at full
    TinyLlama-1.1B width (bf16, 4 × 1024 tokens, ZeRO-3 storage) the τ = 1
    step against the single-host math (autograd of ``Model.loss``,
    ``apply_layer_mask``, ``aggregate``, ``apply_update``) on the card, the
    same step with ``sel_upload`` over two rows (equal to it) and a τ = 2
    step over them against ``Client.local_update`` + ``aggregate``, each
    with its update on the selected rows against the reference's (most
    elements moved, the other rows and groups bit-unchanged), its kernel
    launches and its collectives (counted by the step and
    seen by the profiler) against its structure, ms/step beside the
    single-host step and peak memory; the Mamba2-370M step (4 × 512,
    ``ssd_scan`` counted) likewise; a reduced f32 step on the card against
    the CPU's (gloo, a child process); mesh prefill (4 × 1024) against
    ``Model.logits_seq`` and 32 greedy mesh decode steps against
    ``Model.decode_step``; then the train CLI for three rounds under
    ``torch.distributed.run`` (finite losses, the probe's
    ``layer_grad_norm`` launches); with tensor parallelism over ``model``
    on (``tp_constraints``, model = 1), the τ = 1, ``sel_upload`` and
    τ = 2 steps, prefill and every decode step's logits bit-equal to the
    plain programs', with the same collectives; the same five programs
    for Mamba2-370M, DeepSeek-V2-Lite, PaliGemma-3B and whisper-medium
    (full depth, 1500 stub frames, decode over a cross cache filled from
    its encoder), Zamba2-7B's step and decode; then ``phase_tp_block``:
    one full-width TinyLlama-1.1B block (bf16,
    4 × 1024) forward and backward split over M = 2 and M = 16 model
    coordinates in this process, each coordinate's partial in turn and
    the model-axis sums by hand, against the whole block (output, input
    and every leaf's gradient within TP_BLOCK_RTOL; at M = 16 the flash
    kernels at 2 query heads and 1 kv head on the tensor-core route),
    and the same for the Mamba2, Zamba2, moe and PaliGemma blocks and
    whisper-medium's encoder and decoder blocks (one head a flash launch
    at M = 16; the decoder's cross-attention over a 1500-row encoder
    output, whose gradient is held too);
25. runs ``phase_dryrun``: (a) the dry run's CLI
    (``repro_torch.launch.dryrun``) on the CPU in child processes started
    at the beginning of the script, so that they run beside the card's
    phases and their fake worlds never meet an NCCL one — the single-pod
    ``--all`` (10 archs × 4 shapes on a fake world of 256) and
    ``--multi-pod`` for TinyLlama's four shapes (512), and ``--opt``
    (tensor parallelism) for the dense family's four archs × four shapes
    on 16 × 16 — one line per pair (FLOPs, argument and temporary GB,
    collective GB by kind, the dominant roofline term), and each dense
    arch's ``train_4k`` with ``--opt`` against without (FLOPs and argument
    bytes divided by at least 8, the useful share at least 0.5 but for
    SmolLM's replicated attention); (b) the card check: full-width
    TinyLlama-1.1B (flash)
    and Mamba2-370M (``ssd_scan``), the τ = 1 FL step at seq 4096,
    prefill at 32 768 and decode over a 32 768 cache, each with its batch
    cut to fit the card, run for real on a world of 1 on NCCL under the
    auditor and against the dry run of the same program (a fake world of
    1, meta, in a child): FLOPs within the budget manifest's tolerance,
    argument bytes, kernel launches and collective counts exactly, peak
    temporaries within the manifest's ``temp_bytes`` tolerance; both sides
    printed; TinyLlama's three again with tensor parallelism on, FLOPs
    exact;
26. prints one JSON line of per-kernel results (launches per path, the
    fault, Zamba2, DeepSeek, whisper, theory, strict, audit, distributed
    and dry-run card-check paths among them), the card's name and power
    limit, and a last JSON line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --hybrid-serve-long

runs only the measured Zamba2-7B serving run (about 30 min): shared and
dense mode, 3 slots, 9 requests of 1024 prompt and 64 new tokens, KV rows
sized to the 4096 window; ms/step, tokens/s and peak memory.

    python3 chip_smoke.py --moe-serve-long

runs only the measured DeepSeek-V2-Lite-16B serving run: shared mode at
4 slots with 8 requests, shared and dense mode at 1 slot with 2, each of
1024 prompt and 64 new tokens, latent rows sized to a 4096 window;
ms/step beside the step's byte floor, tokens/s and peak memory.

Imports nothing of JAX or of the JAX package.  Exits non-zero without a
card, or when the port's sources are missing.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit),
# the port's one copy (the dry run's roofline prices its terms with them).
try:
    from repro_torch.sharding.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S
except ImportError as exc:
    sys.exit(f"chip_smoke: the port is missing beside this script: {exc}")
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# Logits after 22 bf16 layers: kernel and plain version round each
# projection to bf16 after summing in different orders, and a one-ulp
# difference (2**-8 relative) in one layer's output carries into the next,
# so the two bf16 paths part by ~2% (norm-wise) with no fault in either.
# Both are held against the same step in f32: the kernel path's error may
# be at most E2E_ERR_RATIO times the plain path's.
E2E_ERR_RATIO = 1.5
# The TinyLlama rounds, kernels vs plain versions on round 0: the flash
# kernels (bf16 P and dS on the tensor cores) and their plain versions (f32
# inside) round attention outputs and gradients to bf16 after summing in
# other orders, and a one-ulp difference in one layer carries through 22
# layers of forward and backward.  On an H100 the probe stats parted by
# 1.51e-3 (seq 128) and 1.08e-3 (seq 1024), while each bf16 path sits
# 1.0e-3 to 3.5e-3 off an f32 probe (PERF.md): the limit is under the
# bf16-vs-f32 gap and well above the readings.  Params: a few bf16 ulps of
# the largest |param| (~0.12, ulp 4.9e-4).
ROUND_PROBE_RTOL = 2.5e-3
ROUND_PARAM_ATOL = 2e-3
REPS = 30


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def lap(t0: float, phase: str) -> None:
    """Log the seconds from ``t0`` (the script's start) to the end of
    ``phase``: where the script's time limit goes."""
    log(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")


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


# The targets of delta_matmul's split-d design: one layer's six projections
# with 2 live entries of 4 within twice their byte bound, and with none no
# slower than torch.matmul(x, w), which then computes the same function.
# Logged against the readings; a miss is a finding, not a fault.
DELTA_TARGET_BOUND_X = 2.0


def phase_kernel(card: str) -> dict:
    """Kernel vs plain version at TinyLlama's six projection shapes (B 4,
    2 live entries of 4), f32, a ragged f, B 1, B 16 and a repeated slot;
    two launches must give the same bits.  Each shape is timed with its 2
    live entries and with none (all slots -1), beside torch.matmul(x, w),
    and logs the planner's grid."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import delta_matmul as dmm
    from repro_torch.models.model import _block_shapes

    cfg = get_arch("tinyllama_1_1b")
    mats = [(name, shp) for name, shp in _block_shapes(cfg, "dense").items()
            if len(shp) == 2]
    C = 4
    live2 = [1, -1, 3, -1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def inputs(B, d, f, dt):
        x = torch.randn((B, d), generator=gen, device="cuda").to(dt)
        w = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(dt)
        dw = torch.randn((C, d, f), generator=gen, device="cuda") * 1e-3
        return x, w, dw

    wq = dict(mats)["attn_wq"]
    cases = [(name, shp, torch.bfloat16, True, 4, live2)
             for name, shp in mats]
    cases += [("attn_wq/f32", wq, torch.float32, False, 4, live2),
              ("ragged_f100", (cfg.d_model, 100), torch.bfloat16, False, 4,
               live2),
              ("attn_wq/B1", wq, torch.bfloat16, False, 1, [0, -1, -1, -1]),
              ("attn_wq/B16", wq, torch.bfloat16, False, 16,
               [15, -1, 3, -1]),
              ("attn_wq/repeated", wq, torch.bfloat16, False, 4,
               [1, -1, 1, 3])]
    rows, max_err = [], 0.0
    for name, (d, f), dt, on_path, B, slot_list in cases:
        slots = torch.tensor(slot_list, dtype=torch.int32, device="cuda")
        x, w, dw = inputs(B, d, f, dt)
        got = dmm.base_delta_matmul_2d(x, w, dw, slots)
        again = dmm.base_delta_matmul_2d(x, w, dw, slots)
        want = dmm.base_delta_matmul_2d_torch(x, w, dw, slots)
        torch.cuda.synchronize()
        dtn = "bfloat16" if dt == torch.bfloat16 else "float32"
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=TOL[dtn],
                            rtol=TOL[dtn])
        same = torch.equal(got, again)
        plan = dmm.plan(B, d, f)
        log(f"[kernel] {name:16s} B={B:2d} d={d:5d} f={f:5d} {dtn:8s} slots "
            f"{slot_list} max_abs_err={err:.3e} (tol {TOL[dtn]:g}) "
            f"{'ok' if ok else 'MISMATCH'}; two launches equal bit for bit: "
            f"{same}; grid {plan.col_tiles} column tiles of {plan.col_tile} x "
            f"{plan.splits} d-splits of {plan.rows} rows = {plan.blocks} "
            f"blocks")
        check(ok, f"kernel disagrees with its plain version at {name}")
        check(same, f"delta_matmul is not deterministic at {name}")
        max_err = max(max_err, err)
        if not on_path:
            continue
        none = torch.full((C,), -1, dtype=torch.int32, device="cuda")
        got0 = dmm.base_delta_matmul_2d(x, w, dw, none)
        want0 = dmm.base_delta_matmul_2d_torch(x, w, dw, none)
        torch.cuda.synchronize()
        check(torch.allclose(got0.float(), want0.float(), atol=TOL[dtn],
                             rtol=TOL[dtn]),
              f"kernel disagrees with its plain version at {name}, no live "
              f"entry")
        ms = time_ms(lambda: dmm.base_delta_matmul_2d(x, w, dw, slots), flush)
        plain_ms = time_ms(
            lambda: dmm.base_delta_matmul_2d_torch(x, w, dw, slots), flush)
        lib_ms = time_ms(lambda: torch.matmul(x, w), flush)
        no_live_ms = time_ms(lambda: dmm.base_delta_matmul_2d(x, w, dw, none),
                             flush)
        bound, by = delta_mm_bound(B, d, f, sum(s >= 0 for s in slot_list),
                                   dt, dt)
        bound0, by0 = delta_mm_bound(B, d, f, 0, dt, dt)
        rows.append({"leaf": name, "d": d, "f": f, "B": B, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound, "bound_by": by,
                     "no_live_ms": no_live_ms,
                     "library_no_live_ms": lib_ms,
                     "no_live_bound_ms": bound0, "no_live_bound_by": by0,
                     "plan": plan._asdict()})
        log(f"[kernel]   2 live: time {ms:.4f} ms | bound {bound:.4f} ms "
            f"({by}) | plain {plain_ms:.4f} ms | torch.matmul x@w (base "
            f"product only) {lib_ms:.4f} ms; no live entry: time "
            f"{no_live_ms:.4f} ms | bound {bound0:.4f} ms ({by0}) | "
            f"torch.matmul x@w (then the same function)"
            f"   [{card}]")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "no_live_ms",
            "library_no_live_ms", "no_live_bound_ms")
    total = {k: sum(r[k] for r in rows) for k in keys}
    log(f"[kernel] one layer's six projections, 2 live entries: kernel "
        f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['ms'] / total['bound_ms']:.2f}x), plain "
        f"{total['plain_ms']:.4f} ms, torch.matmul {total['library_ms']:.4f} "
        f"ms; no live entry: kernel {total['no_live_ms']:.4f} ms, bound "
        f"{total['no_live_bound_ms']:.4f} ms, torch.matmul "
        f"{total['library_no_live_ms']:.4f} ms   [{card}]")
    log(f"[kernel] against the targets: 2 live {total['ms']:.4f} ms <= "
        f"{DELTA_TARGET_BOUND_X:g} x bound {DELTA_TARGET_BOUND_X * total['bound_ms']:.4f} "
        f"ms: {total['ms'] <= DELTA_TARGET_BOUND_X * total['bound_ms']}; no "
        f"live {total['no_live_ms']:.4f} ms <= torch.matmul "
        f"{total['library_no_live_ms']:.4f} ms: "
        f"{total['no_live_ms'] <= total['library_no_live_ms']}")
    return {"rows": rows, "total": total, "max_abs_err": max_err}


def synthetic_store(model, users: int, layers_per_user: int, seed: int):
    """Per-user f32 delta rows on ``layers_per_user`` random layers, drawn
    on the card for those rows only.  (``demo_store`` draws noise for every
    layer of every leaf, about 4e9 numpy normals at full width.)  The
    layers are global mask indices below ``n_layers``: rows of ``blocks``,
    or of the moe family's ``dense0`` and ``blocks``."""
    import numpy as np
    import torch
    from repro_torch.models.model import _block_shapes
    from repro_torch.serve import DeltaRecord, DeltaStore
    from repro_torch.serve.deltas import mask_index_map

    cfg = model.cfg
    kinds = ({"dense0": "moe_dense0", "blocks": "moe"}
             if cfg.family == "moe" else
             {"blocks": "ssm" if cfg.family in ("ssm", "hybrid")
              else "dense"})
    where = mask_index_map(cfg)
    store = DeltaStore(cfg)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for uid in range(users):
        idx = np.sort(rng.choice(cfg.n_layers, size=layers_per_user,
                                 replace=False)).astype(np.int32)
        segments = {}
        for path, kind in kinds.items():
            rows = np.asarray([where[i][1] for i in idx
                               if where[i][0] == path], np.int32)
            if rows.size:
                segments[path] = (rows, {
                    name: (torch.randn((rows.size, *shp), generator=gen,
                                       device=model.device) * 0.01
                           ).cpu().numpy()
                    for name, shp in _block_shapes(cfg, kind).items()})
        store.put(uid, DeltaRecord(layers=idx, segments=segments))
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
    step_ms = {k: v["stats"]["wall_s"] * 1e3 / v["stats"]["steps"]
               for k, v in results.items()}
    results["delta_over_shared"] = step_ms["delta"] / step_ms["shared"]
    log(f"[serve] delta ms/step / shared ms/step in this call: "
        f"{step_ms['delta']:.2f} / {step_ms['shared']:.2f} = "
        f"{results['delta_over_shared']:.3f} (target <= 1.2)   [{card}]")
    results["host_us"] = serve_host_costs(model, params, store, card)
    a, b = results["delta"]["gen"], results["delta_plain"]["gen"]
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    log(f"[serve] delta tokens, kernel vs plain version: {same} of "
        f"{sum(len(v) for v in a.values())} equal (bf16: greedy decoding "
        f"may part after a near tie)")
    return results


def serve_host_costs(model, params, store, card: str) -> dict:
    """Host time per call, in microseconds, of what a delta decode step adds
    to a shared one, at layer 0's attn_wq with four users resident: the
    kernel's wrapper (``ops.base_delta_matmul``) against the shared step's
    ``x @ w``, and the per-slot norm scale (``blocks.per_slot_param``,
    twice a layer).  1000 calls each, synchronised only at the end; the
    decode step is host-bound, so these set its time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    from repro_torch.serve import DeltaOverlay
    ov = DeltaOverlay(model, 4, device="cuda")
    for s in range(4):
        ov.try_admit(s, store.get(s))
    dev = ov.device()
    slots = dev["slots"][0]
    w = params["blocks"]["attn_wq"][0]
    dw = dev["leaves"]["attn_wq"][0]
    x = torch.randn((4, 1, w.shape[0]), device="cuda").to(w.dtype)
    ln, dln = params["blocks"]["attn_ln"][0], dev["leaves"]["attn_ln"][0]
    calls = {"ops.base_delta_matmul": lambda: ops.base_delta_matmul(
                 x, w, dw, slots),
             "x @ w": lambda: x @ w,
             "blocks.per_slot_param": lambda: blocks.per_slot_param(
                 ln, dln, slots, 4)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(1000):
                fn()
            out[name] = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
    log("[serve] host time per call (us, 1000 calls, decode shapes): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out.items())
        + f"   [{card}]")
    del ov
    return out


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


def lgn_check(g, name: str, card: str, flush=None):
    """layer_grad_norm on one (L, F) leaf against its plain version (rtol
    1e-5; two launches bit for bit).  With ``flush``, also its time, its
    bound, the plain version's and the library call's.  Returns
    (max_abs_err, the timed row or None)."""
    import torch
    from repro_torch.kernels import layer_grad_norm as lgn
    L, F = g.shape
    dtn = "bfloat16" if g.dtype == torch.bfloat16 else "float32"
    got = lgn.layer_sq_norms_2d(g)
    want = lgn.layer_sq_norms_2d_torch(g)
    again = lgn.layer_sq_norms_2d(g)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=1e-5, atol=0.0)
    log(f"[train-kernel] layer_grad_norm {name:16s} L={L} F={F:9d} "
        f"{dtn:8s} max_abs_err={err:.3e} max_rel_err="
        f"{((got - want).abs() / want.abs()).max().item():.3e} "
        f"(rtol 1e-5) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"layer_grad_norm disagrees with its plain version at {name}")
    check(torch.equal(got, again), f"layer_grad_norm is not "
                                   f"deterministic at {name}")
    if flush is None:
        return err, None
    bound, by = stream_bound(L * F * g.element_size() + 4 * L, 2 * L * F)
    r = {"leaf": name, "L": L, "F": F, "bound_ms": bound, "bound_by": by,
         "ms": time_ms(lambda: lgn.layer_sq_norms_2d(g), flush),
         "plain_ms": time_ms(lambda: lgn.layer_sq_norms_2d_torch(g), flush),
         "library_ms": time_ms(lambda: torch.linalg.vector_norm(
             g, dim=1, dtype=torch.float32) ** 2, flush)}
    log(f"[train-kernel]   time {r['ms']:.4f} ms | bound "
        f"{bound:.4f} ms ({by}) | kernel/bound {r['ms'] / bound:.2f} "
        f"| plain {r['plain_ms']:.4f} ms | torch.linalg.vector_norm"
        f"(g, dim=1, dtype=f32)**2 {r['library_ms']:.4f} ms   [{card}]")
    return err, r


def mu_check(p, g, mask, lr: float, name: str, card: str, flush=None):
    """masked_update on one (L, F) leaf against its plain version (bit for
    bit).  With ``flush``, also its time, its bound, the plain version's
    and the library call's.  Returns (max_abs_err, the timed row or
    None)."""
    import torch
    from repro_torch.kernels import masked_update as mu
    L, F = p.shape
    dtn = "bfloat16" if p.dtype == torch.bfloat16 else "float32"
    got = mu.masked_sgd_update_2d(p, g, mask, lr)
    want = mu.masked_sgd_update_2d_torch(p, g, mask, lr)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.equal(got, want)
    log(f"[train-kernel] masked_update   {name:16s} L={L} F={F:9d} "
        f"{dtn:8s} max_abs_err={err:.3e} (must be 0) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"masked_update differs from its plain version at {name}")
    del got, want
    if flush is None:
        return err, None
    bound, by = stream_bound(L * F * 3 * p.element_size() + 4 * L, 2 * L * F)
    scale = (-lr * mask)[:, None]
    r = {"leaf": name, "L": L, "F": F, "bound_ms": bound, "bound_by": by,
         "ms": time_ms(lambda: mu.masked_sgd_update_2d(p, g, mask, lr),
                       flush),
         "plain_ms": time_ms(lambda: mu.masked_sgd_update_2d_torch(
             p, g, mask, lr), flush),
         "library_ms": time_ms(lambda: torch.addcmul(p, g, scale), flush)}
    log(f"[train-kernel]   time {r['ms']:.4f} ms | bound "
        f"{bound:.4f} ms ({by}) | kernel/bound {r['ms'] / bound:.2f} "
        f"| plain {r['plain_ms']:.4f} ms | torch.addcmul(p, g, "
        f"(-lr*m)[:, None]) (f32 out) {r['library_ms']:.4f} ms   [{card}]")
    return err, r


def kernel_totals(rows: list) -> dict:
    return {k: sum(r[k] for r in rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


def phase_train_kernels(card: str, arch: str = "tinyllama_1_1b",
                        kind: str = "dense", f32_leaves=("attn_wq",),
                        ragged: bool = True) -> dict:
    """Both training kernels vs their plain versions at one family's block
    leaves (norms over all L rows, the update over the L/2 rows above a cut
    at L/2 with a mixed 0/1 mask), plus f32 cases of ``f32_leaves`` and,
    with ``ragged``, ragged F."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import _block_shapes

    cfg = get_arch(arch)
    leaves = [(name, math.prod(shp))
              for name, shp in sorted(_block_shapes(cfg, kind).items())]
    L, L_upd, lr = cfg.n_layers, cfg.n_layers // 2, 0.01
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    mask = torch.tensor([float(i % 3 != 1) for i in range(L_upd)],
                        device="cuda")
    cases = [(name, F, torch.bfloat16, True) for name, F in leaves]
    cases += [(f"{name}/f32", dict(leaves)[name], torch.float32, False)
              for name in f32_leaves]
    if ragged:
        cases += [("ragged_F5000", 5000, torch.bfloat16, False),
                  ("ragged_F17", 17, torch.float32, False)]
    rows = {"layer_grad_norm": [], "masked_update": []}
    errs = {"layer_grad_norm": 0.0, "masked_update": 0.0}
    for name, F, dt, on_path in cases:
        g = torch.randn((L, F), generator=gen, device="cuda").to(dt)
        err, r = lgn_check(g, name, card, flush if on_path else None)
        if on_path:
            errs["layer_grad_norm"] = max(errs["layer_grad_norm"], err)
            rows["layer_grad_norm"].append(r)
        del g
        p = torch.randn((L_upd, F), generator=gen, device="cuda").to(dt)
        g = torch.randn((L_upd, F), generator=gen, device="cuda").to(dt)
        err, r = mu_check(p, g, mask, lr, name, card,
                          flush if on_path else None)
        if on_path:
            errs["masked_update"] = max(errs["masked_update"], err)
            rows["masked_update"].append(r)
        del p, g
    out = {}
    for kname, rs in rows.items():
        total = kernel_totals(rs)
        log(f"[train-kernel] {kname}, {cfg.name}'s {len(leaves)} leaves: kernel "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, plain "
            f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} "
            f"ms   [{card}]")
        out[kname] = {"rows": rs, "total": total, "max_abs_err": errs[kname]}
    del flush
    torch.cuda.empty_cache()
    return out


def _round_experiment(cfg, task, model=None, strategy="ours", rounds=3,
                      pipeline=False, **kw):
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig
    return Experiment(model if model is not None else cfg, task, strategy,
                      cohort_size=4, local_steps=2, batch_size=4, budget=2,
                      lam=1.0, lr=0.01, rounds=rounds, pipeline=pipeline,
                      runtime=RuntimeConfig(remat=False, seq_chunk=128),
                      device="cuda", **kw)


def probe_err_vs_f32(cfg, task, params, sampled, stats_k,
                     stats_p) -> tuple[float, float]:
    """Largest relative error of two bf16 probes (the kernel path's, the
    plain versions') against the same probe in f32 (plain versions, the
    bf16 params cast up).  The flash kernel and its plain version round
    attention outputs and gradients to bf16 after summing in other orders,
    so the two bf16 paths part by ~1e-3 over 22 layers; each is held
    against f32 instead, as the serving logits are."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    c32 = dataclasses.replace(cfg, dtype="float32")
    ref = _round_experiment(c32, task, model=Model(
        c32, RuntimeConfig(remat=False, seq_chunk=128), device="cuda",
        kernel_mode="torch")).build()
    p32 = tree_map(lambda t: t.float(), params)
    stats_32 = ref.probe_round(p32, sampled)
    del ref, p32
    torch.cuda.empty_cache()

    def err(st):
        return max(float(np.max(np.abs(st[k] - stats_32[k])
                                / np.abs(stats_32[k]))) for k in st)
    return err(stats_k), err(stats_p)


def _tree_max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_tree_max_diff(a[k], b[k]) for k in a)
    return (a.float() - b.float()).abs().max().item()


def phase_round(card: str, seq: int = 128) -> dict:
    """Three rounds of Algorithm 1 ("ours") at full TinyLlama-1.1B width in
    bf16 on sequences of ``seq`` tokens, the attention through the flash
    kernels, through Experiment.run, counting kernel launches against the
    round's structure; then round 0 again, stage by stage (flash launches
    per stage), against the plain versions (each bf16 probe also against
    an f32 probe) and the dense program."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    tag = "round" if seq == 128 else f"round-{seq}"
    cfg = get_arch("tinyllama_1_1b")
    L = cfg.n_layers

    def task():
        return SyntheticFederatedData(FederatedTaskConfig(
            n_clients=16, vocab_size=cfg.vocab_size, seq_len=seq,
            test_samples=32, objective="lm", skew="feature", seed=0))
    exp = _round_experiment(cfg, task())
    fl = exp.fl
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
        log(f"[{tag}] round {r.round}: cohort {r.cohort.tolist()} cut {cut} "
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
            "base_delta_matmul": 0, **SSD_NONE,
            **flash_want(fl, L, cuts)}
    log(f"[{tag}] launches {launches}, want {want}")
    check(launches == want, "the round did not launch the kernels as often "
                            "as its path requires")
    tokens = fl.cohort_size * fl.local_steps * fl.batch_size * seq
    log(f"[{tag}] {len(hist.records)} rounds in {run_s:.3f} s; per round "
        f"{[round(r.wall_s, 3) for r in hist.records]} s; peak device memory "
        f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)   [{card}]")

    # round 0 again, stage by stage: kernels, plain versions, dense program
    t = task()
    srv = _round_experiment(cfg, t).build()
    stage = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t1,
                       (ops.LAUNCHES["flash_attention"],
                        ops.LAUNCHES["flash_attention_bwd"]))
        return res
    plan, sampled = staged("plan+sample", lambda: (
        lambda pl: (pl, srv.sample_round(pl)))(srv.plan_round(0)))
    stats = staged("probe", lambda: srv.probe_round(params, sampled))
    masks = staged("select", lambda: srv.select_round(plan, stats))
    new_k, losses = staged("update", lambda: srv.update_round(params, sampled,
                                                              masks))
    test_loss, _ = staged("eval", lambda: srv.client.evaluate(
        new_k, srv._to_device(t.test_batch())))
    split = {k: v[0] for k, v in stage.items()}
    per_stage = {k: v[1] for k, v in stage.items()}
    c0 = cuts[0]
    probe = fl.cohort_size * fl.selection_batches
    update = fl.cohort_size * fl.local_steps
    want_stage = {"plan+sample": (0, 0), "probe": (L * probe, L * probe),
                  "select": (0, 0),
                  "update": (L * update, update * (L - c0)),
                  "eval": (L, 0)}
    log(f"[{tag}] timed round 0 (synchronised at stage boundaries): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"; {tokens / split['update']:.0f} trained tokens/s in the update "
        f"({tokens} tokens), {tokens / sum(split.values()):.0f} per round; "
        f"(flash_attention, flash_attention_bwd) launches per stage "
        f"{per_stage}, want {want_stage}   [{card}]")
    check(per_stage == want_stage, "flash launches per stage differ from the "
                                   "round's structure")
    check(np.array_equal(masks, hist.records[0].mask_matrix),
          "round 0 replayed stage by stage chose other masks than the run")
    del srv
    torch.cuda.empty_cache()

    plain = _round_experiment(cfg, t, model=Model(
        cfg, RuntimeConfig(remat=False, seq_chunk=128), device="cuda",
        kernel_mode="torch")).build()
    ops.reset_launches()
    stats_p = plain.probe_round(params, sampled)
    masks_p = plain.select_round(plan, stats_p)
    rel = max(float(np.max(np.abs(stats_p[k] - stats[k]) / np.abs(stats[k])))
              for k in stats)
    new_p, losses_p = plain.update_round(params, sampled, masks)
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version replay launched kernels: {ops.LAUNCHES}")
    dp = _tree_max_diff(new_k, new_p)
    del new_p, plain
    torch.cuda.empty_cache()
    err_k, err_p = probe_err_vs_f32(cfg, t, params, sampled, stats, stats_p)
    log(f"[{tag}] round 0, kernels vs plain versions: probe stats max rel "
        f"err {rel:.3e} (rtol {ROUND_PROBE_RTOL:g}); against the f32 probe: "
        f"kernel path {err_k:.3e}, plain path {err_p:.3e} (kernel at most "
        f"{E2E_ERR_RATIO:g}x plain); masks equal: "
        f"{bool(np.array_equal(masks_p, masks))}; update with the kernel "
        f"run's masks: max |Δparams| {dp:.3e} (atol {ROUND_PARAM_ATOL:g}), "
        f"losses {np.abs(losses - losses_p).max():.3e}")
    check(rel <= ROUND_PROBE_RTOL, "probe stats: kernel and plain versions "
                                   "disagree")
    check(err_k <= E2E_ERR_RATIO * err_p,
          "probe stats: the kernel path is less accurate than the plain "
          "versions'")
    check(np.array_equal(masks_p, masks), "plain-version probe stats chose "
                                          "other masks")
    check(dp <= ROUND_PARAM_ATOL, "updated params: kernel and plain versions "
                                  "disagree")
    dense = _round_experiment(cfg, t, mask_aware=False).build()
    new_d, losses_d = dense.update_round(params, sampled, masks)
    log(f"[{tag}] dense program (mask_aware=False) vs masked program, round "
        f"0: max |Δparams| {_tree_max_diff(new_k, new_d):.3e} (bf16), "
        f"losses {np.abs(losses - losses_d).max():.3e}, test loss "
        f"{test_loss:.6f}")
    del new_k, new_d, dense
    torch.cuda.empty_cache()
    return {"launches": launches, "run_s": run_s,
            "wall_s": [r.wall_s for r in hist.records], "split": split,
            "peak_gb": peak_gb, "tokens_per_round": tokens,
            "probe_rel_err": rel, "probe_err_vs_f32": (err_k, err_p),
            "params_max_diff": dp}


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
    # f32 attention takes the exact SIMT route, forward and backward
    check(lg["flash_attention_simt"] == lg["flash_attention"] > 0
          and lg["flash_attention_bwd_simt"] == lg["flash_attention_bwd"] > 0,
          f"reduced f32 run: flash launches by route {lg}")
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

# ---------------------------------------------------------------------------
# The ssm family: ssd_scan, Mamba2-370M rounds and serving
# ---------------------------------------------------------------------------

SSD_CHUNK = 128
# The ssd_scan launch counters of ops.LAUNCHES: total and per route.
SSD_NONE = {"ssd_scan": 0, "ssd_scan_mma": 0, "ssd_scan_simt": 0}
SSM_SEQ = 512            # the Mamba2 round's seq_len: four chunks
# Mamba2-370M's scan on the main path: the round's batch 4 × seq_len 512
SSD_MAIN = dict(b=4, s=512, h=32, p=64, g=1, n=128)
# Forward logits vs step-by-step decode, f32, full width (the reference's
# own decode-consistency test holds 2e-3)
DECODE_TOL = 2e-3


def ssd_bound(b, s, h, p, g, n, q, dtype) -> tuple[float, str]:
    """Least time in ms for one scan: its bytes (x, B/C per group, dt, A, D
    read once, y written once) over HBM bandwidth, or the operations these
    inputs need (the causal half of each chunk's Q × Q products; no
    inter-chunk term for the first chunk, no state update after the last)
    over the peak rate of the inputs' type."""
    import torch

    from repro_torch.kernels.ops import ssd_flops
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * p * es + 2 * b * s * g * n * es
              + b * s * h * 4 + 2 * h * 4)
    flops = ssd_flops(b, s, h, p, n, q)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_inputs(b, s, h, p, g, n, dtype, gen, slow_decay=False):
    """Model-layout scan inputs as mamba2_fwd builds them: x, B and C are
    strided views of one (b, s, h·p + 2·g·n) conv output, dt = softplus(·)
    in f32, A_log and D in the inputs' type.  At the model's init A ≈ −1
    and dt ≈ 0.7, so the state decays within ~20 positions; ``slow_decay``
    (A ∈ [−0.05, −0.005], dt ≈ 0.02) carries it across every chunk."""
    import torch
    import torch.nn.functional as F
    dev = "cuda"
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    raw = torch.randn((b, s, h), generator=gen, device=dev)
    if slow_decay:
        dt = F.softplus(raw - 4.0)
        A_log = torch.log(torch.rand((h,), generator=gen, device=dev)
                          * 0.045 + 0.005).to(dtype)
    else:
        dt = F.softplus(raw)
        A_log = (torch.randn((h,), generator=gen, device=dev) * 0.02).to(dtype)
    D = (torch.randn((h,), generator=gen, device=dev) * 0.02).to(dtype)
    return x, dt, A_log, Bm, Cm, D


def phase_ssd_kernel(card: str, cases=None) -> dict:
    """ssd_scan vs its plain version (``ssd_scan_torch``, through
    ``ops.ssd``'s torch mode) on the card: by default Mamba2-370M's
    main-path shape (at the model's init and with a slowly decaying
    state), a single chunk, G > 1 and f32 inputs; ``cases`` gives others as
    (name, shape, dtype, slow decay, on the main path).  Two launches must
    give the same bits, the bf16 cases must take the tensor-core route and
    f32 the SIMT one.  The main-path and f32 cases are timed; at the
    main-path ones the SIMT kernel is timed on the same bf16 inputs too,
    and one layer's forward and backward."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    m = SSD_MAIN
    bf16, f32 = torch.bfloat16, torch.float32
    if cases is None:
        cases = [("main", m, bf16, False, True),
                 # slice 17: one model rank's share at M = 16 (2 heads)
                 ("tp_local_m16", dict(m, h=m["h"] // 16), bf16, False,
                  True),
                 ("main/slow_decay", m, bf16, True, False),
                 ("single_chunk", dict(m, s=128), bf16, True, False),
                 ("groups_4", dict(m, g=4), bf16, True, False),
                 ("main/f32", m, f32, True, False)]
    out = {}
    for name, shp, dtype, slow, on_path in cases:
        x, dt, A_log, Bm, Cm, D = ssd_inputs(**shp, dtype=dtype, gen=gen,
                                             slow_decay=slow)
        A, Df = -torch.exp(A_log.float()), D.float()

        def kernel():
            return sk.ssd_scan(x, dt, A, Bm, Cm, Df, chunk=SSD_CHUNK)

        def plain():
            with torch.no_grad():
                return ops.ssd(x, dt, A_log, Bm, Cm, D, chunk=SSD_CHUNK,
                               mode="torch")
        route = sk.route(dtype, shp["p"], shp["n"])
        check(route == ("mma" if dtype == bf16 else "simt"),
              f"ssd_scan {name}: {dtype} took the {route} route")
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        # bf16 out: one rounding of an f32 sum taken in another order; f32
        # out: 1e-5 of the output's largest magnitude
        rtol, atol = ((TOL["bfloat16"], TOL["bfloat16"]) if dtype == bf16
                      else (1e-5, 1e-5 * scale))
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), rtol=rtol, atol=atol)
        dtn = "bfloat16" if dtype == bf16 else "float32"
        log(f"[ssd-kernel] {name:16s} {shp} {dtn:8s} route {route} "
            f"max_abs_err={err:.3e} (rtol {rtol:g}, atol {atol:.3g}; |y| <= "
            f"{scale:.3g}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"ssd_scan disagrees with its plain version at {name}")
        check(torch.equal(got, again), f"ssd_scan is not deterministic at "
                                       f"{name}")
        if on_path or dtype == f32:
            bound, by = ssd_bound(**shp, q=SSD_CHUNK, dtype=dtype)
            r = {"case": name, **shp, "chunk": SSD_CHUNK, "dtype": dtn,
                 "route": route, "max_abs_err": err, "bound_ms": bound,
                 "bound_by": by, "ms": time_ms(kernel, flush),
                 "plain_ms": time_ms(plain, flush)}
            simt = ""
            if route == "mma":
                # the SIMT kernel (the f32 route's) on the same bf16 inputs
                with mock.patch.object(sk, "route", lambda *a: "simt"):
                    r["simt_ms"] = time_ms(kernel, flush)
                simt = (f" | SIMT kernel {r['simt_ms']:.4f} ms "
                        f"({r['simt_ms'] / r['ms']:.1f}x)")
            out[name] = r
            log(f"[ssd-kernel]   time {r['ms']:.4f} ms | bound {bound:.4f} "
                f"ms ({by}) | kernel/bound {r['ms'] / bound:.1f} | plain "
                f"{r['plain_ms']:.4f} ms{simt} | library: none   [{card}]")
        if on_path:
            # what one layer's scan costs a training step: the kernel's
            # forward, then the backward's recompute through ssd_chunked
            ins = [t.detach().requires_grad_() for t in (x, dt, A_log, Bm,
                                                         Cm, D)]
            gy = torch.randn_like(got)

            def fwd_bwd():
                torch.autograd.grad(ops.ssd(*ins, chunk=SSD_CHUNK), ins, gy)
            r["fwd_bwd_ms"] = time_ms(fwd_bwd, flush)
            log(f"[ssd-kernel]   ops.ssd forward + backward (recomputed "
                f"through ssd_chunked) {r['fwd_bwd_ms']:.4f} ms   [{card}]")
            del ins, gy
        del x, dt, A_log, Bm, Cm, D, got, again, want
    del flush
    torch.cuda.empty_cache()
    return out


def _ssm_task(cfg):
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    return SyntheticFederatedData(FederatedTaskConfig(
        n_clients=16, vocab_size=cfg.vocab_size, seq_len=SSM_SEQ,
        test_samples=32, objective="lm", skew="feature", seed=0))


def phase_ssm_round(card: str) -> dict:
    """Three rounds of "ours" at full Mamba2-370M width (seq_len 512: four
    chunks, the carried state crosses three boundaries) through
    Experiment.run, counting launches against the round's structure; round
    0 replayed stage by stage (launches per stage) and against the plain
    versions; then one "top" round, whose cut at 46 makes the mask-aware
    engine skip a 46-layer prefix."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, _block_shapes

    cfg = get_arch("mamba2_370m")
    L, n_leaves = cfg.n_layers, len(_block_shapes(cfg, "ssm"))
    exp = _round_experiment(cfg, _ssm_task(cfg))
    fl = exp.fl
    params = exp.init_params()
    log(f"[ssm-round] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params['blocks'].values()) / 1e6:.1f} M "
        f"block + {params['embed']['tok'].numel() / 1e6:.1f} M embedding "
        f"params in {cfg.dtype}")
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
        log(f"[ssm-round] round {r.round}: cohort {r.cohort.tolist()} cut "
            f"{cut} selected "
            f"{[np.flatnonzero(m).tolist() for m in r.mask_matrix]} "
            f"train_loss {r.train_loss:.6f} test_loss {r.test_loss:.6f} "
            f"{r.wall_s:.3f} s   [{card}]")
        check(all(math.isfinite(v) for v in (r.train_loss, r.test_loss)),
              f"round {r.round}: non-finite loss")
        check(np.all(r.mask_matrix.sum(1) <= fl.budget)
              and r.mask_matrix.shape == (fl.cohort_size, L),
              f"round {r.round}: masks break the budget")
    n = len(hist.records)
    probe_fwd = fl.cohort_size * fl.selection_batches
    update_fwd = fl.cohort_size * fl.local_steps
    scans = n * (probe_fwd + update_fwd + 1) * L     # every one bf16: mma
    want = {"ssd_scan": scans, "ssd_scan_mma": scans, "ssd_scan_simt": 0,
            "layer_grad_norm": n * probe_fwd * n_leaves,
            "masked_update": sum(update_fwd * n_leaves for c in cuts
                                 if c < L),
            "base_delta_matmul": 0, **FLASH_NONE}
    log(f"[ssm-round] launches {launches}, want {want} (ssd_scan: one per "
        f"layer per sequence forward: probe {probe_fwd}, update "
        f"{update_fwd}, eval 1 per round; all bf16, on the tensor-core "
        f"route)")
    check(launches == want, "the Mamba2 round did not launch the kernels as "
                            "often as its path requires")
    tokens = update_fwd * fl.batch_size * SSM_SEQ
    log(f"[ssm-round] {n} rounds in {run_s:.3f} s; per round "
        f"{[round(r.wall_s, 3) for r in hist.records]} s; peak device memory "
        f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)   [{card}]")

    # round 0 again, stage by stage, launches counted per stage
    task = _ssm_task(cfg)
    srv = _round_experiment(cfg, task).build()
    rt = RuntimeConfig(remat=False, seq_chunk=128)
    plain = _round_experiment(cfg, task, model=Model(
        cfg, rt, device="cuda", kernel_mode="torch")).build()
    stage = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t, ops.LAUNCHES["ssd_scan"])
        return res
    plan, sampled = staged("plan+sample", lambda: (
        lambda pl: (pl, srv.sample_round(pl)))(srv.plan_round(0)))
    stats = staged("probe", lambda: srv.probe_round(params, sampled))
    masks = staged("select", lambda: srv.select_round(plan, stats))
    new_k, losses = staged("update", lambda: srv.update_round(params, sampled,
                                                              masks))
    test_loss, _ = staged("eval", lambda: srv.client.evaluate(
        new_k, srv._to_device(task.test_batch())))
    split = {k: v[0] for k, v in stage.items()}
    per_stage = {k: v[1] for k, v in stage.items()}
    log(f"[ssm-round] timed round 0 (synchronised at stage boundaries): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"; {tokens / split['update']:.0f} trained tokens/s in the update "
        f"({tokens} tokens), {tokens / sum(split.values()):.0f} per round; "
        f"ssd_scan launches per stage {per_stage}   [{card}]")
    check(per_stage == {"plan+sample": 0, "probe": probe_fwd * L,
                        "select": 0, "update": update_fwd * L, "eval": L},
          "ssd_scan launches per stage differ from the round's structure")
    check(np.array_equal(masks, hist.records[0].mask_matrix),
          "round 0 replayed stage by stage chose other masks than the run")
    ops.reset_launches()
    stats_p = plain.probe_round(params, sampled)
    masks_p = plain.select_round(plan, stats_p)
    rel = max(float(np.max(np.abs(stats_p[k] - stats[k]) / np.abs(stats[k])))
              for k in stats)
    new_p, losses_p = plain.update_round(params, sampled, masks)
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version replay launched kernels: {ops.LAUNCHES}")
    dp = _tree_max_diff(new_k, new_p)
    log(f"[ssm-round] round 0, kernels vs plain versions: probe stats max "
        f"rel err {rel:.3e} (rtol 2e-2: 48 bf16 layers, see PERF.md); masks "
        f"equal: {bool(np.array_equal(masks_p, masks))}; update with the "
        f"kernel run's masks: max |Δparams| {dp:.3e} (bf16), losses "
        f"{np.abs(losses - losses_p).max():.3e}; test loss {test_loss:.6f}")
    check(rel <= 2e-2, "probe stats: kernel and plain versions disagree")
    check(np.array_equal(masks_p, masks), "plain-version probe stats chose "
                                          "other masks")
    del new_p, new_k
    torch.cuda.empty_cache()

    # one "top" round: the cut at L − budget freezes a 46-layer prefix
    top = _round_experiment(cfg, _ssm_task(cfg), strategy="top", rounds=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, hist_top = top.run(params)
    torch.cuda.synchronize()
    top_s = time.perf_counter() - t0
    top_launches = dict(ops.LAUNCHES)
    top_peak = torch.cuda.max_memory_allocated() / 1e9
    del final
    rec = hist_top.records[0]
    top_cut = int(np.flatnonzero(rec.mask_matrix.sum(0) > 0)[0])
    want_top = {"ssd_scan": (update_fwd + 1) * L,
                "ssd_scan_mma": (update_fwd + 1) * L, "ssd_scan_simt": 0,
                "layer_grad_norm": 0,
                "masked_update": update_fwd * n_leaves,
                "base_delta_matmul": 0, **FLASH_NONE}
    log(f"[ssm-round] top round: cut {top_cut}, train_loss "
        f"{rec.train_loss:.6f} test_loss {rec.test_loss:.6f}, {top_s:.3f} s, "
        f"peak {top_peak:.2f} GB; launches {top_launches}, want {want_top}"
        f"   [{card}]")
    check(top_cut == L - fl.budget, f"top round cut at {top_cut}")
    check(top_launches == want_top, "the top round did not launch the "
                                    "kernels as its path requires")
    check(all(math.isfinite(v) for v in (rec.train_loss, rec.test_loss)),
          "top round: non-finite loss")
    return {"launches": launches, "top_launches": top_launches,
            "run_s": run_s, "wall_s": [r.wall_s for r in hist.records],
            "split": split, "peak_gb": peak_gb, "top_s": top_s,
            "top_peak_gb": top_peak, "tokens_per_round": tokens,
            "probe_rel_err": rel}


def phase_profile(card: str, arch, seq: int, tag: str,
                  kernels: dict) -> dict:
    """Where a training step's time goes: one client step at full width
    (loss and gradients of every selectable layer's leaves, batch 4 ×
    ``seq``, bf16) under torch.profiler, after a warm-up step.  ``arch``
    names a config, or is one.  Reports the step's wall time, the device's
    busy time (the kernels' own time; idle = the rest) and the kernels that
    take most of it, grouped by ``kernels`` (label → substrings of the
    port's kernel names), matmuls and the rest.  An audio config's batch
    also carries 4 × ``enc_seq`` frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.models.model import Model, layer_layout

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=128),
                  device="cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, seq),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device="cuda")
    wrt = {seg.path: {k: v.detach().requires_grad_()
                      for k, v in params[seg.path].items()}
           for seg in layer_layout(cfg)}
    leaves = [v for sub in wrt.values() for v in sub.values()]

    def step():
        loss = model.loss({**params, **wrt}, batch)
        torch.autograd.grad(loss, leaves)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    found = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found[e.key] = (found.get(e.key, (0.0, 0))[0]
                            + e.self_device_time_total / 1e3,
                            found.get(e.key, (0.0, 0))[1] + e.count)
    busy_ms = sum(v[0] for v in found.values())
    n_launch = sum(v[1] for v in found.values())
    matmul, other = "matmul (cuBLAS/CUTLASS)", "other"
    groups = {**{label: 0.0 for label in kernels}, matmul: 0.0, other: 0.0}
    for name, (ms, _) in found.items():
        low = name.lower()
        key = next((label for label, pats in kernels.items()
                    if any(pat in low for pat in pats)), None)
        if key is None:
            key = matmul if any(w in low for w in (
                "gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")) else other
        groups[key] += ms
    top = sorted(found.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[{tag}] one full-width client step (fwd+bwd, "
        f"{cfg.n_layers + cfg.n_enc_layers} layers, 4 × {seq} tokens): wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%; idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), {n_launch} kernel launches"
        f"   [{card}]")
    log(f"[{tag}] device time by group: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in groups.items()))
    for name, (ms, cnt) in top:
        log(f"[{tag}]   {ms:8.2f} ms  {cnt:5d}x  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": n_launch,
            "groups": groups}


def phase_ssm_serve(card: str) -> dict:
    """Full-width Mamba2-370M through SlotServer in shared and dense mode;
    then, in f32, the sequence forward's logits (the kernel, two chunks of
    a 256-token prompt) against step-by-step decode (the recurrence)."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_arch("mamba2_370m")
    rt = RuntimeConfig(remat=False, seq_chunk=128)
    model = Model(cfg, rt, device="cuda")
    params = model.init(0)
    slots, n_req, plen, max_new = 4, 8, 8, 16
    max_seq = plen + max_new + 1
    store = synthetic_store(model, users=4, layers_per_user=2, seed=0)
    results = {}
    for mode in ("shared", "dense"):
        srv = serve.SlotServer(model, params, slots, max_seq, mode=mode,
                               store=None if mode == "shared" else store,
                               device="cuda")
        reqs = requests(cfg, n_req, plen, max_new,
                        0 if mode == "shared" else 4)
        torch.cuda.synchronize()
        ops.reset_launches()
        done, stats = srv.run(reqs)
        torch.cuda.synchronize()
        check(len(done) == n_req and all(len(r.generated) == max_new
                                         for r in done),
              f"ssm {mode}: {len(done)} of {n_req} requests finished")
        check(all(v == 0 for v in ops.LAUNCHES.values()),
              f"ssm {mode} decode launched kernels: {ops.LAUNCHES}")
        results[mode] = stats
        log(f"[ssm-serve] {mode:6s} {stats['steps']} steps, "
            f"{stats['gen_tokens']} tokens, {stats['tok_per_s']:.1f} tok/s, "
            f"{stats['wall_s'] * 1e3 / stats['steps']:.2f} ms/step   [{card}]")
        del srv
    del params, store
    torch.cuda.empty_cache()

    import dataclasses
    c32 = dataclasses.replace(cfg, dtype="float32")
    m32 = Model(c32, rt, device="cuda")
    p32 = m32.init(1)
    S = 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launches()
    with torch.no_grad():
        h, _, _ = m32.forward_seq(p32, {"tokens": tokens})
        seq_logits = m32._head(p32, h)
    check(ops.LAUNCHES["ssd_scan"] == ops.LAUNCHES["ssd_scan_simt"]
          == cfg.n_layers and ops.LAUNCHES["ssd_scan_mma"] == 0,
          f"the f32 sequence forward made {ops.LAUNCHES['ssd_scan']} ssd_scan "
          f"launches ({ops.LAUNCHES['ssd_scan_simt']} SIMT), want "
          f"{cfg.n_layers}, all on the SIMT route")
    cache = m32.init_cache(2, S)
    t0 = time.perf_counter()
    dec = []
    for t in range(S):
        logits, cache = m32.decode_step(
            p32, tokens[:, t], torch.tensor(t, dtype=torch.int32,
                                            device="cuda"), cache)
        dec.append(logits)
    dec = torch.stack(dec, 1)
    torch.cuda.synchronize()
    err = (dec - seq_logits).abs().max().item()
    scale = seq_logits.abs().max().item()
    ok = bool(torch.isfinite(seq_logits).all()) and torch.allclose(
        dec, seq_logits, atol=DECODE_TOL, rtol=DECODE_TOL)
    per_pos = (dec - seq_logits).abs().amax(dim=(0, 2))
    log(f"[ssm-serve] f32 forward_seq (ssd_scan, 2 chunks) vs {S} decode "
        f"steps: max_abs_err {err:.3e} (|logits| <= {scale:.3g}; atol/rtol "
        f"{DECODE_TOL:g}); worst position {int(per_pos.argmax())}, at the "
        f"chunk boundary (127, 128) {per_pos[127].item():.3e}, "
        f"{per_pos[128].item():.3e}; decode "
        f"{(time.perf_counter() - t0) * 1e3 / S:.2f} ms/step "
        f"{'ok' if ok else 'MISMATCH'}   [{card}]")
    check(ok, "forward_seq and step-by-step decode disagree (f32)")
    results["decode_max_abs_err"] = err
    return results


# ---------------------------------------------------------------------------
# Slice 4: flash attention on the dense family's sequence attention
# ---------------------------------------------------------------------------

LONG_SEQ = 1024          # the long TinyLlama round's seq_len
# One TinyLlama-1.1B layer's attention on the long round's batch
FLASH_MAIN = dict(b=4, s=LONG_SEQ, h=32, k=4, d=64, causal=True, window=0)
# The same layer's share on one of 16 model ranks under tensor parallelism
# (``kv_shared``: 2 query heads and the one kv head they use)
FLASH_TP_LOCAL = dict(FLASH_MAIN, h=2, k=1)


# The flash launch counters of ops.LAUNCHES: totals and per route.
FLASH_NONE = {f"flash_attention{d}{r}": 0 for d in ("", "_bwd")
              for r in ("", "_mma", "_simt")}


def flash_want(fl, L: int, cuts) -> dict:
    """flash_attention / flash_attention_bwd launches of dense bf16 rounds
    of Algorithm 1 at the given cuts, all on the tensor-core route: one
    forward per layer per sequence forward (probe, τ update steps, one
    eval; at cut L the update still computes its losses), one backward per
    layer per probe and per differentiated layer (those at or above the
    cut) per update step."""
    probe = fl.cohort_size * fl.selection_batches
    update = fl.cohort_size * fl.local_steps
    fwd = len(cuts) * L * (probe + update + 1)
    bwd = sum(L * probe + update * (L - c) for c in cuts)
    return {**FLASH_NONE, "flash_attention": fwd, "flash_attention_mma": fwd,
            "flash_attention_bwd": bwd, "flash_attention_bwd_mma": bwd}


def flash_bound(b, s, h, k, d, causal, window, dtype,
                backward=False) -> tuple[float, str]:
    """Least time in ms for the forward (or the backward): the larger of
    its bytes (q, k, v read once and o, lse written once; the backward also
    reads o, dO and lse and writes dq, dk, dv) over HBM bandwidth and its
    operations on the visible pairs (forward QKᵀ and PV, 4·d per pair; the
    backward's five products, 10·d) over the peak rate of the inputs'
    type."""
    import torch

    from repro_torch.kernels.ops import flash_flops
    es = torch.tensor([], dtype=dtype).element_size()
    qo, kv, lse = b * h * s * d * es, b * k * s * d * es, b * h * s * 4
    nbytes = (4 * qo + 4 * kv + lse) if backward else (2 * qo + 2 * kv + lse)
    flops = flash_flops(b, h, d, s, causal, window, backward=backward)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_inputs(b, s, h, k, d, dtype, gen, fused_kv: bool = True):
    """q, k, v, dO as the model makes them: (B,S,H,D) / (B,S,K,D) slices of
    projections (q of a (B,S,H·D) product, k and v of one (B,S,2·K·D)
    product, so k and v are strided views; with ``fused_kv`` False, of one
    (B,S,K·D) product each, as ``blocks.attention_fwd`` projects them),
    standard normal."""
    import torch
    q = torch.randn((b, s, h * d), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((b, s, 2 * k * d), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, h * d), generator=gen, device="cuda").to(dtype)
    kt, vt = kv[..., :k * d], kv[..., k * d:]
    if not fused_kv:
        kt, vt = kt.contiguous(), vt.contiguous()
    return (q.reshape(b, s, h, d), kt.reshape(b, s, k, d),
            vt.reshape(b, s, k, d), do.reshape(b, s, h, d))


def _flash_close(got, want, dtype, grad: bool):
    """(ok, max_abs_err, rtol, atol).  Outputs: bf16 one rounding (1e-2),
    f32 1e-5.  Gradients sum up to S·H/K terms in another order: f32 within
    1e-4 relative and 1e-4 of the largest |grad|; bf16 one rounding plus
    1e-2 of the largest |grad|."""
    import torch
    scale = want.float().abs().max().item()
    if dtype == torch.bfloat16:
        rtol, atol = TOL["bfloat16"], TOL["bfloat16"] * (scale if grad else 1)
    else:
        rtol, atol = (1e-4, 1e-4 * scale) if grad else (1e-5, 1e-5)
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol)
    return ok, err, rtol, atol


def flash_layer_times(q, k, v, do, causal, window, flush) -> dict:
    """One layer's attention on model-layout (B,S,H,D) inputs through
    ops.flash_attention (the kernels), through blocks.attend_full (the
    path it replaced) and, without a window, through SDPA on (B,H,S,D)
    contiguous copies (the yardstick, timed only): forward under no_grad,
    as eval runs it, and forward plus backward, as the probe and the update
    run it; ms each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    pos = torch.arange(q.shape[1], device="cuda")
    bias = blocks._mask_bias(pos, pos, causal=causal, window=window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwds = {"kernel": (lambda: ops.flash_attention(
                *ins, causal=causal, window=window, mode="cuda"), ins, do),
            "attend_full": (lambda: blocks.attend_full(*ins, bias, scale),
                            ins, do)}
    if not window:
        lib = [t.detach().transpose(1, 2).contiguous().requires_grad_()
               for t in (q, k, v)]
        fwds["sdpa"] = (lambda: F.scaled_dot_product_attention(
            *lib, is_causal=causal, enable_gqa=True), lib,
            do.transpose(1, 2).contiguous())
    out = {}
    for label, (fwd, wrt, grad) in fwds.items():
        with torch.no_grad():
            out[f"{label}_fwd_ms"] = time_ms(fwd, flush)
        out[f"{label}_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(fwd(), wrt, grad), flush)
    return out


def kernel_ms(fn, flush, n: int = 10) -> dict:
    """Device time per call of each flash kernel that ``fn`` launches, from
    torch.profiler over ``n`` calls (cold L2, as time_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_" in e.key):
            name = next(w for w in e.key.replace("(", " ").replace(
                "<", " ").split() if "flash_" in w).split("::")[-1]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def flash_times(res: dict, shp: dict, dtype, q, k, v, do, flush) -> dict:
    """Kernel, plain-version, bound and SDPA times (ms) of one case's
    forward and backward, into ``res``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    causal, window = shp["causal"], shp["window"]
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    res["bound_ms"], res["bound_by"] = flash_bound(**shp, dtype=dtype)
    res["bwd_bound_ms"], res["bwd_bound_by"] = flash_bound(
        **shp, dtype=dtype, backward=True)
    o, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    res["ms"] = time_ms(lambda: fa.flash_attention(
        qt, kt, vt, causal=causal, window=window), flush)
    res["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd(
        qt, kt, vt, o, lse, dot, causal=causal, window=window), flush)
    res["plain_ms"] = time_ms(lambda: fa.flash_attention_torch(
        qt, kt, vt, causal=causal, window=window), flush)
    res["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_torch(
        qt, kt, vt, o, lse, dot, causal=causal, window=window), flush)
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ldo = dot.contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                              enable_gqa=True)
    res["library_ms"] = time_ms(sdpa, flush)
    l_out = sdpa()
    res["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        l_out, (lq, lk, lv), ldo, retain_graph=True), flush)
    return res


def flash_plan(shp: dict, dtype) -> dict:
    """The route of a case and, for the backward, the dK/dV split and grid
    (``flash_attention.route``, ``dkdv_parts``, ``dkdv_grid``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    route = fa.route(dtype, shp["d"])
    parts = fa.dkdv_parts(
        shp["b"], shp["k"], shp["s"], shp["h"] // shp["k"],
        torch.cuda.get_device_properties(0).multi_processor_count) \
        if route == "mma" else 1
    grid = fa.dkdv_grid(route, shp["b"], shp["k"], shp["s"], shp["d"], parts)
    return {"route": route, "dkdv_parts": parts, "dkdv_grid": list(grid),
            "dkdv_blocks": math.prod(grid)}


def flash_check(name: str, shp: dict, dtype, gen, fused_kv: bool = True):
    """The flash forward and backward kernels against their plain versions
    at one shape (o, dQ, dK, dV as :func:`_flash_close`, lse within 1e-5;
    two launches bit for bit); bf16 at head dims 64, 112 and 128 must take
    the tensor-core route.  ``fused_kv`` as :func:`flash_inputs`.  Returns
    the case's record and its model-layout inputs q, k, v, dO."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    causal, window = shp["causal"], shp["window"]
    plan = flash_plan(shp, dtype)
    if dtype == torch.bfloat16 and shp["d"] in (64, 112, 128):
        check(plan["route"] == "mma", f"flash_attention {name}: bf16 at "
                                      f"head dim {shp['d']} took the "
                                      f"{plan['route']} route")
    q, k, v, do = flash_inputs(shp["b"], shp["s"], shp["h"], shp["k"],
                               shp["d"], dtype, gen, fused_kv)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    o2, lse2 = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    o_p, lse_p = fa.flash_attention_torch(qt, kt, vt, causal=causal,
                                          window=window)
    g = fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, causal=causal,
                               window=window)
    g2 = fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, causal=causal,
                                window=window)
    g_p = fa.flash_attention_bwd_torch(qt, kt, vt, o, lse, dot,
                                       causal=causal, window=window)
    torch.cuda.synchronize()
    dtn = "bfloat16" if dtype == torch.bfloat16 else "float32"
    res = {"case": name, **shp, "dtype": dtn, **plan,
           "kv_strides_bhs": list(kt.stride()[:3])}
    checks = [("o", o, o_p, False), ("dq", g[0], g_p[0], True),
              ("dk", g[1], g_p[1], True), ("dv", g[2], g_p[2], True)]
    msgs = []
    for label, got, want, grad in checks:
        ok, err, rtol, atol = _flash_close(got, want, dtype, grad)
        res[f"{label}_max_abs_err"] = err
        msgs.append(f"{label} {err:.3e} (rtol {rtol:g}, atol {atol:.3g})")
        check(ok, f"flash_attention {label} disagrees with its plain "
                  f"version at {name}")
    lse_err = (lse - lse_p).abs().max().item()
    check(torch.allclose(lse, lse_p, rtol=1e-5, atol=1e-5),
          f"flash_attention lse disagrees with its plain version at "
          f"{name}: {lse_err:.3e}")
    same = (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip(g, g2)))
    check(same, f"flash_attention is not deterministic at {name}")
    log(f"[flash-kernel] {name:13s} {shp} {dtn:8s} route "
        f"{plan['route']}, dK/dV grid {tuple(plan['dkdv_grid'])} "
        f"({plan['dkdv_blocks']} blocks, group split in "
        f"{plan['dkdv_parts']}); max_abs_err: " + ", ".join(msgs)
        + f", lse {lse_err:.3e} (rtol/atol 1e-5); two launches equal "
        f"bit for bit: {same}")
    return res, (q, k, v, do)


def phase_flash_kernel(card: str) -> dict:
    """The flash forward and backward kernels vs their plain versions: the
    long round's shape (B 4, S 1024, H 32, K 4, D 64, bf16, causal), f32
    inputs, a 256 window, XLM-R's bidirectional 12 heads, head dims 128 and
    256, a ragged S, a head dim of 8 (the reduced check's) and the seq-128
    round's shapes (B 4 in the probe and update, B 32 in eval); two
    launches must give the same bits, and every bf16 case at head dim 64 or
    128 must take the tensor-core route.  At the main shape: the kernels
    (and each kernel's share), the plain versions, the bound, SDPA (timed
    only; its backward read three times), the SIMT kernels on the same bf16
    inputs, and the port's own attend_full, time and memory; at the seq-128
    shapes, one layer through the kernels against attend_full and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import blocks

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    m = FLASH_MAIN
    cases = [("main", m, bf16),
             ("main/f32", m, f32),
             ("window_256", dict(m, window=256), bf16),
             ("xlmr_bidir", dict(m, s=512, h=12, k=12, causal=False), bf16),
             ("d128", dict(m, b=2, s=512, h=32, k=32, d=128), bf16),
             ("d256", dict(m, b=2, s=512, h=16, k=16, d=256), bf16),
             ("ragged_s1000", dict(m, b=2, s=1000), bf16),
             ("d8_reduced", dict(b=2, s=8, h=4, k=4, d=8, causal=False,
                                 window=0), f32),
             ("round128", dict(m, s=128), bf16),
             ("eval128", dict(m, b=32, s=128), bf16),
             ("tp_local_m16", FLASH_TP_LOCAL, bf16)]
    out = {"cases": []}
    for name, shp, dtype in cases:
        causal, window = shp["causal"], shp["window"]
        res, (q, k, v, do) = flash_check(name, shp, dtype, gen)
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        out["cases"].append(res)
        if name in ("round128", "eval128"):
            if name == "round128":
                check(res["dkdv_blocks"] >= sms, f"the seq-128 round's dK/dV"
                      f" pass has {res['dkdv_blocks']} blocks for {sms} SMs")
            res.update(flash_layer_times(q, k, v, do, causal, window, flush))
            # the kernels alone, without ops.flash_attention's host work
            o, lse = fa.flash_attention(qt, kt, vt, causal=causal,
                                        window=window)
            res["ms"] = time_ms(lambda: fa.flash_attention(
                qt, kt, vt, causal=causal, window=window), flush)
            res["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd(
                qt, kt, vt, o, lse, dot, causal=causal, window=window), flush)
            del o, lse
            log(f"[flash-kernel]   {name}: one layer, forward (no_grad) "
                f"kernel {res['kernel_fwd_ms']:.4f} ms vs attend_full "
                f"{res['attend_full_fwd_ms']:.4f} ms vs SDPA "
                f"{res['sdpa_fwd_ms']:.4f} ms; forward+backward kernel "
                f"{res['kernel_fwd_bwd_ms']:.4f} ms vs attend_full "
                f"{res['attend_full_fwd_bwd_ms']:.4f} ms vs SDPA "
                f"{res['sdpa_fwd_bwd_ms']:.4f} ms; the kernels alone: "
                f"forward {res['ms']:.4f} ms, backward {res['bwd_ms']:.4f} ms"
                f"   [{card}]")
        if name == "tp_local_m16":
            out["tp_local"] = flash_times(res, shp, dtype, q, k, v, do,
                                          flush)
            log(f"[flash-kernel]   {name} (a model rank's share of the main "
                f"layer at model 16): forward {res['ms']:.4f} ms (bound "
                f"{res['bound_ms']:.4f}, {res['bound_by']}; plain "
                f"{res['plain_ms']:.4f}; SDPA {res['library_ms']:.4f}), "
                f"backward {res['bwd_ms']:.4f} ms (bound "
                f"{res['bwd_bound_ms']:.4f}, {res['bwd_bound_by']}; plain "
                f"{res['plain_bwd_ms']:.4f}; SDPA {res['library_bwd_ms']:.4f})"
                f"   [{card}]")
        if name != "main":
            continue

        # ---- the main shape: times, bounds, the library, attend_full -------
        res["bound_ms"], res["bound_by"] = flash_bound(**shp, dtype=dtype)
        res["bwd_bound_ms"], res["bwd_bound_by"] = flash_bound(
            **shp, dtype=dtype, backward=True)
        o, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window)

        def fwd():
            return fa.flash_attention(qt, kt, vt, causal=causal,
                                      window=window)

        def bwd():
            return fa.flash_attention_bwd(qt, kt, vt, o, lse, dot,
                                          causal=causal, window=window)
        res["ms"], res["bwd_ms"] = time_ms(fwd, flush), time_ms(bwd, flush)
        res["kernel_split_ms"] = {**kernel_ms(fwd, flush),
                                  **kernel_ms(bwd, flush)}
        # the SIMT kernels (the f32 route's) on the same bf16 inputs
        with mock.patch.object(fa, "route", lambda dtype_, d: "simt"):
            res["simt_ms"] = time_ms(fwd, flush)
            res["simt_bwd_ms"] = time_ms(bwd, flush)
        res["plain_ms"] = time_ms(lambda: fa.flash_attention_torch(
            qt, kt, vt, causal=causal, window=window), flush)
        res["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_torch(
            qt, kt, vt, o, lse, dot, causal=causal, window=window), flush)
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        res.update(flash_layer_times(q, k, v, do, causal, window, flush))
        res["fwd_bwd_ms"] = res["kernel_fwd_bwd_ms"]
        # the yardstick: one PyTorch call, (B,H,S,D) contiguous as it likes
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ldo = dot.contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                  enable_gqa=True)
        res["library_ms"] = time_ms(sdpa, flush)
        l_out = sdpa()
        reads = [time_ms(lambda: torch.autograd.grad(
            l_out, (lq, lk, lv), ldo, retain_graph=True), flush)
            for _ in range(3)]
        res["library_bwd_reads_ms"] = reads
        res["library_bwd_ms"] = statistics.median(reads)
        res["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(), (lq, lk, lv), ldo), flush)
        l_err = (l_out.transpose(1, 2).float() - o.transpose(1, 2).float()
                 ).abs().max().item()
        del l_out
        # the port's own dense attention on the same inputs
        bias = blocks._mask_bias(torch.arange(shp["s"], device="cuda"),
                                 torch.arange(shp["s"], device="cuda"),
                                 causal=True, window=0)
        scale = 1.0 / math.sqrt(shp["d"])
        for label, layer in (("kernel", lambda: ops.flash_attention(
                *ins, causal=causal, mode="cuda")),
                             ("attend_full", lambda: blocks.attend_full(
                                 *ins, bias, scale))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = layer()
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated() - base - y.numel() \
                * y.element_size()
            torch.autograd.grad(y, ins, do)
            torch.cuda.synchronize()
            res[f"{label}_kept_mb"] = kept / 1e6
            res[f"{label}_peak_mb"] = (torch.cuda.max_memory_allocated()
                                       - base) / 1e6
            del y
        split = ", ".join(f"{k} {v:.4f}" for k, v in
                          res["kernel_split_ms"].items())
        log(f"[flash-kernel]   forward {res['ms']:.4f} ms | bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}) | kernel/bound "
            f"{res['ms'] / res['bound_ms']:.1f} | plain {res['plain_ms']:.4f} "
            f"ms | SDPA(is_causal, enable_gqa) {res['library_ms']:.4f} ms "
            f"(kernel/SDPA {res['ms'] / res['library_ms']:.2f}; |Δo| vs "
            f"kernel {l_err:.3e}) | SIMT kernel {res['simt_ms']:.4f} ms   "
            f"[{card}]")
        log(f"[flash-kernel]   backward {res['bwd_ms']:.4f} ms | bound "
            f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}) | "
            f"kernel/bound {res['bwd_ms'] / res['bwd_bound_ms']:.1f} | plain "
            f"{res['plain_bwd_ms']:.4f} ms | SDPA backward, three reads "
            f"{', '.join(f'{x:.4f}' for x in reads)} ms (median "
            f"{res['library_bwd_ms']:.4f}; kernel/SDPA "
            f"{res['bwd_ms'] / res['library_bwd_ms']:.2f}) | SIMT kernels "
            f"{res['simt_bwd_ms']:.4f} ms   [{card}]")
        log(f"[flash-kernel]   device time per kernel (ms, torch.profiler): "
            f"{split}")
        log(f"[flash-kernel]   against the targets: forward "
            f"{res['ms'] / res['library_ms']:.2f}x SDPA (at most 2), backward "
            f"{res['bwd_ms'] / res['library_bwd_ms']:.2f}x SDPA's median (at "
            f"most 3); {res['simt_ms'] / res['ms']:.1f}x and "
            f"{res['simt_bwd_ms'] / res['bwd_ms']:.1f}x faster than the SIMT "
            f"kernels (at least 5)")
        log(f"[flash-kernel]   forward+backward through ops.flash_attention "
            f"{res['fwd_bwd_ms']:.4f} ms | SDPA {res['library_fwd_bwd_ms']:.4f}"
            f" ms | blocks.attend_full {res['attend_full_fwd_bwd_ms']:.4f} ms;"
            f" one layer's memory kept for the backward: kernel "
            f"{res['kernel_kept_mb']:.1f} MB, attend_full "
            f"{res['attend_full_kept_mb']:.1f} MB; peak over fwd+bwd: kernel "
            f"{res['kernel_peak_mb']:.1f} MB, attend_full "
            f"{res['attend_full_peak_mb']:.1f} MB   [{card}]")
        out["main"] = res
        del ins, lq, lk, lv, ldo, o, lse, bias
    del flush
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The front door at the reference's defaults: the streaming scheduler,
# pretraining and round-boundary checkpoints
# ---------------------------------------------------------------------------

PIPE_WAYS = (("synchronous", dict(pipeline=False)),
             ("depth 1", dict(pipeline=True, pipeline_depth=1)),
             ("depth 2", dict(pipeline=True, pipeline_depth=2)))
# AdamW at the reference's default lr (3e-3) diverged from random init at
# full TinyLlama width on an H100 (losses 10.80 → 13.75 by step 7, 12.02 at
# step 20; PERF.md §5): the smoke pretrains at 3e-4.
PRETRAIN = dict(seq=128, batch=64, steps=20, lr=3e-4)
CKPT_SEQ = 128


def round_want(cfg, fl, cuts) -> dict:
    """Kernel launches of bf16 "ours" rounds at the given cuts: one
    ``layer_grad_norm`` per block leaf per probe, one ``masked_update`` per
    leaf per τ step of a round that trains, and the family's sequence
    kernel (flash for the dense stack, ``ssd_scan`` for Mamba2).  The
    hybrid runs the dense program whatever the cut: its probe reads the
    shared block's leaves too (one row each), no ``masked_update``, one
    ``ssd_scan`` per Mamba2 block and one flash forward per shared-block
    site per sequence forward, one flash backward per site per probe and
    per update step."""
    from repro_torch.models.model import _block_shapes
    L = cfg.n_layers
    probe = fl.cohort_size * fl.selection_batches
    update = fl.cohort_size * fl.local_steps
    if cfg.family == "hybrid":
        leaves = (len(_block_shapes(cfg, "ssm"))
                  + len(_block_shapes(cfg, "attn_mlp_shared")))
        seqs, grads = (len(cuts) * (probe + update + 1),
                       len(cuts) * (probe + update))
        sites = L // cfg.attn_every
        return {"layer_grad_norm": len(cuts) * probe * leaves,
                "masked_update": 0, "base_delta_matmul": 0, **FLASH_NONE,
                "ssd_scan": seqs * L, "ssd_scan_mma": seqs * L,
                "ssd_scan_simt": 0, "flash_attention": seqs * sites,
                "flash_attention_mma": seqs * sites,
                "flash_attention_bwd": grads * sites,
                "flash_attention_bwd_mma": grads * sites}
    if cfg.family == "moe":
        # MLA and the expert dispatch call no kernel; the probe reads both
        # segments' leaves, an update step those of the segments above the
        # cut (dense0 only at cut 0)
        d0 = len(_block_shapes(cfg, "moe_dense0")) if cfg.first_dense else 0
        nb = len(_block_shapes(cfg, "moe"))
        return {"layer_grad_norm": len(cuts) * probe * (d0 + nb),
                "masked_update": sum(
                    update * ((d0 if c < cfg.first_dense else 0)
                              + (nb if c < L else 0)) for c in cuts),
                "base_delta_matmul": 0, **FLASH_NONE, **SSD_NONE}
    n_leaves = len(_block_shapes(cfg, cfg.family if cfg.family == "ssm"
                                 else "dense"))
    want = {"layer_grad_norm": len(cuts) * probe * n_leaves,
            "masked_update": sum(update * n_leaves for c in cuts if c < L),
            "base_delta_matmul": 0}
    if cfg.family == "ssm":
        scans = len(cuts) * (probe + update + 1) * L
        return {**want, **FLASH_NONE, "ssd_scan": scans,
                "ssd_scan_mma": scans, "ssd_scan_simt": 0}
    return {**want, **SSD_NONE, **flash_want(fl, L, cuts)}


def device_busy_ms(prof) -> float:
    """The union of the device's kernel and copy intervals in a
    torch.profiler trace (ms): the time the card was busy."""
    import torch
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


class SyncCounter:
    """Host syncs of a run from the end of round 0 on: ``torch.cuda``
    sync-debug warnings (each names the Python line that made it) and
    waits on a ``HostCopy`` event (the probe stats' and the records'
    copies, which the sync-debug mode does not see).  ``arm`` is called
    after each round's eval is queued (``Client.evaluate_raw``), ``stop``
    when the run returns.  ``main_waits`` holds, for each event wait on
    the main thread, the number of rounds queued before it."""

    def __init__(self):
        import warnings
        self.warnings = warnings
        self.rounds_seen = 0
        self.armed = False
        self.syncs: list = []        # "file:line" of each sync
        self.waits: list = []        # seconds of each event wait
        self.main_waits: list = []   # rounds_seen at each main-thread wait
        self.other_warnings = 0

    def __enter__(self):
        import torch
        from repro_torch.core.client import HostCopy
        self._torch = torch
        self._catch = self.warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        self.warnings.simplefilter("always")
        orig = HostCopy.to_numpy
        counter = self

        def to_numpy(hc):
            t0 = time.perf_counter()
            out = orig(hc)
            if counter.armed:
                counter.waits.append(time.perf_counter() - t0)
                if threading.current_thread() is threading.main_thread():
                    counter.main_waits.append(counter.rounds_seen)
            return out
        self._patch = mock.patch.object(HostCopy, "to_numpy", to_numpy)
        self._patch.start()
        return self

    def arm(self):
        self.rounds_seen += 1
        if not self.armed:
            del self._log[:]
            self.armed = True
            self._torch.cuda.set_sync_debug_mode("warn")

    def stop(self):
        self._torch.cuda.set_sync_debug_mode("default")
        for w in self._log:
            if not self.armed:
                continue
            if "synchroniz" in str(w.message):
                self.syncs.append(f"{os.path.relpath(w.filename, ROOT)}:"
                                  f"{w.lineno}")
            else:
                self.other_warnings += 1
        del self._log[:]
        self.armed = False

    def __exit__(self, *exc):
        self.stop()
        self._patch.stop()
        self._catch.__exit__(*exc)
        return False


def _run_way(cfg, task, params, way: dict, profile=False,
             prepare=None) -> dict:
    """One 3-round run of "ours" through Experiment.run, the round
    scheduler or the synchronous loop as ``way`` says (``prepare`` is
    called with the built server first).  Returns the run, its launches,
    the host time at each round's queued eval, the host syncs after round
    0, the peak device memory and, with ``profile``, the device's busy time
    from a CUDA-only trace."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch.kernels import ops

    exp = _round_experiment(cfg, task, **way)
    srv = exp.build()
    if prepare is not None:
        prepare(srv)
    marks = []
    orig = srv.client.evaluate_raw
    with SyncCounter() as counter:
        def evaluate_raw(*a, **k):
            out = orig(*a, **k)
            marks.append((time.perf_counter(), dict(ops.LAUNCHES)))
            counter.arm()
            return out
        srv.client.evaluate_raw = evaluate_raw
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        prof = torch_profile(activities=[ProfilerActivity.CUDA]) \
            if profile else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        final, hist = exp.run(params)
        counter.stop()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    out = {"final": final, "hist": hist, "run_s": run_s,
           "launches": dict(ops.LAUNCHES), "syncs": counter.syncs,
           "waits": counter.waits, "main_waits": counter.main_waits,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "other_warnings": counter.other_warnings,
           "marks": [t - t0 for t, _ in marks],
           "per_round": [{k: v - (marks[i - 1][1][k] if i else 0)
                          for k, v in m.items() if v}
                         for i, (_, m) in enumerate(marks)]}
    if prof is not None:
        out["busy_ms"] = device_busy_ms(prof)
    return out


def phase_pipeline(card: str) -> dict:
    """Three "ours" rounds at full width run three ways in one call — the
    synchronous loop, the round scheduler at depth 1 and at depth 2 — for
    TinyLlama-1.1B at seq_len 1024 and Mamba2-370M at 512, after one
    untimed warm-up round, each way twice in turns (sync, d1, d2, d2, d1,
    sync): the same cohorts and masks, params within ROUND_PARAM_ATOL and
    the same kernel launches every time.  Logs s/round of each run, the
    host syncs after round 0 (sync-debug warnings by line, event waits),
    and the device's busy share from a third, CUDA-only profiled run of
    each way."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)

    ways = dict(PIPE_WAYS)
    order = [n for n, _ in PIPE_WAYS] + [n for n, _ in PIPE_WAYS][::-1]
    out = {}
    for arch, seq in (("tinyllama_1_1b", LONG_SEQ), ("mamba2_370m", SSM_SEQ)):
        cfg = get_arch(arch)
        tag = f"pipeline {cfg.name}"

        def task():
            return SyntheticFederatedData(FederatedTaskConfig(
                n_clients=16, vocab_size=cfg.vocab_size, seq_len=seq,
                test_samples=32, objective="lm", skew="feature", seed=0))
        exp = _round_experiment(cfg, task())
        fl, params = exp.fl, exp.init_params()
        t0 = time.perf_counter()
        exp.run(params, rounds=1)                      # warm-up, untimed
        torch.cuda.synchronize()
        log(f"[{tag}] warm-up round (synchronous, untimed) "
            f"{time.perf_counter() - t0:.3f} s")
        runs = {name: [] for name in ways}
        base = None
        for name in order:
            r = _run_way(cfg, task(), params, ways[name])
            if base is None:
                base, base_final = r, r["final"]
                cuts = [int(np.flatnonzero(rec.mask_matrix.sum(0) > 0)[0])
                        if rec.mask_matrix.any() else cfg.n_layers
                        for rec in base["hist"].records]
                want = round_want(cfg, fl, cuts)
            for ra, rb in zip(r["hist"].records, base["hist"].records):
                check(np.array_equal(ra.cohort, rb.cohort)
                      and np.array_equal(ra.mask_matrix, rb.mask_matrix),
                      f"[{tag}] {name}, round {ra.round}: other cohorts or "
                      f"masks than the first synchronous run")
                check(all(math.isfinite(v) for v in (ra.train_loss,
                                                      ra.test_loss)),
                      f"[{tag}] {name}: non-finite loss")
            dp = _tree_max_diff(r.pop("final"), base_final)
            n = len(r["hist"].records)
            by_line = {}
            for where in r["syncs"]:
                by_line[where] = by_line.get(where, 0) + 1
            r.update(params_max_diff=dp, s_per_round=r["run_s"] / n,
                     syncs_per_round=len(r["syncs"]) / (n - 1),
                     event_waits_per_round=len(r["waits"]) / (n - 1))
            log(f"[{tag}] {name}: {n} rounds in {r['run_s']:.3f} s = "
                f"{r['s_per_round']:.4f} s/round; evals queued at "
                f"{[round(m, 3) for m in r['marks']]} s; max |Δparams| vs "
                f"the first synchronous run {dp:.3e} (atol "
                f"{ROUND_PARAM_ATOL:g}); host syncs after round 0: "
                f"{len(r['syncs'])} sync-debug warnings "
                f"({r['syncs_per_round']:.2f}/round) at {by_line}, "
                f"{len(r['waits'])} event waits "
                f"({r['event_waits_per_round']:.2f}/round, "
                f"{sum(r['waits']) * 1e3:.1f} ms); other warnings "
                f"{r['other_warnings']}   [{card}]")
            check(dp <= ROUND_PARAM_ATOL,
                  f"[{tag}] {name}: params differ from the synchronous loop")
            check(r["launches"] == want,
                  f"[{tag}] {name}: launches {r['launches']}, want {want}")
            runs[name].append(r)
        log(f"[{tag}] launches per round at each queued eval: " + "; ".join(
            f"{name} {runs[name][0]['per_round']}" for name in ways))
        sync_s = statistics.mean(r["s_per_round"]
                                 for r in runs["synchronous"])
        summary = {}
        for name in ways:
            prof = _run_way(cfg, task(), params, ways[name], profile=True)
            check(prof["launches"] == want,
                  f"[{tag}] {name}: the profiled run launched otherwise")
            per = [r["s_per_round"] for r in runs[name]]
            summary[name] = {
                "s_per_round": per,
                "vs_synchronous": statistics.mean(per) / sync_s,
                "busy_share": prof["busy_ms"] / (prof["run_s"] * 1e3),
                "busy_ms": prof["busy_ms"], "profiled_run_s": prof["run_s"],
                "syncs_per_round": [r["syncs_per_round"]
                                    for r in runs[name]],
                "event_waits_per_round": [r["event_waits_per_round"]
                                          for r in runs[name]],
                "sync_lines": sorted({w for r in runs[name]
                                      for w in r["syncs"]})}
            log(f"[{tag}] {name}: s/round {[round(x, 4) for x in per]} "
                f"(mean x {summary[name]['vs_synchronous']:.4f} the "
                f"synchronous loop's); profiled run {prof['run_s']:.3f} s, "
                f"device busy {prof['busy_ms']:.1f} ms "
                f"({100 * summary[name]['busy_share']:.1f}%)   [{card}]")
            del prof
            torch.cuda.empty_cache()
        summary["launches"] = {k: sum(r["launches"][k] for rs in runs.values()
                                      for r in rs) for k in want}
        out[arch] = summary
        del runs, base, base_final, params, exp
        torch.cuda.empty_cache()
    return out


def phase_pretrain(card: str) -> dict:
    """``data.pretrain.pretrain`` (AdamW, every param differentiated) on
    full-width TinyLlama-1.1B at seq_len 128 and the reference's default
    batch 64, lr ``PRETRAIN["lr"]``, for 20 steps after one warm-up step:
    finite losses, the last five steps' mean below the first five's;
    ms/step, peak memory and flash launches per step."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.data.pretrain import pretrain
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = get_arch("tinyllama_1_1b")
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=128),
                  device="cuda")
    data = SyntheticFederatedData(FederatedTaskConfig(
        n_clients=16, vocab_size=cfg.vocab_size, seq_len=PRETRAIN["seq"],
        test_samples=32, objective="lm", skew="feature", seed=0))
    params = model.init(0)
    losses = []
    orig = model.seq_loss

    def seq_loss(*a, **k):
        loss = orig(*a, **k)
        losses.append(loss.detach())
        return loss
    model.loss = seq_loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = pretrain(model, params, data, steps=1, lr=PRETRAIN["lr"],
                    batch_size=PRETRAIN["batch"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del warm
    losses.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params = pretrain(model, params, data, steps=PRETRAIN["steps"],
                      lr=PRETRAIN["lr"], batch_size=PRETRAIN["batch"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = torch.stack(losses).float().cpu().tolist()
    steps = PRETRAIN["steps"]
    L = cfg.n_layers
    want = {**{k: 0 for k in launches}, "flash_attention": steps * L,
            "flash_attention_mma": steps * L,
            "flash_attention_bwd": steps * L,
            "flash_attention_bwd_mma": steps * L}
    first, last = sum(vals[:5]) / 5, sum(vals[-5:]) / 5
    log(f"[pretrain] {cfg.name}, AdamW lr {PRETRAIN['lr']:g}, batch "
        f"{PRETRAIN['batch']} x "
        f"{PRETRAIN['seq']} tokens: warm-up step {warm_s:.3f} s, then "
        f"{steps} steps in {run_s:.3f} s = {run_s / steps * 1e3:.1f} ms/step "
        f"({PRETRAIN['batch'] * PRETRAIN['seq'] * steps / run_s:.0f} tokens/s)"
        f"; peak device memory {peak_gb:.2f} GB; flash launches per step "
        f"{launches['flash_attention'] / steps:g} forward, "
        f"{launches['flash_attention_bwd'] / steps:g} backward; losses "
        f"{[round(v, 4) for v in vals]}; mean of the first five "
        f"{first:.4f}, of the last five {last:.4f}   [{card}]")
    check(all(math.isfinite(v) for v in vals), "pretrain: non-finite loss")
    check(last < first, "pretrain: the loss did not fall")
    check(launches == want, f"pretrain: launches {launches}, want {want}")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": run_s / steps * 1e3,
            "peak_gb": peak_gb, "losses": vals}


def _ckpt_dir(need_bytes: int) -> str:
    """A fresh directory for the checkpoint phase: under the system's
    temporary directory, or the checkout's ``build/`` when that is short
    of ``need_bytes`` free."""
    import shutil
    import tempfile
    for base in (tempfile.gettempdir(), os.path.join(ROOT, "build")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        log(f"[checkpoint] {base}: {free / 1e9:.1f} GB free, need "
            f"{need_bytes / 1e9:.1f} GB")
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix="ckpt-smoke-", dir=base)
    raise SmokeFailure("checkpoint: no directory has room for the "
                       "phase's checkpoints")


def phase_checkpoint(card: str) -> dict:
    """Round-boundary checkpoints at full TinyLlama-1.1B width (seq_len
    128): an uninterrupted 4-round pipelined run (depth 2,
    checkpoint_every=2); one flipped byte in the latest step (4); a fresh
    Experiment that falls back to step 2 (``ckpt_fallbacks`` 1), resumes
    and finishes with the uninterrupted run's cohorts and masks and params
    within ROUND_PARAM_ATOL.  Logs the bytes of a checkpoint and the save,
    verify and restore times; deletes the directory afterwards."""
    import shutil
    import warnings
    import numpy as np
    import torch
    from repro_torch import ckpt
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops

    cfg = get_arch("tinyllama_1_1b")

    def task():
        return SyntheticFederatedData(FederatedTaskConfig(
            n_clients=16, vocab_size=cfg.vocab_size, seq_len=CKPT_SEQ,
            test_samples=32, objective="lm", skew="feature", seed=0))

    def experiment(d):
        return _round_experiment(cfg, task(), rounds=4, pipeline=True,
                                 pipeline_depth=2, checkpoint_dir=d,
                                 checkpoint_every=2)
    exp = experiment(None)
    params = exp.init_params()
    n_params = sum(t.numel() * t.element_size() for t in
                   (leaf for sub in params.values() for leaf in
                    (sub.values() if isinstance(sub, dict) else [sub])))
    d = _ckpt_dir(4 * n_params)
    times = {"save": [], "verify": [], "restore": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            if name == "save":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            times[name].append(time.perf_counter() - t0)
            return res
        return wrapper
    try:
        with mock.patch.object(ckpt, "save_checkpoint",
                               timed("save", ckpt.save_checkpoint)), \
                mock.patch.object(ckpt_mod, "verify_checkpoint",
                                  timed("verify", ckpt_mod.verify_checkpoint)):
            ops.reset_launches()
            t0 = time.perf_counter()
            final, hist = experiment(d).run(params)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            steps = ckpt.all_checkpoint_steps(d)
            sizes = {s: sum(os.path.getsize(os.path.join(
                d, f"step_{s:08d}", f)) for f in ("arrays.npz",
                                                  "manifest.json"))
                     for s in steps}
            check(steps == [2, 4], f"checkpoint: steps {steps}, want [2, 4]")
            check(ckpt.verify_checkpoint(d, 4) == (True, "ok"),
                  "checkpoint: step 4 does not verify")
            path = os.path.join(d, "step_00000004", "arrays.npz")
            with open(path, "r+b") as f:             # one flipped byte
                f.seek(os.path.getsize(path) // 2)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0x01]))
            resumed = experiment(d)
            srv = resumed.build()
            srv.restore_state = timed("restore", srv.restore_state)
            ops.reset_launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t1 = time.perf_counter()
                final_r, hist_r = resumed.run()
                torch.cuda.synchronize()
                resume_s = time.perf_counter() - t1
            resume_launches = dict(ops.LAUNCHES)
        fell = [str(w.message) for w in caught
                if "corrupt checkpoint" in str(w.message)]
        check(srv.select_stats["ckpt_fallbacks"] == 1 and fell,
              f"checkpoint: the corrupted step 4 did not fall back "
              f"(ckpt_fallbacks {srv.select_stats['ckpt_fallbacks']})")
        check(len(hist_r.records) == 4, "checkpoint: the resumed history "
                                        "is not 4 rounds long")
        for ra, rb in zip(hist_r.records, hist.records):
            check(np.array_equal(ra.cohort, rb.cohort)
                  and np.array_equal(ra.mask_matrix, rb.mask_matrix),
                  f"checkpoint: round {ra.round} resumed with other cohorts "
                  f"or masks")
        dp = _tree_max_diff(final_r, final)
        log(f"[checkpoint] {cfg.name} seq {CKPT_SEQ}: 4 pipelined rounds "
            f"(depth 2, checkpoint_every 2) in {run_s:.3f} s, checkpoints "
            f"at steps {steps} of {sizes} bytes ({n_params} bytes of bf16 "
            f"params); save {[round(t, 3) for t in times['save']]} s, verify "
            f"{[round(t, 3) for t in times['verify']]} s, restore "
            f"{[round(t, 3) for t in times['restore']]} s; a flipped byte in "
            f"step 4: {fell[0][:120]}...; ckpt_fallbacks "
            f"{srv.select_stats['ckpt_fallbacks']}; resumed from step 2 and "
            f"ran rounds 2-3 in {resume_s:.3f} s: cohorts and masks equal, "
            f"max |Δparams| {dp:.3e} (atol {ROUND_PARAM_ATOL:g})   [{card}]")
        check(dp <= ROUND_PARAM_ATOL, "checkpoint: resumed params differ")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del final, final_r, params
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] + resume_launches[k]
                         for k in launches},
            "bytes": sizes, "times": times, "params_max_diff": dp}


# ---------------------------------------------------------------------------
# Slice 8: fault injection and graceful degradation
# ---------------------------------------------------------------------------

# The guarded TinyLlama rounds' plan (seed picked by replay, fault_seed):
# client death, every corruption kind, a finite norm threshold (so an
# exploded row is quarantined by the threshold), solver stalls and
# dispatch failures.
TINY_FAULTS = dict(death_rate=0.25, corrupt_rate=0.5,
                   corrupt_kinds=("nan", "inf", "explode"), max_delta_sq=1e12,
                   stall_rate=0.3, dispatch_fail_rate=0.5)
MAMBA_FAULTS = dict(death_rate=0.25, corrupt_rate=0.5,
                    corrupt_kinds=("nan", "inf", "explode"),
                    max_delta_sq=1e12)
SERVE_FAULTS = dict(upload_fail_rate=0.3, slot_fault_rate=0.05)


def replay_faults(kw: dict, seed: int, rounds: int, n: int):
    """A plan's round schedule replayed on the host with a fresh injector:
    per round the survivors, codes, stall and dispatch failures, and the
    ``select_stats`` counters the guarded rounds must reach."""
    import numpy as np
    from repro_torch.faults import FaultInjector, FaultPlan
    inj = FaultInjector(FaultPlan(seed=seed, **kw))
    rows = []
    for t in range(rounds):
        surv, codes = inj.round_faults(t, n)
        rows.append({"survivors": surv, "codes": codes,
                     "stall": inj.solver_stalls(t),
                     "dispatch": inj.dispatch_failures(t)})
    alive = [r["survivors"] > 0 for r in rows]
    counters = {
        "dead_clients": int(sum((~a).sum() for a in alive)),
        "quarantined_rows": int(sum((a & (r["codes"] != 0)).sum()
                                    for a, r in zip(alive, rows))),
        "solver_timeouts": sum(r["stall"] for r in rows),
        "dispatch_retries": sum(r["dispatch"] for r in rows)}
    return rows, counters


def fault_seed(kw: dict, rounds: int, n: int) -> int:
    """The smallest seed whose schedule holds a dead row, each corruption
    kind on a live row, a live clean row in every round, and a stall and a
    dispatch failure when the plan has them."""
    import numpy as np
    from repro_torch.faults import CORRUPT_CODES
    want_kinds = {CORRUPT_CODES[k] for k in kw["corrupt_kinds"]}
    for seed in range(100_000):
        rows, _ = replay_faults(kw, seed, rounds, n)
        kinds = {int(c) for r in rows
                 for s, c in zip(r["survivors"], r["codes"]) if s > 0 and c}
        if (any((r["survivors"] <= 0).any() for r in rows)
                and kinds == want_kinds
                and all(((r["survivors"] > 0) & (r["codes"] == 0)).any()
                        for r in rows)
                and (not kw.get("stall_rate") or any(r["stall"]
                                                     for r in rows))
                and (not kw.get("dispatch_fail_rate")
                     or any(r["dispatch"] for r in rows))):
            return seed
    raise SmokeFailure(f"no seed covers every fault of {kw}")


def record_faults(srv) -> list:
    """Wrap a server's fault hooks: per round the drawn survivors and codes
    and the guard's ``ok`` rows, as the round step saw them."""
    import numpy as np
    rec: list = []
    draw, account = srv._injector.round_faults, srv._account_faults

    def round_faults(t, n):
        surv, codes = draw(t, n)
        rec.append({"t": t, "survivors": surv.copy(), "codes": codes.copy()})
        return surv, codes

    def account_faults(survivors, ok):
        rec[-1]["ok"] = np.asarray(ok).copy()
        return account(survivors, ok)
    srv._injector.round_faults = round_faults
    srv._account_faults = account_faults
    return rec


def check_fault_log(tag, rec, rows, stats, counters):
    """The rounds' draws, ``ok`` rows and counters against the replay: a
    row aggregates iff it is alive and clean (every corruption kind is
    quarantined under the finite threshold)."""
    import numpy as np
    check(len(rec) == len(rows), f"[{tag}] {len(rec)} guarded rounds, want "
                                 f"{len(rows)}")
    for got, want in zip(rec, rows):
        check(np.array_equal(got["survivors"], want["survivors"])
              and np.array_equal(got["codes"], want["codes"]),
              f"[{tag}] round {got['t']}: the injector drew other faults "
              f"than its host replay")
        ok = ((want["survivors"] > 0) & (want["codes"] == 0)).astype(
            np.float32)
        check(np.array_equal(got["ok"], ok),
              f"[{tag}] round {got['t']}: ok rows {got['ok'].tolist()}, "
              f"want {ok.tolist()}")
    got = {k: stats[k] for k in counters}
    check(got == counters, f"[{tag}] select_stats {got}, replayed "
                           f"{counters}")


def _all_finite(tree) -> bool:
    import torch
    from repro_torch.tree import tree_leaves
    return all(torch.isfinite(x).all().item() for x in tree_leaves(tree))


def _params_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def guarded_want(cfg, fl, rounds: int) -> dict:
    """Kernel launches of guarded rounds: the dense program differentiates
    every layer of every client (cut 0) and applies its τ steps without
    the ``masked_update`` kernel; the probe and eval are the fault-free
    ones."""
    return dict(round_want(cfg, fl, [0] * rounds), masked_update=0)


def phase_faults(card: str, pipe: dict) -> dict:
    """Fault injection at full width (DESIGN.md §12), through the entry
    points a user calls: (a) three guarded TinyLlama-1.1B rounds at seq
    1024 under client death, every corruption kind, stalls and dispatch
    failures, synchronous and pipelined (depth 1), held against the
    injector's host replay, with launches and main-thread syncs counted;
    (b) round 0's inputs through the guarded step directly: no fault, one
    dead row, all rows NaN, peak memory and the guard's cost; (c) a
    reduced f32 guarded run on the card and on the CPU; (d) a disabled
    injector against none, in turns; (e) two guarded Mamba2-370M rounds at
    seq 512; (f) delta-mode TinyLlama serving under upload failures and
    slot strikes, and with every upload failing."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.faults import FaultPlan

    out = {"launches": {}}
    # (c) first: a reduced f32 guarded run on the card and on the CPU
    out["reduced"] = faults_reduced(card)

    cfg = get_arch("tinyllama_1_1b")
    L = cfg.n_layers
    tag = f"faults {cfg.name}"

    def task():
        return SyntheticFederatedData(FederatedTaskConfig(
            n_clients=16, vocab_size=cfg.vocab_size, seq_len=LONG_SEQ,
            test_samples=32, objective="lm", skew="feature", seed=0))
    exp = _round_experiment(cfg, task())
    fl, params = exp.fl, exp.init_params()
    del exp
    seed = fault_seed(TINY_FAULTS, 3, fl.cohort_size)
    rows, counters = replay_faults(TINY_FAULTS, seed, 3, fl.cohort_size)
    log(f"[{tag}] plan {TINY_FAULTS}, seed {seed} (the first whose replay "
        f"covers every fault): survivors "
        f"{[r['survivors'].astype(int).tolist() for r in rows]}, codes "
        f"{[r['codes'].tolist() for r in rows]}, stalls "
        f"{[r['stall'] for r in rows]}, dispatch failures "
        f"{[r['dispatch'] for r in rows]}; counters {counters}")
    want = guarded_want(cfg, fl, 3)

    # (a) the guarded rounds, synchronous and pipelined
    runs = {}
    for name, way in (("synchronous", dict(pipeline=False)),
                      ("depth 1", dict(pipeline=True, pipeline_depth=1))):
        held = {}

        def prepare(srv, held=held):
            held["srv"], held["rec"] = srv, record_faults(srv)
        r = _run_way(cfg, task(), params, dict(
            way, faults=FaultPlan(seed=seed, **TINY_FAULTS)),
            prepare=prepare)
        srv, hist = held["srv"], r["hist"]
        check_fault_log(f"{tag}, {name}", held["rec"], rows,
                        srv.select_stats, counters)
        check(r["launches"] == want, f"[{tag}] {name}: launches "
                                     f"{r['launches']}, want {want}")
        check(_all_finite(r["final"]), f"[{tag}] {name}: non-finite params")
        for rec in hist.records:
            check(math.isfinite(rec.test_loss),
                  f"[{tag}] {name}, round {rec.round}: non-finite test loss")
        n = len(hist.records)
        window = [w for w in r["main_waits"] if 1 <= w <= n - 1]
        per_round = {t: window.count(t) for t in range(1, n)}
        r.update(rec=held["rec"], select_stats=dict(srv.select_stats),
                 injector=dict(srv._injector.stats),
                 s_per_round=r["run_s"] / n, per_round_waits=per_round)
        log(f"[{tag}] {name}: {n} guarded rounds in {r['run_s']:.3f} s = "
            f"{r['s_per_round']:.4f} s/round, peak {r['peak_gb']:.2f} GB; "
            f"ok rows {[x['ok'].astype(int).tolist() for x in held['rec']]}; "
            f"train losses {[rec.train_loss for rec in hist.records]}, test "
            f"losses {[round(rec.test_loss, 6) for rec in hist.records]}; "
            f"select_stats {r['select_stats']}; injector {r['injector']}; "
            f"launches {r['launches']}; host syncs after round 0: "
            f"{len(r['syncs'])} sync-debug warnings at {r['syncs']}, "
            f"main-thread event waits per round {per_round}, all event "
            f"waits {len(r['waits'])}   [{card}]")
        runs[name] = r
        del srv, held
    sync, d1 = runs["synchronous"], runs["depth 1"]
    for ra, rb in zip(sync["hist"].records, d1["hist"].records):
        check(np.array_equal(ra.cohort, rb.cohort)
              and np.array_equal(ra.mask_matrix, rb.mask_matrix),
              f"[{tag}] round {ra.round}: the two ways chose other cohorts "
              f"or masks")
    check(all(np.array_equal(x["ok"], y["ok"])
              for x, y in zip(sync["rec"], d1["rec"])),
          f"[{tag}] the two ways kept other rows")
    dp = _tree_max_diff(sync.pop("final"), d1.pop("final"))
    check(dp == 0.0, f"[{tag}] pipelined params differ from the "
                     f"synchronous loop's by {dp:.3e}")
    n = len(d1["hist"].records)
    check(len(d1["syncs"]) == 0
          and all(v <= 1 for v in d1["per_round_waits"].values()),
          f"[{tag}] depth 1: more than one host sync a round on the main "
          f"thread: {d1['syncs']}, {d1['per_round_waits']}")
    log(f"[{tag}] synchronous vs depth 1: cohorts, masks and ok rows equal, "
        f"max |Δparams| {dp:.3e}; s/round {sync['s_per_round']:.4f} / "
        f"{d1['s_per_round']:.4f}")
    out["launches"]["faults_round_tinyllama"] = {
        k: sync["launches"][k] + d1["launches"][k] for k in want}
    out["round"] = {name: {k: r[k] for k in (
        "s_per_round", "run_s", "peak_gb", "select_stats", "injector",
        "per_round_waits", "syncs", "launches")}
        for name, r in runs.items()}
    del runs, sync, d1
    torch.cuda.empty_cache()

    # (b) round 0's inputs through the guarded step, called directly
    out["step"] = faults_step(card, cfg, task, params, seed)
    # (d) the harness's cost: a disabled injector against none
    out["disabled"] = faults_disabled(card, cfg, task, params)
    fault_free = pipe["tinyllama_1_1b"]["depth 1"]["s_per_round"]
    guarded = out["round"]["depth 1"]
    none = out["disabled"]
    log(f"[{tag}] guarded depth-1 rounds {guarded['s_per_round']:.4f} "
        f"s/round, peak {guarded['peak_gb']:.2f} GB; fault-free depth-1 "
        f"rounds {none['none_s_per_round']:.4f} s/round, peak "
        f"{none['none_peak_gb']:.2f} GB (this phase), "
        f"{[round(x, 4) for x in fault_free]} s/round (phase_pipeline); "
        f"guarded / fault-free "
        f"{guarded['s_per_round'] / none['none_s_per_round']:.4f}   "
        f"[{card}]")
    del params
    torch.cuda.empty_cache()

    # (e) Mamba2-370M
    out["mamba2"] = faults_mamba2(card)
    out["launches"]["faults_round_mamba2"] = out["mamba2"].pop("launches")
    # (f) serving
    out["serve"] = faults_serve(card)
    out["launches"]["faults_serve"] = out["serve"].pop("launches")
    return out


def faults_reduced(card: str) -> dict:
    """(c) Reduced xlm-roberta in f32, 3 guarded rounds (the synchronous
    loop) on the card and on the CPU: the same cohorts, masks and ok rows,
    counters as replayed, params within 1e-5."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.faults import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("xlm_roberta_base"), n_layers=4, d_model=32)
    seed = fault_seed(TINY_FAULTS, 3, 4)
    rows, counters = replay_faults(TINY_FAULTS, seed, 3, 4)
    runs = {}
    for dev in ("cuda", "cpu"):
        task = SyntheticFederatedData(FederatedTaskConfig(
            n_clients=12, n_classes=10, vocab_size=cfg.vocab_size, seq_len=8,
            samples_per_client=16, skew="label", objective="classification"))
        exp = Experiment(cfg, task, "ours", cohort_size=4, rounds=3,
                         local_steps=2, lr=0.01, batch_size=4, budget=2,
                         lam=1.0, seed=3, pipeline=False, device=dev,
                         runtime=RuntimeConfig(remat=False, seq_chunk=16),
                         faults=FaultPlan(seed=seed, **TINY_FAULTS))
        srv = exp.build()
        rec = record_faults(srv)
        params = tree_map(lambda t: t.to(dev),
                          Experiment(cfg, task, device="cpu").init_params())
        ops.reset_launches()
        final, hist = exp.run(params)
        check_fault_log(f"faults-reduced {dev}", rec, rows, srv.select_stats,
                        counters)
        runs[dev] = (tree_map(lambda t: t.cpu(), final), hist, rec,
                     dict(ops.LAUNCHES))
    (pg, hg, rg, lg), (pc, hc, rc, lc) = runs["cuda"], runs["cpu"]
    check(lg["layer_grad_norm"] > 0 and lc == {k: 0 for k in lc}
          and lg["flash_attention_simt"] == lg["flash_attention"] > 0,
          f"[faults-reduced] launches on the card {lg}, on the CPU {lc}")
    for a, b in zip(hg.records, hc.records):
        check(np.array_equal(a.cohort, b.cohort)
              and np.array_equal(a.mask_matrix, b.mask_matrix),
              f"[faults-reduced] round {a.round}: card and CPU chose other "
              f"cohorts or masks")
    err = _tree_max_diff(pg, pc)
    log(f"[faults-reduced] reduced xlm-r f32, 3 guarded rounds (seed "
        f"{seed}): cohorts, masks and ok rows "
        f"{[x['ok'].astype(int).tolist() for x in rg]} equal on card and "
        f"CPU, counters {counters}; max |Δparams| {err:.3e} (atol 1e-5); "
        f"card launches {lg}")
    check(err <= 1e-5, "[faults-reduced] card and CPU params differ")
    return {"params_max_diff": err, "seed": seed}


def faults_step(card, cfg, task, params, seed) -> dict:
    """(b) Round 0 of the guarded TinyLlama run, stage by stage, then its
    sampled inputs through the guarded step directly: no fault
    (bit-equal to the dense step), one dead row (against the dense step
    over the survivors), every row NaN (params unchanged); peak memory of
    each call and the guard's own time on the stacked deltas."""
    import numpy as np
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.faults import FaultPlan
    from repro_torch.tree import tree_leaves

    tag = f"faults-step {cfg.name}"
    t = task()
    srv = _round_experiment(cfg, t, faults=FaultPlan(seed=seed,
                                                     **TINY_FAULTS)).build()
    split = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t1
        return res
    plan, sampled = staged("plan+sample", lambda: (
        lambda pl: (pl, srv.sample_round(pl)))(srv.plan_round(0)))
    stats = staged("probe", lambda: srv.probe_round(params, sampled))
    masks = staged("select", lambda: srv.select_round(plan, stats))
    new, _ = staged("update (guarded)", lambda: srv.update_round(
        params, sampled, masks))
    staged("eval", lambda: srv.client.evaluate(new, srv._to_device(
        t.test_batch())))
    del new
    log(f"[{tag}] round 0 synchronised at stage boundaries: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"   [{card}]")

    client, fl = srv.client, srv.fl
    n, b, sizes = fl.cohort_size, sampled.update_batches, plan.sizes
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.int32)

    def call(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t1, \
            torch.cuda.max_memory_allocated() / 1e9
    (dense, _), dense_s, dense_gb = call(lambda: client.cohort_update_raw(
        params, b, masks, sizes, fl.lr, cut=None))
    (guard, _, ok), guard_s, guard_gb = call(
        lambda: client.cohort_update_guarded(params, b, masks, sizes, fl.lr,
                                             ones, zeros, 1e30, 1e12))
    same = _params_equal(guard, dense)
    check(same and np.array_equal(ok, ones),
          f"[{tag}] no fault: the guarded step differs from the dense step "
          f"(max |Δ| {_tree_max_diff(guard, dense):.3e}, ok {ok})")
    del guard, dense
    surv = ones.copy()
    surv[1] = 0.0
    idx = np.flatnonzero(surv > 0)
    (dead, _, ok), _, _ = call(lambda: client.cohort_update_guarded(
        params, b, masks, sizes, fl.lr, surv, zeros, 1e30, 1e12))
    sub = {k: v[idx] for k, v in b.items()}
    subd, _ = client.cohort_update_raw(params, sub, masks[idx], sizes[idx],
                                       fl.lr, cut=None)
    d_dead = _tree_max_diff(dead, subd)
    check(np.array_equal(ok, surv) and d_dead <= ROUND_PARAM_ATOL,
          f"[{tag}] one dead row: ok {ok}, max |Δ| {d_dead:.3e} against "
          f"the dense step over the survivors")
    del dead, subd, sub
    (nan, _, ok), _, _ = call(lambda: client.cohort_update_guarded(
        params, b, masks, sizes, fl.lr, ones, np.ones(n, np.int32), 1e30,
        1e12))
    check(_params_equal(nan, params) and not ok.any(),
          f"[{tag}] every row NaN: params moved or rows kept ({ok})")
    del nan
    torch.cuda.empty_cache()

    # the guard alone on the round's stacked deltas
    mt = client._device_f32(masks)
    deltas, _ = client._stacked_deltas(
        lambda i: client._local_update_impl(
            params, {k: v[i] for k, v in b.items()}, mt[i], fl.lr), n)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(deltas))
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        agg.corrupt_delta_rows(deltas, zeros, 1e30)
        okd = agg.finite_row_mask(deltas, 1e12)
        agg.zero_delta_rows(deltas, okd)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    guard_ms = statistics.median(times)
    del deltas
    torch.cuda.empty_cache()
    log(f"[{tag}] guarded step without faults: bit-equal to the dense step "
        f"({same}); {guard_s:.4f} s, peak {guard_gb:.2f} GB against the "
        f"dense step's {dense_s:.4f} s, peak {dense_gb:.2f} GB; one dead "
        f"row: max |Δparams| {d_dead:.3e} against the dense step over the "
        f"survivors (atol {ROUND_PARAM_ATOL:g}, bf16 params); every row "
        f"NaN: params unchanged; the guard alone (finite_row_mask + "
        f"zero_delta_rows, no codes) on {nbytes / 1e9:.2f} GB of stacked f32 "
        f"deltas: {guard_ms:.3f} ms median of 3, "
        f"{nbytes / guard_ms / 1e6:.0f} GB/s read   [{card}]")
    del srv
    return {"split": split, "dense_s": dense_s, "dense_peak_gb": dense_gb,
            "guarded_s": guard_s, "guarded_peak_gb": guard_gb,
            "dead_row_max_diff": d_dead, "guard_ms": guard_ms,
            "delta_bytes": nbytes}


def faults_disabled(card, cfg, task, params) -> dict:
    """(d) Three pipelined seq-1024 rounds with no injector and with a
    disabled one, in turns (none, disabled, disabled, none): the same
    cohorts and masks and bit-equal params; the s/round ratio."""
    import numpy as np
    from repro_torch.faults import FaultPlan
    tag = f"faults-disabled {cfg.name}"
    runs = {"none": [], "disabled": []}
    base = None
    for name in ("none", "disabled", "disabled", "none"):
        plan = None if name == "none" else FaultPlan(enabled=False,
                                                     **TINY_FAULTS)
        r = _run_way(cfg, task(), params, dict(pipeline=True,
                                               pipeline_depth=1,
                                               faults=plan))
        if base is None:
            base, base_final = r, r["final"]
        for ra, rb in zip(r["hist"].records, base["hist"].records):
            check(np.array_equal(ra.cohort, rb.cohort)
                  and np.array_equal(ra.mask_matrix, rb.mask_matrix),
                  f"[{tag}] {name}: other cohorts or masks")
        check(_params_equal(r.pop("final"), base_final),
              f"[{tag}] {name}: params differ from the first run's")
        n = len(r["hist"].records)
        runs[name].append((r["run_s"] / n, r["peak_gb"]))
        log(f"[{tag}] {name}: {n} rounds in {r['run_s']:.3f} s = "
            f"{r['run_s'] / n:.4f} s/round, peak {r['peak_gb']:.2f} GB, "
            f"launches {r['launches']}   [{card}]")
    del base_final
    none = statistics.mean(x for x, _ in runs["none"])
    off = statistics.mean(x for x, _ in runs["disabled"])
    log(f"[{tag}] disabled / none s/round: {off:.4f} / {none:.4f} = "
        f"{off / none:.4f} (the reference's relation: a disabled injector "
        f"costs at most 1.05x); params bit-equal   [{card}]")
    return {"none_s_per_round": none, "disabled_s_per_round": off,
            "ratio": off / none, "none_peak_gb": runs["none"][0][1],
            "runs": runs}


def faults_mamba2(card: str) -> dict:
    """(e) Two guarded Mamba2-370M rounds at seq 512 (pipelined, depth 1)
    under client death and every corruption kind: every ``ssd_scan``
    launch on the tensor-core route, finite params, ok rows and counters
    as replayed."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.faults import FaultPlan

    cfg = get_arch("mamba2_370m")
    tag = f"faults {cfg.name}"
    exp = _round_experiment(cfg, _ssm_task(cfg), rounds=2, pipeline=True,
                            pipeline_depth=1)
    fl, params = exp.fl, exp.init_params()
    del exp
    seed = fault_seed(MAMBA_FAULTS, 2, fl.cohort_size)
    rows, counters = replay_faults(MAMBA_FAULTS, seed, 2, fl.cohort_size)
    held = {}

    def prepare(srv):
        held["srv"], held["rec"] = srv, record_faults(srv)
    r = _run_way(cfg, _ssm_task(cfg), params, dict(
        rounds=2, pipeline=True, pipeline_depth=1,
        faults=FaultPlan(seed=seed, **MAMBA_FAULTS)), prepare=prepare)
    srv = held["srv"]
    check_fault_log(tag, held["rec"], rows, srv.select_stats, counters)
    want = guarded_want(cfg, fl, 2)
    check(r["launches"] == want, f"[{tag}] launches {r['launches']}, want "
                                 f"{want}")
    check(_all_finite(r.pop("final")), f"[{tag}] non-finite params")
    n = len(r["hist"].records)
    log(f"[{tag}] seed {seed}: {n} guarded rounds (seq {SSM_SEQ}) in "
        f"{r['run_s']:.3f} s = {r['run_s'] / n:.4f} s/round, peak "
        f"{r['peak_gb']:.2f} GB; ok rows "
        f"{[x['ok'].astype(int).tolist() for x in held['rec']]}; counters "
        f"{counters}; launches {r['launches']}   [{card}]")
    del params, srv, held
    torch.cuda.empty_cache()
    return {"launches": r["launches"], "s_per_round": r["run_s"] / n,
            "peak_gb": r["peak_gb"], "seed": seed}


def serve_fault_seed(slots: int, first_steps: int, first_writes: int) -> int:
    """The smallest seed of SERVE_FAULTS whose slot lane strikes within
    the first ``first_steps`` decode steps (every slot busy then) and whose
    upload lane fails one of the first ``first_writes`` entry writes."""
    from repro_torch.faults import FaultInjector, FaultPlan, TransientFault
    for seed in range(100_000):
        inj = FaultInjector(FaultPlan(seed=seed, **SERVE_FAULTS))
        strikes = any(inj.slot_faults(s, slots).any()
                      for s in range(1, first_steps + 1))
        fails = 0
        for q in range(first_writes):
            try:
                inj.maybe_fail_upload(q)
            except TransientFault:
                fails += 1
        if strikes and fails:
            return seed
    raise SmokeFailure("no serving seed covers both faults")


def faults_serve(card: str) -> dict:
    """(f) Delta-mode TinyLlama-1.1B serving (4 slots, 8 requests of prompt
    8 and 16 new tokens, 4 users × 2 delta layers): under upload failures
    and slot strikes with generous retries every request finishes with the
    fault-free run's tokens; with every upload failing no user is ever
    half-admitted and the requests are dropped within ``admit_retries``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.faults import FaultInjector, FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_arch("tinyllama_1_1b")
    tag = f"faults-serve {cfg.name}"
    model = Model(cfg, RuntimeConfig(remat=False), device="cuda")
    params = model.init(0)
    store = synthetic_store(model, users=4, layers_per_user=2, seed=0)
    slots, n_req, plen, max_new = 4, 8, 8, 16
    max_seq = plen + max_new + 1

    clean, _ = serve.SlotServer(model, params, slots, max_seq, mode="delta",
                                store=store, device="cuda").run(
        requests(cfg, n_req, plen, max_new, 4))
    want_tokens = {r.rid: r.generated for r in clean}
    seed = serve_fault_seed(slots, 16, 8)
    inj = FaultInjector(FaultPlan(seed=seed, **SERVE_FAULTS))
    srv = serve.SlotServer(model, params, slots, max_seq, mode="delta",
                           store=store, injector=inj, max_slot_retries=50,
                           device="cuda")
    srv.overlay.max_upload_retries = 50
    hits = [0]
    draw = inj.slot_faults

    def slot_faults(step, n):
        hit = draw(step, n)
        hits[0] += sum(srv.active[i] is not None
                       for i in np.flatnonzero(hit).tolist())
        return hit
    inj.slot_faults = slot_faults
    torch.cuda.synchronize()
    ops.reset_launches()
    done, stats = srv.run(requests(cfg, n_req, plen, max_new, 4))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    got = {r.rid: r.generated for r in done}
    check(sorted(got) == list(range(n_req))
          and all(len(v) == max_new for v in got.values()),
          f"[{tag}] {len(done)} of {n_req} requests finished")
    same = sum(got[r] == want_tokens[r] for r in got)
    check(same == n_req, f"[{tag}] {n_req - same} requests generated other "
                         f"tokens than the fault-free run")
    check(srv.overlay.stats["upload_retries"] == inj.stats["upload_faults"]
          > 0 and srv.overlay.stats["failed_admits"] == 0,
          f"[{tag}] overlay {srv.overlay.stats}, injector {inj.stats}")
    check(stats["slot_failures"] == hits[0] > 0,
          f"[{tag}] slot_failures {stats['slot_failures']}, strikes on busy "
          f"slots {hits[0]}")
    want_mm = stats["steps"] * cfg.n_layers * 6
    check(launches["base_delta_matmul"] == want_mm,
          f"[{tag}] {launches['base_delta_matmul']} delta_matmul launches "
          f"over {stats['steps']} steps, want {want_mm}")
    log(f"[{tag}] seed {seed}, {SERVE_FAULTS}: {len(done)} of {n_req} "
        f"requests finished in {stats['steps']} steps, each with the "
        f"fault-free run's tokens; slot_failures {stats['slot_failures']} "
        f"(strikes on busy slots {hits[0]}, injector {inj.stats}); overlay "
        f"{srv.overlay.stats}; {launches['base_delta_matmul']} delta_matmul "
        f"launches; {stats['wall_s'] * 1e3 / stats['steps']:.2f} ms/step   "
        f"[{card}]")
    del srv

    # every upload fails: admits roll back whole, requests are dropped
    inj = FaultInjector(FaultPlan(seed=0, upload_fail_rate=1.0))
    srv = serve.SlotServer(model, params, slots, max_seq, mode="delta",
                           store=store, injector=inj, admit_retries=2,
                           device="cuda")
    admits = {"failed": 0, "half": 0}
    try_admit = srv.overlay.try_admit

    def checked_admit(slot, record):
        ok = try_admit(slot, record)
        if not ok:
            admits["failed"] += 1
            admits["half"] += srv.overlay.n_entries != 0
        return ok
    srv.overlay.try_admit = checked_admit
    done, stats2 = srv.run(requests(cfg, n_req, plen, max_new, 4))
    check(not done and len(srv.dropped) == n_req and admits["half"] == 0
          and admits["failed"] == n_req * (srv.admit_retries + 1)
          == srv.overlay.stats["failed_admits"],
          f"[{tag}] every upload failing: done {len(done)}, dropped "
          f"{len(srv.dropped)}, admits {admits}, overlay "
          f"{srv.overlay.stats}")
    log(f"[{tag}] every upload failing: {admits['failed']} admits failed "
        f"and rolled back whole (n_entries 0 after each), {len(srv.dropped)}"
        f" of {n_req} requests dropped within admit_retries "
        f"{srv.admit_retries}; injector {inj.stats}   [{card}]")
    del srv, params, model, store
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "seed": seed,
            "slot_hits": hits[0]}


# ---------------------------------------------------------------------------
# The hybrid family: Zamba2-7B (Mamba2 blocks and one shared attention+MLP
# block after every 6 of them)
# ---------------------------------------------------------------------------

# The round's depth: two groups of attn_every 6 and a tail of 3 (81 mod 6),
# the full model's structure.  At full depth the cohort's stacked f32
# deltas alone would take 104 GB (PERF.md §4).
HYBRID_ROUND_LAYERS = 15
# Zamba2-7B's scan on the round's batch: 112 heads of P 64, state N 64
SSD_ZAMBA = dict(b=4, s=SSM_SEQ, h=112, p=64, g=1, n=64)
# The shared block's attention on the round's batch: MHA 32/32, D 112
FLASH_ZAMBA = dict(b=4, s=SSM_SEQ, h=32, k=32, d=112, causal=True,
                   window=4096)
# serving: a functional check in the whole script (every request finishes)
# and a measured run alone (``--hybrid-serve-long``) at prompts of 1024
# tokens, every slot refilled twice; both with the KV rows sized to the
# model's window (4096)
HYBRID_SERVE = dict(slots=3, requests=6, plen=8, max_new=16)
HYBRID_SERVE_LONG = dict(slots=3, requests=9, plen=1024, max_new=64)


def set_precision():
    """f32 products in full f32 on the card: matmuls (PyTorch's default)
    and cuDNN convolutions (TF32 by default)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_hybrid_kernels(card: str) -> dict:
    """The three kernels of the Zamba2-7B path against their plain versions
    at its shapes, each timed beside its bound: ``ssd_scan`` at N 64 and
    112 heads (bf16 on the tensor cores, with a slowly decaying state too;
    f32 on SIMT), the flash forward and backward at D 112, MHA, window 4096
    (which S 512 does not reach) and 128 (which cuts every row), both on
    the tensor-core route, with SDPA on the same function timed beside
    them; ``layer_grad_norm`` at the nine Mamba2 leaves of the depth-15
    round (L 15) and at the shared block's eight leaves, one row each (up
    to 102.8 M elements in ``mlp_wi``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import _block_shapes

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"ssd": phase_ssd_kernel(card, cases=[
        ("zamba2", SSD_ZAMBA, bf16, False, True),
        ("zamba2/tp_local_m16", dict(SSD_ZAMBA, h=SSD_ZAMBA["h"] // 16),
         bf16, False, True),
        ("zamba2/slow_decay", SSD_ZAMBA, bf16, True, False),
        ("zamba2/f32", SSD_ZAMBA, f32, True, False)])}
    check(out["ssd"]["zamba2"]["route"] == "mma"
          and out["ssd"]["zamba2/f32"]["route"] == "simt",
          "ssd_scan at Zamba2's shape took the wrong routes")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out["flash"] = []
    for name, window in (("zamba2", 4096), ("zamba2/window_128", 128)):
        shp = dict(FLASH_ZAMBA, window=window)
        res, (q, k, v, do) = flash_check(name, shp, bf16, gen)
        check(res["route"] == "mma", f"flash_attention {name} took the "
                                     f"{res['route']} route")
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        o, lse = fa.flash_attention(qt, kt, vt, causal=True, window=window)
        res["bound_ms"], res["bound_by"] = flash_bound(**shp, dtype=bf16)
        res["bwd_bound_ms"], res["bwd_bound_by"] = flash_bound(
            **shp, dtype=bf16, backward=True)
        res["ms"] = time_ms(lambda: fa.flash_attention(
            qt, kt, vt, causal=True, window=window), flush)
        res["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd(
            qt, kt, vt, o, lse, dot, causal=True, window=window), flush)
        res["plain_ms"] = time_ms(lambda: fa.flash_attention_torch(
            qt, kt, vt, causal=True, window=window), flush)
        res["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_torch(
            qt, kt, vt, o, lse, dot, causal=True, window=window), flush)
        # the yardstick: SDPA on (B,H,S,D) contiguous copies, the same
        # function (a window past S is plain causal; else a boolean mask)
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ldo = dot.contiguous()
        idx = torch.arange(shp["s"], device="cuda")
        mask = None if window >= shp["s"] else (
            (idx[None, :] <= idx[:, None])
            & (idx[:, None] - idx[None, :] < window))

        def sdpa():
            return F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask, is_causal=mask is None)
        res["library_ms"] = time_ms(sdpa, flush)
        l_out = sdpa()
        res["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            l_out, (lq, lk, lv), ldo, retain_graph=True), flush)
        l_err = (l_out.transpose(1, 2).float() - o.transpose(1, 2).float()
                 ).abs().max().item()
        log(f"[hybrid-kernel] flash {name}: forward {res['ms']:.4f} ms | "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) | "
            f"kernel/bound {res['ms'] / res['bound_ms']:.1f} | plain "
            f"{res['plain_ms']:.4f} ms | SDPA {res['library_ms']:.4f} ms "
            f"(|Δo| vs kernel {l_err:.3e}); backward {res['bwd_ms']:.4f} ms "
            f"| bound {res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}) "
            f"| kernel/bound {res['bwd_ms'] / res['bwd_bound_ms']:.1f} | "
            f"plain {res['plain_bwd_ms']:.4f} ms | SDPA backward "
            f"{res['library_bwd_ms']:.4f} ms   [{card}]")
        out["flash"].append(res)
        del q, k, v, do, qt, kt, vt, dot, o, lse, lq, lk, lv, ldo, l_out

    cfg = get_arch("zamba2_7b")
    rows, errs = [], []
    for kind, L in (("ssm", HYBRID_ROUND_LAYERS), ("attn_mlp_shared", 1)):
        for name, shp in sorted(_block_shapes(cfg, kind).items()):
            g = torch.randn((L, math.prod(shp)), generator=gen,
                            device="cuda").to(bf16)
            err, r = lgn_check(g, name, card, flush)
            errs.append(err)
            rows.append(r)
            del g
    total = kernel_totals(rows)
    log(f"[hybrid-kernel] layer_grad_norm over one Zamba2 probe's 17 leaves "
        f"(nine Mamba2 leaves at L {HYBRID_ROUND_LAYERS}, the shared "
        f"block's eight as single rows): kernel {total['ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"library {total['library_ms']:.4f} ms   [{card}]")
    out["layer_grad_norm"] = {"rows": rows, "total": total,
                              "max_abs_err": max(errs)}
    del flush
    torch.cuda.empty_cache()
    return out


def _param_split(params) -> str:
    """The parameter count, in all and per group of leaves."""
    n = {k: sum(v.numel() for v in sub.values())
         for k, sub in params.items() if isinstance(sub, dict)}
    total = sum(n.values()) + sum(v.numel() for v in params.values()
                                  if not isinstance(v, dict))
    return (f"{total / 1e9:.4f} B params ("
            + ", ".join(f"{k} {v / 1e9:.4f} B" for k, v in n.items()) + ")")


def hybrid_serve_modes(card: str, sv: dict, timed: bool):
    """Full Zamba2-7B (81 layers, random weights, seed 0) through
    SlotServer in shared and dense mode, ``sv["slots"]`` slots and
    ``sv["requests"]`` requests of ``sv["plen"]`` prompt and
    ``sv["max_new"]`` new tokens, the KV rows sized to the window: every
    request must finish and the decode launches no kernel; delta mode must
    be refused.  ``timed``: log ms/step, tokens/s and the peak memory of
    each mode, and their ratio.  Returns (model, params, results)."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = get_arch("zamba2_7b")
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=128),
                  device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"[hybrid-serve] {cfg.name}: {cfg.n_layers} Mamba2 layers, "
        f"{cfg.n_layers // cfg.attn_every} shared-block sites, "
        f"{_param_split(params)} in {cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; init "
        f"{time.perf_counter() - t0:.1f} s   [{card}]")
    max_seq = cfg.sliding_window
    store = synthetic_store(model, users=3, layers_per_user=2, seed=0)
    try:
        serve.SlotServer(model, params, sv["slots"], max_seq, mode="delta",
                         store=store, device="cuda")
        refused = False
    except ValueError as exc:
        refused = "delta-decode" in str(exc)
    check(refused, "zamba2 delta mode was not refused")
    results = {}
    for mode in ("shared", "dense"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        srv = serve.SlotServer(model, params, sv["slots"], max_seq,
                               mode=mode,
                               store=None if mode == "shared" else store,
                               device="cuda")
        kv = sum(t.numel() * t.element_size()
                 for t in srv.cache["shared_attn"].values())
        reqs = requests(cfg, sv["requests"], sv["plen"], sv["max_new"],
                        0 if mode == "shared" else 3)
        torch.cuda.synchronize()
        ops.reset_launches()
        done, stats = srv.run(reqs)
        torch.cuda.synchronize()
        check(len(done) == sv["requests"]
              and all(len(r.generated) == sv["max_new"] for r in done),
              f"zamba2 {mode}: {len(done)} of {sv['requests']} requests "
              f"finished")
        check(all(v == 0 for v in ops.LAUNCHES.values()),
              f"zamba2 {mode} decode launched kernels: {ops.LAUNCHES}")
        stats["ms_per_step"] = stats["wall_s"] * 1e3 / stats["steps"]
        stats["fed_tok_per_s"] = (sv["requests"] * (sv["plen"]
                                                    + sv["max_new"] - 1)
                                  / stats["wall_s"])
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats["kv_gb"] = kv / 1e9
        results[mode] = stats
        line = (f"[hybrid-serve] {mode:6s} {sv['requests']} requests of "
                f"{sv['plen']} + {sv['max_new']} tokens on {sv['slots']} "
                f"slots, KV rows of {max_seq} ({stats['kv_gb']:.2f} GB): "
                f"all finished in {stats['steps']} steps")
        if timed:
            line += (f", {stats['wall_s']:.1f} s, {stats['ms_per_step']:.2f} "
                     f"ms/step, {stats['tok_per_s']:.3f} generated tok/s, "
                     f"{stats['fed_tok_per_s']:.2f} tokens through the "
                     f"model/s, peak {stats['peak_gb']:.2f} GB "
                     f"(torch.cuda.max_memory_allocated)")
        log(line + f"   [{card}]")
        del srv
        torch.cuda.empty_cache()
    results["dense_over_shared_step"] = (results["dense"]["ms_per_step"]
                                         / results["shared"]["ms_per_step"])
    if timed:
        log(f"[hybrid-serve] dense ms/step ÷ shared ms/step "
            f"{results['dense_over_shared_step']:.3f}   [{card}]")
    del store
    torch.cuda.empty_cache()
    return model, params, results


def phase_hybrid_serve_long(card: str) -> dict:
    """The measured Zamba2-7B serving run (``--hybrid-serve-long``, about
    30 min on one H100): HYBRID_SERVE_LONG in shared and dense mode."""
    model, params, results = hybrid_serve_modes(card, HYBRID_SERVE_LONG,
                                                timed=True)
    del model, params
    return results


def phase_hybrid_serve(card: str) -> dict:
    """Full Zamba2-7B served in shared and dense mode as a functional check
    (HYBRID_SERVE: every request finishes, delta mode refused; its times
    are too short a run to report, ``phase_hybrid_serve_long`` measures).
    Then, in f32 at full width and depth 15, the sequence forward's logits
    over a 256-token prompt (the kernels: two chunks, the shared block
    twice) against step-by-step decode (the recurrence and the windowed KV
    rows)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    model, params, results = hybrid_serve_modes(card, HYBRID_SERVE,
                                                timed=False)
    cfg, rt = model.cfg, model.runtime
    del params, model
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, n_layers=HYBRID_ROUND_LAYERS,
                              dtype="float32")
    m32 = Model(c32, rt, device="cuda")
    p32 = m32.init(1)
    S, sites = 256, c32.n_layers // c32.attn_every
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launches()
    with torch.no_grad():
        h, _, _ = m32.forward_seq(p32, {"tokens": tokens})
        seq_logits = m32._head(p32, h)
    la = dict(ops.LAUNCHES)
    check(la["ssd_scan"] == la["ssd_scan_simt"] == c32.n_layers
          and la["ssd_scan_mma"] == 0
          and la["flash_attention"] == la["flash_attention_simt"] == sites,
          f"the f32 sequence forward launched {la}, want {c32.n_layers} "
          f"ssd_scan and {sites} flash forwards, all on the SIMT route")
    cache = m32.init_cache(2, S)
    t0 = time.perf_counter()
    dec = []
    for t in range(S):
        logits, cache = m32.decode_step(
            p32, tokens[:, t], torch.tensor(t, dtype=torch.int32,
                                            device="cuda"), cache)
        dec.append(logits)
    dec = torch.stack(dec, 1)
    torch.cuda.synchronize()
    err = (dec - seq_logits).abs().max().item()
    scale = seq_logits.abs().max().item()
    ok = bool(torch.isfinite(seq_logits).all()) and torch.allclose(
        dec, seq_logits, atol=DECODE_TOL, rtol=DECODE_TOL)
    log(f"[hybrid-serve] f32, full width, depth {c32.n_layers}: forward_seq "
        f"(ssd_scan, 2 chunks; flash at {sites} sites) vs {S} decode steps: "
        f"max_abs_err {err:.3e} (|logits| <= {scale:.3g}; atol/rtol "
        f"{DECODE_TOL:g}); decode "
        f"{(time.perf_counter() - t0) * 1e3 / S:.2f} ms/step "
        f"{'ok' if ok else 'MISMATCH'}   [{card}]")
    check(ok, "zamba2 forward_seq and step-by-step decode disagree (f32)")
    results["decode_max_abs_err"] = err
    del p32, m32, cache, dec, seq_logits, h
    torch.cuda.empty_cache()
    return results


def phase_hybrid_round(card: str) -> dict:
    """Three rounds of "ours" at full Zamba2-7B width and depth 15 (the
    dense program: every selectable layer and the shared block
    differentiated, the gradient masked), seq_len 512, synchronous and
    through the round scheduler at depth 1, after an untimed warm-up
    round: the same cohorts and masks, params within ROUND_PARAM_ATOL, the
    launches the round's structure needs (round_want) in total and per
    round.  Round 0 replayed stage by stage (time and launches per stage)
    and against the plain versions, its update also with the shared block
    selected; one client step profiled; a reduced f32 round on card and
    CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_arch("zamba2_7b"),
                              n_layers=HYBRID_ROUND_LAYERS)
    exp = _round_experiment(cfg, _ssm_task(cfg))
    fl, params = exp.fl, exp.init_params()
    sel = sum(v.numel() for k in ("blocks", "shared_attn")
              for v in params[k].values())
    log(f"[hybrid-round] {cfg.name} at depth {cfg.n_layers}: "
        f"{_param_split(params)}, {sel / 1e9:.4f} B selectable; stacked "
        f"f32 deltas of a cohort of {fl.cohort_size}: "
        f"{fl.cohort_size * sel * 4 / 1e9:.2f} GB   [{card}]")
    t0 = time.perf_counter()
    exp.run(params, rounds=1)                          # warm-up, untimed
    torch.cuda.synchronize()
    log(f"[hybrid-round] warm-up round (synchronous, untimed) "
        f"{time.perf_counter() - t0:.3f} s")
    del exp
    torch.cuda.empty_cache()
    runs = {}
    for name, way in (("synchronous", dict(pipeline=False)),
                      ("depth 1", dict(pipeline=True, pipeline_depth=1))):
        r = _run_way(cfg, _ssm_task(cfg), params, way)
        n = len(r["hist"].records)
        want = round_want(cfg, fl, [0] * n)
        want_one = {k: v for k, v in round_want(cfg, fl, [0]).items() if v}
        for rec in r["hist"].records:
            check(all(math.isfinite(v) for v in (rec.train_loss,
                                                  rec.test_loss)),
                  f"[hybrid-round] {name}: non-finite loss")
            check(np.all(rec.mask_matrix.sum(1) <= fl.budget),
                  f"[hybrid-round] {name}: masks break the budget")
        check(r["launches"] == want,
              f"[hybrid-round] {name}: launches {r['launches']}, want {want}")
        # the scheduler queues round r + 1's probe before round r's eval,
        # so only the synchronous loop's evals split the launches by round
        check(way["pipeline"]
              or all(pr == want_one for pr in r["per_round"]),
              f"[hybrid-round] {name}: launches per round {r['per_round']}, "
              f"want {want_one}")
        if runs:
            base = runs["synchronous"]
            for ra, rb in zip(r["hist"].records, base["hist"].records):
                check(np.array_equal(ra.cohort, rb.cohort)
                      and np.array_equal(ra.mask_matrix, rb.mask_matrix),
                      f"[hybrid-round] {name}, round {ra.round}: other "
                      f"cohorts or masks than the synchronous loop")
            r["params_max_diff"] = _tree_max_diff(r["final"], base["final"])
            check(r["params_max_diff"] <= ROUND_PARAM_ATOL,
                  f"[hybrid-round] {name}: params differ from the "
                  f"synchronous loop by {r['params_max_diff']:.3e}")
        r["s_per_round"] = r["run_s"] / n
        for rec in r["hist"].records:
            log(f"[hybrid-round] {name} round {rec.round}: cohort "
                f"{rec.cohort.tolist()} selected "
                f"{[np.flatnonzero(m).tolist() for m in rec.mask_matrix]} "
                f"train_loss {rec.train_loss:.6f} test_loss "
                f"{rec.test_loss:.6f}")
        log(f"[hybrid-round] {name}: {n} rounds in {r['run_s']:.3f} s = "
            f"{r['s_per_round']:.4f} s/round; max |Δparams| vs the "
            f"synchronous loop {r.get('params_max_diff', 0.0):.3e} (atol "
            f"{ROUND_PARAM_ATOL:g}); peak {r['peak_gb']:.2f} GB "
            f"(torch.cuda.max_memory_allocated); launches {r['launches']}; "
            f"at each queued eval {r['per_round']}   [{card}]")
        runs[name] = r
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ops.LAUNCHES}
    hist = runs["synchronous"]["hist"]
    for r in runs.values():
        r.pop("final")
    torch.cuda.empty_cache()

    # round 0 again, stage by stage, then against the plain versions
    task = _ssm_task(cfg)
    srv = _round_experiment(cfg, task).build()
    plain = _round_experiment(cfg, task, model=Model(
        cfg, RuntimeConfig(remat=False, seq_chunk=128), device="cuda",
        kernel_mode="torch")).build()
    stage = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t,
                       {k: v for k, v in ops.LAUNCHES.items()
                        if v and not k.endswith(("_mma", "_simt"))})
        return res
    plan, sampled = staged("plan+sample", lambda: (
        lambda pl: (pl, srv.sample_round(pl)))(srv.plan_round(0)))
    stats = staged("probe", lambda: srv.probe_round(params, sampled))
    masks = staged("select", lambda: srv.select_round(plan, stats))
    new_k, losses = staged("update", lambda: srv.update_round(params, sampled,
                                                              masks))
    staged("eval", lambda: srv.client.evaluate(
        new_k, srv._to_device(task.test_batch())))
    split = {k: v[0] for k, v in stage.items()}
    log(f"[hybrid-round] timed round 0 (synchronised at stage boundaries): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"; launches per stage {({k: v[1] for k, v in stage.items()})}"
        f"   [{card}]")
    check(np.array_equal(masks, hist.records[0].mask_matrix),
          "round 0 replayed stage by stage chose other masks than the run")
    ops.reset_launches()
    stats_p = plain.probe_round(params, sampled)
    masks_p = plain.select_round(plan, stats_p)
    rel = max(float(np.max(np.abs(stats_p[k] - stats[k]) / np.abs(stats[k])))
              for k in stats)
    new_p, losses_p = plain.update_round(params, sampled, masks)
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version replay launched kernels: {ops.LAUNCHES}")
    dp = _tree_max_diff(new_k, new_p)
    log(f"[hybrid-round] round 0, kernels vs plain versions: probe stats max "
        f"rel err {rel:.3e} (rtol 2e-2, Mamba2's bf16 limit); masks equal: "
        f"{bool(np.array_equal(masks_p, masks))}; update with the kernel "
        f"run's masks: max |Δparams| {dp:.3e} (bf16), losses "
        f"{np.abs(losses - losses_p).max():.3e}   [{card}]")
    check(rel <= 2e-2, "zamba2 probe stats: kernel and plain versions "
                       "disagree")
    check(np.array_equal(masks_p, masks), "zamba2 plain-version probe stats "
                                          "chose other masks")
    check(dp <= ROUND_PARAM_ATOL, f"zamba2 round 0 update: kernel and plain "
                                  f"versions differ by {dp:.3e}")
    del new_k, new_p
    torch.cuda.empty_cache()
    # the shared block as a selected layer: its (1,) mask column, taken by
    # clients 0 and 2 only (an Eq. (5) weight over 2 of 4), and its update,
    # which runs the flash backward at both sites into a kept gradient
    masks_s = np.zeros_like(masks)
    masks_s[:, 0] = 1
    masks_s[[0, 2], -1] = 1
    new_k, losses_k = srv.update_round(params, sampled, masks_s)
    ops.reset_launches()
    new_p, losses_p = plain.update_round(params, sampled, masks_s)
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version shared-block update launched kernels: "
          f"{ops.LAUNCHES}")
    moved = _tree_max_diff(new_k["shared_attn"], params["shared_attn"])
    kept = _tree_max_diff({k: v[1:] for k, v in new_k["blocks"].items()},
                          {k: v[1:] for k, v in params["blocks"].items()})
    dps = _tree_max_diff(new_k, new_p)
    log(f"[hybrid-round] round 0 update with the shared block selected "
        f"(masks {[np.flatnonzero(m).tolist() for m in masks_s]}): shared "
        f"leaves moved by up to {moved:.3e}, unselected rows by {kept:.3e}; "
        f"kernels vs plain versions max |Δparams| {dps:.3e} (atol "
        f"{ROUND_PARAM_ATOL:g}), losses "
        f"{np.abs(losses_k - losses_p).max():.3e}   [{card}]")
    check(moved > 0 and kept == 0,
          f"zamba2 shared-block update: shared leaves moved {moved:.3e}, "
          f"unselected rows {kept:.3e}")
    check(dps <= ROUND_PARAM_ATOL, f"zamba2 shared-block update: kernel and "
                                   f"plain versions differ by {dps:.3e}")
    del new_k, new_p, srv, plain, params
    torch.cuda.empty_cache()
    prof = phase_profile(card, cfg, SSM_SEQ, "hybrid-profile", {
        "ssd_scan (forward kernel)": ("ssd_scan",),
        "flash_attention (forward, dQ, dK/dV kernels)": ("flash_",),
        "layer_grad_norm": ("sqnorm",)})
    torch.cuda.empty_cache()
    hybrid_round_exact(card)
    return {"launches": launches, "split": split, "probe_rel_err": rel,
            "update_max_diff": dp, "shared_update_max_diff": dps,
            "profile": prof,
            **{name: {k: r[k] for k in ("s_per_round", "run_s", "peak_gb")}
               for name, r in runs.items()}}


def hybrid_round_exact(card: str) -> None:
    """Reduced zamba2 in f32 (3 layers, d_model 64: P 32, head dim 16, the
    kernels' SIMT routes), 2 rounds: the card and the CPU choose the same
    cohorts and masks and reach params within atol 1e-5."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("zamba2_7b"), n_layers=2, d_model=64)
    runs = {}
    for dev in ("cuda", "cpu"):
        task = SyntheticFederatedData(FederatedTaskConfig(
            n_clients=8, vocab_size=cfg.vocab_size, seq_len=64,
            samples_per_client=8, skew="label", objective="lm"))
        exp = Experiment(cfg, task, "ours", cohort_size=3, rounds=2,
                         local_steps=2, lr=0.01, batch_size=2, budget=2,
                         lam=1.0, seed=3, pipeline=False, device=dev,
                         runtime=RuntimeConfig(remat=False, seq_chunk=16))
        params = tree_map(lambda t: t.to(dev),
                          Experiment(cfg, task, device="cpu").init_params())
        ops.reset_launches()
        final, hist = exp.run(params)
        runs[dev] = (tree_map(lambda t: t.cpu(), final), hist,
                     dict(ops.LAUNCHES))
    (pg, hg, lg), (pc, hc, lc) = runs["cuda"], runs["cpu"]
    check(lg["layer_grad_norm"] > 0 and lg["masked_update"] == 0
          and lc == {k: 0 for k in lc}
          and lg["ssd_scan_simt"] == lg["ssd_scan"] > 0
          and lg["flash_attention_simt"] == lg["flash_attention"] > 0
          and lg["flash_attention_bwd_simt"] == lg["flash_attention_bwd"] > 0,
          f"reduced zamba2 run: launches on the card {lg}, on the CPU {lc}")
    for rg, rc in zip(hg.records, hc.records):
        check(np.array_equal(rg.cohort, rc.cohort)
              and np.array_equal(rg.mask_matrix, rc.mask_matrix),
              f"reduced zamba2 run, round {rg.round}: card and CPU chose "
              f"other cohorts or masks")
    err = _tree_max_diff(pg, pc)
    log(f"[hybrid-round] reduced zamba2 f32, 2 rounds: cohorts and masks "
        f"equal on card and CPU; max |Δparams| {err:.3e} (atol 1e-5); card "
        f"launches {lg}   [{card}]")
    check(err <= 1e-5, "reduced zamba2 run: card and CPU params differ")


# ---------------------------------------------------------------------------
# slice 10: the moe family, DeepSeek-V2-Lite-16B
# ---------------------------------------------------------------------------

# The round's depth: dense0 and three moe blocks, 1.84 B selectable
# params, whose stacked f32 deltas take 29.4 GB for a cohort of 4; at
# full depth (15.29 B selectable) they would take 244.6 GB.  Depth 5 (38.8
# GB of deltas) peaked at 76.4 GB synchronous and ran out of memory
# pipelined (PERF.md §4).
MOE_ROUND_LAYERS = 4
# serving: a functional check in the whole script (every request finishes)
# and a measured run alone (``--moe-serve-long``), the latent rows sized to
# a 4096 window (31 KB a token over 27 layers).  Dense mode holds one
# private copy beside the base (2 × 31.4 GB of the card's 80), so it runs
# one slot, and shared mode runs at one slot too, to compare.
MOE_WINDOW = 4096
MOE_SERVE = dict(slots=4, requests=8, plen=8, max_new=16,
                 one_slot_requests=2)
MOE_SERVE_LONG = dict(slots=4, requests=8, plen=1024, max_new=64,
                      one_slot_requests=2)


class MoEStatsLog:
    """Every moe layer's router statistics (aux loss, dropped fraction)
    while active, through a patch of ``models.moe.moe_fwd``; the values stay
    on the card until :meth:`summary` reads them after the run."""

    def __enter__(self):
        from repro_torch.models import moe
        orig = moe.moe_fwd
        self.stats = []

        def moe_fwd(*a, **k):
            out, st = orig(*a, **k)
            self.stats.append((st.aux_loss.detach(),
                               st.dropped_frac.detach()))
            return out, st
        self._patch = mock.patch.object(moe, "moe_fwd", moe_fwd)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        return False

    def summary(self) -> dict:
        import torch
        if not self.stats:
            return {"layer_calls": 0}
        aux = torch.stack([a for a, _ in self.stats]).float().cpu()
        drop = torch.stack([d for _, d in self.stats]).float().cpu()
        return {"layer_calls": len(self.stats),
                "aux_mean": aux.mean().item(), "aux_max": aux.max().item(),
                "dropped_mean": drop.mean().item(),
                "dropped_max": drop.max().item()}


class RowsSeen:
    """The rows of every ``masked_update`` launch while active (a patch of
    ``kernels.masked_update.masked_sgd_update_2d`` that calls it)."""

    def __enter__(self):
        from repro_torch.kernels import masked_update as mu
        orig = mu.masked_sgd_update_2d
        self.rows = []

        def counted(p, g, mask, lr):
            self.rows.append(p.shape[0])
            return orig(p, g, mask, lr)
        self._patch = mock.patch.object(mu, "masked_sgd_update_2d", counted)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        return False


def phase_moe_kernels(card: str) -> dict:
    """The two training kernels of the DeepSeek-V2-Lite-16B round against
    their plain versions at its leaves, each timed beside its bound and
    the library call: ``dense0``'s 10 leaves at L 1 and the moe
    ``blocks``' 13 at the round's depth (L 3; ``moe_wi_e`` 369.1 M
    elements a row).  ``layer_grad_norm`` over all L rows (one probe),
    ``masked_update`` over the same rows with a mixed 0/1 mask (one τ step
    at cut 0)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import _block_shapes

    cfg = get_arch("deepseek_v2_lite_16b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = {"layer_grad_norm": [], "masked_update": []}
    errs = {"layer_grad_norm": 0.0, "masked_update": 0.0}
    for path, kind, L in (("dense0", "moe_dense0", cfg.first_dense),
                          ("blocks", "moe",
                           MOE_ROUND_LAYERS - cfg.first_dense)):
        mask = torch.tensor([float(i % 3 != 1) for i in range(L)],
                            device="cuda")
        for name, shp in sorted(_block_shapes(cfg, kind).items()):
            F = math.prod(shp)
            tag = f"{path}/{name}"
            g = torch.randn((L, F), generator=gen,
                            device="cuda").to(torch.bfloat16)
            err, r = lgn_check(g, tag, card, flush)
            errs["layer_grad_norm"] = max(errs["layer_grad_norm"], err)
            rows["layer_grad_norm"].append(r)
            p = torch.randn((L, F), generator=gen,
                            device="cuda").to(torch.bfloat16)
            err, r = mu_check(p, g, mask, 0.01, tag, card, flush)
            errs["masked_update"] = max(errs["masked_update"], err)
            rows["masked_update"].append(r)
            del p, g
            torch.cuda.empty_cache()
    out = {}
    for kname, rs in rows.items():
        total = kernel_totals(rs)
        log(f"[moe-kernel] {kname} over DeepSeek-V2-Lite's {len(rs)} leaves "
            f"(dense0 at L 1, blocks at L {MOE_ROUND_LAYERS - 1}): kernel "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
            f"(kernel/bound {total['ms'] / total['bound_ms']:.2f}), plain "
            f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} "
            f"ms   [{card}]")
        out[kname] = {"rows": rs, "total": total, "max_abs_err": errs[kname]}
    del flush
    torch.cuda.empty_cache()
    return out


def moe_serve_modes(card: str, sv: dict, timed: bool):
    """Full DeepSeek-V2-Lite-16B (27 layers, random weights, seed 0)
    through SlotServer: shared mode at ``sv["slots"]`` slots with
    ``sv["requests"]`` requests, then shared and dense mode at one slot
    with ``sv["one_slot_requests"]`` (dense: a user's private copy built in
    the slot's bank entry), each request ``sv["plen"]`` prompt and
    ``sv["max_new"]`` new tokens, the latent rows sized to MOE_WINDOW:
    every request must finish and the decode launches no kernel; delta
    mode must be refused.  ``timed``: log ms/step, tokens/s and the peak
    memory of each mode.  Returns (model, results)."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serve import DeltaOverlay

    cfg = get_arch("deepseek_v2_lite_16b")
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=128),
                  device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    pbytes = sum(v.numel() * v.element_size() for sub in params.values()
                 for v in (sub.values() if isinstance(sub, dict) else [sub]))
    log(f"[moe-serve] {cfg.name}: {cfg.first_dense} dense + "
        f"{cfg.n_layers - cfg.first_dense} moe layers, "
        f"{_param_split(params)} in {cfg.dtype}, {pbytes / 1e9:.2f} GB; "
        f"init {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the row-by-row "
        f"draw)   [{card}]")
    store = synthetic_store(model, users=2, layers_per_user=1, seed=0)
    refused = []
    for make in (lambda: serve.SlotServer(model, params, sv["slots"],
                                          MOE_WINDOW, mode="delta",
                                          store=store, device="cuda"),
                 lambda: DeltaOverlay(model, sv["slots"], device="cuda")):
        try:
            make()
            refused.append(False)
        except ValueError as exc:
            refused.append("delta-decode" in str(exc))
    check(all(refused), "deepseek delta mode was not refused")
    # a step reads every weight but the embedding table (B rows of it):
    # capacity dispatch runs all 64 experts on their C slots
    floor_ms = ((pbytes - params["embed"]["tok"].numel()
                 * params["embed"]["tok"].element_size())
                / HBM_BYTES_PER_S * 1e3)
    results = {"step_floor_ms": floor_ms}
    for name, mode, slots, n_req in (
            ("shared", "shared", sv["slots"], sv["requests"]),
            ("shared_1slot", "shared", 1, sv["one_slot_requests"]),
            ("dense_1slot", "dense", 1, sv["one_slot_requests"])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        srv = serve.SlotServer(model, params, slots, MOE_WINDOW, mode=mode,
                               store=None if mode == "shared" else store,
                               device="cuda")
        kv = sum(t.numel() * t.element_size() for seg in srv.cache.values()
                 for t in seg.values())
        reqs = requests(cfg, n_req, sv["plen"], sv["max_new"],
                        0 if mode == "shared" else 2)
        torch.cuda.synchronize()
        ops.reset_launches()
        done, stats = srv.run(reqs)
        torch.cuda.synchronize()
        check(len(done) == n_req
              and all(len(r.generated) == sv["max_new"] for r in done),
              f"deepseek {name}: {len(done)} of {n_req} requests finished")
        check(all(v == 0 for v in ops.LAUNCHES.values()),
              f"deepseek {name} decode launched kernels: {ops.LAUNCHES}")
        stats.update(
            slots=slots, requests=n_req, kv_gb=kv / 1e9,
            ms_per_step=stats["wall_s"] * 1e3 / stats["steps"],
            fed_tok_per_s=(n_req * (sv["plen"] + sv["max_new"] - 1)
                           / stats["wall_s"]),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        results[name] = stats
        line = (f"[moe-serve] {name:12s} {n_req} requests of {sv['plen']} + "
                f"{sv['max_new']} tokens on {slots} slot(s), latent rows of "
                f"{MOE_WINDOW} ({stats['kv_gb']:.3f} GB): all finished in "
                f"{stats['steps']} steps, peak {stats['peak_gb']:.2f} GB")
        if timed:
            line += (f", {stats['wall_s']:.1f} s, {stats['ms_per_step']:.2f} "
                     f"ms/step (floor {floor_ms:.2f}), "
                     f"{stats['tok_per_s']:.3f} generated tok/s, "
                     f"{stats['fed_tok_per_s']:.2f} tokens through the "
                     f"model/s")
        log(line + f"   [{card}]")
        del srv
        torch.cuda.empty_cache()
    results["dense_over_shared_step_1slot"] = (
        results["dense_1slot"]["ms_per_step"]
        / results["shared_1slot"]["ms_per_step"])
    if timed:
        log(f"[moe-serve] step floor {floor_ms:.2f} ms (every weight but the "
            f"embedding once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); one slot: "
            f"dense ms/step ÷ shared ms/step "
            f"{results['dense_over_shared_step_1slot']:.3f}   [{card}]")
    del store, params
    torch.cuda.empty_cache()
    return model, results


def phase_moe_serve_long(card: str) -> dict:
    """The measured DeepSeek-V2-Lite-16B serving run (``--moe-serve-long``):
    MOE_SERVE_LONG."""
    model, results = moe_serve_modes(card, MOE_SERVE_LONG, timed=True)
    del model
    return results


def phase_moe_serve(card: str) -> dict:
    """Full DeepSeek-V2-Lite-16B served as a functional check (MOE_SERVE:
    every request finishes, delta mode refused; ``phase_moe_serve_long``
    measures).  Then, in f32 at full width and depth MOE_ROUND_LAYERS with
    capacity factor 8 (dropless, so prefill and decode route alike), the
    sequence forward's logits over a 256-token prompt (MLA expanded, by two
    query chunks) against step-by-step decode (MLA's absorbed matmuls over
    the latent cache)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    model, results = moe_serve_modes(card, MOE_SERVE, timed=False)
    cfg, rt = model.cfg, model.runtime
    del model
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, n_layers=MOE_ROUND_LAYERS,
                              dtype="float32", capacity_factor=8.0)
    m32 = Model(c32, rt, device="cuda")
    p32 = m32.init(1)
    S = 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launches()
    with MoEStatsLog() as st, torch.no_grad():
        h, aux, _ = m32.forward_seq(p32, {"tokens": tokens})
        seq_logits = m32._head(p32, h)
    fwd = st.summary()
    cache = m32.init_cache(2, S)
    t0 = time.perf_counter()
    dec = []
    with MoEStatsLog() as st:
        for t in range(S):
            logits, cache = m32.decode_step(
                p32, tokens[:, t], torch.tensor(t, dtype=torch.int32,
                                                device="cuda"), cache)
            dec.append(logits)
    dec = torch.stack(dec, 1)
    torch.cuda.synchronize()
    decs = st.summary()
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"the f32 moe forward and decode launched kernels: {ops.LAUNCHES}")
    check(fwd["dropped_max"] == 0 and decs["dropped_max"] == 0,
          f"capacity factor 8 dropped tokens: forward {fwd}, decode {decs}")
    err = (dec - seq_logits).abs().max().item()
    scale = seq_logits.abs().max().item()
    ok = bool(torch.isfinite(seq_logits).all()) and torch.allclose(
        dec, seq_logits, atol=DECODE_TOL, rtol=DECODE_TOL)
    log(f"[moe-serve] f32, full width, depth {c32.n_layers}, capacity factor "
        f"8: forward_seq (MLA expanded, query chunks of {rt.seq_chunk}) vs "
        f"{S} decode steps (absorbed): max_abs_err {err:.3e} (|logits| <= "
        f"{scale:.3g}; atol/rtol {DECODE_TOL:g}); aux loss {aux.item():.6f}, "
        f"dropped 0 of the forward's and the decode's routed pairs; decode "
        f"{(time.perf_counter() - t0) * 1e3 / S:.2f} ms/step "
        f"{'ok' if ok else 'MISMATCH'}   [{card}]")
    check(ok, "deepseek forward_seq and step-by-step decode disagree (f32)")
    results["decode_max_abs_err"] = err
    del p32, m32, cache, dec, seq_logits, h
    torch.cuda.empty_cache()
    return results


def phase_moe_round(card: str) -> dict:
    """Three rounds of "ours" at full DeepSeek-V2-Lite-16B width and depth
    MOE_ROUND_LAYERS (dense0 + 3 moe blocks; the mask-aware engine at each
    round's cut), seq_len 512, synchronous and through the round scheduler
    at depth 1, after an untimed warm-up round: the same cohorts and masks,
    bit-equal params, the launches each round's cut needs (round_want).
    Round 0 replayed stage by stage (time, launches, the routers' aux loss
    and dropped fraction in the probe) and against the plain versions; one
    "top" round whose cut falls inside ``blocks``; one client step
    profiled; a reduced f32 round on card and CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.core.masks import first_trainable_layer
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, segment_prefix_cuts
    from repro_torch.models.moe import capacity

    cfg = dataclasses.replace(get_arch("deepseek_v2_lite_16b"),
                              n_layers=MOE_ROUND_LAYERS)
    L = cfg.n_layers
    exp = _round_experiment(cfg, _ssm_task(cfg))
    fl, params = exp.fl, exp.init_params()
    sel = sum(v.numel() for k in ("dense0", "blocks")
              for v in params[k].values())
    log(f"[moe-round] {cfg.name} at depth {L}: {_param_split(params)}, "
        f"{sel / 1e9:.4f} B selectable; stacked f32 deltas of a cohort of "
        f"{fl.cohort_size}: {fl.cohort_size * sel * 4 / 1e9:.2f} GB   "
        f"[{card}]")
    t0 = time.perf_counter()
    exp.run(params, rounds=1)                          # warm-up, untimed
    torch.cuda.synchronize()
    log(f"[moe-round] warm-up round (synchronous, untimed) "
        f"{time.perf_counter() - t0:.3f} s")
    del exp
    torch.cuda.empty_cache()
    runs = {}
    for name, way in (("synchronous", dict(pipeline=False)),
                      ("depth 1", dict(pipeline=True, pipeline_depth=1))):
        r = _run_way(cfg, _ssm_task(cfg), params, way)
        recs = r["hist"].records
        cuts = [first_trainable_layer(rec.mask_matrix) for rec in recs]
        want = round_want(cfg, fl, cuts)
        for rec in recs:
            check(all(math.isfinite(v) for v in (rec.train_loss,
                                                  rec.test_loss)),
                  f"[moe-round] {name}: non-finite loss")
            check(np.all(rec.mask_matrix.sum(1) <= fl.budget),
                  f"[moe-round] {name}: masks break the budget")
        check(r["launches"] == want,
              f"[moe-round] {name}: launches {r['launches']}, want {want}")
        want_each = [{k: v for k, v in round_want(cfg, fl, [c]).items() if v}
                     for c in cuts]
        # the scheduler queues round r + 1's probe before round r's eval,
        # so only the synchronous loop's evals split the launches by round
        check(way["pipeline"] or r["per_round"] == want_each,
              f"[moe-round] {name}: launches per round {r['per_round']}, "
              f"want {want_each}")
        if runs:
            base = runs["synchronous"]
            for ra, rb in zip(recs, base["hist"].records):
                check(np.array_equal(ra.cohort, rb.cohort)
                      and np.array_equal(ra.mask_matrix, rb.mask_matrix),
                      f"[moe-round] {name}, round {ra.round}: other cohorts "
                      f"or masks than the synchronous loop")
            r["params_max_diff"] = _tree_max_diff(r["final"], base["final"])
            check(r["params_max_diff"] == 0.0,
                  f"[moe-round] {name}: params differ from the synchronous "
                  f"loop by {r['params_max_diff']:.3e} (want bit-equal)")
        r["s_per_round"] = r["run_s"] / len(recs)
        r["cuts"] = cuts
        for rec, c in zip(recs, cuts):
            log(f"[moe-round] {name} round {rec.round}: cohort "
                f"{rec.cohort.tolist()} cut {c} "
                f"{segment_prefix_cuts(c, cfg)} selected "
                f"{[np.flatnonzero(m).tolist() for m in rec.mask_matrix]} "
                f"train_loss {rec.train_loss:.6f} test_loss "
                f"{rec.test_loss:.6f}")
        log(f"[moe-round] {name}: {len(recs)} rounds in {r['run_s']:.3f} s = "
            f"{r['s_per_round']:.4f} s/round; max |Δparams| vs the "
            f"synchronous loop {r.get('params_max_diff', 0.0):.3e} (bit-equal "
            f"required); peak {r['peak_gb']:.2f} GB "
            f"(torch.cuda.max_memory_allocated); launches {r['launches']}; "
            f"at each queued eval {r['per_round']}   [{card}]")
        runs[name] = r
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ops.LAUNCHES}
    hist = runs["synchronous"]["hist"]
    for r in runs.values():
        r.pop("final")
    torch.cuda.empty_cache()

    # round 0 again, stage by stage, then against the plain versions
    task = _ssm_task(cfg)
    srv = _round_experiment(cfg, task).build()
    plain = _round_experiment(cfg, task, model=Model(
        cfg, RuntimeConfig(remat=False, seq_chunk=128), device="cuda",
        kernel_mode="torch")).build()
    stage = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t,
                       {k: v for k, v in ops.LAUNCHES.items() if v})
        return res
    plan, sampled = staged("plan+sample", lambda: (
        lambda pl: (pl, srv.sample_round(pl)))(srv.plan_round(0)))
    with MoEStatsLog() as router:
        stats = staged("probe", lambda: srv.probe_round(params, sampled))
    routed = router.summary()
    masks = staged("select", lambda: srv.select_round(plan, stats))
    new_k, losses = staged("update", lambda: srv.update_round(params, sampled,
                                                              masks))
    staged("eval", lambda: srv.client.evaluate(
        new_k, srv._to_device(task.test_batch())))
    split = {k: v[0] for k, v in stage.items()}
    log(f"[moe-round] timed round 0 (synchronised at stage boundaries): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
        + f"; launches per stage {({k: v[1] for k, v in stage.items()})}"
        f"   [{card}]")
    log(f"[moe-round] the probe's {routed['layer_calls']} moe layer calls "
        f"({fl.batch_size} × {SSM_SEQ} tokens each, capacity "
        f"{capacity(fl.batch_size * SSM_SEQ, cfg)} per expert of "
        f"{cfg.n_experts}, top {cfg.top_k}): aux loss mean "
        f"{routed['aux_mean']:.6f} max {routed['aux_max']:.6f}; dropped "
        f"fraction of routed pairs mean {routed['dropped_mean']:.4f} max "
        f"{routed['dropped_max']:.4f}   [{card}]")
    check(np.array_equal(masks, hist.records[0].mask_matrix),
          "round 0 replayed stage by stage chose other masks than the run")
    ops.reset_launches()
    stats_p = plain.probe_round(params, sampled)
    masks_p = plain.select_round(plan, stats_p)
    rel = max(float(np.max(np.abs(stats_p[k] - stats[k]) / np.abs(stats[k])))
              for k in stats)
    new_p, losses_p = plain.update_round(params, sampled, masks)
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version replay launched kernels: {ops.LAUNCHES}")
    dp = _tree_max_diff(new_k, new_p)
    log(f"[moe-round] round 0, kernels vs plain versions: probe stats max "
        f"rel err {rel:.3e} (rtol 1e-5: the same gradients, summed in "
        f"another order); masks equal: {bool(np.array_equal(masks_p, masks))};"
        f" update with the kernel run's masks: max |Δparams| {dp:.3e} "
        f"(atol {ROUND_PARAM_ATOL:g}), losses "
        f"{np.abs(losses - losses_p).max():.3e}   [{card}]")
    check(rel <= 1e-5, "deepseek probe stats: kernel and plain versions "
                       "disagree")
    check(np.array_equal(masks_p, masks), "deepseek plain-version probe "
                                          "stats chose other masks")
    check(dp <= ROUND_PARAM_ATOL, f"deepseek round 0 update: kernel and "
                                  f"plain versions differ by {dp:.3e}")
    del new_k, new_p, srv, plain
    torch.cuda.empty_cache()

    # one "top" round: every client trains the last `budget` layers, so the
    # cut falls inside blocks: dense0 frozen and left out of the trainable
    # rows, the first blocks rows frozen
    top = _round_experiment(cfg, _ssm_task(cfg), strategy="top", rounds=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with RowsSeen() as seen:
        final, hist_top = top.run(params)
    rows_seen = seen.rows
    torch.cuda.synchronize()
    top_s = time.perf_counter() - t0
    top_launches = dict(ops.LAUNCHES)
    top_peak = torch.cuda.max_memory_allocated() / 1e9
    rec = hist_top.records[0]
    top_cut = first_trainable_layer(rec.mask_matrix)
    seg = segment_prefix_cuts(top_cut, cfg)
    nb = L - cfg.first_dense
    want_top = {**round_want(cfg, fl, [top_cut]), "layer_grad_norm": 0}
    frozen = _tree_max_diff(
        {"dense0": final["dense0"],
         "blocks": {k: v[:seg["blocks"]] for k, v in final["blocks"].items()}},
        {"dense0": params["dense0"],
         "blocks": {k: v[:seg["blocks"]]
                    for k, v in params["blocks"].items()}})
    moved = _tree_max_diff(
        {k: v[seg["blocks"]:] for k, v in final["blocks"].items()},
        {k: v[seg["blocks"]:] for k, v in params["blocks"].items()})
    log(f"[moe-round] top round: cut {top_cut} {seg}, train_loss "
        f"{rec.train_loss:.6f} test_loss {rec.test_loss:.6f}, {top_s:.3f} s, "
        f"peak {top_peak:.2f} GB; masked_update rows per launch "
        f"{sorted(set(rows_seen))}; frozen rows moved {frozen:.3e}, trained "
        f"rows {moved:.3e}; launches {top_launches}, want {want_top}"
        f"   [{card}]")
    check(top_cut == L - fl.budget and seg["dense0"] == cfg.first_dense
          and 0 < seg["blocks"] < nb,
          f"top round cut at {top_cut} {seg}, want one inside blocks")
    check(top_launches == want_top, "the top round did not launch the "
                                    "kernels as its path requires")
    check(rows_seen and set(rows_seen) == {nb - seg["blocks"]},
          f"top round: masked_update took {sorted(set(rows_seen))} rows, want "
          f"only the {nb - seg['blocks']} trainable ones")
    check(frozen == 0.0 and moved > 0,
          f"top round: frozen rows moved {frozen:.3e}, trained {moved:.3e}")
    check(all(math.isfinite(v) for v in (rec.train_loss, rec.test_loss)),
          "top round: non-finite loss")
    del final, top, params
    torch.cuda.empty_cache()
    prof = phase_profile(card, cfg, SSM_SEQ, "moe-profile", {
        "routing, dispatch and combine (sort, scan, gather, scatter, "
        "index)": ("sort", "scan", "gather", "scatter", "index")})
    torch.cuda.empty_cache()
    moe_round_exact(card)
    return {"launches": launches, "top_launches": top_launches,
            "split": split, "probe_rel_err": rel, "update_max_diff": dp,
            "router": routed, "top_s": top_s, "top_peak_gb": top_peak,
            "profile": prof,
            **{name: {k: r[k] for k in ("s_per_round", "run_s", "peak_gb",
                                        "cuts")}
               for name, r in runs.items()}}


def moe_round_exact(card: str) -> None:
    """Reduced deepseek in f32 (3 layers: dense0 + 2 moe blocks, d_model
    64), 2 rounds: the card and the CPU choose the same cohorts and masks
    and reach params within atol 1e-5."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("deepseek_v2_lite_16b"), n_layers=3, d_model=64)
    runs = {}
    for dev in ("cuda", "cpu"):
        task = SyntheticFederatedData(FederatedTaskConfig(
            n_clients=8, vocab_size=cfg.vocab_size, seq_len=64,
            samples_per_client=8, skew="label", objective="lm"))
        exp = Experiment(cfg, task, "ours", cohort_size=3, rounds=2,
                         local_steps=2, lr=0.01, batch_size=2, budget=2,
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
          and lc == {k: 0 for k in lc}
          and all(lg[k] == 0 for k in lg
                  if k not in ("layer_grad_norm", "masked_update")),
          f"reduced deepseek run: launches on the card {lg}, on the CPU {lc}")
    for rg, rc in zip(hg.records, hc.records):
        check(np.array_equal(rg.cohort, rc.cohort)
              and np.array_equal(rg.mask_matrix, rc.mask_matrix),
              f"reduced deepseek run, round {rg.round}: card and CPU chose "
              f"other cohorts or masks")
    err = _tree_max_diff(pg, pc)
    log(f"[moe-round] reduced deepseek f32, 2 rounds: cohorts and masks "
        f"equal on card and CPU; max |Δparams| {err:.3e} (atol 1e-5); card "
        f"launches {lg}   [{card}]")
    check(err <= 1e-5, "reduced deepseek run: card and CPU params differ")


# ---------------------------------------------------------------------------
# slice 11: the audio family, whisper-medium
# ---------------------------------------------------------------------------

# whisper-medium at full width and depth: 24 encoder and 24 decoder layers
# over 1500 stub frame embeddings, 758.9 M params (1.52 GB in bf16), 704.8
# M of them selectable in 48 mask entries (a cohort of 4's stacked f32
# deltas take 11.3 GB).  The reference's whisper path is Model + Client
# (it has no whisper task, and its SlotServer cannot serve whisper), so
# the round is composed from the port's parts: the probe, "ours", the
# masked cohort update at the selected cut and at the cuts below.
AUDIO_SEQ = 448                     # the decoder's text context
AUDIO_ROUND = dict(cohort=4, tau=2, batch=4, budget=2, lr=0.01, lam=1.0)
AUDIO_CUTS = (0, 12, 24, 46)        # cut 0, mid-encoder, the boundary, deep
AUDIO_DECODE_STEPS = 64
# one layer's attention on the round's batch: the encoder's (non-causal,
# S 1500 = 23·64 + 28, a ragged last block) and the decoder's (causal)
FLASH_WHISPER = (("whisper_encoder", dict(b=4, s=1500, h=16, k=16, d=64,
                                          causal=False, window=0)),
                 ("whisper_decoder", dict(b=4, s=AUDIO_SEQ, h=16, k=16, d=64,
                                          causal=True, window=0)))


def phase_audio_kernels(card: str) -> dict:
    """The three kernels of the whisper-medium round against their plain
    versions at its shapes, each timed beside its bound and the library
    call: the flash forward and backward at the encoder's self-attention
    (B 4, S 1500, MHA 16 heads of 64, bf16, non-causal: the ragged last
    block) and the decoder's (S 448, causal), both on the tensor-core
    route, on separate k and v projections as the model makes them (their
    (b, h, s) strides 1 536 000 / 64 / 1024 at the encoder), SDPA on the
    same function beside them; ``layer_grad_norm`` over the 21 leaves of
    one probe (the encoder's 8 and the decoder's 13, L 24 each, 704.8 M
    elements) and ``masked_update`` over the same rows with a mixed 0/1
    mask (one τ step at cut 0)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import _block_shapes

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {"flash": []}
    for name, shp in FLASH_WHISPER:
        causal = shp["causal"]
        res, (q, k, v, do) = flash_check(name, shp, bf16, gen, fused_kv=False)
        check(res["route"] == "mma", f"flash_attention {name} took the "
                                     f"{res['route']} route")
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        o, lse = fa.flash_attention(qt, kt, vt, causal=causal)
        res["bound_ms"], res["bound_by"] = flash_bound(**shp, dtype=bf16)
        res["bwd_bound_ms"], res["bwd_bound_by"] = flash_bound(
            **shp, dtype=bf16, backward=True)
        res["ms"] = time_ms(lambda: fa.flash_attention(
            qt, kt, vt, causal=causal), flush)
        res["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd(
            qt, kt, vt, o, lse, dot, causal=causal), flush)
        res["plain_ms"] = time_ms(lambda: fa.flash_attention_torch(
            qt, kt, vt, causal=causal), flush)
        res["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_torch(
            qt, kt, vt, o, lse, dot, causal=causal), flush)
        lq, lk, lv = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        ldo = dot.contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(lq, lk, lv,
                                                  is_causal=causal)
        res["library_ms"] = time_ms(sdpa, flush)
        l_out = sdpa()
        res["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            l_out, (lq, lk, lv), ldo, retain_graph=True), flush)
        l_err = (l_out.transpose(1, 2).float() - o.transpose(1, 2).float()
                 ).abs().max().item()
        log(f"[audio-kernel] flash {name}: (b, h, s) strides of k "
            f"{tuple(res['kv_strides_bhs'])}; forward {res['ms']:.4f} ms | "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) | "
            f"kernel/bound {res['ms'] / res['bound_ms']:.1f} | plain "
            f"{res['plain_ms']:.4f} ms | SDPA {res['library_ms']:.4f} ms "
            f"(|Δo| vs kernel {l_err:.3e}); backward {res['bwd_ms']:.4f} ms "
            f"| bound {res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}) "
            f"| kernel/bound {res['bwd_ms'] / res['bwd_bound_ms']:.1f} | "
            f"plain {res['plain_bwd_ms']:.4f} ms | SDPA backward "
            f"{res['library_bwd_ms']:.4f} ms   [{card}]")
        out["flash"].append(res)
        del q, k, v, do, qt, kt, vt, dot, o, lse, lq, lk, lv, ldo, l_out

    cfg = get_arch("whisper_medium")
    rows = {"layer_grad_norm": [], "masked_update": []}
    errs = {"layer_grad_norm": 0.0, "masked_update": 0.0}
    for path, kind, L in (("enc_blocks", "dense", cfg.n_enc_layers),
                          ("blocks", "encdec", cfg.n_layers)):
        mask = torch.tensor([float(i % 3 != 1) for i in range(L)],
                            device="cuda")
        for name, shp in sorted(_block_shapes(cfg, kind).items()):
            F_ = math.prod(shp)
            tag = f"{path}/{name}"
            g = torch.randn((L, F_), generator=gen,
                            device="cuda").to(bf16)
            err, r = lgn_check(g, tag, card, flush)
            errs["layer_grad_norm"] = max(errs["layer_grad_norm"], err)
            rows["layer_grad_norm"].append(r)
            p = torch.randn((L, F_), generator=gen, device="cuda").to(bf16)
            err, r = mu_check(p, g, mask, 0.01, tag, card, flush)
            errs["masked_update"] = max(errs["masked_update"], err)
            rows["masked_update"].append(r)
            del p, g
    for kname, rs in rows.items():
        total = kernel_totals(rs)
        log(f"[audio-kernel] {kname} over whisper-medium's {len(rs)} leaves "
            f"(the encoder's 8 and the decoder's 13, L 24 each): kernel "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
            f"(kernel/bound {total['ms'] / total['bound_ms']:.2f}), plain "
            f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} "
            f"ms   [{card}]")
        out[kname] = {"rows": rs, "total": total, "max_abs_err": errs[kname]}
    del flush
    torch.cuda.empty_cache()
    return out


def audio_batches(cfg, lead: tuple, gen) -> dict:
    """whisper batches on the card: stub frame embeddings (…, B,
    enc_seq, d_model) standard normal in f32, as the reference draws them,
    and decoder tokens (…, B, AUDIO_SEQ)."""
    import torch
    b = AUDIO_ROUND["batch"]
    return {"frames": torch.randn(lead + (b, cfg.enc_seq, cfg.d_model),
                                  generator=gen, device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, lead + (b, AUDIO_SEQ),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32)}


def audio_want(cfg, n: int, steps: int, *, probe: bool = False,
               cut=None) -> dict:
    """Kernel launches of a whisper probe (``probe``: ``steps`` batches per
    client) or cohort update (τ = ``steps``; ``cut`` None is the dense
    program) over ``n`` clients: one bf16 flash forward per attention site
    (24 encoder and 24 decoder self-attentions; cross-attention runs the
    plain path) per sequence forward, one backward per differentiated site
    (all in the probe and the dense program, those at or above the cut in
    the masked one), one ``layer_grad_norm`` per leaf per probe batch and
    one ``masked_update`` per leaf of a segment with trainable rows per
    masked τ step."""
    from repro_torch.models.model import _block_shapes, segment_prefix_cuts
    L = cfg.n_selectable_layers()
    n_enc = len(_block_shapes(cfg, "dense"))
    n_dec = len(_block_shapes(cfg, "encdec"))
    seqs = n * steps
    bwd = seqs * (L - (cut or 0))
    want = {k: 0 for k in ("base_delta_matmul", "layer_grad_norm",
                           "masked_update")}
    want.update({**SSD_NONE, **FLASH_NONE, "flash_attention": seqs * L,
                 "flash_attention_mma": seqs * L,
                 "flash_attention_bwd": bwd, "flash_attention_bwd_mma": bwd})
    if probe:
        want["layer_grad_norm"] = seqs * (n_enc + n_dec)
    elif cut is not None:
        cuts = segment_prefix_cuts(cut, cfg)
        want["masked_update"] = seqs * (
            (n_enc if cuts["enc_blocks"] < cfg.n_enc_layers else 0)
            + (n_dec if cuts["blocks"] < cfg.n_layers else 0))
    return want


def audio_rows_want(cfg, n: int, tau: int, cut: int) -> list:
    """The rows each ``masked_update`` launch of a masked update at ``cut``
    takes, in launch order: per client and τ step, the encoder's 8 leaves
    (its rows above the cut) and then the decoder's 13."""
    from repro_torch.models.model import _block_shapes, segment_prefix_cuts
    cuts = segment_prefix_cuts(cut, cfg)
    step = []
    for path, kind, count in (("enc_blocks", "dense", cfg.n_enc_layers),
                              ("blocks", "encdec", cfg.n_layers)):
        if cuts[path] < count:
            step += [count - cuts[path]] * len(_block_shapes(cfg, kind))
    return step * (n * tau)


def audio_cut_masks(n: int, L: int, cut: int):
    """Masks whose first selected layer is ``cut``: client i selects layer
    cut + (i % 2) and the last layer (two layers at most, rows that
    differ)."""
    import numpy as np
    m = np.zeros((n, L), np.float32)
    for i in range(n):
        m[i, min(cut + i % 2, L - 1)] = 1.0
        m[i, L - 1] = 1.0
    return m


def audio_run(fn) -> dict:
    """``fn()`` with the launch counts set to 0 just before and read just
    after, the rows of each ``masked_update`` launch, the time (the card
    synchronised at both ends) and the peak device memory."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RowsSeen() as seen:
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    return {"result": res, "s": s, "launches": launches, "rows": seen.rows,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _rows_equal(a: dict, b: dict, upto: dict) -> float:
    """Largest |a − b| over the first ``upto[path]`` rows of each stacked
    segment."""
    return max(_tree_max_diff({k: v[:upto[p]] for k, v in a[p].items()},
                              {k: v[:upto[p]] for k, v in b[p].items()})
               if upto[p] else 0.0 for p in upto)


def phase_audio_round(card: str) -> dict:
    """One step of Algorithm 1 at full whisper-medium width and depth
    (bf16, random weights from seed 0), cohort 4, τ 2, local batch 4,
    decoder seq_len 448 over 1500 random frames, composed from the port's
    parts as the reference composes its whisper path: ``probe_cohort_raw``
    (its ‖g‖² through ``layer_grad_norm``), "ours" at budget 2 on a
    ``ProbeReport`` of the stats, ``cohort_update_raw`` at
    ``first_trainable_layer`` of the masks; then the masked update against
    the dense program on masks that start at cuts 0, 12 (mid-encoder), 24
    (the boundary) and 46 (deep).  Every run's launches against
    :func:`audio_want` (flash on the tensor-core route at every site),
    ``masked_update`` only on the rows above the cut, the frozen rows
    unmoved, masked = dense within ROUND_PARAM_ATOL, finite losses; round
    0 replayed against the plain versions (the probes part by less than
    the plain one sits from an f32 probe; the kernel path at most
    E2E_ERR_RATIO times as far from it; the same masks); ms per client
    step and peak memory; one client step
    profiled; a reduced f32 cohort update on card and CPU."""
    import numpy as np
    import torch
    from repro_torch.api.strategy import SelectionContext, get_strategy
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.core.client import Client
    from repro_torch.core.masks import first_trainable_layer
    from repro_torch.core.strategies import ProbeReport
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, segment_prefix_cuts
    from repro_torch.tree import tree_map

    cfg = get_arch("whisper_medium")
    rt = RuntimeConfig(remat=False, seq_chunk=128)
    ar = AUDIO_ROUND
    n, tau, L = ar["cohort"], ar["tau"], cfg.n_selectable_layers()
    model = Model(cfg, rt, device="cuda")
    params = model.init(0)
    client = Client(model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = audio_batches(cfg, (n, tau), gen)
    probe_b = audio_batches(cfg, (n, 1), gen)
    sizes = np.array([16.0, 12.0, 20.0, 8.0][:n])
    reqs = ("grad_sq_norms",)
    sel = sum(v.numel() for k in ("enc_blocks", "blocks")
              for v in params[k].values())
    log(f"[audio-round] {cfg.name}: {_param_split(params)}, "
        f"{sel / 1e6:.1f} M selectable in {L} mask entries; stacked f32 "
        f"deltas of a cohort of {n}: {n * sel * 4 / 1e9:.2f} GB; frames "
        f"{tuple(batches['frames'].shape)}, tokens "
        f"{tuple(batches['tokens'].shape)}   [{card}]")
    t0 = time.perf_counter()
    client.probe_cohort_raw(params, probe_b, reqs)            # warm-up
    torch.cuda.synchronize()
    log(f"[audio-round] warm-up probe (untimed) "
        f"{time.perf_counter() - t0:.3f} s")

    def held(tag, run, want, rows=None):
        check(run["launches"] == want,
              f"[audio-round] {tag}: launches {run['launches']}, want {want}")
        if rows is not None:
            check(run["rows"] == rows,
                  f"[audio-round] {tag}: masked_update took rows "
                  f"{sorted(set(run['rows']))} in {len(run['rows'])} "
                  f"launches, want {sorted(set(rows))} in {len(rows)}")
    paths = {}
    probe = audio_run(lambda: client.probe_cohort_raw(params, probe_b, reqs))
    held("probe", probe, audio_want(cfg, n, 1, probe=True))
    paths["whisper_probe"] = probe["launches"]
    g = probe["result"]["grad_sq_norms"].cpu().numpy()
    check(g.shape == (n, L) and np.isfinite(g).all() and (g > 0).all(),
          "[audio-round] probe stats not finite and positive")
    ctx = SelectionContext(client_ids=np.arange(n), lam=ar["lam"],
                           n_layers=L)
    masks = get_strategy("ours").select(ProbeReport(grad_sq_norms=g),
                                        ar["budget"], ctx)
    cut0 = first_trainable_layer(masks)
    check(masks.shape == (n, L) and (masks.sum(1) <= ar["budget"]).all(),
          "[audio-round] masks break the budget")
    log(f"[audio-round] probe {probe['s']:.3f} s ({n} clients × one batch), "
        f"peak {probe['peak_gb']:.2f} GB; ‖g‖² encoder rows "
        f"{np.round(g[0, :cfg.n_enc_layers:6], 6).tolist()}…, decoder rows "
        f"{np.round(g[0, cfg.n_enc_layers::6], 6).tolist()}…; \"ours\" "
        f"selected {[np.flatnonzero(m).tolist() for m in masks]}, cut "
        f"{cut0} {segment_prefix_cuts(cut0, cfg)}   [{card}]")
    upd = audio_run(lambda: client.cohort_update_raw(
        params, batches, masks, sizes, ar["lr"], cut=cut0))
    new_k, losses_k = upd["result"]
    held(f"update at cut {cut0}", upd, audio_want(cfg, n, tau, cut=cut0),
         audio_rows_want(cfg, n, tau, cut0))
    paths[f"whisper_update_cut{cut0}"] = upd["launches"]
    losses_k = losses_k.cpu().numpy()
    check(np.isfinite(losses_k).all(), "[audio-round] non-finite loss")
    step_ms = upd["s"] * 1e3 / (n * tau)
    log(f"[audio-round] update at cut {cut0}: {upd['s']:.3f} s = "
        f"{step_ms:.1f} ms per client step ({ar['batch']} × {AUDIO_SEQ} "
        f"tokens over {ar['batch']} × {cfg.enc_seq} frames); losses "
        f"{np.round(losses_k, 6).tolist()}; peak {upd['peak_gb']:.2f} GB "
        f"(torch.cuda.max_memory_allocated); launches {upd['launches']}"
        f"   [{card}]")

    cut_runs = {}
    for cut in AUDIO_CUTS:
        mc = audio_cut_masks(n, L, cut)
        check(first_trainable_layer(mc) == cut, f"masks for cut {cut}")
        seg = segment_prefix_cuts(cut, cfg)
        m = audio_run(lambda: client.cohort_update_raw(
            params, batches, mc, sizes, ar["lr"], cut=cut))
        held(f"masked update at cut {cut}", m,
             audio_want(cfg, n, tau, cut=cut),
             audio_rows_want(cfg, n, tau, cut))
        d = audio_run(lambda: client.cohort_update_raw(
            params, batches, mc, sizes, ar["lr"]))
        held(f"dense update on cut {cut}'s masks", d,
             audio_want(cfg, n, tau))
        (pm, lm), (pd, ld) = m["result"], d["result"]
        lm, ld = lm.cpu().numpy(), ld.cpu().numpy()
        diff = _tree_max_diff(pm, pd)
        frozen = _rows_equal(pm, params, seg)
        moved = _tree_max_diff({k: v[seg["blocks"]:]
                                for k, v in pm["blocks"].items()},
                               {k: v[seg["blocks"]:]
                                for k, v in params["blocks"].items()})
        log(f"[audio-round] cut {cut} {seg}: masked {m['s']:.3f} s "
            f"({m['s'] * 1e3 / (n * tau):.1f} ms per client step, peak "
            f"{m['peak_gb']:.2f} GB) vs dense {d['s']:.3f} s "
            f"({d['s'] * 1e3 / (n * tau):.1f} ms, peak {d['peak_gb']:.2f} "
            f"GB); max |Δparams| masked vs dense {diff:.3e} (atol "
            f"{ROUND_PARAM_ATOL:g}), losses {np.abs(lm - ld).max():.3e}; "
            f"frozen rows moved {frozen:.3e}, trained decoder rows "
            f"{moved:.3e}; masked_update rows per launch "
            f"{sorted(set(m['rows']))} × {len(m['rows'])}   [{card}]")
        check(np.isfinite(lm).all() and np.isfinite(ld).all(),
              f"[audio-round] cut {cut}: non-finite loss")
        check(diff <= ROUND_PARAM_ATOL and np.abs(lm - ld).max() <= 1e-3,
              f"[audio-round] cut {cut}: masked and dense differ by "
              f"{diff:.3e}")
        check(frozen == 0.0 and moved > 0,
              f"[audio-round] cut {cut}: frozen rows moved {frozen:.3e}, "
              f"trained {moved:.3e}")
        paths[f"whisper_update_cut{cut}"] = m["launches"]
        paths[f"whisper_dense_cut{cut}"] = d["launches"]
        cut_runs[cut] = {"masked_s": m["s"], "dense_s": d["s"],
                         "masked_peak_gb": m["peak_gb"],
                         "dense_peak_gb": d["peak_gb"],
                         "masked_vs_dense": diff}
        del pm, pd, m, d
        torch.cuda.empty_cache()

    # round 0 against the plain versions, and both probes against f32
    plain = Client(Model(cfg, rt, device="cuda", kernel_mode="torch"))
    ops.reset_launches()
    g_p = plain.probe_cohort_raw(params, probe_b, reqs)[
        "grad_sq_norms"].cpu().numpy()
    masks_p = get_strategy("ours").select(ProbeReport(grad_sq_norms=g_p),
                                          ar["budget"], ctx)
    new_p, losses_p = plain.cohort_update_raw(params, batches, masks, sizes,
                                              ar["lr"], cut=cut0)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES},
          f"the plain-version replay launched kernels: {ops.LAUNCHES}")
    rel = float(np.max(np.abs(g_p - g) / np.abs(g)))
    dp = _tree_max_diff(new_k, new_p)
    dl = float(np.abs(losses_k - losses_p.cpu().numpy()).max())
    del new_p, plain
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype="float32")
    ref = Client(Model(c32, rt, device="cuda", kernel_mode="torch"))
    g_32 = ref.probe_cohort_raw(tree_map(lambda t: t.float(), params),
                                probe_b, reqs)["grad_sq_norms"].cpu().numpy()
    del ref
    torch.cuda.empty_cache()
    err_k = float(np.max(np.abs(g - g_32) / np.abs(g_32)))
    err_p = float(np.max(np.abs(g_p - g_32) / np.abs(g_32)))
    # 48 bf16 layers (24 of them over 1500 frames): each bf16 path sits
    # ~1.5e-2 off the f32 probe on an H100, six times TinyLlama's gap, so
    # TinyLlama's ROUND_PROBE_RTOL does not carry over.  The two paths must
    # part by less than the plain path sits from f32, and the kernel path
    # be at most E2E_ERR_RATIO times as far from it.
    log(f"[audio-round] round 0, kernels vs plain versions: probe stats max "
        f"rel err {rel:.3e} (at most the plain path's distance from f32); "
        f"against the f32 probe: kernel path {err_k:.3e}, plain path "
        f"{err_p:.3e} (kernel at most {E2E_ERR_RATIO:g}x plain); masks "
        f"equal: "
        f"{bool(np.array_equal(masks_p, masks))}; update with the kernel "
        f"run's masks: max |Δparams| {dp:.3e} (atol {ROUND_PARAM_ATOL:g}), "
        f"losses {dl:.3e}   [{card}]")
    check(rel <= err_p, "whisper probe stats: kernel and plain versions "
                        "part by more than the plain path sits from f32")
    check(err_k <= E2E_ERR_RATIO * err_p,
          "whisper probe stats: the kernel path is less accurate than the "
          "plain versions'")
    check(np.array_equal(masks_p, masks), "whisper plain-version probe "
                                          "stats chose other masks")
    check(dp <= ROUND_PARAM_ATOL, f"whisper update: kernel and plain "
                                  f"versions differ by {dp:.3e}")
    del new_k, params, batches, probe_b, client, model
    gc.collect()
    torch.cuda.empty_cache()
    prof = phase_profile(card, cfg, AUDIO_SEQ, "audio-profile", {
        "flash_attention (forward kernel)": ("flash_fwd",),
        "flash_attention_bwd (dQ, dK/dV kernels, the split's sum)": (
            "flash_dq", "flash_dkdv")})
    torch.cuda.empty_cache()
    audio_round_exact(card)
    return {"launches": paths, "cut": cut0, "probe_s": probe["s"],
            "update_s": upd["s"], "ms_per_client_step": step_ms,
            "update_peak_gb": upd["peak_gb"], "cuts": cut_runs,
            "probe_rel_err": rel, "probe_err_vs_f32": (err_k, err_p),
            "update_max_diff": dp, "profile": prof}


def audio_round_exact(card: str) -> None:
    """Reduced whisper in f32 (2 encoder and 2 decoder layers, d_model 64:
    head dim 16, the flash kernels' SIMT route): the probe and one cohort
    update at cut 1 (mid-encoder) on the card and on the CPU give the same
    stats (rtol 1e-5) and "ours" masks, and params within atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.api.strategy import SelectionContext, get_strategy
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.core.client import Client
    from repro_torch.core.strategies import ProbeReport
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("whisper_medium"), n_layers=2, d_model=64)
    rng = np.random.RandomState(11)
    n, tau, b, s = 3, 2, 2, 8

    def batch(lead):
        return {"frames": torch.from_numpy(rng.standard_normal(
                    lead + (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)),
                "tokens": torch.from_numpy(rng.randint(
                    0, cfg.vocab_size, lead + (b, s)).astype(np.int32))}
    batches, probe_b = batch((n, tau)), batch((n, 1))
    sizes = np.array([8.0, 5.0, 11.0])
    masks = audio_cut_masks(n, cfg.n_selectable_layers(), 1)
    params = Model(cfg, device="cpu").init(0)
    runs = {}
    for dev in ("cuda", "cpu"):
        client = Client(Model(cfg, RuntimeConfig(remat=False, seq_chunk=4),
                              device=dev))
        on = tree_map(lambda t: t.to(dev), {"p": params, "b": batches,
                                            "q": probe_b})
        ops.reset_launches()
        g = client.probe_cohort(on["p"], on["q"],
                                ("grad_sq_norms",))["grad_sq_norms"]
        new, losses = client.cohort_update(on["p"], on["b"], masks, sizes,
                                           0.01, cut=1)
        sel = get_strategy("ours").select(
            ProbeReport(grad_sq_norms=g), 2,
            SelectionContext(client_ids=np.arange(n), lam=1.0))
        runs[dev] = (g, sel, tree_map(lambda t: t.cpu(), new), losses,
                     dict(ops.LAUNCHES))
    (gg, sg, pg, lg, kg), (gc_, sc, pc, lc, kc) = runs["cuda"], runs["cpu"]
    want = {k: 0 for k in kg}
    want.update(layer_grad_norm=n * 21, masked_update=n * tau * 21,
                flash_attention=(n + n * tau) * 4,
                flash_attention_simt=(n + n * tau) * 4,
                flash_attention_bwd=n * 4 + n * tau * 3,
                flash_attention_bwd_simt=n * 4 + n * tau * 3)
    check(kg == want and kc == {k: 0 for k in kc},
          f"reduced whisper: launches on the card {kg} (want {want}), on the "
          f"CPU {kc}")
    err = _tree_max_diff(pg, pc)
    g_rel = float(np.max(np.abs(gg - gc_) / np.abs(gc_)))
    log(f"[audio-round] reduced whisper f32, probe and a cohort update at "
        f"cut 1 (mid-encoder): probe stats max rel err card vs CPU "
        f"{g_rel:.3e} (rtol 1e-5), masks equal {bool(np.array_equal(sg, sc))}"
        f"; max |Δparams| {err:.3e} (atol 1e-5), losses "
        f"{np.abs(lg - lc).max():.3e}; card launches {kg}   [{card}]")
    check(g_rel <= 1e-5 and np.array_equal(sg, sc),
          "reduced whisper: card and CPU probes differ")
    check(err <= 1e-5 and np.abs(lg - lc).max() <= 1e-5,
          "reduced whisper: card and CPU params differ")


def phase_audio_decode(card: str) -> dict:
    """Full-width whisper-medium in f32 (random weights, seed 0; the flash
    kernels' exact SIMT route): the sequence forward's logits over
    AUDIO_DECODE_STEPS decoder tokens against as many ``decode_step``s
    over a cross cache filled from the port's own encoder, row by row
    through ``make_cross_kv`` (as the reference's
    tests/test_decode_consistency.py fills it), within DECODE_TOL; the
    forward launches one SIMT flash forward per site, decode none; a
    per-slot position vector and delta decode are refused."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_arch("whisper_medium"), dtype="float32")
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=128),
                  device="cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, S = 2, AUDIO_DECODE_STEPS
    frames = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                         device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launches()
    with torch.no_grad():
        h, _, _ = model.hidden_seq(params, {"frames": frames,
                                            "tokens": tokens})
        want = model._head(params, h).float()
    fwd_launches = dict(ops.LAUNCHES)
    sites = cfg.n_selectable_layers()
    check(fwd_launches == {**{k: 0 for k in ops.LAUNCHES},
                           "flash_attention": sites,
                           "flash_attention_simt": sites},
          f"[audio-decode] f32 forward launches {fwd_launches}")
    cache = model.init_cache(B, S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fill_cross_cache(model, params, cache, frames)
    xkv = cache["cross_kv"]
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    ops.reset_launches()
    got = []
    t0 = time.perf_counter()
    for t in range(S):
        logits, cache = model.decode_step(
            params, tokens[:, t], torch.tensor(t, dtype=torch.int32,
                                               device="cuda"), cache)
        got.append(logits.float())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / S
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"[audio-decode] decode launched kernels {ops.LAUNCHES}")
    got = torch.stack(got, 1)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
    log(f"[audio-decode] whisper-medium f32, {B} × {S} decoder tokens over "
        f"{cfg.enc_seq} frames: the forward's logits vs {S} decode steps "
        f"over the encoder-filled cross cache: max |Δ| {err:.3e} (max "
        f"|logit| {scale:.3e}; rtol/atol {DECODE_TOL:g}); cross cache "
        f"{2 * xkv['k'].numel() * 4 / 1e6:.0f} MB filled in {fill_s:.3f} s; "
        f"{step_ms:.2f} ms per decode step (f32, host-timed); forward "
        f"launches {({k: v for k, v in fwd_launches.items() if v})}"
        f"   [{card}]")
    check(ok, "[audio-decode] decode disagrees with the sequence forward")
    refused = []
    for label, args in (
            ("per-slot positions", dict(pos=torch.zeros(
                B, dtype=torch.int32, device="cuda"),
                cache=model.init_cache(B, S, per_slot=True))),
            ("delta decode", dict(pos=torch.tensor(0, dtype=torch.int32,
                                                   device="cuda"),
                                  cache=model.init_cache(B, S), delta={}))):
        try:
            model.decode_step(params, tokens[:, 0], **args)
        except ValueError as exc:
            refused.append(f"{label}: {exc}")
        else:
            raise SmokeFailure(f"[audio-decode] {label} was not refused")
    log(f"[audio-decode] refused: " + "; ".join(refused))
    del params, cache, got, want, h
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "step_ms": step_ms, "fill_s": fill_s,
            "forward_launches": fwd_launches}


# Slice 12: the theory and cost modules, strict mode and the auditor.
# examples/heterogeneous_budgets.py at full TinyLlama-1.1B width: 16 clients,
# 30 pretraining steps (the example's REPRO_SMOKE count; AdamW at the
# smoke's PRETRAIN lr, since the example's 3e-3 diverges at this width),
# full-batch client gradients of 8 × 128 tokens, "ours" and "top" for 3
# rounds (cohort 4, τ 2, lr 0.01, λ 1, the example's batch 16), σ_l from 4
# minibatches of 8 against a batch of 32, the Theorem 4.7 floor at γ 1.
THEORY = dict(clients=16, seq=128, pretrain_steps=30, grad_batch=8,
              rounds=3, cohort=4, tau=2, lr=0.01, lam=1.0, batch=16,
              sigma_batches=4, sigma_batch=8, sigma_full=32, gamma=1.0)
THEORY_RTOL = 1e-5       # kernel vs plain route, card vs CPU
THEORY_PEAK_GB = 70.0    # above this, the phase should run 8 clients
# The full-width audit: Mamba2 at every sixth cut, to keep time.
STRICT_DEPTHS = (1, 4)


def half_normal_budgets(n, lo=1, hi=4, seed=0):
    """The example's client budgets R_i: a half-normal on [lo, hi]."""
    import numpy as np
    rng = np.random.RandomState(seed)
    v = np.abs(rng.randn(n)) * (hi - lo) / 2 + lo
    return tuple(int(x) for x in np.clip(np.round(v), lo, hi))


def _rel_err(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def theory_reduced(card: str) -> float:
    """κ, E_t1 and E_t2 of a reduced f32 TinyLlama (3 layers, d 64) on the
    card (the flash kernels' exact f32 SIMT route, the norm kernel) and on
    the CPU (the plain versions), on the same params and batches."""
    import numpy as np
    from repro_torch.bridge import params_to_numpy, params_to_torch
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.core import theory
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = reduced(get_arch("tinyllama_1_1b"), n_layers=3, d_model=64)
    rt = RuntimeConfig(remat=False, seq_chunk=16)
    host = params_to_numpy(Model(cfg, rt, device="cpu").init(0))
    rng = np.random.RandomState(4)
    batches = [{"tokens": rng.randint(0, cfg.vocab_size, (4, 16)).astype(
        np.int32)} for _ in range(4)]
    alpha = np.array([0.1, 0.2, 0.3, 0.4])
    masks = np.array([[1, 0, 1], [0, 1, 0]], np.float32)
    sizes, idx = np.array([10.0, 30.0]), np.array([3, 1])
    def quantities(dev):
        model = Model(cfg, rt, device=dev)
        p = params_to_torch(host, dev)
        gg = theory.global_gradient(model, p, batches, alpha)
        kappa = theory.kappa_per_layer(model, gg, theory.per_client_gradients(
            model, p, batches))
        return [*kappa, theory.e_t1(model, gg, np.array([1, 0, 0],
                                                        np.float32)),
                theory.e_t2(masks, sizes, kappa),
                theory.e_t2(masks, sizes, kappa, population_alpha=alpha,
                            cohort_idx=idx)]
    ops.reset_launches()
    card_v = quantities("cuda")
    card_launches = dict(ops.LAUNCHES)
    check(card_launches["flash_attention_simt"] > 0
          and card_launches["layer_grad_norm"] > 0,
          f"[theory] the reduced card run took no kernel: {card_launches}")
    cpu_v = quantities("cpu")
    err = _rel_err(card_v, cpu_v)
    log(f"[theory] reduced f32 TinyLlama (3 layers, d 64): κ, E_t1, E_t2 "
        f"(cohort α, population α) card {np.round(card_v, 6).tolist()} "
        f"vs CPU: max rel err {err:.3e} (limit {THEORY_RTOL:g})   [{card}]")
    check(err <= THEORY_RTOL, "[theory] the card's κ / E_t1 / E_t2 differ "
                              "from the CPU's on the reduced f32 world")
    return err


def phase_theory(card: str) -> dict:
    """examples/heterogeneous_budgets.py at full TinyLlama-1.1B width in
    bf16 (seq 128, 16 clients): κ_l over 22 layers from 16 full-batch client
    gradients (the global gradient in f32), E_t1 and E_t2 of the last round
    of "ours" and "top" under the example's half-normal budgets, σ_l, the
    Theorem 4.7 right-hand side and the Table 3 costs of each strategy's
    selection; checks E_t1 = 0 at a full union and growing as the union
    shrinks, κ_l above every client's deviation (plain f64 norms), E_t2 ≈ 0
    for a full uniform cohort, the norm kernel against the plain route, and
    a reduced f32 world against the CPU."""
    import numpy as np
    import torch
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.core import costs, theory
    from repro_torch.core.masks import count_layer_params, union_mask
    from repro_torch.data.pretrain import pretrain
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    th = THEORY
    cfg = get_arch("tinyllama_1_1b")
    L = cfg.n_layers
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=th["seq"]),
                  device="cuda")
    data = SyntheticFederatedData(FederatedTaskConfig(
        n_clients=th["clients"], vocab_size=cfg.vocab_size,
        seq_len=th["seq"], test_samples=32, objective="lm", skew="feature",
        seed=0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ops.reset_launches()
    params = pretrain(model, model.init(0), data,
                      steps=th["pretrain_steps"], lr=PRETRAIN["lr"])
    budgets = half_normal_budgets(th["clients"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [data.client_batch(i, th["grad_batch"])
               for i in range(th["clients"])]
    gg = theory.global_gradient(model, params, batches, data.alpha)
    cg = theory.per_client_gradients(model, params, batches)
    kappa = theory.kappa_per_layer(model, gg, cg)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grads_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kappa_plain = theory.kappa_per_layer(model, gg, cg, mode="torch")
    kappa_err = _rel_err(kappa, kappa_plain)
    log(f"[theory] TinyLlama-1.1B bf16, {th['clients']} clients, "
        f"{th['pretrain_steps']} pretraining steps, budgets {budgets}; "
        f"κ_l ({L} layers) {np.round(kappa, 6).tolist()}; kernel vs plain "
        f"route max rel err {kappa_err:.3e} (limit {THEORY_RTOL:g}); global "
        f"+ {th['clients']} client gradients and κ in {grad_s:.3f} s, peak "
        f"{grads_peak_gb:.2f} GB   [{card}]")
    check(kappa.shape == (L,) and np.all(np.isfinite(kappa))
          and np.all(kappa > 0), "[theory] κ is not finite and positive")
    check(kappa_err <= THEORY_RTOL,
          "[theory] κ differs between the kernel and the plain route")
    # each client's deviation apart from theory.layer_diff and the norm
    # kernel: plain f64 row norms of the blocks' f32 differences (TinyLlama's
    # one selectable segment), held under the kernel route's κ
    worst = -np.inf
    for g_i in cg:
        sq = sum(torch.linalg.vector_norm(
                     (a.float() - b.float()).reshape(L, -1), dim=1,
                     dtype=torch.float64) ** 2
                 for a, b in zip(tree_leaves(gg["blocks"]),
                                 tree_leaves(g_i["blocks"])))
        worst = max(worst, float(np.max(np.sqrt(sq.cpu().numpy()) / kappa)
                                 - 1.0))
    log(f"[theory] each client's deviation (plain f64 norms) against κ "
        f"(kernel route): largest excess {worst:.3e} relative (limit "
        f"{THEORY_RTOL:g})   [{card}]")
    check(worst <= THEORY_RTOL, f"[theory] a client's deviation exceeds κ "
                                f"by {worst:.3e} relative (limit "
                                f"{THEORY_RTOL:g})")
    del cg
    torch.cuda.empty_cache()

    # E_t1 over a shrinking union: 0 when every layer is selected
    chain = [np.ones(L, np.float32)]
    for layer in range(L):
        u = chain[-1].copy()
        u[layer] = 0.0
        chain.append(u)
    e1_chain = [theory.e_t1(model, gg, u) for u in chain]
    e1_plain = [theory.e_t1(model, gg, u, mode="torch") for u in chain]
    e1_err = _rel_err(e1_chain[1:], e1_plain[1:])
    log(f"[theory] E_t1 as the union shrinks from all {L} layers to none: "
        f"{[float(f'{e:.6g}') for e in e1_chain]}; kernel vs plain route "
        f"max rel err {e1_err:.3e}   [{card}]")
    check(e1_chain[0] == 0.0 and e1_plain[0] == 0.0,
          "[theory] E_t1 at a full union is not exactly 0")
    check(all(b >= a for a, b in zip(e1_chain, e1_chain[1:]))
          and e1_chain[-1] > 0.0, "[theory] E_t1 does not grow as the "
                                  "union shrinks")
    check(e1_err <= THEORY_RTOL,
          "[theory] E_t1 differs between the kernel and the plain route")
    full = np.ones((th["clients"], L), np.float32)
    e2_uniform = [theory.e_t2(full, data.sizes, kappa),
                  theory.e_t2(full, data.sizes, kappa,
                              population_alpha=data.alpha,
                              cohort_idx=np.arange(th["clients"]))]
    scale = float(np.sum(kappa ** 2))
    log(f"[theory] E_t2, full cohort with equal full masks: "
        f"{e2_uniform} (Σκ² {scale:.6g})   [{card}]")
    check(max(e2_uniform) <= 1e-6 * scale,
          "[theory] E_t2 of a full uniform cohort is not 0 up to f32 "
          "rounding")

    # σ_l and the Theorem 4.7 floor, then each strategy's rounds
    sigma = theory.sigma_per_layer(
        model, params, [data.client_batch(0, th["sigma_batch"])
                        for _ in range(th["sigma_batches"])],
        data.client_batch(0, th["sigma_full"]))
    check(np.all(np.isfinite(sigma)) and sigma.shape == (L,),
          "[theory] σ is not finite")
    with torch.no_grad():
        test = {k: torch.from_numpy(v).to("cuda")
                for k, v in data.test_batch().items()}
        f0 = model.seq_loss(params, test).item()
    layer_params = count_layer_params(params, cfg)
    tokens = th["grad_batch"] * th["seq"]
    out = {"kappa": kappa.tolist(), "sigma": sigma.tolist(),
           "e1_chain": e1_chain, "e2_uniform": e2_uniform,
           "kappa_route_rel_err": kappa_err, "e1_route_rel_err": e1_err,
           "budgets": budgets, "strategies": {}}
    for strategy in ("ours", "top"):
        exp = Experiment(model, data, strategy, cohort_size=th["cohort"],
                         rounds=th["rounds"], local_steps=th["tau"],
                         lr=th["lr"], batch_size=th["batch"],
                         budgets=budgets, lam=th["lam"], device="cuda")
        t0 = time.perf_counter()
        new_params, hist = exp.run(params)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        del new_params
        e1s, e2s = [], []
        for rec in hist.records:
            e1s.append(theory.e_t1(model, gg, union_mask(rec.mask_matrix)))
            e2s.append(theory.e_t2(rec.mask_matrix, data.sizes[rec.cohort],
                                   kappa, population_alpha=data.alpha,
                                   cohort_idx=rec.cohort))
        rhs = theory.theorem_4_7_rhs(
            f0, 0.0, eta=th["lr"], gamma=th["gamma"], T=len(hist.records),
            sigma_sq=float(np.sum(sigma ** 2)), e1_sum=sum(e1s),
            e2_sum=sum(e2s))
        union = union_mask(hist.records[-1].mask_matrix)
        exact = costs.backward_cost_exact(layer_params, union, th["tau"],
                                          tokens_per_batch=tokens)
        uniform = costs.backward_cost_uniform(L, float(np.mean(budgets)),
                                              th["tau"])
        s = hist.summary()
        log(f"[theory] {strategy}: {len(hist.records)} rounds in "
            f"{run_s:.3f} s, final test loss {s['final_loss']:.6f}; last "
            f"round E_t1 {e1s[-1]:.6g}, E_t2 {e2s[-1]:.6g} (union "
            f"{np.flatnonzero(union).tolist()}); per round E_t1 "
            f"{[float(f'{e:.6g}') for e in e1s]}, E_t2 "
            f"{[float(f'{e:.6g}') for e in e2s]}; Theorem 4.7 RHS "
            f"{rhs:.6g} (f0 {f0:.6f}, f* 0, η {th['lr']}, γ {th['gamma']}, "
            f"Σσ² {float(np.sum(sigma ** 2)):.6g}); Table 3 exact: backward "
            f"{exact.compute_flops:.6g} FLOPs ({exact.ratio_compute:.4f} of "
            f"full), upload {exact.transmit_bits:.6g} bits "
            f"({exact.ratio_transmit:.4f}); uniform Eq.(16)/(17) at R̄ "
            f"{float(np.mean(budgets)):.4g}: {uniform.ratio_compute:.4f} / "
            f"{uniform.ratio_transmit:.4f}   [{card}]")
        check(all(np.isfinite([*e1s, *e2s, rhs])) and min(e1s + e2s) >= 0,
              f"[theory] {strategy}: non-finite or negative E terms")
        out["strategies"][strategy] = {
            "e1": e1s, "e2": e2s, "rhs": rhs, "run_s": run_s,
            "final_loss": s["final_loss"],
            "cost_exact": dataclasses.asdict(exact),
            "cost_uniform": dataclasses.asdict(uniform)}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    log(f"[theory] launches {({k: v for k, v in launches.items() if v})}; "
        f"σ_l {np.round(sigma, 6).tolist()}; phase {phase_s:.1f} s, peak "
        f"device memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated; "
        f"more than {THEORY_PEAK_GB:g} GB would call for 8 clients)"
        f"   [{card}]")
    check(all(launches[k] > 0 for k in ("layer_grad_norm", "masked_update",
                                        "flash_attention_mma",
                                        "flash_attention_bwd_mma"))
          and launches["flash_attention_simt"] == 0,
          f"[theory] the path did not go through the kernels: {launches}")
    del params, gg
    torch.cuda.empty_cache()
    out.update(launches=launches, peak_gb=peak_gb, grads_peak_gb=grads_peak_gb,
               phase_s=phase_s, reduced_rel_err=theory_reduced(card))
    return out


def phase_contracts(card: str) -> dict:
    """(a) Strict mode: three pipelined "ours" TinyLlama-1.1B rounds at seq
    128 to warm up, then the same run under ``strict_region`` (the card's
    sync-debug mode at "error", the kernel-cache sentinel) at each of
    STRICT_DEPTHS: nothing may sync or grow, and the summary must equal the
    warm run's.  (b) The program auditor at full width on the card: the
    reference's three audit configs (TinyLlama f32 training, Mamba2-370M
    f32 training at every sixth cut, TinyLlama bf16 serving) at the specs'
    cohort 2, τ 2, 2 × 16 tokens; ``check_all`` must find nothing, the
    kernels' work must reach the facts through the recorder, and
    :func:`budget_gate` must pass against the committed card manifest."""
    import numpy as np
    import torch
    from repro_torch.analysis.contracts import FORWARD_ONLY_MAX_FRAC, check_all
    from repro_torch.analysis.program import (H100_FULL_WIDTH_BUDGETS,
                                              audit_models, enumerate_specs,
                                              load_budgets, run_audit)
    from repro_torch.analysis.strict import strict_region
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import (FederatedTaskConfig,
                                            SyntheticFederatedData)
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_arch("tinyllama_1_1b")

    def task():
        return SyntheticFederatedData(FederatedTaskConfig(
            n_clients=16, vocab_size=cfg.vocab_size, seq_len=CKPT_SEQ,
            test_samples=32, objective="lm", skew="feature", seed=0))
    exp = _round_experiment(cfg, task(), pipeline=True, pipeline_depth=1)
    params = exp.init_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, h_warm = exp.run(params)
    torch.cuda.synchronize()
    warm = {"s_per_round": (time.perf_counter() - t0) / len(h_warm.records),
            "summary": h_warm.summary()}
    log(f"[strict] warm run (depth 1): {warm['s_per_round']:.4f} s/round, "
        f"summary {warm['summary']}   [{card}]")
    # the guard guards: a card .item() inside the region raises
    try:
        with strict_region("tripwire", enabled=True, device="cuda"):
            torch.ones(2, device="cuda").sum().item()
    except RuntimeError as exc:
        log(f"[strict] a card .item() inside strict_region raised: "
            f"{str(exc).splitlines()[0]}")
    else:
        raise SmokeFailure("[strict] strict_region let a card .item() "
                           "through")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "[strict] the sync-debug mode was not restored")
    strict, launches = {}, {k: 0 for k in ops.LAUNCHES}
    for depth in STRICT_DEPTHS:
        exp = _round_experiment(cfg, task(), pipeline=True,
                                pipeline_depth=depth)
        exp.build()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with strict_region(f"TinyLlama rounds at depth {depth}",
                           enabled=True, device="cuda"):
            _, hist = exp.run(params)
        torch.cuda.synchronize()
        s_round = (time.perf_counter() - t0) / len(hist.records)
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        same = hist.summary() == warm["summary"]
        log(f"[strict] depth {depth} under strict_region: no host sync, no "
            f"kernel cache grew; {s_round:.4f} s/round (warm "
            f"{warm['s_per_round']:.4f}); summary equal to the warm run's: "
            f"{same}   [{card}]")
        check(same, f"[strict] depth {depth}: the strict run's summary "
                    f"{hist.summary()} differs from the warm run's")
        strict[f"depth {depth}"] = {"s_per_round": s_round}
    del params, exp
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the auditor at full width
    t0 = time.perf_counter()
    specs = enumerate_specs(audit_models("cuda", reduced=False))
    ops.reset_launches()
    facts = run_audit(specs)
    torch.cuda.synchronize()
    audit_launches = dict(ops.LAUNCHES)
    audit_s = time.perf_counter() - t0
    violations = check_all(facts)
    for v in violations:
        log(f"[audit] CONTRACT {v.contract} :: {v.program}: {v.message}")
    series = {}
    for label in ("dense", "ssm"):
        cuts = sorted((f.meta["cut"], f.flops) for f in facts.values()
                      if f.meta.get("kind") == "fl_step_masked"
                      and f.meta["config"] == label)
        series[label] = {"cuts": [c for c, _ in cuts],
                         "flops": [x for _, x in cuts],
                         "forward_only_frac": cuts[-1][1] / cuts[0][1]}
        log(f"[audit] {label}: fl_step_masked FLOPs by cut "
            f"{[(c, float(f'{x:.6g}')) for c, x in cuts]}; cut "
            f"{cuts[-1][0]} / cut 0 = {series[label]['forward_only_frac']:.4f}"
            f" (limit {FORWARD_ONLY_MAX_FRAC})   [{card}]")
    delta = {f"B{f.meta['batch']}/C{f.meta['capacity']}": f.weight_bytes
             for f in facts.values()
             if f.meta.get("kind") == "serve_decode_delta"
             and f.meta["config"] == "dense_bf16"}
    dense = {f"B{f.meta['batch']}": f.weight_bytes for f in facts.values()
             if f.meta.get("kind") == "serve_decode_dense"
             and f.meta["config"] == "dense_bf16"}
    log(f"[audit] TinyLlama bf16 serving weight bytes: delta {delta}; dense "
        f"baseline {dense}   [{card}]")
    n_layers = get_arch("tinyllama_1_1b").n_layers
    for name, f in facts.items():
        if "/serve_decode_delta/" in name:
            check(f.kernel_launches.get("base_delta_matmul") == 6 * n_layers,
                  f"[audit] {name}: delta launches {f.kernel_launches}")
        if name.startswith("dense/fl_step_masked/cut0"):
            check(f.kernel_launches.get("flash_attention", 0) > 0
                  and f.kernel_launches.get("flash_attention_bwd", 0) > 0,
                  f"[audit] {name}: no flash work reached the facts")
    log(f"[audit] {len(facts)} programs in {audit_s:.1f} s, "
        f"{len(violations)} contract violation(s); launches "
        f"{({k: v for k, v in audit_launches.items() if v})}; largest "
        f"temp {max(f.temp_bytes for f in facts.values()) / 1e9:.2f} GB"
        f"   [{card}]")
    check(not violations, f"[audit] {len(violations)} contract violation(s)")
    n_programs = len(facts)
    check(all(audit_launches[k] > 0 for k in (
        "base_delta_matmul", "flash_attention_simt", "layer_grad_norm",
        "masked_update", "ssd_scan_simt")), f"[audit] the programs did not "
                                            f"go through the kernels: "
                                            f"{audit_launches}")
    budget = budget_gate(facts, load_budgets(H100_FULL_WIDTH_BUDGETS), card)
    del specs, facts
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[contracts] phase {phase_s:.1f} s   [{card}]")
    return {"warm": warm, "strict": strict, "strict_launches": launches,
            "audit_launches": audit_launches, "audit_s": audit_s,
            "flops_series": series, "delta_weight_bytes": delta,
            "dense_weight_bytes": dense, "phase_s": phase_s,
            "violations": len(violations), "programs": n_programs,
            **budget}


def budget_gate(facts: dict, manifest, card: str) -> dict:
    """``check_budgets`` of the full-width audit against the committed card
    manifest must find nothing; one ``[budget]`` line per config with the
    largest drift of each key and the largest temporary bytes (audited,
    budget).  Then a copy with one program's FLOPs doubled, one program
    removed and one flash launch count off by one must fail on exactly
    those three."""
    import copy
    from repro_torch.analysis.program import (H100_FULL_WIDTH_BUDGETS,
                                              budget_drifts, check_budgets)

    check(manifest is not None, f"[budget] no manifest at "
                                f"{H100_FULL_WIDTH_BUDGETS}")
    log(f"[budget] manifest recorded on {manifest['_meta']['device']}, torch "
        f"{manifest['_meta']['torch_version']}")
    failures = check_budgets(facts, manifest)
    for msg in failures:
        log(f"[budget] FAIL {msg}")
    drift: dict = {}
    temp: dict = {}
    for name, f in facts.items():
        row = manifest["programs"].get(name, {})
        temp.setdefault(f.meta["config"], {})[name] = (
            f.temp_bytes, row.get("temp_bytes"))
        cfg_d = drift.setdefault(f.meta["config"], {})
        for _, key, _, _, d in budget_drifts(f, row):
            cfg_d[key] = max(cfg_d.get(key, 0.0), d)
    for label, d in sorted(drift.items()):
        top = max(temp[label].items(), key=lambda kv: kv[1][0])
        log(f"[budget] {label}: {len(temp[label])} programs, largest drift "
            f"{({k: float(f'{v:.6g}') for k, v in sorted(d.items())})}; "
            f"largest temp bytes {top[0]} (audited, budget) {top[1]}"
            f"   [{card}]")
    check(not failures, f"[budget] {len(failures)} budget failure(s) against "
                        f"{H100_FULL_WIDTH_BUDGETS}")
    # the gate is not vacuous: three doctored entries, each named
    bad = copy.deepcopy(manifest)
    doubled, removed = "dense/fl_step", "ssm/probe"
    off = "dense/fl_step_masked/cut0"
    bad["programs"][doubled]["flops"] *= 2
    del bad["programs"][removed]
    bad["programs"][off]["kernel_launches"]["flash_attention"] += 1
    caught = check_budgets(facts, bad)
    log(f"[budget] doctored manifest: {caught}")
    check(len(caught) == 3
          and any(m.startswith(f"{doubled}: flops drifted") for m in caught)
          and any(m.startswith(f"{removed}: audited but missing")
                  for m in caught)
          and any(m.startswith(f"{off}: kernel_launches[flash_attention] "
                               f"drifted") for m in caught),
          f"[budget] the doctored manifest was not caught as expected: "
          f"{caught}")
    return {"budget_drift": drift, "budget_temp_bytes": temp,
            "doctored": caught}


# ---------------------------------------------------------------------------
# Slice 14: the port's source linter
# ---------------------------------------------------------------------------

def phase_lint(card: str) -> dict:
    """The port's source linter over ``src/repro_torch`` with every rule:
    no finding may stand (each sync reachable from the hot loops repaired
    or carrying a reasoned pragma)."""
    from repro_torch.analysis.engine import RULES, collect_files, run_files

    t0 = time.perf_counter()
    files = collect_files(["src/repro_torch"], ROOT)
    findings = run_files(files, ROOT)
    for f in findings:
        log(f"[lint] {f.format()}")
    log(f"[lint] {len(RULES)} rules ({', '.join(sorted(RULES))}) over "
        f"{len(files)} files: {len(findings)} finding(s) in "
        f"{time.perf_counter() - t0:.1f} s   [{card}]")
    check(not findings, f"[lint] {len(findings)} finding(s) in src/repro_torch")
    return {"rules": len(RULES), "files": len(files),
            "findings": len(findings)}


# ---------------------------------------------------------------------------
# Slice 13: the distributed round and mesh serving (torch.distributed)
# ---------------------------------------------------------------------------

DIST_SEL = (5, 17)          # 2 of TinyLlama's 22 rows: sel_upload, τ = 2
DIST_SSM_SEL = (3, 40)      # Mamba2's selected rows
# Learning rates at which a step moves a large share of the selected rows'
# bf16 elements by whole ulps, so that the update itself is held against
# the reference's (at 0.01 most updates fell under half an ulp).  On an
# H100 at full depth, 1.0 moved 52% of TinyLlama's elements (rows 5, 17)
# and 0.3 moved 37% of Mamba2's (rows 3, 40), by up to 9.0e-2.  Both are
# powers of two: the single-host Eq.(6) (``apply_update``, as the
# reference's) rounds lr·Δ to bf16 before it subtracts, the distributed
# step (as the reference's sharded one) subtracts in f32 and rounds once,
# and only a power of two makes the two agree bit for bit (at 0.3 Mamba2's
# update parted from the reference's by 2.8e-2).  Mamba2's is lower: its
# largest gradients (D) are far larger than TinyLlama's, and at 1.0 one
# ulp of a moved D would exceed ROUND_PARAM_ATOL.
DIST_LR = 1.0
DIST_SSM_LR = 0.25
# Slice 17: Zamba2-7B at the rounds' depth (HYBRID_ROUND_LAYERS): two of
# its Mamba2 rows (the shared block's mask entry off, so that every group
# but ``blocks`` stays bit-unchanged), at Mamba2's rate
DIST_HYBRID_SEL = (3, 11)
DIST_HYBRID_LR = 0.25
DIST_UPDATE_RTOL = 0.05     # ‖new − ref‖₂ / ‖ref − old‖₂, selected rows
DIST_MIN_MOVED = 0.2        # share of the selected rows' elements moved
DIST_TAU = 2
DIST_REPS = 3
DIST_DECODE = dict(batch=4, prompt=8, steps=32)
# Slice 17's decode checks (Mamba2, Zamba2): fewer steps, for the time limit
DIST_DECODE_TP = dict(DIST_DECODE, steps=8)
# Slice 18: DeepSeek-V2-Lite at the moe rounds' depth (dense0 + 3 blocks
# rows), 4 × SSM_SEQ tokens: the τ = 1 step's mask rows (dense0's row 0
# and blocks row 1, mask column 2), the blocks rows of sel_upload and
# τ = 2 (mask columns 2 and 3), a rate at which the bf16 update moves
DIST_MOE_MASK = (0, 2)
DIST_MOE_SEL = (1, 2)
DIST_MOE_LR = 0.25
DIST_DECODE_MOE = dict(DIST_DECODE, steps=8)
# Slice 19: PaliGemma-3B at full width and depth (18 rows, 5.9 GB of bf16),
# 1 client × 4 sequences of DIST_VLM_PREFIX stub patches + DIST_VLM_TEXT
# text tokens; two of its rows selected (mask, sel_upload and τ = 2 alike)
DIST_VLM_SEL = (5, 12)
DIST_VLM_PREFIX = 256
DIST_VLM_TEXT = 256
DIST_VLM_LR = 0.25
# Slice 20: whisper-medium at full width and depth (24 + 24 rows, 1.52 GB
# of bf16), 1 client × 4 sequences of 1500 stub frames + AUDIO_SEQ tokens:
# the τ = 1 mask's encoder row 5 and decoder row 17 (mask columns 5 and
# 24 + 17), the decoder rows of sel_upload and τ = 2
DIST_AUDIO_MASK = (5, 41)
DIST_AUDIO_SEL = (5, 17)
DIST_AUDIO_LR = 0.25
DIST_CPU_TOL = 1e-6
CLI_ROUNDS = 3
COLLECTIVE_OPS = {"all_gather": "c10d::_allgather_base_",
                  "reduce_scatter": "c10d::_reduce_scatter_base_",
                  "all_reduce": "c10d::allreduce_"}


def run_child(cmd: list, timeout: float, env=None) -> tuple[int, str]:
    """Run ``cmd`` in a session of its own; on timeout kill the whole
    session (a launcher's workers too).  Returns (exit code, output)."""
    import signal
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise SmokeFailure(f"{cmd[:6]} did not finish in {timeout} s:\n"
                           f"{out[-3000:]}")
    return p.returncode, out


def dist_update_check(new, old, ref, rows) -> dict:
    """How far a step moved the params, against its reference: on the
    selected ``blocks`` rows the update's distance from the reference's,
    ‖new − ref‖₂ / ‖ref − old‖₂ (``update_rel``), the share of their
    elements the step changed (``moved_frac``) and its largest change
    (``moved_max``); whether every other row and every other group is
    bit-unchanged (``rest_unchanged``)."""
    import torch
    num = den = 0.0
    moved = total = 0
    top, same = 0.0, True
    rows = list(rows)
    for key, sub in old.items():
        if key != "blocks":
            same &= _params_equal(new[key], sub)
            continue
        for nm, o in sub.items():
            nw, rf = new["blocks"][nm], ref["blocks"][nm]
            other = [i for i in range(o.shape[0]) if i not in rows]
            same &= torch.equal(nw[other], o[other])
            d_new = nw[rows].float() - o[rows].float()
            d_ref = rf[rows].float() - o[rows].float()
            num += float(((d_new - d_ref) ** 2).sum())
            den += float((d_ref ** 2).sum())
            moved += int((d_new != 0).sum())
            total += d_new.numel()
            top = max(top, float(d_new.abs().max()))
    return {"update_rel": math.sqrt(num / den) if den > 0 else math.inf,
            "moved_frac": moved / total, "moved_max": top,
            "rest_unchanged": same}


def dist_collectives_want(model, specs, *, tau: int = 1, sel=None,
                          sel_upload: bool = False) -> dict:
    """One step's collectives by its structure (``blocks`` the only
    selectable segment, as for TinyLlama and Mamba2, or the hybrid's
    ``blocks`` and ``shared_attn`` in its plain τ = 1 step): an all-gather
    per sharded leaf of the groups gathered whole and, per layer, of each
    sharded ``blocks`` leaf (τ > 1: of the unselected rows each local
    step, the selected rows once); a reduce-scatter per sharded block
    leaf and layer (sel_upload and τ > 1: once, on the R rows) and per
    sharded shared leaf; an all-reduce for Eq.(7)'s denominators, each
    replicated block and shared leaf's residual sum and the two
    metrics."""
    from repro_torch.models.model import layer_layout
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves
    layout = layer_layout(model.cfg)
    shared = specs.get("shared_attn", {})
    check([s.path for s in layout] in (["blocks"], ["blocks", "shared_attn"])
          and (not shared or (tau == 1 and not sel_upload)),
          f"[dist] the structure count takes blocks only, or the hybrid's "
          f"plain τ = 1 step: {layout}")
    L = layout[0].count

    def n_sharded(tree):
        return sum(rules.zero3_gather_axis(s) is not None
                   for s in tree_leaves(tree))
    blocks = n_sharded(specs["blocks"])
    rest = sum(n_sharded(v) for k, v in specs.items() if k != "blocks")
    replicated = len(specs["blocks"]) - blocks
    shared_sharded = n_sharded(shared)
    if tau > 1:
        ag = rest + blocks + tau * (L - len(sel)) * blocks
    elif sel_upload:
        ag = rest + 2 * blocks
    else:
        ag = rest + L * blocks
    rs = blocks if (tau > 1 or sel_upload) else L * blocks + shared_sharded
    return {"all_gather": ag, "reduce_scatter": rs,
            "all_reduce": 1 + replicated + len(shared) - shared_sharded + 2}


def dist_profiled(fn):
    """``fn()`` under torch.profiler: (its result, the collectives the
    profiler saw as ``c10d::`` ops, the device ms of the NCCL ops, the
    device's busy ms, the six ops with the most host time)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events())
    seen = {k: names[op] for k, op in COLLECTIVE_OPS.items()}
    averages = prof.key_averages()
    nccl_ms = sum(getattr(e, "device_time_total", 0) or 0
                  for e in averages if e.key.startswith("nccl:")) / 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in averages), reverse=True)[:6]
    return out, seen, nccl_ms, device_busy_ms(prof), host


def dist_time_ms(fn, reps: int = DIST_REPS) -> float:
    """Median wall ms of ``fn()`` over ``reps`` synchronised runs."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def single_host_step(model, params, batch, masks, sizes, lr):
    """One client's round on one device: ``torch.autograd.grad`` of
    ``Model.loss`` over the selectable segments, ``apply_layer_mask``,
    ``aggregation.aggregate``, ``apply_update``."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.models.model import apply_layer_mask, layer_layout
    from repro_torch.tree import tree_leaves, tree_map
    paths = [s.path for s in layer_layout(model.cfg)]
    wrt = {k: tree_map(lambda t: t.detach().requires_grad_(), params[k])
           for k in paths}
    loss = model.seq_loss({**params, **wrt}, batch)
    it = iter(torch.autograd.grad(loss, tree_leaves(wrt)))
    g = {k: tree_map(lambda _: next(it), wrt[k]) if k in wrt
         else tree_map(torch.zeros_like, v) for k, v in params.items()}
    delta = apply_layer_mask(g, masks[0], model.cfg)
    update = agg.aggregate([delta], masks, sizes, model.cfg)
    return agg.apply_update(params, update, lr)


def dist_reduced_step(device: str) -> dict:
    """One τ = 1 zero3 step of a reduced f32 TinyLlama (3 layers, d 64) on
    a (1, 1) mesh of ``device`` (the caller has joined the world): the
    params, from a CPU seed, as numpy."""
    import numpy as np
    import torch
    from repro_torch.bridge import gather_params, params_to_numpy
    from repro_torch.bridge import params_to_local
    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding.fl_step import make_fl_train_step
    cfg = reduced(get_arch("tinyllama_1_1b"), n_layers=3, d_model=64)
    rt = RuntimeConfig(remat=False, seq_chunk=16)
    host = params_to_numpy(Model(cfg, rt, device="cpu").init(0))
    mesh = make_host_mesh(1, 1, device=device)
    model = Model(cfg, rt, device=mesh.device)
    step, specs = make_fl_train_step(model, mesh)(host)
    rng = np.random.RandomState(6)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, 4, 32)).astype(np.int32)).to(mesh.device)}
    masks = torch.tensor([[1.0, 0.0, 1.0]], device=mesh.device)
    sizes = torch.tensor([5.0], device=mesh.device)
    new, _ = step(params_to_local(host, specs, mesh), batch, masks, sizes,
                  0.1)
    return params_to_numpy(gather_params(new, specs, mesh))


def dist_cpu_step(out_path: str) -> int:
    """The CPU side of the reduced card-vs-CPU check: a gloo world of 1
    in this process, :func:`dist_reduced_step` on the CPU, saved to
    ``out_path`` (npz, leaves by path)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    from repro_torch.tree import tree_items
    try:
        new = dist_reduced_step("cpu")
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **{"/".join(path): v for path, v in tree_items(new)})
    return 0


def tp_programs(card: str, mesh, gen, out: dict, paths: dict, tp_same, *,
                tag: str, label: str, cfg, rt, batch_of, mask_cols, sel,
                lr: float, seed: int, flash=None,
                fill_cache=None) -> None:
    """Slices 18–20 in ``phase_distributed``: one model's five programs on
    the phase's (1, 1) mesh (zero3, 1 client), none under the profiler:
    the τ = 1 step over the mask columns ``mask_cols`` against the
    single-host step (every group holding one moved, the groups outside
    the mask bit-unchanged), ``sel_upload`` and τ = DIST_TAU over the
    ``blocks`` rows ``sel`` (``masked_update`` on each ``blocks`` leaf a
    local step), a prefill of the client's rows against
    ``Model.logits_seq`` and DIST_DECODE_MOE greedy decode steps against
    ``Model.decode_step``; each again with ``tp_constraints`` at model = 1
    (``tp_same``): bit-equal, with the plain program's collectives.
    ``batch_of(lead)`` draws a batch of leading dims ``lead`` from
    ``gen`` (seeded ``seed``, ``seed + 1`` for τ = 2, ``seed + 2`` for the
    prompt).  ``flash``: each program's (forward, backward) flash
    launches, all on the tensor-core route; none where not given (neither
    MLA nor the prefix-LM attends through flash).  ``fill_cache(model,
    params, cache)`` fills the full decode cache before it is laid out
    (whisper's cross cache, from ``Model.encode``).  The launches are the
    paths ``distributed_<tag>_<program>``; the programs' peak GB is
    logged."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, layer_layout
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import (COLLECTIVES, make_fl_train_step,
                                              make_fl_train_step_tau,
                                              reset_collectives, shard_params)
    from repro_torch.sharding.serve import (make_prefill_step, make_serve_step,
                                            shard_cache)
    from repro_torch.tree import tree_map
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, rt)
    tp_rt = dataclasses.replace(rt, tp_constraints=True)
    tp_model = Model(cfg, tp_rt)
    params = model.init(0)
    segs = layer_layout(cfg)
    gen.manual_seed(seed)
    batch = batch_of((1,))
    one = {k: v[0] for k, v in batch.items()}
    sizes = torch.tensor([7.0], device="cuda")

    def mask_of(cols):
        m = torch.zeros((1, model.n_selectable), device="cuda")
        m[0, list(cols)] = 1.0
        return m
    off = sum(g.count for g in segs[:[g.path for g in segs].index("blocks")])
    masks, sel_masks = mask_of(mask_cols), mask_of([off + i for i in sel])
    step, specs = make_fl_train_step(model, mesh)(params)
    local = rules.shard_tree(params, specs, mesh)
    tp_local = shard_params(tp_model, mesh, params, specs)

    def plain(program, fn):
        """``fn()`` once: its result, collectives, launches (the path
        ``distributed_<tag>_<program>``) and seconds."""
        torch.cuda.synchronize()
        reset_collectives()
        ops.reset_launches()
        t_run = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        paths[f"distributed_{tag}_{program}"] = launches = dict(ops.LAUNCHES)
        fwd, bwd = (flash or {}).get(program, (0, 0))
        check(launches["flash_attention"] == launches["flash_attention_mma"]
              == fwd and launches["flash_attention_bwd"]
              == launches["flash_attention_bwd_mma"] == bwd,
              f"[dist] {label} {program}: flash launches {launches}, want "
              f"{fwd} forward and {bwd} backward, all mma")
        return got, dict(COLLECTIVES), time.perf_counter() - t_run

    res = {}
    (new, metrics), coll, s = plain("step", lambda: step(
        local, batch, masks, sizes, lr))
    loss = float(metrics["loss"])
    ref = single_host_step(model, params, one, masks, sizes, lr)
    err = _tree_max_diff(new, ref)
    cols, start = set(mask_cols), 0
    moved = {}
    for g in segs:
        if cols & set(range(start, start + g.count)):
            moved[g.path] = _tree_max_diff(new[g.path], params[g.path])
        start += g.count
    frozen = _tree_max_diff({k: new[k] for k in params if k not in moved},
                            {k: params[k] for k in params if k not in moved})
    res["step"] = {"loss": loss, "param_err": err, "moved_max": moved,
                   "collectives": coll, "s": s}
    log(f"[dist] {label} τ = 1 over mask columns {tuple(mask_cols)}: loss "
        f"{loss:.4f}; params off the single-host step {err:.3e} (limit "
        f"{ROUND_PARAM_ATOL:g}); moved by up to {moved}, the rest by "
        f"{frozen:g}; collectives {coll}; {s:.1f} s   [{card}]")
    check(math.isfinite(loss) and err <= ROUND_PARAM_ATOL
          and min(moved.values()) > 0 and frozen == 0,
          f"[dist] {label} τ = 1: loss {loss}, params off the single-host "
          f"step {err:.3e}, moved {moved}, the rest {frozen}")
    del ref
    tp_step = make_fl_train_step(tp_model, mesh)(params)[0]
    tp_same(f"{tag}_step", lambda: new, lambda: tp_step(
        tp_local, batch, masks, sizes, lr)[0], coll)
    del new, tp_step

    sel_step = make_fl_train_step(
        Model(cfg, dataclasses.replace(rt, sel_upload=True)), mesh,
        sel_idx=sel)(params)[0]
    new, coll, s = plain("sel_upload", lambda: sel_step(
        local, batch, sel_masks, sizes, lr)[0])
    res["sel_upload"] = {"collectives": coll, "s": s,
                         "moved_max": _tree_max_diff(new, params)}
    tp_sel = make_fl_train_step(
        Model(cfg, dataclasses.replace(tp_rt, sel_upload=True)), mesh,
        sel_idx=sel)(params)[0]
    tp_same(f"{tag}_sel_upload", lambda: new, lambda: tp_sel(
        tp_local, batch, sel_masks, sizes, lr)[0], coll)
    del new, sel_step, tp_sel

    gen.manual_seed(seed + 1)
    tau_batch = batch_of((1, DIST_TAU))
    tau_step = make_fl_train_step_tau(model, mesh, sel_idx=sel,
                                      tau=DIST_TAU)(params)[0]
    new, coll, s = plain("tau2", lambda: tau_step(
        local, tau_batch, sel_masks, sizes, lr)[0])
    n_leaves = len(params["blocks"])
    res["tau2"] = {"collectives": coll, "s": s,
                   "moved_max": _tree_max_diff(new, params),
                   "launches": paths[f"distributed_{tag}_tau2"]}
    tp_tau = make_fl_train_step_tau(tp_model, mesh, sel_idx=sel,
                                    tau=DIST_TAU)(params)[0]
    tp_same(f"{tag}_tau2", lambda: new, lambda: tp_tau(
        tp_local, tau_batch, sel_masks, sizes, lr)[0], coll)
    for path in (f"distributed_{tag}_tau2", f"distributed_tp_{tag}_tau2"):
        check(paths[path]["masked_update"] == DIST_TAU * n_leaves,
              f"[dist] {label}: {path}'s masked_update launches "
              f"{paths[path]}, want {DIST_TAU * n_leaves}")
    del new, tau_step, tp_tau

    prefill = make_prefill_step(model, mesh)(params, one)[0]
    got, coll, s = plain("prefill", lambda: prefill(local, one))
    with torch.no_grad():
        want = model.logits_seq(params, one)
    err = (got.float() - want.float()).abs().max().item()
    res["prefill"] = {"max_abs_err": err, "collectives": coll, "s": s}
    log(f"[dist] {label} prefill "
        f"{ {k: tuple(v.shape) for k, v in one.items()} }: last-position "
        f"logits against Model.logits_seq {err:.3e} (limit "
        f"{TOL['bfloat16']:g}); collectives {coll}   [{card}]")
    check(err <= TOL["bfloat16"], f"[dist] {label}: the mesh prefill's "
                                  f"logits differ from Model.logits_seq")
    tp_prefill = make_prefill_step(tp_model, mesh)(params, one)[0]
    tp_same(f"{tag}_prefill", lambda: got,
            lambda: tp_prefill(tp_local, one), coll)
    del prefill, tp_prefill, got, want

    dd = DIST_DECODE_MOE
    gen.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab_size, (dd["batch"], dd["prompt"]),
                           device="cuda", generator=gen, dtype=torch.int32)
    total = dd["prompt"] + dd["steps"]
    full_cache = model.init_cache(dd["batch"], total)
    if fill_cache is not None:
        fill_cache(model, params, full_cache)

    def lockstep(serve_fn, p, shard):
        cache = shard(tree_map(torch.clone, full_cache))
        tok, logits = prompt[:, 0], {}
        for t in range(total - 1):
            nxt, logits[t], cache = serve_fn(
                p, tok, torch.tensor(t, dtype=torch.int32, device="cuda"),
                cache)
            tok = prompt[:, t + 1] if t + 1 < dd["prompt"] else nxt
        return logits

    def model_serve(p, tok, pos, cache):
        logits, cache = model.decode_step(p, tok, pos, cache)
        return logits.argmax(-1).to(torch.int32), logits, cache
    serve = make_serve_step(model, mesh)(params, full_cache, dd["batch"])[0]
    mesh_logits, coll, s = plain("decode", lambda: lockstep(
        serve, local, lambda c: c))
    model_logits = lockstep(model_serve, params, lambda c: c)
    same = all(torch.equal(mesh_logits[t].argmax(-1),
                           model_logits[t].argmax(-1)) for t in mesh_logits)
    res["decode"] = {"same_tokens": same, "collectives": coll, "s": s}
    log(f"[dist] {label}: {dd['steps']} greedy decode steps (batch "
        f"{dd['batch']}, prompt {dd['prompt']}): the same tokens as "
        f"Model.decode_step: {same}; collectives {coll}   [{card}]")
    check(same, f"[dist] {label}: the mesh decode's tokens differ from "
                f"Model.decode_step's")
    tp_serve, (_, tp_cspecs) = make_serve_step(tp_model, mesh)(
        params, full_cache, dd["batch"])
    tp_same(f"{tag}_decode", lambda: mesh_logits, lambda: lockstep(
        tp_serve, tp_local, lambda c: shard_cache(tp_model, mesh, c,
                                                  tp_cspecs)), coll)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["s"] = time.perf_counter() - t0
    log(f"[dist] {label}: peak {res['peak_gb']:.2f} GB over its programs; "
        f"{res['s']:.1f} s   [{card}]")
    out[tag] = res
    del params, local, tp_local, serve, tp_serve, mesh_logits, model_logits
    del full_cache
    gc.collect()
    torch.cuda.empty_cache()


def moe_programs(card: str, mesh, gen, out: dict, paths: dict,
                 tp_same) -> None:
    """Slice 18: :func:`tp_programs` of DeepSeek-V2-Lite-16B at full
    width and depth MOE_ROUND_LAYERS (bf16, 4 × SSM_SEQ tokens): τ = 1
    over DIST_MOE_MASK (a ``dense0`` row and a ``blocks`` row), the
    ``blocks`` rows DIST_MOE_SEL; since slice 19 its MLA splits by heads
    under tensor parallelism, which at model = 1 is the plain code."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    cfg = dataclasses.replace(get_arch("deepseek_v2_lite_16b"),
                              n_layers=MOE_ROUND_LAYERS)

    def batch_of(lead):
        return {"tokens": torch.randint(
            0, cfg.vocab_size, lead + (4, SSM_SEQ), device="cuda",
            generator=gen, dtype=torch.int32)}
    tp_programs(card, mesh, gen, out, paths, tp_same, tag="deepseek",
                label=f"DeepSeek-V2-Lite (depth {cfg.n_layers})", cfg=cfg,
                rt=RuntimeConfig(remat=False, seq_chunk=SSM_SEQ),
                batch_of=batch_of, mask_cols=DIST_MOE_MASK, sel=DIST_MOE_SEL,
                lr=DIST_MOE_LR, seed=30)


def vlm_programs(card: str, mesh, gen, out: dict, paths: dict,
                 tp_same) -> None:
    """Slice 19: :func:`tp_programs` of PaliGemma-3B at full width and
    depth (18 rows, bf16), its first run on the card: 4 sequences of
    DIST_VLM_PREFIX stub patches + DIST_VLM_TEXT tokens, its ``blocks``
    rows DIST_VLM_SEL the τ = 1 mask too.  The prefix-LM attends on the
    plain path (the flash kernel's mask has no prefix)."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    cfg = get_arch("paligemma_3b")

    def batch_of(lead):
        return {"tokens": torch.randint(
            0, cfg.vocab_size, lead + (4, DIST_VLM_TEXT), device="cuda",
            generator=gen, dtype=torch.int32),
            "patches": torch.randn(
                lead + (4, DIST_VLM_PREFIX, cfg.d_model), device="cuda",
                generator=gen).to(torch.bfloat16)}
    tp_programs(card, mesh, gen, out, paths, tp_same, tag="paligemma",
                label="PaliGemma-3B (full depth)", cfg=cfg,
                rt=RuntimeConfig(remat=False,
                                 seq_chunk=DIST_VLM_PREFIX + DIST_VLM_TEXT),
                batch_of=batch_of, mask_cols=DIST_VLM_SEL, sel=DIST_VLM_SEL,
                lr=DIST_VLM_LR, seed=33)


def fill_cross_cache(model, params, cache, frames) -> None:
    """whisper's cross cache from the port's encoder over ``frames``, row
    by row through ``make_cross_kv``, in place (as the reference's
    tests/test_decode_consistency.py fills it: neither package has an
    encoder-prefill entry point)."""
    import torch
    from repro_torch.models import blocks
    with torch.no_grad():
        enc = model.encode(params, frames)
        xkv = cache["cross_kv"]
        for li in range(model.cfg.n_layers):
            row = {k[len("xattn_"):]: v[li]
                   for k, v in params["blocks"].items()
                   if k.startswith("xattn_")}
            xkv["k"][li], xkv["v"][li] = blocks.make_cross_kv(row, enc,
                                                              model.cfg)


def audio_programs(card: str, mesh, gen, out: dict, paths: dict,
                   tp_same) -> None:
    """Slice 20: :func:`tp_programs` of whisper-medium at full width and
    depth (24 encoder and 24 decoder rows, 1.52 GB of bf16), its first
    run on the mesh: 4 sequences of 1500 stub frames + AUDIO_SEQ tokens,
    the τ = 1 mask over DIST_AUDIO_MASK (an ``enc_blocks`` row and a
    ``blocks`` row), ``sel_upload`` and τ = 2 over the ``blocks`` rows
    DIST_AUDIO_SEL, decode over a cross cache filled from
    ``Model.encode`` (:func:`fill_cross_cache`).  The encoder's and the
    decoder's self-attention run the flash kernels (48 sites a sequence
    forward; backward from every row at τ = 1, from the decoder's rows
    under ``sel_upload``, whose index_copy makes every ``blocks`` row
    differentiable, and from the lowest selected row at each τ = 2 local
    step, the encoder frozen), cross-attention the plain path; decode
    none."""
    import torch
    from repro_torch.configs.base import RuntimeConfig, get_arch
    cfg = get_arch("whisper_medium")
    E, D = cfg.n_enc_layers, cfg.n_layers

    def batch_of(lead):
        return {"tokens": torch.randint(
            0, cfg.vocab_size, lead + (4, AUDIO_SEQ), device="cuda",
            generator=gen, dtype=torch.int32),
            "frames": torch.randn(
                lead + (4, cfg.enc_seq, cfg.d_model), device="cuda",
                generator=gen).to(torch.bfloat16)}

    def fill(model, params, cache):
        frames = torch.randn((cache["cross_kv"]["k"].shape[1], cfg.enc_seq,
                              cfg.d_model), device="cuda", generator=gen)
        fill_cross_cache(model, params, cache, frames)
    low = D - min(DIST_AUDIO_SEL)
    tp_programs(card, mesh, gen, out, paths, tp_same, tag="whisper",
                label="whisper-medium (full depth)", cfg=cfg,
                rt=RuntimeConfig(remat=False, seq_chunk=AUDIO_SEQ),
                batch_of=batch_of, mask_cols=DIST_AUDIO_MASK,
                sel=DIST_AUDIO_SEL, lr=DIST_AUDIO_LR, seed=36,
                flash={"step": (E + D, E + D), "sel_upload": (E + D, D),
                       "tau2": (DIST_TAU * (E + D), DIST_TAU * low),
                       "prefill": (E + D, 0)},
                fill_cache=fill)


def phase_distributed(card: str) -> dict:
    """Slice 13 on one card: a world of 1 on NCCL in this process (no
    fallback), a (1, 1) mesh, and through it (a) full-width TinyLlama-1.1B
    (bf16, batch 1 client × 4 × 1024, zero3): the τ = 1 step against the
    single-host math on the same card, the same step with ``sel_upload``
    over DIST_SEL (equal to the plain one), a τ = 2 step over DIST_SEL
    against ``Client.local_update`` + ``aggregate``, each step's update
    on the selected rows against its reference's (``dist_update_check``,
    at DIST_LR, where most of the rows' bf16 elements move); launches and
    the collectives (counted by the step and seen by the profiler) against
    each step's structure, ms/step beside the single-host step, peak
    memory; (b) full-width Mamba2-370M (4 × 512): the τ = 1 step, held the
    same way, ``ssd_scan`` counted, and (slice 17) its ``sel_upload`` and
    τ = 2 steps, prefill and decode, each again with ``tp_constraints`` at
    model = 1, bit-equal (``tp_family``); (c) a reduced f32 TinyLlama step
    against the CPU's (gloo, world 1, a child process); (d) mesh serving:
    a 4 × 1024 prefill against ``Model.logits_seq``, 32 greedy decode
    steps against ``Model.decode_step``; then (e) the train CLI under
    ``torch.distributed.run`` for CLI_ROUNDS rounds; (f, slice 17)
    Zamba2-7B at full width and the rounds' depth HYBRID_ROUND_LAYERS (81
    rows' bf16 params are 13.3 GB; with the single-host reference's
    gradients, delta, f32 aggregate and update and the steps' results
    about eight such copies, over the card's 80 GB): the
    τ = 1 step against the single-host one, then the step and decode with
    tensor parallelism at model = 1, bit-equal; (g, slice 18)
    DeepSeek-V2-Lite at full width and the moe rounds' depth
    (:func:`moe_programs`): its τ = 1, ``sel_upload`` and τ = 2 steps,
    prefill and decode, plain and with tensor parallelism at model = 1,
    bit-equal with the same collectives; (h, slice 19) PaliGemma-3B at
    full width and depth (:func:`vlm_programs`): the same five programs
    over its 256-patch prefix, plain against the single-host step and
    ``Model``, and with tensor parallelism at model = 1, bit-equal; (i,
    slice 20) whisper-medium at full width and depth
    (:func:`audio_programs`): the same five over 1500 stub frames, decode
    over a cross cache filled from its encoder."""
    import json as _json
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.tree import tree_leaves
    from repro_torch.configs.base import RuntimeConfig, get_arch
    from repro_torch.core.client import Client
    from repro_torch.core import aggregation as agg
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import (COLLECTIVES, make_fl_train_step,
                                              make_fl_train_step_tau,
                                              reset_collectives, shard_params)
    from repro_torch.sharding.serve import (make_prefill_step, make_serve_step,
                                            shard_cache)

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out, paths = {}, {}

    def mark(what):
        log(f"[dist] {what} done at {time.perf_counter() - t_phase:.1f} s "
            f"of the phase")
    try:
        mesh = make_host_mesh(1, 1)
        check(dist.get_backend() == "nccl", "[dist] the world is not NCCL")
        log(f"[dist] world of {dist.get_world_size()} on "
            f"{dist.get_backend()}, mesh {mesh.shape} on {mesh.device}")
        gen = torch.Generator(device="cuda")

        def run_step(tag, model, step, local, batch, masks, sizes, want_c,
                     want_l, ref, old, rows, lr=DIST_LR, ref_fn=None,
                     profiled=True):
            """Profile one step (collectives, launches), time it against
            ``ref_fn`` and hold its params against ``ref``: within
            ROUND_PARAM_ATOL, the update on the selected ``rows`` of
            ``blocks`` against ``ref``'s from ``old``, every other row
            and group bit-unchanged.  ``profiled=False`` runs the first
            step without the profiler (a Mamba2 step's 14 000 launches
            take it 14–28 s on the host): its collectives are then the
            step's own count alone, held against the structure."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_collectives()
            ops.reset_launches()
            t_run = time.perf_counter()
            if profiled:
                (new, metrics), seen, nccl_ms, busy, host = dist_profiled(
                    lambda: step(local, batch, masks, sizes, lr))
            else:
                new, metrics = step(local, batch, masks, sizes, lr)
                torch.cuda.synchronize()
                seen, nccl_ms, busy, host = dict(COLLECTIVES), None, None, []
            first_s = time.perf_counter() - t_run
            peak = torch.cuda.max_memory_allocated() / 1e9
            launches, counted = dict(ops.LAUNCHES), dict(COLLECTIVES)
            loss = float(metrics["loss"])
            check(math.isfinite(loss), f"[dist] {tag}: loss {loss}")
            check(counted == want_c and seen == want_c,
                  f"[dist] {tag}: collectives counted {counted}, seen by "
                  f"the profiler {seen}, structure {want_c}")
            bad = {k: (launches[k], v) for k, v in want_l.items()
                   if launches[k] != v}
            check(not bad, f"[dist] {tag}: launches (got, want) {bad}")
            t_run = time.perf_counter()
            ms = dist_time_ms(lambda: step(local, batch, masks, sizes, lr))
            res = {"loss": loss, "ms": ms, "peak_gb": peak, "lr": lr,
                   "first_run_s": first_s, "profiled": profiled,
                   "collectives": counted, "nccl_device_ms": nccl_ms,
                   "busy_ms_profiled": busy, "launches": launches,
                   "param_err": _tree_max_diff(new, ref),
                   **dist_update_check(new, old, ref, rows)}
            log(f"[dist] {tag}: lr {lr:g}; params off the reference "
                f"{res['param_err']:.3e} (limit {ROUND_PARAM_ATOL:g}); rows "
                f"{rows}: {res['moved_frac']:.4f} of the elements moved "
                f"(limit {DIST_MIN_MOVED:g}), by up to "
                f"{res['moved_max']:.3e}; update off the reference's "
                f"{res['update_rel']:.3e} (limit {DIST_UPDATE_RTOL:g}); the "
                f"other rows and groups bit-unchanged: "
                f"{res['rest_unchanged']}   [{card}]")
            check(res["param_err"] <= ROUND_PARAM_ATOL,
                  f"[dist] {tag}: params {res['param_err']:.3e} off the "
                  f"reference (limit {ROUND_PARAM_ATOL})")
            check(res["moved_frac"] >= DIST_MIN_MOVED
                  and res["update_rel"] <= DIST_UPDATE_RTOL
                  and res["rest_unchanged"],
                  f"[dist] {tag}: the update is not the reference's: "
                  f"moved {res['moved_frac']:.4f}, off it "
                  f"{res['update_rel']:.3e}, the rest unchanged "
                  f"{res['rest_unchanged']}")
            if ref_fn is not None:
                torch.cuda.reset_peak_memory_stats()
                res["single_host_ms"] = dist_time_ms(ref_fn)
                res["single_host_peak_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
            res["timed_s"] = time.perf_counter() - t_run
            seen_by = (f"profiler {seen}; NCCL device {nccl_ms:.3f} ms; "
                       f"busy {busy:.2f} ms profiled" if profiled
                       else "not profiled")
            log(f"[dist] {tag}: loss {loss:.4f}; {ms:.2f} ms/step "
                f"(single-host {res.get('single_host_ms', float('nan')):.2f}), peak "
                f"{peak:.2f} GB; collectives {counted} ({seen_by}); launches "
                f"{({k: v for k, v in launches.items() if v})}; the first "
                f"run took {first_s:.1f} s, the timed runs "
                f"{res['timed_s']:.1f} s   [{card}]")
            if profiled:
                log(f"[dist] {tag}: most host time in the profiled step "
                    f"(self ms, op, calls): "
                    f"{[(round(t, 2), k[:40], n) for t, k, n in host]}")
            res["host_top"] = [[t, k, n] for t, k, n in host]
            return new, res

        def tp_same(tag, want_fn, fn, collectives=None):
            """(a) of slice 16: the tensor-parallel program (model = 1) run
            once, its launches the path ``distributed_tp_<tag>``, its
            result bit-equal to the plain program's (``want_fn()``), its
            collectives those of the plain step where given."""
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            reset_collectives()
            ops.reset_launches()
            got = fn()
            torch.cuda.synchronize()
            launches, counted = dict(ops.LAUNCHES), dict(COLLECTIVES)
            paths[f"distributed_tp_{tag}"] = launches
            same = _params_equal(got, want_fn()) and len(
                tree_leaves(got)) == len(tree_leaves(want_fn()))
            out.setdefault("tp_bit_equal", {})[tag] = same
            log(f"[dist] tensor parallelism on (model = 1), {tag}: bit-equal "
                f"to the plain program: {same}; collectives {counted}; "
                f"launches {({k: v for k, v in launches.items() if v})}; "
                f"{time.perf_counter() - t_run:.1f} s   [{card}]")
            check(same, f"[dist] the tensor-parallel {tag} program at "
                        f"model = 1 differs from the plain one")
            check(collectives is None or counted == collectives,
                  f"[dist] the tensor-parallel {tag} step's collectives "
                  f"{counted} differ from the plain step's {collectives}")
            return got

        # (a) full-width TinyLlama-1.1B
        cfg = get_arch("tinyllama_1_1b")
        rt = RuntimeConfig(remat=False, seq_chunk=LONG_SEQ)
        model = Model(cfg, rt)
        params = model.init(0)
        L = model.n_selectable
        gen.manual_seed(23)
        tokens = torch.randint(0, cfg.vocab_size, (1, 4, LONG_SEQ),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        mask_np = np.zeros((1, L), np.float32)
        mask_np[0, list(DIST_SEL)] = 1.0
        masks = torch.from_numpy(mask_np).cuda()
        sizes = torch.tensor([7.0], device="cuda")
        step, specs = make_fl_train_step(model, mesh)(params)
        local = rules.shard_tree(params, specs, mesh)
        batch = {"tokens": tokens}
        one = {"tokens": tokens[0]}
        ref = single_host_step(model, params, one, masks, sizes, DIST_LR)
        flash = {"flash_attention": L, "flash_attention_bwd": L,
                 "masked_update": 0, "layer_grad_norm": 0, "ssd_scan": 0}
        plain, out["tinyllama_step"] = run_step(
            "TinyLlama-1.1B τ = 1", model, step, local, batch, masks, sizes,
            dist_collectives_want(model, specs), flash, ref, params,
            DIST_SEL, ref_fn=lambda: single_host_step(
                model, params, one, masks, sizes, DIST_LR))
        paths["distributed_tinyllama_step"] = out["tinyllama_step"]["launches"]
        del ref
        tp_rt = dataclasses.replace(rt, tp_constraints=True)
        tp_model = Model(cfg, tp_rt)
        tp_step, tp_specs = make_fl_train_step(tp_model, mesh)(params)
        tp_local = shard_params(tp_model, mesh, params, tp_specs)
        tp_same("step", lambda: plain, lambda: tp_step(
            tp_local, batch, masks, sizes, DIST_LR)[0],
            out["tinyllama_step"]["collectives"])
        sel_model = Model(cfg, dataclasses.replace(rt, sel_upload=True))
        sel_step, _ = make_fl_train_step(sel_model, mesh,
                                         sel_idx=DIST_SEL)(params)
        sel_new, out["tinyllama_sel_upload"] = run_step(
            f"TinyLlama-1.1B τ = 1, sel_upload over rows {DIST_SEL}",
            sel_model, sel_step, local, batch, masks, sizes,
            dist_collectives_want(model, specs, sel_upload=True), flash,
            plain, params, DIST_SEL)
        out["tinyllama_sel_upload"]["vs_plain"] = \
            out["tinyllama_sel_upload"]["param_err"]
        paths["distributed_tinyllama_sel_upload"] = \
            out["tinyllama_sel_upload"]["launches"]
        tp_sel_step, _ = make_fl_train_step(
            Model(cfg, dataclasses.replace(tp_rt, sel_upload=True)), mesh,
            sel_idx=DIST_SEL)(params)
        tp_same("sel_upload", lambda: sel_new, lambda: tp_sel_step(
            tp_local, batch, masks, sizes, DIST_LR)[0],
            out["tinyllama_sel_upload"]["collectives"])
        del sel_new, plain, tp_sel_step
        gen.manual_seed(24)
        tau_tokens = torch.randint(0, cfg.vocab_size,
                                   (1, DIST_TAU, 4, LONG_SEQ), device="cuda",
                                   generator=gen, dtype=torch.int32)
        client = Client(model)

        def tau_ref():
            delta, _ = client.local_update(params, {"tokens": tau_tokens[0]},
                                           mask_np[0], DIST_LR)
            return agg.apply_update(params, agg.aggregate(
                [delta], masks, sizes, cfg), DIST_LR)
        tau_step, _ = make_fl_train_step_tau(
            model, mesh, sel_idx=DIST_SEL, tau=DIST_TAU)(params)
        n_leaves = len(params["blocks"])
        tau_new, out["tinyllama_tau2"] = run_step(
            f"TinyLlama-1.1B τ = {DIST_TAU} over rows {DIST_SEL}", model,
            tau_step, local, {"tokens": tau_tokens}, masks, sizes,
            dist_collectives_want(model, specs, tau=DIST_TAU, sel=DIST_SEL),
            {"flash_attention": DIST_TAU * L,
             "flash_attention_bwd": DIST_TAU * (L - min(DIST_SEL)),
             "masked_update": DIST_TAU * n_leaves, "layer_grad_norm": 0},
            tau_ref(), params, DIST_SEL, ref_fn=tau_ref)
        paths["distributed_tinyllama_tau2"] = out["tinyllama_tau2"]["launches"]
        tp_tau_step, _ = make_fl_train_step_tau(
            tp_model, mesh, sel_idx=DIST_SEL, tau=DIST_TAU)(params)
        tp_same("tau2", lambda: tau_new, lambda: tp_tau_step(
            tp_local, {"tokens": tau_tokens}, masks, sizes, DIST_LR)[0],
            out["tinyllama_tau2"]["collectives"])
        check(paths["distributed_tp_tau2"]["masked_update"]
              == DIST_TAU * n_leaves,
              f"[dist] the tensor-parallel τ = {DIST_TAU} step's "
              f"masked_update launches: {paths['distributed_tp_tau2']}")
        del tau_new, tp_tau_step

        # (d) mesh serving on the same params
        prefill, _ = make_prefill_step(model, mesh)(params, batch)
        ops.reset_launches()
        got = prefill(local, one)
        torch.cuda.synchronize()
        paths["distributed_prefill"] = dict(ops.LAUNCHES)
        with torch.no_grad():
            want = model.logits_seq(params, one)
        err = (got.float() - want.float()).abs().max().item()
        pre_ms = dist_time_ms(lambda: prefill(local, one))
        with torch.no_grad():
            plain_ms = dist_time_ms(lambda: model.logits_seq(params, one))
        out["prefill"] = {"max_abs_err": err, "ms": pre_ms,
                          "model_ms": plain_ms,
                          "launches": paths["distributed_prefill"]}
        tp_prefill, _ = make_prefill_step(tp_model, mesh)(params, batch)
        tp_same("prefill", lambda: got, lambda: tp_prefill(tp_local, one))
        del tp_prefill
        log(f"[dist] prefill 4 × {LONG_SEQ}: last-position logits against "
            f"Model.logits_seq {err:.3e}; {pre_ms:.2f} ms (Model alone "
            f"{plain_ms:.2f}); flash "
            f"{paths['distributed_prefill']['flash_attention']}"
            f"   [{card}]")
        check(err <= TOL["bfloat16"]
              and paths["distributed_prefill"]["flash_attention"] == L,
              "[dist] the mesh prefill's logits differ from Model.logits_seq")
        dd = DIST_DECODE
        gen.manual_seed(25)
        prompt = torch.randint(0, cfg.vocab_size, (dd["batch"], dd["prompt"]),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        total = dd["prompt"] + dd["steps"]
        serve, _ = make_serve_step(model, mesh)(
            params, model.init_cache(dd["batch"], total), dd["batch"])

        def greedy(step_fn):
            cache = model.init_cache(dd["batch"], total)
            tok, toks = prompt[:, 0], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(total - 1):
                nxt, cache = step_fn(tok, torch.tensor(t, dtype=torch.int32,
                                                       device="cuda"), cache)
                tok = prompt[:, t + 1] if t + 1 < dd["prompt"] else nxt
                if t + 1 >= dd["prompt"]:
                    toks.append(nxt)
            torch.cuda.synchronize()
            return (torch.stack(toks, 1),
                    (time.perf_counter() - t0) * 1e3 / (total - 1))

        def mesh_step(tok, pos, cache):
            nxt, _, cache = serve(local, tok, pos, cache)
            return nxt, cache

        def model_step(tok, pos, cache):
            logits, cache = model.decode_step(params, tok, pos, cache)
            return logits.argmax(-1).to(torch.int32), cache
        ops.reset_launches()
        mesh_toks, mesh_ms = greedy(mesh_step)
        paths["distributed_decode"] = dict(ops.LAUNCHES)
        model_toks, model_ms = greedy(model_step)
        same = bool(torch.equal(mesh_toks, model_toks))
        out["decode"] = {"same_tokens": same, "ms_per_step": mesh_ms,
                         "model_ms_per_step": model_ms}
        log(f"[dist] {dd['steps']} greedy decode steps (batch {dd['batch']}, "
            f"prompt {dd['prompt']} fed a token a step): the same tokens as "
            f"Model.decode_step: {same}; {mesh_ms:.2f} ms/step (Model alone "
            f"{model_ms:.2f})   [{card}]")
        check(same, "[dist] the mesh decode's tokens differ from "
                    "Model.decode_step's")
        tp_serve, (_, tp_cspecs) = make_serve_step(tp_model, mesh)(
            params, model.init_cache(dd["batch"], total), dd["batch"])

        def lockstep(serve_fn, local_params, shard):
            """The logits of every step of a prompt fed a token a step and
            then greedy tokens, through one serve step."""
            cache = shard(model.init_cache(dd["batch"], total))
            tok, logits = prompt[:, 0], {}
            for t in range(total - 1):
                nxt, logits[t], cache = serve_fn(
                    local_params, tok, torch.tensor(t, dtype=torch.int32,
                                                    device="cuda"), cache)
                tok = prompt[:, t + 1] if t + 1 < dd["prompt"] else nxt
            return logits
        plain_logits = lockstep(serve, local, lambda c: c)
        tp_same("decode", lambda: plain_logits, lambda: lockstep(
            tp_serve, tp_local, lambda c: shard_cache(
                tp_model, mesh, c, tp_cspecs)))
        del plain_logits, tp_serve, tp_local, tp_step
        del params, local, prefill, serve, step, sel_step, tau_step, client
        gc.collect()
        torch.cuda.empty_cache()
        mark("TinyLlama")

        # (b) full-width Mamba2-370M, and (slice 17) the same programs
        # with tensor parallelism on at model = 1
        def lockstep(fmodel, serve_fn, local_params, shard, prompt, total):
            """Every step's logits of ``prompt`` fed a token a step and
            then greedy tokens, through ``serve_fn(params, tok, pos,
            cache) -> (next, logits, cache)``."""
            cache = shard(fmodel.init_cache(prompt.shape[0], total))
            tok, logits = prompt[:, 0], {}
            for t in range(total - 1):
                nxt, logits[t], cache = serve_fn(
                    local_params, tok, torch.tensor(t, dtype=torch.int32,
                                                    device="cuda"), cache)
                tok = prompt[:, t + 1] if t + 1 < prompt.shape[1] else nxt
            return logits

        def model_serve(fmodel):
            def serve_fn(p, tok, pos, cache):
                logits, cache = fmodel.decode_step(p, tok, pos, cache)
                return logits.argmax(-1).to(torch.int32), logits, cache
            return serve_fn

        def tp_family(tag, label, fmodel, params, specs, local, plain, batch,
                      masks, sizes, lr, sel, want_l, collectives,
                      programs, seed):
            """Slice 17 for an ssm or hybrid model: its τ = 1 step again
            with ``tp_constraints`` at model = 1, bit-equal to ``plain``;
            then each of ``programs``: ``sel_upload`` over ``sel`` (held
            against the plain τ = 1 step) and τ = DIST_TAU (against
            ``Client.local_update`` + ``aggregate``), each again with
            tensor parallelism, bit-equal; mesh prefill of this client's
            rows against ``Model.logits_seq``; DIST_DECODE_TP greedy
            decode steps against ``Model.decode_step`` (the same tokens);
            both again with tensor parallelism, every logit bit-equal.
            ``specs`` and ``local`` are the plain step's; the new plain
            programs run unprofiled (``run_step(profiled=False)``)."""
            fcfg, frt = fmodel.cfg, fmodel.runtime
            tp_rt = dataclasses.replace(frt, tp_constraints=True)
            tp_model = Model(fcfg, tp_rt)
            tp_step, tp_specs = make_fl_train_step(tp_model, mesh)(params)
            tp_local = shard_params(tp_model, mesh, params, tp_specs)
            tp_same(f"{tag}_step", lambda: plain, lambda: tp_step(
                tp_local, batch, masks, sizes, lr)[0], collectives)
            del tp_step
            n_leaves = len(params["blocks"])
            rows = fmodel.cfg.n_layers
            if "sel_upload" in programs:
                sel_step, _ = make_fl_train_step(
                    Model(fcfg, dataclasses.replace(frt, sel_upload=True)),
                    mesh, sel_idx=sel)(params)
                sel_new, out[f"{tag}_sel_upload"] = run_step(
                    f"{label} τ = 1, sel_upload over rows {sel}", fmodel,
                    sel_step, local, batch, masks, sizes,
                    dist_collectives_want(fmodel, specs, sel_upload=True),
                    want_l, plain, params, sel, lr=lr, profiled=False)
                paths[f"distributed_{tag}_sel_upload"] = \
                    out[f"{tag}_sel_upload"]["launches"]
                tp_sel_step, _ = make_fl_train_step(
                    Model(fcfg, dataclasses.replace(tp_rt, sel_upload=True)),
                    mesh, sel_idx=sel)(params)
                tp_same(f"{tag}_sel_upload", lambda: sel_new,
                        lambda: tp_sel_step(tp_local, batch, masks, sizes,
                                            lr)[0],
                        out[f"{tag}_sel_upload"]["collectives"])
                del sel_new, sel_step, tp_sel_step
            if "tau" in programs:
                gen.manual_seed(seed)
                tau_tokens = torch.randint(
                    0, fcfg.vocab_size, (1, DIST_TAU) + tuple(
                        batch["tokens"].shape[1:]), device="cuda",
                    generator=gen, dtype=torch.int32)
                client = Client(fmodel)
                mask_row = masks[0].cpu().numpy()

                def tau_ref():
                    delta, _ = client.local_update(
                        params, {"tokens": tau_tokens[0]}, mask_row, lr)
                    return agg.apply_update(params, agg.aggregate(
                        [delta], masks, sizes, fcfg), lr)
                tau_step, _ = make_fl_train_step_tau(
                    fmodel, mesh, sel_idx=sel, tau=DIST_TAU)(params)
                want_tau = {k: DIST_TAU * v for k, v in want_l.items()}
                want_tau["masked_update"] = DIST_TAU * n_leaves
                tau_new, out[f"{tag}_tau2"] = run_step(
                    f"{label} τ = {DIST_TAU} over rows {sel}", fmodel,
                    tau_step, local, {"tokens": tau_tokens}, masks, sizes,
                    dist_collectives_want(fmodel, specs, tau=DIST_TAU,
                                          sel=sel),
                    want_tau, tau_ref(), params, sel, lr=lr, profiled=False)
                paths[f"distributed_{tag}_tau2"] = \
                    out[f"{tag}_tau2"]["launches"]
                tp_tau_step, _ = make_fl_train_step_tau(
                    tp_model, mesh, sel_idx=sel, tau=DIST_TAU)(params)
                tp_same(f"{tag}_tau2", lambda: tau_new, lambda: tp_tau_step(
                    tp_local, {"tokens": tau_tokens}, masks, sizes, lr)[0],
                    out[f"{tag}_tau2"]["collectives"])
                check(paths[f"distributed_tp_{tag}_tau2"]["masked_update"]
                      == DIST_TAU * n_leaves,
                      f"[dist] {label}: the tensor-parallel τ = {DIST_TAU} "
                      f"step's masked_update launches: "
                      f"{paths[f'distributed_tp_{tag}_tau2']}")
                del tau_new, tau_step, tp_tau_step, client
            one = {"tokens": batch["tokens"][0]}
            if "prefill" in programs:
                prefill, _ = make_prefill_step(fmodel, mesh)(params, one)
                ops.reset_launches()
                got = prefill(local, one)
                torch.cuda.synchronize()
                paths[f"distributed_{tag}_prefill"] = dict(ops.LAUNCHES)
                with torch.no_grad():
                    want = fmodel.logits_seq(params, one)
                err = (got.float() - want.float()).abs().max().item()
                out[f"{tag}_prefill"] = {
                    "max_abs_err": err,
                    "launches": paths[f"distributed_{tag}_prefill"]}
                log(f"[dist] {label} prefill {tuple(one['tokens'].shape)}: "
                    f"last-position logits against Model.logits_seq "
                    f"{err:.3e}; ssd_scan "
                    f"{paths[f'distributed_{tag}_prefill']['ssd_scan']}"
                    f"   [{card}]")
                check(err <= TOL["bfloat16"] and paths[
                    f"distributed_{tag}_prefill"]["ssd_scan"] == rows,
                      f"[dist] {label}: the mesh prefill's logits differ "
                      f"from Model.logits_seq")
                tp_prefill, _ = make_prefill_step(tp_model, mesh)(params,
                                                                  one)
                tp_same(f"{tag}_prefill", lambda: got,
                        lambda: tp_prefill(tp_local, one))
                del prefill, tp_prefill, got, want
            dd = DIST_DECODE_TP
            gen.manual_seed(seed + 1)
            prompt = torch.randint(0, fcfg.vocab_size,
                                   (dd["batch"], dd["prompt"]),
                                   device="cuda", generator=gen,
                                   dtype=torch.int32)
            total = dd["prompt"] + dd["steps"]
            serve, (_, c_specs) = make_serve_step(fmodel, mesh)(
                params, fmodel.init_cache(dd["batch"], total), dd["batch"])
            ops.reset_launches()
            plain_logits = lockstep(fmodel, serve, local, lambda c: c,
                                    prompt, total)
            torch.cuda.synchronize()
            paths[f"distributed_{tag}_decode"] = dict(ops.LAUNCHES)
            model_logits = lockstep(fmodel, model_serve(fmodel), params,
                                    lambda c: c, prompt, total)
            same = all(torch.equal(plain_logits[t].argmax(-1),
                                   model_logits[t].argmax(-1))
                       for t in plain_logits)
            out[f"{tag}_decode"] = {"same_tokens": same}
            log(f"[dist] {label}: {dd['steps']} greedy decode steps (batch "
                f"{dd['batch']}, prompt {dd['prompt']}): the same tokens as "
                f"Model.decode_step: {same}   [{card}]")
            mark(f"{label}: the plain decode against Model.decode_step")
            check(same, f"[dist] {label}: the mesh decode's tokens differ "
                        f"from Model.decode_step's")
            tp_serve, (_, tp_cspecs) = make_serve_step(tp_model, mesh)(
                params, fmodel.init_cache(dd["batch"], total), dd["batch"])
            tp_same(f"{tag}_decode", lambda: plain_logits, lambda: lockstep(
                fmodel, tp_serve, tp_local, lambda c: shard_cache(
                    tp_model, mesh, c, tp_cspecs), prompt, total))
            del plain_logits, model_logits, serve, tp_serve, tp_local

        cfg = get_arch("mamba2_370m")
        model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=SSM_SEQ))
        params = model.init(0)
        L = model.n_selectable
        gen.manual_seed(26)
        tokens = torch.randint(0, cfg.vocab_size, (1, 4, SSM_SEQ),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        mask_np = np.zeros((1, L), np.float32)
        mask_np[0, list(DIST_SSM_SEL)] = 1.0
        masks = torch.from_numpy(mask_np).cuda()
        step, specs = make_fl_train_step(model, mesh)(params)
        local = rules.shard_tree(params, specs, mesh)
        one = {"tokens": tokens[0]}
        ssd = {"ssd_scan": L, "ssd_scan_mma": L, "masked_update": 0,
               "layer_grad_norm": 0, "flash_attention": 0}
        plain, out["mamba2_step"] = run_step(
            "Mamba2-370M τ = 1", model, step, local, {"tokens": tokens},
            masks, sizes, dist_collectives_want(model, specs), ssd,
            single_host_step(model, params, one, masks, sizes, DIST_SSM_LR),
            params, DIST_SSM_SEL, lr=DIST_SSM_LR,
            ref_fn=lambda: single_host_step(model, params, one, masks, sizes,
                                            DIST_SSM_LR))
        paths["distributed_mamba2_step"] = out["mamba2_step"]["launches"]
        tp_family("mamba2", "Mamba2-370M", model, params, specs, local,
                  plain, {"tokens": tokens}, masks, sizes, DIST_SSM_LR,
                  DIST_SSM_SEL, ssd, out["mamba2_step"]["collectives"],
                  ("sel_upload", "tau", "prefill"), 27)
        del params, local, step, plain
        gc.collect()
        torch.cuda.empty_cache()
        mark("Mamba2-370M")

        # (f) slice 17: Zamba2-7B (full width, the rounds' depth), its
        # plain step against the single-host one, then the step and decode
        # with tensor parallelism at model = 1
        cfg = dataclasses.replace(get_arch("zamba2_7b"),
                                  n_layers=HYBRID_ROUND_LAYERS)
        model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=SSM_SEQ))
        params = model.init(0)
        mark("Zamba2-7B's params")
        L = model.n_selectable
        sites = cfg.n_layers // cfg.attn_every
        gen.manual_seed(28)
        tokens = torch.randint(0, cfg.vocab_size, (1, 4, SSM_SEQ),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        mask_np = np.zeros((1, L), np.float32)
        mask_np[0, list(DIST_HYBRID_SEL)] = 1.0
        masks = torch.from_numpy(mask_np).cuda()
        step, specs = make_fl_train_step(model, mesh)(params)
        local = rules.shard_tree(params, specs, mesh)
        one = {"tokens": tokens[0]}
        hyb = {"ssd_scan": cfg.n_layers, "ssd_scan_mma": cfg.n_layers,
               "flash_attention": sites, "flash_attention_bwd": sites,
               "flash_attention_mma": sites, "masked_update": 0,
               "layer_grad_norm": 0}
        plain, out["zamba2_step"] = run_step(
            f"Zamba2-7B (depth {cfg.n_layers}) τ = 1", model, step, local,
            {"tokens": tokens}, masks, sizes,
            dist_collectives_want(model, specs), hyb,
            single_host_step(model, params, one, masks, sizes,
                             DIST_HYBRID_LR),
            params, DIST_HYBRID_SEL, lr=DIST_HYBRID_LR,
            ref_fn=lambda: single_host_step(model, params, one, masks, sizes,
                                            DIST_HYBRID_LR))
        paths["distributed_zamba2_step"] = out["zamba2_step"]["launches"]
        tp_family("zamba2", f"Zamba2-7B (depth {cfg.n_layers})", model,
                  params, specs, local, plain, {"tokens": tokens}, masks,
                  sizes, DIST_HYBRID_LR, DIST_HYBRID_SEL, hyb,
                  out["zamba2_step"]["collectives"], (), 29)
        del params, local, step, plain
        gc.collect()
        torch.cuda.empty_cache()
        mark("Zamba2-7B")

        # (g) slice 18: DeepSeek-V2-Lite (full width, the moe rounds'
        # depth), each program plain and with tensor parallelism at model =
        # 1, bit-equal with the same collectives, none profiled
        moe_programs(card, mesh, gen, out, paths, tp_same)
        mark("DeepSeek-V2-Lite")

        # (h) slice 19: PaliGemma-3B (full width and depth), its first run
        # on the card: each program plain and with tensor parallelism at
        # model = 1, bit-equal with the same collectives, none profiled
        vlm_programs(card, mesh, gen, out, paths, tp_same)
        mark("PaliGemma-3B")

        # (i) slice 20: whisper-medium (full width and depth), its first
        # run on the mesh: each program plain and with tensor parallelism
        # at model = 1, bit-equal with the same collectives, none profiled
        audio_programs(card, mesh, gen, out, paths, tp_same)
        mark("whisper-medium")

        # (c) reduced f32: the card against the CPU (gloo, a child process)
        ops.reset_launches()
        card_new = dist_reduced_step("cuda")
        paths["distributed_reduced_f32"] = dict(ops.LAUNCHES)
        check(paths["distributed_reduced_f32"]["flash_attention_simt"] > 0,
              f"[dist] the reduced card step took no kernel: "
              f"{paths['distributed_reduced_f32']}")
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cpu_step.npz")
        rc, text = run_child([sys.executable, os.path.abspath(__file__),
                              "--dist-cpu-step", path], timeout=300)
        check(rc == 0, f"[dist] the CPU step failed:\n{text[-3000:]}")
        cpu = dict(np.load(path))
    from repro_torch.tree import tree_items
    errs = [float(np.abs(v - cpu["/".join(path)]).max())
            for path, v in tree_items(card_new)]
    out["reduced_card_vs_cpu"] = max(errs)
    log(f"[dist] reduced f32 TinyLlama step (3 layers, d 64): card (NCCL) "
        f"against CPU (gloo) {max(errs):.3e} (limit {DIST_CPU_TOL:g})"
        f"   [{card}]")
    check(max(errs) <= DIST_CPU_TOL, "[dist] the card's reduced step differs "
                                     "from the CPU's")
    mark("the reduced step, card and CPU")

    # (e) the CLI, its own world under torch.distributed.run
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    rc, text = run_child([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", "1", "-m",
                          "repro_torch.launch.train", "--rounds",
                          str(CLI_ROUNDS)], timeout=300, env=env)
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"[dist] the train CLI failed:\n{text[-3000:]}")
    losses = [float(line.split("loss=")[1].split()[0])
              for line in text.splitlines() if line.startswith("[round ")]
    launched = [line for line in text.splitlines()
                if line.startswith("[launches] ")]
    check(len(losses) == CLI_ROUNDS and all(map(math.isfinite, losses))
          and len(launched) == 1, f"[dist] the CLI's output:\n{text[-3000:]}")
    cli = {k: 0 for k in ops.LAUNCHES}
    cli.update(_json.loads(launched[0][len("[launches] "):]))
    paths["distributed_cli"] = cli
    check(cli["layer_grad_norm"] > 0, f"[dist] the CLI's probe took no "
                                      f"layer_grad_norm launch: {cli}")
    out["cli"] = {"losses": losses, "s": cli_s, "launches": cli}
    log(f"[dist] train CLI, {CLI_ROUNDS} rounds under torch.distributed.run "
        f"(reduced, world 1): losses {losses}, {cli_s:.1f} s with its "
        f"launcher; launches {({k: v for k, v in cli.items() if v})}"
        f"   [{card}]")
    out["paths"] = paths
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] phase {out['phase_s']:.1f} s   [{card}]")
    return out


# ---------------------------------------------------------------------------
# Slice 16: tensor parallelism over 'model' (the dense family)
# ---------------------------------------------------------------------------

TP_BLOCK_MS = (2, 16)       # model sizes of the block's split on the card
# The summed partials of a full-width bf16 block against the whole block:
# each partial is bf16 products over its share of the heads and columns,
# summed by hand in f32 and rounded to bf16 once, where the whole block
# rounds one product over all of them; autograd adds the gradients of
# shared inputs (x, the norms, a kv head under "kv_shared") from M
# branches in bf16.  Held relative to the largest magnitude of the whole
# block's tensor (a reduced bf16 block on the CPU parted by up to 1.1e-2 at
# M = 4); a wrong head, column or vocabulary mapping parts by order 1.
TP_BLOCK_RTOL = 5e-2


def tp_block_split(cfg, row: dict, x, dy, M: int, causal: bool = True,
                   enc=None):
    """One dense block's parallel form at M model coordinates, computed in
    this process: each coordinate's attention partial
    (``blocks.attention_fwd`` on ``TPLayout.compute_slice`` of the full
    leaves, a ``ModelAxis`` whose f and g are the identity) in turn, summed
    by hand, then (whisper's decoder block, ``enc`` its encoder output)
    the cross-attention's over each coordinate's cross k/v
    (``blocks.make_cross_kv`` of its ``xattn_`` slices), then the MLP's
    on the result.  Returns the output and the gradients of ``x`` (and of
    ``enc``) and of each full leaf for the cotangent ``dy``."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models.model import _take
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    layout = rules.TPLayout(cfg, M)
    leaves = {k: v.detach().requires_grad_() for k, v in row.items()}
    xin = x.detach().requires_grad_()
    ins = [xin] if enc is None else [xin, enc.detach().requires_grad_()]
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def one(sub, p, inp, ax):
        if sub == "attn":
            return B.attention_fwd(_take(p, "attn_"), inp, cfg,
                                   positions=pos, causal=causal, tp=ax)
        if sub == "xattn":
            xp = _take(p, "xattn_")
            return B.attention_fwd(xp, inp, cfg, positions=pos,
                                   cross_kv=B.make_cross_kv(xp, ins[1], cfg),
                                   causal=False, tp=ax)
        return B.mlp_fwd(_take(p, "mlp_"), inp, cfg, tp=ax)

    def summed(sub, inp):
        n = M if sub == "mlp" or layout.mode != "replicated" else 1
        tot = None
        for m in range(n):
            p = {k: layout.compute_slice(k, v, m) for k, v in leaves.items()}
            y = one(sub, p, inp, ModelAxis(layout, m)).float()
            tot = y if tot is None else tot + y
        return tot.to(inp.dtype)
    h = xin + summed("attn", xin)
    if enc is not None:
        h = h + summed("xattn", h)
    out = h + summed("mlp", h)
    grads = torch.autograd.grad(out, [*ins, *leaves.values()], dy)
    return out.detach(), dict(zip(["x", "enc"][:len(ins)] + list(leaves),
                                  grads))


def tp_ssm_block_split(cfg, row: dict, x, dy, M: int):
    """One Mamba2 block's parallel form at M model coordinates, computed
    in this process (``ssd.mamba2_fwd`` on ``TPLayout.compute_slice`` of
    the full leaves, a ``ModelAxis`` whose f and g are the identity), in
    two passes, because the gate norm's statistic couples the
    coordinates: the first records each coordinate's Σ y²; their sum S
    stays in the graph, and the second pass is given S through
    ``reduce_stat`` and sums the partials by hand, so the gradients
    through both passes add up to the true ones.  Returns x + the block
    and the gradients of ``x`` and of each full leaf for ``dy``."""
    import torch
    from repro_torch.models import ssd as SSD
    from repro_torch.models.model import _take
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    layout = rules.TPLayout(cfg, M)
    leaves = {k: v.detach().requires_grad_() for k, v in row.items()}
    xin = x.detach().requires_grad_()
    slices = [_take({k: layout.compute_slice(k, v, m)
                     for k, v in leaves.items()}, "ssm_") for m in range(M)]
    stats = []

    def record(st):
        stats.append(st)
        return st
    for m in range(M):
        SSD.mamba2_fwd(slices[m], xin, cfg,
                       tp=ModelAxis(layout, m, reduce_stat=record))
    total = torch.stack(stats).sum(0)
    tot = None
    for m in range(M):
        y, _ = SSD.mamba2_fwd(slices[m], xin, cfg, tp=ModelAxis(
            layout, m, reduce_stat=lambda st: total))
        tot = y.float() if tot is None else tot + y.float()
    out = xin + tot.to(xin.dtype)
    grads = torch.autograd.grad(out, [xin, *leaves.values()], dy)
    return out.detach(), dict(zip(["x", *leaves], grads))


# Slice 17: the blocks split by hand on the card (arch, kind, batch, seq,
# model sizes): TinyLlama's dense block (slice 16's), a Mamba2 block of
# Mamba2-370M (2 / 16 of 32 SSD heads a coordinate) and of Zamba2-7B (56 /
# 7 of 112), and Zamba2's shared attention+MLP block at 16 (2 of 32 heads
# of 112, "heads"); slice 20: whisper-medium's encoder block (a dense
# block of the audio family: non-causal, 4 × 1500 frames) and its decoder
# block (4 × AUDIO_SEQ, causal self-attention, then cross-attention over
# a 1500-row encoder output), 8 and 1 of 16 heads and 2048 and 256 of the
# MLP's 4096 columns a coordinate at M = 2 and 16
TP_BLOCKS = (("tinyllama_1_1b", "dense", 4, LONG_SEQ, TP_BLOCK_MS),
             ("mamba2_370m", "ssm", 4, SSM_SEQ, TP_BLOCK_MS),
             ("zamba2_7b", "ssm", 4, SSM_SEQ, TP_BLOCK_MS),
             ("zamba2_7b", "attn_mlp_shared", 4, SSM_SEQ, (16,)),
             ("whisper_medium", "dense", 4, 1500, TP_BLOCK_MS),
             ("whisper_medium", "encdec", 4, AUDIO_SEQ, TP_BLOCK_MS))


# Slice 18: the moe family's blocks split by hand on the card (arch, kind,
# batch, seq, model sizes, prefix): DeepSeek-V2-Lite's moe block
# expert-parallel (32 and 4 of 64 experts a coordinate; slice 19: MLA 8
# and 1 of 16 heads, over the whole latent) and its dense0 (the MLP of
# 11 264 columns, 704 a coordinate), Grok-1's moe block at full width (one
# layer: 9.7 GB of bf16 experts), expert-parallel at 2 (4 of 8 experts)
# and on ff at 16 (2048 of 32 768 columns), its attention 24/4 and 3/1
# heads a coordinate; slice 19: PaliGemma-3B's block over its 256-patch
# prefix (the prefix-LM on the plain path), "kv_shared" at 2 and 8 (4 and
# 1 of 8 query heads over its one kv head), attention whole at 16 (8 heads
# do not divide) with the MLP split (1024 of 16 384 columns).  Each
# sub-block is held on the same input as the whole one (see
# tp_sub_block_split): the router's bf16 logits tie often at full width,
# and a tie broken by the summed attention's rounding would route a token
# elsewhere.
TP_SUB_BLOCKS = (("deepseek_v2_lite_16b", "moe", 4, LONG_SEQ, TP_BLOCK_MS, 0),
                 ("deepseek_v2_lite_16b", "moe_dense0", 4, LONG_SEQ, (16,),
                  0),
                 ("grok_1_314b", "moe", 4, LONG_SEQ, TP_BLOCK_MS, 0),
                 ("paligemma_3b", "dense", 4, 512, (2, 8, 16), 256))
TP_SUB_RTOL = 2e-2


def tp_sub_block_split(cfg, kind: str, row: dict, x, h, dy, M, prefix=0):
    """One block's two sub-blocks, whole (M None) or at M model
    coordinates computed in this process (``TPLayout.compute_slice`` of
    the full leaves, a ``ModelAxis`` whose f and g are the identity, the
    partials summed by hand in f32): the attention on ``x`` (the moe
    family's through ``_moe_attention``, MLA's by heads; otherwise
    ``blocks.attention_fwd``, causal with a bidirectional ``prefix``) and
    the moe layer (or the MLP) on ``h``, the same input whole and split,
    so that both route alike; a ``"replicated"`` attention once, whole.
    The split's inputs and the leaves several coordinates read whole (the
    norms, the router, MLA's latent projections, a ``"kv_shared"`` kv
    head) reach the coordinates through one f32 copy each, so that their
    gradients, like the outputs, are summed in f32 and rounded once.
    Returns ({"attn": x + attention, "ffn": h + the layer}, the gradients
    of ``x``, ``h`` and each full leaf for the cotangent ``dy`` on
    both)."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import _moe_attention, _take
    from repro_torch.sharding import rules
    from repro_torch.sharding.tensor_parallel import ModelAxis
    leaves = {k: v.detach().requires_grad_() for k, v in row.items()}
    xin, hin = x.detach().requires_grad_(), h.detach().requires_grad_()
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    attn = dict(positions=pos, window=0, seq_chunk=x.shape[1])

    def attention(p, tp, inp):
        if cfg.family == "moe":
            return _moe_attention(_take(p, "attn_"), inp, cfg, tp=tp, **attn)
        return B.attention_fwd(_take(p, "attn_"), inp, cfg, causal=True,
                               prefix_len=prefix, tp=tp, **attn)

    def ffn(p, tp, inp):
        if kind == "moe":
            return MOE.moe_fwd(_take(p, "moe_"), inp, cfg, tp=tp)[0]
        return B.mlp_fwd(_take(p, "mlp_"), inp, cfg, tp=tp)
    if M is None:
        a = attention(leaves, None, xin)
        f = ffn(leaves, None, hin)
    else:
        layout = rules.TPLayout(cfg, M)
        n = 1 if layout.mode == "replicated" else M
        shared = ("attn_ln", "attn_kv_ln", "attn_w_dkv", "attn_w_krope",
                  "mlp_ln", "moe_ln", "moe_router") + (
            ("attn_wk", "attn_wv") if layout.mode == "kv_shared" else ())
        whole = {k: v.float() for k, v in leaves.items() if k in shared}
        x32, h32 = xin.float(), hin.float()
        a = f = 0.0
        for m in range(M):
            tp = ModelAxis(layout, m)
            p = {k: layout.compute_slice(
                k, whole[k].to(v.dtype) if k in whole else v, m)
                for k, v in leaves.items()}
            if m < n:
                a = a + attention(p, tp, x32.to(x.dtype)).float()
            f = f + ffn(p, tp, h32.to(h.dtype)).float()
        a, f = a.to(x.dtype), f.to(x.dtype)
    outs = {"attn": xin + a, "ffn": hin + f}
    grads = torch.autograd.grad(list(outs.values()),
                                [xin, hin, *leaves.values()], [dy, dy])
    return ({k: v.detach() for k, v in outs.items()},
            dict(zip(["x", "h", *leaves], grads)))


def phase_tp_sub_block(card: str, out: dict, paths: dict) -> None:
    """Slices 18–19 in ``phase_tp_block``: each block of TP_SUB_BLOCKS at
    full width (bf16, random weights, seed 0, the norms' scales drawn away
    from 0), forward and backward, whole and at each model size M
    (:func:`tp_sub_block_split`): both sub-blocks' outputs, the inputs'
    gradients and every leaf's within TP_SUB_RTOL of the whole's largest
    magnitude.  Grok's attention must launch the tensor-core flash kernels
    M times each way, MLA and PaliGemma's prefix-LM none (the split's
    launches are the paths ``tp_block_<arch>_<kind>_m<M>``)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models.model import _block_shapes
    from repro_torch.sharding import rules
    for arch, kind, b, s, sizes, prefix in TP_SUB_BLOCKS:
        cfg = get_arch(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        row = {k: v[0] for k, v in B.init_stacked(
            gen, _block_shapes(cfg, kind), 1, torch.bfloat16,
            "cuda").items()}
        for k in ("attn_ln", "attn_kv_ln", "mlp_ln", "moe_ln"):
            if k in row:
                row[k] = (torch.randn(row[k].shape, generator=gen,
                                      device="cuda") * 0.1).to(torch.bfloat16)
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        h = torch.randn(x.shape, generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(x.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_g = tp_sub_block_split(cfg, kind, row, x, h, dy, None,
                                          prefix)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        for M in sizes:
            layout = rules.TPLayout(cfg, M)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            got, got_g = tp_sub_block_split(cfg, kind, row, x, h, dy, M,
                                            prefix)
            torch.cuda.synchronize()
            split_s = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            tag = f"{arch}_{kind}_m{M}"
            paths[f"tp_block_{tag}"] = launches

            def rel(a, b_):
                """max |a − b| / max |b|, by chunks of 2^26 elements (a
                Grok expert leaf is 3.2 G elements)."""
                num = den = 0.0
                for ca, cb in zip(a.reshape(-1).split(1 << 26),
                                  b_.reshape(-1).split(1 << 26)):
                    num = max(num, (ca.float() - cb.float()).abs().max()
                              .item())
                    den = max(den, cb.float().abs().max().item())
                return num / den
            pairs = {**{k: (got[k], want[k]) for k in want},
                     **{k: (got_g[k], want_g[k]) for k in want_g}}
            errs = {k: rel(*v) for k, v in pairs.items()}
            worst = max(errs, key=errs.get)
            q, kv = layout.q_heads(0)[1], layout.kv_heads(0)[1]
            e0, ne = layout.experts(0) if kind == "moe" else (0, 0)
            split = (f"{ne} of {cfg.n_experts} experts whole"
                     if layout.expert_parallel else
                     f"all {cfg.n_experts} experts on "
                     f"{cfg.d_ff // M} of {cfg.d_ff} ff columns")
            if kind != "moe":
                split = (f"the MLP's {row['mlp_wo'].shape[0] // M} of "
                         f"{row['mlp_wo'].shape[0]} columns")
            share = f"attention {layout.mode}: {q} query / {kv} kv heads; "
            share += split
            out[tag] = {"mode": layout.mode, "q_heads": q, "kv_heads": kv,
                        "expert_parallel": layout.expert_parallel,
                        "experts": ne, "rel_err": errs, "launches": launches,
                        "whole_s": whole_s, "split_s": split_s}
            log(f"[tp-block] {cfg.name} {kind} block, {b} × {s}"
                f"{f' (prefix {prefix})' if prefix else ''}, bf16, M = "
                f"{M} ({share} a coordinate): the hand-summed partials "
                f"against the whole, relative to its largest magnitude: "
                f"attention {errs['attn']:.3e}, ffn {errs['ffn']:.3e}, dx "
                f"{errs['x']:.3e}, dh {errs['h']:.3e}, worst {worst} "
                f"{errs[worst]:.3e} (limit {TP_SUB_RTOL:g}); launches "
                f"{({k: v for k, v in launches.items() if v})}; whole "
                f"{whole_s:.2f} s, split {split_s:.2f} s   [{card}]")
            check(max(errs.values()) <= TP_SUB_RTOL and all(
                math.isfinite(e) for e in errs.values()),
                f"[tp-block] {cfg.name} {kind}, M = {M}: the split block "
                f"disagrees with the whole: {errs}")
            flash = 0 if cfg.use_mla or prefix else M
            check(launches["flash_attention_mma"] == flash
                  and launches["flash_attention_bwd_mma"] == flash
                  and launches["flash_attention"] == flash,
                  f"[tp-block] {cfg.name}, M = {M}: want {flash} "
                  f"tensor-core flash launches each way (one a coordinate, "
                  f"none for MLA or a prefix-LM): {launches}")
            del got, got_g
        del row, want, want_g, x, h, dy
        gc.collect()
        torch.cuda.empty_cache()


def phase_tp_block(card: str) -> dict:
    """Slice 16 (b), and slice 17: the split itself on the card.  Each
    block of TP_BLOCKS at full width (bf16, random weights, seed 0, the
    norms' scales drawn away from 0) on its round's batch, forward and
    backward, at each model size M: each coordinate's partial in turn,
    the sums by hand (``tp_block_split`` for a dense block,
    ``tp_ssm_block_split`` for a Mamba2 block), against the whole block
    (``models.model._dense_block_fwd``, x + ``ssd.mamba2_fwd``): the
    output, the input's gradient and every leaf's within TP_BLOCK_RTOL of
    the largest magnitude (whisper's decoder block: the encoder output's
    gradient too).  A dense block's attention (whisper's encoder block's
    non-causal one, its decoder block's causal self-attention; the
    cross-attention is plain) must launch the
    tensor-core flash kernels M times each way; a Mamba2 block's scan the
    tensor-core ``ssd_scan`` 2 M times (both passes).  The split's
    launches are the paths ``tp_block_m<M>`` (TinyLlama) and
    ``tp_block_<arch>_<kind>_m<M>``.  Then (slices 18–19) the moe
    family's blocks and PaliGemma's, :func:`phase_tp_sub_block`."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models import ssd as SSD
    from repro_torch.models.model import (_block_shapes, _dense_block_fwd,
                                          _take)
    from repro_torch.sharding import rules
    t_phase = time.perf_counter()
    out, paths = {}, {}
    for arch, kind, b, s, sizes in TP_BLOCKS:
        cfg = get_arch(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        row = {k: v[0] for k, v in B.init_stacked(
            gen, _block_shapes(cfg, kind), 1, torch.bfloat16,
            "cuda").items()}
        # the norms' scales away from 0, so their gradients are not vacuous
        for k in ("attn_ln", "xattn_ln", "mlp_ln", "ssm_ln", "ssm_gate_ln"):
            if k in row:
                row[k] = (torch.randn(row[k].shape, generator=gen,
                                      device="cuda") * 0.1).to(torch.bfloat16)
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(x.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        # whisper: its encoder block attends over all frames; its decoder
        # block's cross-attention reads an encoder output of enc_seq rows
        causal = cfg.family != "audio" or kind == "encdec"
        enc = (torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen,
                           device="cuda").to(torch.bfloat16)
               if kind == "encdec" else None)
        leaves = {k: v.detach().requires_grad_() for k, v in row.items()}
        ins = [x.detach().requires_grad_()]
        if enc is not None:
            ins.append(enc.detach().requires_grad_())
        pos = torch.arange(s, dtype=torch.int32, device="cuda")
        if kind == "ssm":
            want = ins[0] + SSD.mamba2_fwd(_take(leaves, "ssm_"), ins[0],
                                           cfg)[0]
        else:
            want = _dense_block_fwd(
                leaves, ins[0], cfg, positions=pos, window=0, causal=causal,
                cross_kv=None if enc is None else B.make_cross_kv(
                    _take(leaves, "xattn_"), ins[1], cfg))
        want_g = dict(zip(["x", "enc"][:len(ins)] + list(leaves),
                          torch.autograd.grad(
                              want, [*ins, *leaves.values()], dy)))
        name = {"attn_mlp_shared": f"{cfg.name} shared",
                "encdec": f"{cfg.name} decoder"}.get(
            kind, f"{cfg.name} encoder" if cfg.family == "audio"
            else cfg.name)
        for M in sizes:
            layout = rules.TPLayout(cfg, M)
            torch.cuda.synchronize()
            ops.reset_launches()
            if kind == "ssm":
                got, got_g = tp_ssm_block_split(cfg, row, x, dy, M)
            else:
                got, got_g = tp_block_split(cfg, row, x, dy, M,
                                            causal=causal, enc=enc)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            tag = (f"m{M}" if arch == "tinyllama_1_1b"
                   else f"{arch}_{kind}_m{M}")
            paths[f"tp_block_{tag}"] = launches

            def rel(a, b_):
                return ((a.float() - b_.float()).abs().max()
                        / b_.float().abs().max()).item()

            def rel2(a, b_):
                return ((a.float() - b_.float()).norm()
                        / b_.float().norm()).item()
            pairs = {"out": (got, want.detach()),
                     **{k: (got_g[k], want_g[k]) for k in want_g}}
            errs = {k: rel(*v) for k, v in pairs.items()}
            worst = max(errs, key=errs.get)
            if kind == "ssm":
                share = (f"{layout.ssm_heads(0)[1]} of "
                         f"{cfg.resolved_ssm_heads} SSD heads")
                res = {"ssm_heads": layout.ssm_heads(0)[1]}
            else:
                q, kv = layout.q_heads(0)[1], layout.kv_heads(0)[1]
                share = f"{layout.mode}: {q} query / {kv} kv heads"
                res = {"mode": layout.mode, "q_heads": q, "kv_heads": kv}
            res.update(rel_err=errs, launches=launches,
                       rel_l2_err={k: rel2(*v) for k, v in pairs.items()})
            out[tag] = res
            over, denc = "", ""
            if enc is not None:
                over = f" over {cfg.enc_seq} encoder rows"
                denc = f", denc {errs['enc']:.3e}"
            log(f"[tp-block] {name} {kind} block, {b} × {s}{over}, bf16, M "
                f"= {M} ({share} a coordinate): the hand-summed partials "
                f"against the whole block, relative to its largest "
                f"magnitude: out {errs['out']:.3e}, dx {errs['x']:.3e}"
                f"{denc}, worst {worst} "
                f"{errs[worst]:.3e} (limit {TP_BLOCK_RTOL:g}; norm-wise, "
                f"worst {max(res['rel_l2_err'].values()):.3e}); launches "
                f"{({k: v for k, v in launches.items() if v})}   [{card}]")
            check(max(errs.values()) <= TP_BLOCK_RTOL and all(
                math.isfinite(e) for e in errs.values()),
                f"[tp-block] {name} {kind}, M = {M}: the split block "
                f"disagrees with the whole: {errs}")
            if kind == "ssm":
                check(launches["ssd_scan"] == 2 * M
                      and launches["ssd_scan_mma"] == 2 * M,
                      f"[tp-block] {name}, M = {M}: each coordinate's scan "
                      f"must launch the tensor-core ssd_scan kernel once a "
                      f"pass: {launches}")
            else:
                check(launches["flash_attention_mma"] == M
                      and launches["flash_attention_bwd_mma"] == M
                      and launches["flash_attention"] == M,
                      f"[tp-block] {name}, M = {M}: each coordinate's "
                      f"attention must launch the tensor-core flash kernels "
                      f"once forward and once backward: {launches}")
            del got, got_g
        del row, leaves, ins, want, want_g, x, dy, enc
        torch.cuda.empty_cache()
    phase_tp_sub_block(card, out, paths)
    out["paths"] = paths
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp-block] phase {out['phase_s']:.1f} s   [{card}]")
    return out


# ---------------------------------------------------------------------------
# Slice 15: the dry run (repro_torch.launch.dryrun), held against the card
# ---------------------------------------------------------------------------

# The card check's programs: (arch, input shape, the global batch cut to
# fit one card: 1 client × 4 × 4096 tokens to train, 2 × 32 768 to
# prefill, 8 rows over a 32 768 cache to decode).
DRYRUN_CARD = (("tinyllama_1_1b", "train_4k", 4),
               ("tinyllama_1_1b", "prefill_32k", 2),
               ("tinyllama_1_1b", "decode_32k", 8),
               ("mamba2_370m", "train_4k", 4),
               ("mamba2_370m", "prefill_32k", 2),
               ("mamba2_370m", "decode_32k", 8))
# Slice 16: TinyLlama's three again under tensor parallelism (model = 1);
# slice 17: Mamba2's three too
DRYRUN_CARD_TP = DRYRUN_CARD
# The archs whose --opt (tensor-parallel) programs the dry run runs: the
# dense family, (slice 17) the ssm and hybrid ones, (slice 18) the moe,
# (slice 19) the vlm family's language model and (slice 20) the audio one
DRYRUN_TP_ARCHS = ("tinyllama_1_1b", "smollm_360m", "codeqwen1_5_7b",
                   "gemma_7b", "mamba2_370m", "zamba2_7b",
                   "deepseek_v2_lite_16b", "grok_1_314b", "paligemma_3b",
                   "whisper_medium")
# What --opt must at least give a train_4k step on 16 × 16, per device,
# against the step replicated over 'model': (argument bytes ÷, FLOPs ÷,
# useful share), None where not held.  SmolLM's attention (15 heads) and
# Mamba2's vocabulary (50 280 rows do not divide by 16: the embedding and
# the tied head whole on every rank) stay replicated; DeepSeek's MLA
# splits by heads over a latent whole on every rank (the meta count:
# FLOPs ÷13.74, useful 0.5344); PaliGemma's 8 heads do not divide by 16,
# so its attention and the full prefix-LM scores stay whole (÷3.78,
# 0.1873); whisper's vocabulary (51 865 rows) and the client's 1500 stub
# frames stay whole on every rank (the meta count: argument ÷6.42, FLOPs
# ÷10.14, useful 0.5219).
DRYRUN_TP_MIN = {"smollm_360m": (8, None, None),
                 "mamba2_370m": (4, 4, 0.25),
                 "deepseek_v2_lite_16b": (8, 10, 0.4),
                 "paligemma_3b": (8, 3, 0.15),
                 "whisper_medium": (6, 8, 0.45)}
# A device's memory, against which the --opt programs' argument and peak
# temporary bytes are read
DEVICE_GB = 80.0
DRYRUN_TP_MIN_DEFAULT = (8, 8, 0.5)
DRYRUN_TP_OPTS = ["tp", "rematsc", "moelocal"]
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
DRYRUN_META = os.path.join(DRYRUN_DIR, "card_check_meta.json")
DRYRUN_TIMEOUT = 900        # seconds a child may take, from its start


def dryrun_card_shape(shape_name: str, batch: int):
    from repro_torch.configs.base import INPUT_SHAPES
    return dataclasses.replace(INPUT_SHAPES[shape_name], global_batch=batch)


def dryrun_card_programs():
    """(name, arch, shape name, batch, runtime) of the card check's
    programs: DRYRUN_CARD's, then DRYRUN_CARD_TP's with tensor parallelism
    on (names ending in ``/tp``)."""
    from repro_torch.configs.base import RuntimeConfig
    for arch, shape_name, batch in DRYRUN_CARD:
        yield f"{arch}/{shape_name}", arch, shape_name, batch, RuntimeConfig()
    for arch, shape_name, batch in DRYRUN_CARD_TP:
        yield (f"{arch}/{shape_name}/tp", arch, shape_name, batch,
               RuntimeConfig(tp_constraints=True))


def dryrun_meta(out_path: str) -> int:
    """The dry side of the card check (``--dryrun-meta``): the programs of
    :func:`dryrun_card_programs` on a fake world of 1 (``dry_mesh``, the
    meta device), their fact rows written to ``out_path``."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.dryrun import build_program, program_facts
    from repro_torch.launch.mesh import dry_mesh
    torch.set_num_threads(1)
    rows = {}
    with dry_mesh((1, 1), ("data", "model")) as mesh:
        for name, arch, shape_name, batch, runtime in dryrun_card_programs():
            t0 = time.perf_counter()
            prog = build_program(get_arch(arch),
                                 dryrun_card_shape(shape_name, batch), mesh,
                                 runtime)
            rows[name] = program_facts(name, prog).to_dict()
            print(f"[dryrun-meta] {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    with open(out_path, "w") as fh:
        json.dump(rows, fh)
    return 0


class DryrunChildren:
    """``phase_dryrun``'s CPU processes, started together at the beginning
    of the script (``CUDA_VISIBLE_DEVICES`` empty: they never touch the
    card): the CLI over every pair on 16 × 16, over TinyLlama's on
    2 × 16 × 16, the ``--opt`` programs and the card check's dry side, at
    the lowest scheduling priority (``os.nice(19)``): they have most of
    the script's run to finish, while its host-bound phases beside them
    do not wait well.  Each writes its output to a log under DRYRUN_DIR;
    a thread per child, started once every child is, notes when it
    ended."""

    def __init__(self):
        import shutil
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
        os.makedirs(DRYRUN_DIR)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        cli = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--continue-on-error", "--out", DRYRUN_DIR]
        cmds = {"single_pod": cli + ["--all"],
                "multi_pod": cli + ["--all", "--multi-pod", "--arch",
                                    "tinyllama_1_1b"],
                "card_meta": [sys.executable, os.path.abspath(__file__),
                              "--dryrun-meta", DRYRUN_META],
                # slice 16: the dense family's tensor-parallel programs
                **{f"opt_{a}": cli + ["--all", "--opt", "--arch", a]
                   for a in DRYRUN_TP_ARCHS}}
        self.t0 = time.perf_counter()
        self.procs, self.logs, self.ended = {}, {}, {}
        for tag, cmd in cmds.items():
            self.logs[tag] = os.path.join(DRYRUN_DIR, f"{tag}.log")
            with open(self.logs[tag], "w") as out:
                self.procs[tag] = subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True,
                    preexec_fn=lambda: os.nice(19))
        for tag in cmds:
            threading.Thread(target=self._note_end, args=(tag,),
                             daemon=True).start()

    def _note_end(self, tag: str) -> None:
        self.procs[tag].wait()
        self.ended[tag] = time.perf_counter() - self.t0

    def wait(self) -> dict:
        """Wait for every child (at most DRYRUN_TIMEOUT from the start);
        returns {tag: seconds from the start to its end}.  Raises on a
        child that failed or did not end."""
        for tag, p in self.procs.items():
            left = DRYRUN_TIMEOUT - (time.perf_counter() - self.t0)
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                self.stop()
                raise SmokeFailure(f"[dryrun] {tag} did not end in "
                                   f"{DRYRUN_TIMEOUT} s")
            if p.returncode != 0:
                with open(self.logs[tag]) as fh:
                    text = fh.read()
                raise SmokeFailure(f"[dryrun] {tag} exited {p.returncode}:\n"
                                   f"{text[-3000:]}")
        while len(self.ended) < len(self.procs):   # the threads' notes
            time.sleep(0.01)
        return dict(self.ended)

    def stop(self) -> None:
        import signal
        for p in self.procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def dryrun_line(r: dict) -> str:
    coll = ", ".join(f"{k} {v / 1e9:.3f}"
                     for k, v in sorted(r["collective_by_kind"].items()))
    return (f"{r['arch']:<21} {r['shape']:<11} {r['mesh']:<7} zero3 "
            f"{str(r['zero3']):<5} FLOPs {r['flops']:.4e} (per device "
            f"{r['unrolled_cost_analysis']['flops']:.4e}); argument "
            f"{r['memory']['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{r['memory']['temp_bytes'] / 1e9:.3f} GB a device; collective "
            f"GB (all devices) {{{coll}}}; dominant {r['dominant']}; "
            f"useful FLOPs {r['useful_flops_frac'] or 0:.4f}; "
            f"{r['lower_s']} s")


def phase_dryrun(card: str, children: DryrunChildren) -> dict:
    """Slice 15: (a) the dry run's CLI over every pair (the children's
    reports, one line each), (b) the card check: DRYRUN_CARD's programs
    run for real at full width on a world of 1 on NCCL under the auditor,
    against the dry run of the same program on a fake world of 1 (meta):
    FLOPs within the budget manifest's ``flops`` tolerance, argument bytes,
    kernel launches and collective counts exactly, peak temporaries within
    its ``temp_bytes`` tolerance."""
    import glob
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.facts import ProgramFacts
    from repro_torch.analysis.program import (BUDGET_TOLERANCES, budget_drifts,
                                              budget_row)
    from repro_torch.configs.base import ASSIGNED_ARCHS, INPUT_SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import (build_program, program_facts,
                                           report_name)
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    ended = children.wait()
    waited = time.perf_counter() - t_phase
    log(f"[dryrun] children ended at {ended} s from their start (the "
        f"phase waited {waited:.1f} s for them)")
    out = {"children_s": ended, "waited_s": waited, "pairs": {}}
    want = [(a, s, m) for m, archs in (("16x16", ASSIGNED_ARCHS),
                                       ("2x16x16", ("tinyllama_1_1b",)))
            for a in archs for s in INPUT_SHAPES]
    want = [(a, s, m, []) for a, s, m in want] + [
        (a, s, "16x16", DRYRUN_TP_OPTS) for a in DRYRUN_TP_ARCHS
        for s in INPUT_SHAPES]
    missing = [w for w in want if not os.path.exists(
        os.path.join(DRYRUN_DIR, report_name(*w)))]
    check(not missing, f"[dryrun] no report for {missing}")
    check(len(glob.glob(os.path.join(DRYRUN_DIR, "*__*.json"))) == len(want),
          "[dryrun] reports beside the expected ones")
    for a, s, m, opts in want:
        with open(os.path.join(DRYRUN_DIR, report_name(a, s, m, opts))) as fh:
            r = json.load(fh)
        log(f"[dryrun] {dryrun_line(r)}")
        tag = f"{a}/{s}/{m}" + ("/tp" if opts else "")
        out["pairs"][tag] = {
            k: r[k] for k in ("zero3", "flops", "hbm_bytes",
                              "collective_bytes", "collective_by_kind",
                              "collective_counts", "kernel_launches",
                              "dominant", "useful_flops_frac", "memory",
                              "lower_s")}
        check(r["flops"] > 0 and r["memory"]["argument_bytes"] > 0,
              f"[dryrun] {a}/{s}/{m} {opts}: an empty report")
    for a in DRYRUN_TP_ARCHS:
        plain = out["pairs"][f"{a}/train_4k/16x16"]
        tp = out["pairs"][f"{a}/train_4k/16x16/tp"]
        pf = plain["flops"] / tp["flops"]
        pa = (plain["memory"]["argument_bytes"]
              / tp["memory"]["argument_bytes"])
        log(f"[dryrun] tensor parallelism (--opt), {a} train_4k on 16x16: "
            f"FLOPs ÷{pf:.2f}, argument bytes ÷{pa:.2f}, useful "
            f"{plain['useful_flops_frac']:.4f} → "
            f"{tp['useful_flops_frac']:.4f}, temp "
            f"{plain['memory']['temp_bytes'] / 1e9:.3f} → "
            f"{tp['memory']['temp_bytes'] / 1e9:.3f} GB a device")
        min_pa, min_pf, min_useful = DRYRUN_TP_MIN.get(
            a, DRYRUN_TP_MIN_DEFAULT)
        check(pa >= min_pa and tp["collective_counts"].get("all-reduce", 0)
              > plain["collective_counts"].get("all-reduce", 0),
              f"[dryrun] {a}: --opt does not split the step over 'model'")
        check(min_pf is None or (pf >= min_pf and tp["useful_flops_frac"]
                                 >= min_useful),
              f"[dryrun] {a}: --opt FLOPs ÷{pf:.2f}, useful "
              f"{tp['useful_flops_frac']}")
        for s_ in ("train_4k", "prefill_32k"):
            mem = [out["pairs"][f"{a}/{s_}/16x16" + t]["memory"]
                   for t in ("", "/tp")]
            gb = [(m_["argument_bytes"] + m_["temp_bytes"]) / 1e9
                  for m_ in mem]
            out["pairs"][f"{a}/{s_}/16x16/tp"]["fits"] = gb[1] <= DEVICE_GB
            log(f"[dryrun] {a} {s_} on 16x16, argument + temp a device: "
                f"{gb[0]:.3f} → {gb[1]:.3f} GB under --opt (fits "
                f"{DEVICE_GB:g} GB: {gb[0] <= DEVICE_GB} → "
                f"{gb[1] <= DEVICE_GB})")

    # (b) the card check
    with open(DRYRUN_META) as fh:
        meta_rows = json.load(fh)
    tols = dict(BUDGET_TOLERANCES, arg_bytes=0.0)
    paths, rows, card_facts = {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        for name, arch, shape_name, batch, runtime in dryrun_card_programs():
            shape = dryrun_card_shape(shape_name, batch)
            full = INPUT_SHAPES[shape_name]
            t0 = time.perf_counter()
            prog = build_program(get_arch(arch), shape, mesh, runtime)
            torch.cuda.synchronize()
            ops.reset_launches()
            f = program_facts(name, prog)
            paths[f"dryrun_{arch}_{shape.kind}"
                  + ("_tp" if runtime.tp_constraints else "")] = dict(
                ops.LAUNCHES)
            run_s = time.perf_counter() - t0
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            dry = ProgramFacts(**meta_rows[name])
            drifts = {label: (w, h, d) for label, key, w, h, d in
                      budget_drifts(f, budget_row(dry))}
            bad = {label: v for label, v in drifts.items()
                   if v[2] > tols[label.split("[")[0]]}
            same_coll = f.collective_counts == dry.collective_counts
            rows[name] = {"global_batch": batch, "card": budget_row(f),
                          "dry": budget_row(dry),
                          "card_collectives": f.collective_counts,
                          "dry_collectives": dry.collective_counts,
                          "card_hbm_bytes": f.hbm_bytes,
                          "dry_hbm_bytes": dry.hbm_bytes,
                          "drift": {k: v[2] for k, v in drifts.items()},
                          "run_s": run_s}
            log(f"[dryrun] card check {name}, global batch "
                f"{full.global_batch} cut to {batch} (seq {shape.seq_len}): "
                f"(card, dry run, drift) FLOPs {f.flops:.6e} / "
                f"{dry.flops:.6e} / {drifts['flops'][2]:.2e} (limit "
                f"{tols['flops']}); argument bytes {f.arg_bytes} / "
                f"{dry.arg_bytes}; temp bytes {f.temp_bytes} / "
                f"{dry.temp_bytes} / {drifts['temp_bytes'][2]:.4f} (limit "
                f"{tols['temp_bytes']}); launches {f.kernel_launches} / "
                f"{dry.kernel_launches}; collectives {f.collective_counts} / "
                f"{dry.collective_counts}; weight bytes {f.weight_bytes:.6e}"
                f" / {dry.weight_bytes:.6e}; HBM bytes (not held) "
                f"{f.hbm_bytes:.6e} / {dry.hbm_bytes:.6e}; {run_s:.1f} s"
                f"   [{card}]")
            check(not bad and same_coll,
                  f"[dryrun] {name}: the dry run disagrees with the card: "
                  f"{bad}, collectives {f.collective_counts} / "
                  f"{dry.collective_counts}")
            check(not runtime.tp_constraints or f.flops == dry.flops,
                  f"[dryrun] {name}: FLOPs {f.flops} on the card, "
                  f"{dry.flops} in the dry run")
            card_facts[name] = f
            if runtime.tp_constraints:
                # model = 1: the tensor-parallel program is the plain one
                p_ = card_facts[name[:-len("/tp")]]
                check(f.flops == p_.flops
                      and f.collective_counts == p_.collective_counts
                      and f.kernel_launches == p_.kernel_launches,
                      f"[dryrun] {name}: FLOPs {f.flops}, collectives "
                      f"{f.collective_counts}, launches {f.kernel_launches}"
                      f" on the card; the plain program's {p_.flops}, "
                      f"{p_.collective_counts}, {p_.kernel_launches}")
        check(any(p.get("flash_attention", 0) for p in paths.values())
              and any(p.get("ssd_scan", 0) for p in paths.values()),
              f"[dryrun] the card check launched no flash or ssd_scan "
              f"kernel: {paths}")
    finally:
        dist.destroy_process_group()
    out.update(card_check=rows, paths=paths,
               phase_s=time.perf_counter() - t_phase)
    log(f"[dryrun] phase {out['phase_s']:.1f} s (children "
        f"{max(ended.values()):.1f} s beside the earlier phases)   [{card}]")
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hybrid-serve-long", action="store_true",
                    help="only the measured Zamba2-7B serving run "
                         "(phase_hybrid_serve_long, about 30 min)")
    ap.add_argument("--moe-serve-long", action="store_true",
                    help="only the measured DeepSeek-V2-Lite-16B serving "
                         "run (phase_moe_serve_long)")
    ap.add_argument("--dist-cpu-step", metavar="NPZ",
                    help=argparse.SUPPRESS)   # phase_distributed's CPU side
    ap.add_argument("--dryrun-meta", metavar="JSON",
                    help=argparse.SUPPRESS)   # phase_dryrun's dry side
    args = ap.parse_args(argv)
    if args.dist_cpu_step:
        return dist_cpu_step(args.dist_cpu_step)
    if args.dryrun_meta:
        return dryrun_meta(args.dryrun_meta)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is missing beside this script: {exc}",
              file=sys.stderr)
        return 2
    set_precision()
    t0 = time.perf_counter()
    card = card_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    for flag, name, phase in (
            (args.hybrid_serve_long, "hybrid_serve_long",
             phase_hybrid_serve_long),
            (args.moe_serve_long, "moe_serve_long", phase_moe_serve_long)):
        if not flag:
            continue
        try:
            res = phase(card)
        except SmokeFailure as exc:
            log(f"FAIL: {exc}")
            return 1
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        print(json.dumps({name: res}))
        print(card)
        return 0
    children = None
    try:
        # slice 15: the dry run's CPU children run beside the card phases
        children = DryrunChildren()
        phase_lint(card)
        lap(t0, "phase_lint")
        build_kernels()
        lap(t0, "build_kernels")
        ssd = phase_ssd_kernel(card)
        lap(t0, "phase_ssd_kernel")
        kern = phase_kernel(card)
        lap(t0, "phase_kernel")
        served = phase_serve(card)
        lap(t0, "phase_serve")
        phase_exact(card)
        lap(t0, "phase_exact")
        train = phase_train_kernels(card)
        lap(t0, "phase_train_kernels")
        rounds = phase_round(card)
        lap(t0, "phase_round")
        phase_round_exact(card)
        lap(t0, "phase_round_exact")
        train_ssm = phase_train_kernels(card, "mamba2_370m", "ssm",
                                        f32_leaves=("ssm_D", "ssm_in_proj"),
                                        ragged=False)
        lap(t0, "phase_train_kernels")
        ssm_rounds = phase_ssm_round(card)
        lap(t0, "phase_ssm_round")
        phase_profile(card, "mamba2_370m", SSM_SEQ, "ssm-profile",
                      {"ssd_scan (forward kernel)": ("ssd_scan",)})
        lap(t0, "phase_profile")
        phase_ssm_serve(card)
        lap(t0, "phase_ssm_serve")
        flash = phase_flash_kernel(card)
        lap(t0, "phase_flash_kernel")
        long_rounds = phase_round(card, LONG_SEQ)
        lap(t0, "phase_round")
        phase_profile(card, "tinyllama_1_1b", LONG_SEQ, "long-profile", {
            "flash_attention (forward kernel)": ("flash_fwd",),
            "flash_attention_bwd (dQ, dK/dV kernels, the split's sum)": (
                "flash_dq", "flash_dkdv")})
        lap(t0, "phase_profile")
        pipe = phase_pipeline(card)
        lap(t0, "phase_pipeline")
        pre = phase_pretrain(card)
        lap(t0, "phase_pretrain")
        ckp = phase_checkpoint(card)
        lap(t0, "phase_checkpoint")
        faults = phase_faults(card, pipe)
        lap(t0, "phase_faults")
        # slice 9: the earlier phases' models are gone with their frames
        gc.collect()
        torch.cuda.empty_cache()
        hyk = phase_hybrid_kernels(card)
        lap(t0, "phase_hybrid_kernels")
        phase_hybrid_serve(card)
        lap(t0, "phase_hybrid_serve")
        hyr = phase_hybrid_round(card)
        lap(t0, "phase_hybrid_round")
        # slice 10: the full DeepSeek-V2-Lite-16B takes 31.4 GB
        gc.collect()
        torch.cuda.empty_cache()
        mok = phase_moe_kernels(card)
        lap(t0, "phase_moe_kernels")
        phase_moe_serve(card)
        lap(t0, "phase_moe_serve")
        mor = phase_moe_round(card)
        lap(t0, "phase_moe_round")
        # slice 11: whisper-medium, after the 31.4 GB DeepSeek model
        gc.collect()
        torch.cuda.empty_cache()
        auk = phase_audio_kernels(card)
        lap(t0, "phase_audio_kernels")
        aur = phase_audio_round(card)
        lap(t0, "phase_audio_round")
        phase_audio_decode(card)
        lap(t0, "phase_audio_decode")
        # slice 12: theory at full TinyLlama width, strict mode, the auditor
        gc.collect()
        torch.cuda.empty_cache()
        thr = phase_theory(card)
        lap(t0, "phase_theory")
        con = phase_contracts(card)
        lap(t0, "phase_contracts")
        # slice 13: the distributed round and mesh serving (NCCL, world 1)
        gc.collect()
        torch.cuda.empty_cache()
        dst = phase_distributed(card)
        lap(t0, "phase_distributed")
        # slice 16: the tensor-parallel split of one block, summed by hand
        tpb = phase_tp_block(card)
        lap(t0, "phase_tp_block")
        # slice 15: the dry run, and its counts against the card's
        gc.collect()
        torch.cuda.empty_cache()
        dry = phase_dryrun(card, children)
        lap(t0, "phase_dryrun")
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        return 1
    finally:
        if children is not None:
            children.stop()
    total = kern["total"]
    fault_paths = faults["launches"]
    # the moe paths launch no serving, flash or ssd kernel: they are listed
    # with their counts (0) beside the training kernels' launches
    moe_paths = {"deepseek_round": mor["launches"],
                 "deepseek_top_round": mor["top_launches"]}
    # the whisper paths: the probe, the update at "ours"' cut, and the
    # masked and dense updates at each of AUDIO_CUTS
    audio_paths = aur["launches"]
    # slice 12: the theory phase, the strict rounds and the full-width audit
    later_paths = {"tinyllama_theory": thr["launches"],
                     "tinyllama_strict": con["strict_launches"],
                     "audit_full_width": con["audit_launches"],
                     # slice 13: the distributed steps, mesh serving, the CLI
                     # (slice 16: and their tensor-parallel programs)
                     **dst["paths"],
                     # slice 16: the block's split at M = 2 and 16
                     **tpb["paths"],
                     # slice 15: the dry run's card check
                     **dry["paths"]}
    delta_paths = {"serve": served["delta"]["launches"],
                   **{p: l["base_delta_matmul"]
                      for p, l in fault_paths.items()},
                   **{p: l["base_delta_matmul"]
                      for p, l in moe_paths.items()},
                   **{p: l["base_delta_matmul"]
                      for p, l in audio_paths.items()},
                   **{p: l["base_delta_matmul"]
                      for p, l in later_paths.items()}}
    line = {"kernels": [{
        "name": "base_delta_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_matmul.cu",
        "replaces": "src/repro/kernels/delta_matmul.py:89",
        "launches": sum(delta_paths.values()),
        "launches_by_path": delta_paths,
        "max_abs_err": kern["max_abs_err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in kern["rows"]) else "operations"),
        "library_ms": total["library_ms"],
        "no_live_ms": total["no_live_ms"],
        "library_no_live_ms": total["library_no_live_ms"],
        "no_live_bound_ms": total["no_live_bound_ms"],
        "launches_by_kernel_route": {"cuda": sum(delta_paths.values())},
        "delta_over_shared_step": served["delta_over_shared"],
        "timed_as": "sum over one layer's six projections at B=4, 2 live "
                    "entries of 4 (no_live_ms: none live)",
        "library_call": "torch.matmul(x, w): the base product only with "
                        "live entries, the same function with none",
        "shapes": kern["rows"]}]}
    for name, rel, lib, timed, timed_ssm in (
            ("layer_grad_norm", "layer_grad_norm.py:64",
             "torch.linalg.vector_norm(g, dim=1, dtype=float32)**2",
             "sum over TinyLlama's eight block leaves at L=22, one probe "
             "batch",
             "sum over Mamba2's nine block leaves at L=48, one probe batch"),
            ("masked_update", "masked_update.py:40",
             "torch.addcmul(p, g, (-lr*m)[:, None]) (f32 output)",
             "sum over TinyLlama's eight block leaves at L=11, one local step",
             "sum over Mamba2's nine block leaves at L=24, one local "
             "step")):
        t, tm = train[name], train_ssm[name]
        by_path = {"tinyllama_round": rounds["launches"][name],
                   "tinyllama_round_seq1024": long_rounds["launches"][name],
                   "mamba2_round": ssm_rounds["launches"][name],
                   "mamba2_top_round": ssm_rounds["top_launches"][name],
                   "tinyllama_pipeline_seq1024":
                       pipe["tinyllama_1_1b"]["launches"][name],
                   "mamba2_pipeline": pipe["mamba2_370m"]["launches"][name],
                   "tinyllama_checkpoint_resume": ckp["launches"][name],
                   **{p: l[name] for p, l in fault_paths.items()},
                   **{p: l[name] for p, l in moe_paths.items()},
                   **{p: l[name] for p, l in audio_paths.items()},
                   **{p: l[name] for p, l in later_paths.items()}}
        extra = {"deepseek_v2_lite_16b": {
            **mok[name]["total"], "shapes": mok[name]["rows"],
            "timed_as": f"sum over DeepSeek-V2-Lite's 23 leaves: dense0's "
                        f"10 at L=1, the moe blocks' 13 at "
                        f"L={MOE_ROUND_LAYERS - 1}"
                        + (", one probe" if name == "layer_grad_norm"
                           else ", one local step at cut 0")},
            "whisper_medium": {
            **auk[name]["total"], "shapes": auk[name]["rows"],
            "timed_as": "sum over whisper-medium's 21 leaves: the "
                        "encoder's 8 and the decoder's 13, L=24 each"
                        + (", one probe" if name == "layer_grad_norm"
                           else ", one local step at cut 0")}}
        errs = [t["max_abs_err"], tm["max_abs_err"],
                mok[name]["max_abs_err"], auk[name]["max_abs_err"]]
        if name == "layer_grad_norm":
            by_path["zamba2_round"] = hyr["launches"][name]
            extra["zamba2_7b"] = {
                **hyk[name]["total"], "shapes": hyk[name]["rows"],
                "timed_as": "sum over one Zamba2 probe's 17 leaves: nine "
                            "Mamba2 leaves at L=15, the shared block's "
                            "eight as single rows"}
            errs.append(hyk[name]["max_abs_err"])
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{rel}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(errs),
            "ms": t["total"]["ms"], "plain_ms": t["total"]["plain_ms"],
            "bound_ms": t["total"]["bound_ms"],
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in t["rows"]) else "operations"),
            "library_ms": t["total"]["library_ms"],
            "timed_as": timed, "library_call": lib, "shapes": t["rows"],
            "mamba2_370m": {**tm["total"], "timed_as": timed_ssm,
                            "shapes": tm["rows"]}, **extra})
    main_ssd = ssd["main"]
    ssd_paths = {"mamba2_round": ssm_rounds["launches"],
                 "mamba2_top_round": ssm_rounds["top_launches"],
                 "mamba2_pipeline": pipe["mamba2_370m"]["launches"],
                 **fault_paths, "zamba2_round": hyr["launches"],
                 **moe_paths, **audio_paths, **later_paths}
    line["kernels"].append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:72",
        "launches": sum(l["ssd_scan"] for l in ssd_paths.values()),
        "launches_by_path": {p: l["ssd_scan"] for p, l in ssd_paths.items()},
        "launches_by_kernel_route": {
            r: sum(l[f"ssd_scan_{r}"] for l in ssd_paths.values())
            for r in ("mma", "simt")},
        "max_abs_err": main_ssd["max_abs_err"], "ms": main_ssd["ms"],
        "plain_ms": main_ssd["plain_ms"], "bound_ms": main_ssd["bound_ms"],
        "bound_by": main_ssd["bound_by"], "library_ms": None,
        "simt_ms": main_ssd["simt_ms"],
        "timed_as": "one Mamba2-370M layer's scan on the round's batch: "
                    "b 4, S 512, H 32, P 64, G 1, N 128, chunk 128, bf16",
        # slice 17: one model rank's heads at M = 16
        "tp_local_heads": {
            arch: {k: r[k] for k in ("b", "s", "h", "p", "g", "n",
                                     "max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")}
            for arch, r in (("mamba2_370m", ssd["tp_local_m16"]),
                            ("zamba2_7b",
                             hyk["ssd"]["zamba2/tp_local_m16"]))},
        "library_call": None,
        "shapes": list(ssd.values()) + list(hyk["ssd"].values())})
    fm = flash["main"]
    flash_paths = {"tinyllama_round": rounds["launches"],
                   "tinyllama_round_seq1024": long_rounds["launches"],
                   "tinyllama_pipeline_seq1024":
                       pipe["tinyllama_1_1b"]["launches"],
                   "tinyllama_pretrain": pre["launches"],
                   "tinyllama_checkpoint_resume": ckp["launches"],
                   **fault_paths, "zamba2_round": hyr["launches"],
                   **moe_paths, **audio_paths, **later_paths}
    flash_shapes = [{k: v for k, v in c.items()}
                    for c in flash["cases"] + hyk["flash"] + auk["flash"]]
    whisper_flash = {c["case"]: c for c in auk["flash"]}
    tpl = flash["tp_local"]
    tp_flash = {k: tpl[k] for k in (
        "b", "s", "h", "k", "d", "causal", "o_max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for name, key, err_keys, extra in (
            ("flash_attention", "flash_attention", ("o_max_abs_err",),
             {"ms": fm["ms"], "plain_ms": fm["plain_ms"],
              "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
              "library_ms": fm["library_ms"], "simt_ms": fm["simt_ms"],
              "library_call": "F.scaled_dot_product_attention(q, k, v, "
                              "is_causal=True, enable_gqa=True), (B,H,S,D) "
                              "contiguous bf16",
              "whisper_medium": {
                  c: {k: whisper_flash[c][k] for k in (
                      "ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "o_max_abs_err")}
                  for c in whisper_flash},
              "tp_local_heads": tp_flash}),
            ("flash_attention_bwd", "flash_attention_bwd",
             ("dq_max_abs_err", "dk_max_abs_err", "dv_max_abs_err"),
             {"ms": fm["bwd_ms"], "plain_ms": fm["plain_bwd_ms"],
              "bound_ms": fm["bwd_bound_ms"], "bound_by": fm["bwd_bound_by"],
              "library_ms": fm["library_bwd_ms"],
              "library_reads_ms": fm["library_bwd_reads_ms"],
              "simt_ms": fm["simt_bwd_ms"],
              "library_call": "torch.autograd.grad of that SDPA call's "
                              "output (its backward alone; the median of "
                              "three reads)",
              "fwd_bwd_ms": fm["fwd_bwd_ms"],
              "library_fwd_bwd_ms": fm["library_fwd_bwd_ms"],
              "attend_full_fwd_bwd_ms": fm["attend_full_fwd_bwd_ms"],
              "whisper_medium": {
                  c: {"ms": whisper_flash[c]["bwd_ms"],
                      "plain_ms": whisper_flash[c]["plain_bwd_ms"],
                      "bound_ms": whisper_flash[c]["bwd_bound_ms"],
                      "bound_by": whisper_flash[c]["bwd_bound_by"],
                      "library_ms": whisper_flash[c]["library_bwd_ms"]}
                  for c in whisper_flash},
              "tp_local_heads": {
                  "ms": tpl["bwd_ms"], "plain_ms": tpl["plain_bwd_ms"],
                  "bound_ms": tpl["bwd_bound_ms"],
                  "bound_by": tpl["bwd_bound_by"],
                  "library_ms": tpl["library_bwd_ms"],
                  "max_abs_err": max(tpl[f"{g}_max_abs_err"]
                                     for g in ("dq", "dk", "dv"))}})):
        by_path = {p: l[key] for p, l in flash_paths.items()}
        by_route = {r: sum(l[f"{key}_{r}"] for l in flash_paths.values())
                    for r in ("mma", "simt")}
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_by_kernel_route": by_route,
            "kernel_split_ms": fm["kernel_split_ms"],
            "max_abs_err": max(c[k] for c in [fm] + auk["flash"]
                               for k in err_keys), **extra,
            "timed_as": "one TinyLlama-1.1B layer on the seq-1024 round's "
                        "batch: B 4, S 1024, H 32, K 4, D 64, bf16, causal",
            "shapes": flash_shapes})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
