#!/usr/bin/env python3
"""One run of one cell of the port's benchmark: federated fine-tuning
rounds (Algorithm 1) of the PyTorch and CUDA port, ``repro_torch``, on one
card.

    python3 fedbench/run.py --workload mamba2-370m.round.ours --seed 7 \\
        --seconds 45 --trace 0

Set-up makes the weights (bf16, on the card, from the seed) and the
traffic, builds the program's front door (``repro_torch.api.experiment.
Experiment`` at its defaults: the vectorized engine streamed through the
round scheduler) and runs the federation's first rounds (the cell's
``rounds_compared``) through the same call the window makes.  Those rounds
are what the plain reference (``fedbench/reference/``) later follows and
judges.  The window is one call of ``Experiment.run`` over a fixed number
of rounds, ``--seconds`` over the cell's ``round_s`` (its round time as
measured on the card), ending in a synchronise.

``--trace 0`` reports the end-to-end metrics (``train_tok_s``,
``setup_s``); ``--trace 1`` the per-layer ones, read by
``fedbench/metrics/<metric>.py``, with the window's select stage wrapped
in the benchmark's own spans and, after the window, the client calls of
its last probed round (update, probe, eval) replayed under
``torch.profiler``.  Then the program's state is freed and the
reference re-runs the first rounds in float32 from the same weights and
inputs; ``correct`` holds when every number in the cell's ``limits`` is
within its limit.  The last line of standard output is the result's JSON;
the last lines of standard error are the numbers compared beside their
limits.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the run may fill, at fixed paths inside the checkout
CACHE = ROOT / "build" / "fedbench-cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is one of
    :data:`FORBIDDEN`, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sub_seeds(seed: int) -> tuple:
    """Weights, data and federation seeds from the run's seed."""
    import numpy as np
    w, d, f = np.random.SeedSequence(int(seed)).generate_state(3)
    return int(w), int(d) % (1 << 22), int(f) % (1 << 31)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", sabotage=None) -> dict:
    """Set-up, window, metrics and the comparison with the reference."""
    import numpy as np
    import torch

    from fedbench.harness.capture import LastRound, Recorder, SelectSpans
    from fedbench.harness.follow import follow
    from fedbench.harness.readings import readings
    from fedbench.harness.weights import make_params
    from fedbench.reference.numerics import full_f32
    from fedbench.traffic.generator import LMTraffic
    from repro_torch.api.experiment import Experiment
    from repro_torch.configs.base import ArchConfig

    cuda = torch.device(device).type == "cuda"
    traffic, c = cell.traffic, cell.c
    fl = traffic["fl"]
    w_seed, d_seed, f_seed = sub_seeds(seed)
    task = LMTraffic(traffic["data"], cell.vocab, traffic["seq_len"],
                     d_seed)
    specs = cell.reference.leaf_specs(c)
    params0 = make_params(specs, w_seed, device)
    exp = Experiment(ArchConfig(**c), task, traffic["strategy"],
                     pipeline_depth=traffic["pipeline_depth"], seed=f_seed,
                     device=device, **fl)
    server = exp.build()
    if sabotage is not None:
        sabotage(exp)

    # the first rounds, through the window's own call and feed
    warm = int(cell.spec["rounds_compared"])
    rec = Recorder(server, task, params0).install()
    params, hist = exp.run(params=params0, rounds=warm, resume=False)
    _sync(device)
    rec.remove()
    prog, inputs = rec.trajectory(hist, params, server.needs_probe)
    rec.params0 = params0 = None
    test_tokens = task.test_batch()["tokens"].copy()
    # a fixed amount of work for a given --seconds: the cell's round time
    # as measured on the card, not this run's, sets the rounds
    n_rounds = max(2, round(seconds / float(cell.spec["round_s"])))
    log(f"[fedbench] {cell.name} seed {seed}: {warm} rounds compared, "
        f"{n_rounds} rounds in the window")

    gc.collect()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - _T0
    spans = SelectSpans(server).install() if trace else None
    calls = LastRound(server.client).install() if trace else None
    t0 = time.perf_counter()
    params, hist = exp.run(params=params, rounds=n_rounds, resume=False)
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        spans.remove()
        calls.remove()
    records = hist.records
    cohort = exp.fl.cohort_size
    tokens = (n_rounds * cohort * fl["local_steps"] * fl["batch_size"]
              * traffic["seq_len"])
    failed = sum(not all(math.isfinite(v) for v in
                         (r.train_loss, r.test_loss)) for r in records)
    log(f"[fedbench] window {window_s:.3f} s, {n_rounds} rounds, "
        f"{tokens} tokens, peak {peak / 1e9:.2f} GB")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if not trace:
        values = {"train_tok_s": tokens / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from fedbench.harness.trace import trace_call
        t_tr = time.perf_counter()
        tr = trace_call(lambda: calls.replay(params), cuda)
        names = ", ".join(n for n, _, _ in calls.calls)
        log(f"[fedbench] traced round ({names}): "
            f"{time.perf_counter() - t_tr:.1f} s with the profiler, busy "
            f"{tr['busy_s']:.4f} of {tr['window_s']:.4f} s")
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
        ctx = SimpleNamespace(
            cell=cell, c=c, traffic=traffic, work=cell.work,
            records=records, window_s=window_s, select_s=spans.seconds,
            trace=tr, forwards=calls.forwards(), peak_bytes=peak,
            needs_probe=server.needs_probe)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the window has closed: free the program's state, then the reference
    del exp, server, params, hist, records, calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        full_f32()
    t_ref = time.perf_counter()
    ref = follow(cell.reference, c, make_params(specs, w_seed, device),
                 inputs, test_tokens, fl, device)
    got = readings(prog, ref, traffic["strategy"], fl["budget"], fl["lam"])
    log(f"[fedbench] reference {time.perf_counter() - t_ref:.1f} s")
    # a number the cell compares but the run could not read fails
    limits = cell.spec["limits"]
    checks = {k: {"value": got.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    correct = all(ch["value"] <= ch["limit"] for ch in checks.values())
    out = {"correct": bool(correct), "attempted": n_rounds,
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fedbench.harness.manifest import Cell
    cell = Cell(args.workload)
    import torch
    # load from one process with few threads: the program's host work is
    # its launching threads', and an intra-op pool only competes with them
    torch.set_num_threads(1)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"[fedbench] {args.workload} needs {need} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"[fedbench] card: {card_line()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[fedbench] refused: the run loaded {', '.join(found)}")
        return 4
    for name, ch in out["checks"].items():
        log(f"check {name} {ch['value']:.6g} limit {ch['limit']}")
    log(f"correct {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
