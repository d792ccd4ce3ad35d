#!/usr/bin/env python3
"""The readings that set a cell's limits from above: the reference put in
the program's place, computed one precision lower (``fp8``) or with a
fault planted where the program would have it (``half_batch``: each
loss over half of its batch; ``alter``: one client's update of one layer
doubled where it is produced; ``reversed``: the first round's (P1) masks
solved on its utilities in reverse layer order, read on the host from the
reference's own first round), against the float32 reference that follows
its cohorts, batches and masks.  Not part of a benchmark run.

    python3 fedbench/control.py --workload mamba2-370m.round.ours \\
        --seeds 11 12 13 --candidates fp8 half_batch alter

Prints one JSON line per (seed, candidate) with the readings of
:mod:`fedbench.harness.readings`.  The weights, traffic and cohorts are a
run's for the same seed (the program's server draws its cohorts from a
``RandomState`` of the federation seed, as :func:`~fedbench.harness.
follow.plan_inputs` does).  Needs a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CANDIDATES = ("fp8", "half_batch", "alter", "reversed")


def control_readings(cell, seed: int, candidates, device: str) -> dict:
    """``{candidate: readings}`` for one seed.  The float32 reference runs
    once choosing its own masks; a candidate that chose other masks gets
    a reference run of its own that follows them."""
    import numpy as np
    import torch

    from fedbench.harness.follow import follow, plan_inputs
    from fedbench.harness.readings import mask_gap, readings
    from fedbench.harness.weights import make_params
    from fedbench.reference.numerics import Numerics, full_f32
    from fedbench.reference.rounds import Selector, solve_icm
    from fedbench.run import sub_seeds
    from fedbench.traffic.generator import LMTraffic

    if torch.device(device).type == "cuda":
        full_f32()
    traffic, c = cell.traffic, cell.c
    fl = traffic["fl"]
    w_seed, d_seed, f_seed = sub_seeds(seed)
    task = LMTraffic(traffic["data"], cell.vocab, traffic["seq_len"],
                     d_seed)
    inputs = plan_inputs(traffic, task, f_seed,
                         int(cell.spec["rounds_compared"]))
    test = task.test_batch()["tokens"]
    specs = cell.reference.leaf_specs(c)
    L = len(cell.reference.units(c))

    def run(num="f32", fault=None, masks=None):
        ins = inputs if masks is None else [dict(i, masks=m)
                                            for i, m in zip(inputs, masks)]
        sel = (Selector(traffic["strategy"], L, fl["budget"], fl["lam"])
               if masks is None else None)
        out = follow(cell.reference, c, make_params(specs, w_seed, device),
                     ins, test, fl, device, num=Numerics(num), fault=fault,
                     selector=sel)
        gc.collect()
        return out

    ref_own = run()
    got = {}
    for cand in candidates:
        if cand == "reversed":
            first = ref_own["rounds"][:1]
            G = np.asarray(first[0]["G"], np.float64)
            M = solve_icm(G[:, ::-1], fl["budget"], fl["lam"])
            got[cand] = {"masks": mask_gap([{"masks": M}], first,
                                           traffic["strategy"], fl["budget"],
                                           fl["lam"])}
            continue
        traj = run("fp8" if cand == "fp8" else "f32",
                   None if cand == "fp8" else cand)
        masks = [r["masks"] for r in traj["rounds"]]
        same = all(np.array_equal(m, r["masks"])
                   for m, r in zip(masks, ref_own["rounds"]))
        ref = ref_own if same else run(masks=masks)
        got[cand] = readings(traj, ref, traffic["strategy"], fl["budget"],
                             fl["lam"])
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--candidates", nargs="+", default=list(CANDIDATES),
                    choices=CANDIDATES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from fedbench.harness.manifest import Cell
    cell = Cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_readings(cell, seed, args.candidates, args.device)
        for cand, readings in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "candidate": cand, "readings": readings,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
