"""Multi-pod dry run: every (arch × input shape × mesh) run once on a fake
world (counterpart of ``repro/launch/dryrun.py``).

The reference fakes 512 host devices, lowers and compiles each step
against ``ShapeDtypeStruct`` inputs and reads XLA's analyses.  Eager
PyTorch has no lowering: here the step *runs* once, at full width, as rank
0 of a fake world of 256 (16 × 16) or 512 (2 × 16 × 16) ranks
(``launch/mesh.py::dry_mesh``: the ``fake`` backend, whose collectives
move nothing), on meta tensors, under the program auditor
(``analysis/facts.py::extract_facts``).  For each pair this:

  1. builds the step through the port's own builders — the FL train step
     (``make_fl_train_step``, ``sel_idx`` from ``--sel-frac``), prefill
     (``make_prefill_step``) or the serve step (``make_serve_step`` with
     :func:`window_for`'s window) — with inputs from ``launch/specs.py``,
     the cohort rows of ``fl_step.shard_cohort_rows`` and rank 0's shards
     of ``fl_step.shard_params`` (``serve.shard_cache`` for a cache), all
     on the meta device;
  2. runs it once: the Hopper kernels take their meta route
     (``kernels/ops.py``: what the card's launch allocates, its launch
     counted and its work reported), so the facts are those of the
     program the card runs;
  3. reads rank 0's FLOPs, HBM traffic, argument, output and peak
     temporary bytes, collectives by kind and kernel launches; rank 0's
     program is the per-device program, and whole-step totals are its
     counts × ``n_chips``;
  4. prices them with :mod:`repro_torch.sharding.roofline` (H100
     data-sheet rates) and writes
     ``<out>/<arch>__<shape>__<mesh><suffix>.json``.

The report keeps the reference's keys where the port has a counterpart;
``lower_s`` is the seconds of the meta run.  ``compile_s``, ``analyze_s``
and ``memory.code_bytes`` (XLA's compile, its analyses, its generated
code) have no eager counterpart and are left out.

:func:`build_program` builds a pair's program on any mesh and
``ShapeConfig``: on a mesh of the meta device its inputs are stand-ins,
on a real one (gloo on the CPU, NCCL on the card) concrete tensors from a
seed, so the dry run's counts can be held against the same program run
for real (``tests/test_torch_dryrun.py``, ``chip_smoke.phase_dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--all] [--opt] [--out DIR]

``--opt`` turns on the reference's §Perf levers (:func:`opt_runtime`),
tensor parallelism over ``model`` among them: the steps of the dense,
vlm, ssm, hybrid, moe and audio families' language models split over
``model`` (``sharding/tensor_parallel.py``: DeepSeek's MLA by heads over
a latent whole on every rank, PaliGemma's prefix-LM blocks as the dense
family's, whisper's encoder and decoder by heads with its cross k/v from
an encoder output whole on every rank and its 51 865-row vocabulary,
which 16 does not divide, whole; a moe model with per-sample dispatch,
as the reference's ``--opt`` runs it) and write
``…__tp-rematsc-moelocal.json``; the classifiers' (CLIP, XLM-R) raise,
naming the family.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.analysis.facts import ProgramFacts, extract_facts
from repro_torch.analysis.program import budget_row
from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                      ArchConfig, RuntimeConfig, ShapeConfig,
                                      get_arch)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import dry_mesh, production_mesh_shape
from repro_torch.models.model import (Model, count_active_params,
                                      count_params, init_params)
from repro_torch.sharding import roofline as R
from repro_torch.sharding import rules
from repro_torch.sharding.fl_step import (make_fl_train_step,
                                          shard_cohort_rows, shard_params)
from repro_torch.sharding.serve import (batch_spec, make_prefill_step,
                                        make_serve_step, shard_cache)
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")

# Archs whose full-context attention cannot serve 500k tokens: they run the
# sliding-window variant (DESIGN.md §long_500k policy).
LONG_WINDOW = 4096
# Replicate-vs-ZeRO3 threshold: replicate the base when the per-chip copy
# (params/model_axis) stays under ~1.5 GB.
ZERO3_THRESHOLD_BYTES = 1.5e9
# The train step's learning rate: a host float, as the step takes it.
LR = 0.01
_META = torch.device("meta")


@functools.cache
def param_shapes(cfg: ArchConfig) -> dict:
    """The params' layout on the meta device: shapes and types, no
    storage (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, None, _META)


def pick_zero3(cfg: ArchConfig, mesh) -> bool:
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(param_shapes(cfg)))
    return nbytes / mesh.shape["model"] > ZERO3_THRESHOLD_BYTES


def window_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.sliding_window or LONG_WINDOW
    return 0


def sel_indices(cfg: ArchConfig, sel_frac: float) -> Optional[tuple]:
    """The top ``round(L · sel_frac)`` (at least 1) selectable layers, as a
    static index tuple; None for ``sel_frac`` 0."""
    if sel_frac <= 0:
        return None
    L = cfg.n_layers - cfg.first_dense
    R_ = max(1, int(round(L * sel_frac)))
    return tuple(range(L - R_, L))


def param_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(n_params, n_active_params): a moe model's routed experts count at
    top_k / n_experts."""
    shapes = param_shapes(cfg)
    return count_params(shapes), count_active_params(cfg, shapes)


def tokens_of(shape: ShapeConfig) -> int:
    if shape.kind == "decode":
        return shape.global_batch
    return shape.global_batch * shape.seq_len


def model_flops(shape: ShapeConfig, n_active: int) -> int:
    """6 · N_active · tokens for training, 2 · N_active · tokens else."""
    return (6 if shape.kind == "train" else 2) * n_active * tokens_of(shape)


def opts_of(runtime: RuntimeConfig, sel_idx: Optional[tuple]) -> list:
    opts = []
    if runtime.tp_constraints:
        opts.append("tp")
    if runtime.remat_scores:
        opts.append("rematsc")
    if runtime.sel_upload and sel_idx is not None:
        opts.append(f"sel{len(sel_idx)}")
    if runtime.moe_local_dispatch:
        opts.append("moelocal")
    return opts


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def report_name(arch: str, shape: str, mesh: str, opts: list) -> str:
    suffix = ("__" + "-".join(opts)) if opts else ""
    return f"{arch}__{shape}__{mesh}{suffix}.json"


# ---------------------------------------------------------------------------
# A pair's program on a mesh
# ---------------------------------------------------------------------------

@dataclass
class Program:
    """A step and its arguments on one rank: ``fn(*args)``."""
    fn: Callable
    args: tuple
    zero3: bool


class _Inputs:
    """Inputs on the mesh's device: the meta stand-ins themselves on the
    meta device, else concrete tensors drawn from seed 0 (params by
    ``init_params``, token ids below the vocabulary, other floats
    N(0, 0.02²), masks and sizes 1)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg, self.device = cfg, device
        self.meta = device.type == "meta"
        if not self.meta:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(0)

    def params(self) -> dict:
        if self.meta:
            return param_shapes(self.cfg)
        return init_params(self.cfg, self.gen, self.device)

    def fill(self, tree):
        if self.meta:
            return tree

        def one(t):
            if t.dtype.is_floating_point:
                return (torch.randn(t.shape, generator=self.gen,
                                    device=self.device) * 0.02).to(t.dtype)
            return torch.randint(0, self.cfg.vocab_size, t.shape,
                                 generator=self.gen, device=self.device,
                                 dtype=t.dtype)
        return tree_map(one, tree)

    def ones(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.meta else torch.ones(t.shape, dtype=t.dtype,
                                              device=self.device)


def build_program(cfg: ArchConfig, shape: ShapeConfig, mesh,
                  runtime: RuntimeConfig = RuntimeConfig(), *,
                  sel_idx: Optional[tuple] = None,
                  kernel_mode: Optional[str] = None) -> Program:
    """The pair's step on ``mesh`` and this rank's arguments: the train
    step at ``lr`` :data:`LR`, prefill, or decode at the cache's last
    position.  ``kernel_mode="torch"`` forces the kernels' plain versions
    (on meta too)."""
    model = Model(cfg, runtime, device=mesh.device, kernel_mode=kernel_mode)
    zero3 = pick_zero3(cfg, mesh) and runtime.zero3
    inputs = _Inputs(cfg, mesh.device)
    shapes = param_shapes(cfg)

    def local(params, specs):
        return shard_params(model, mesh, params, specs)

    if shape.kind == "train":
        step, specs = make_fl_train_step(model, mesh, zero3=zero3,
                                         sel_idx=sel_idx)(shapes)
        batch, masks, sizes, _ = S.fl_round_specs(cfg, shape, mesh,
                                                  model.n_selectable)
        args = (local(inputs.params(), specs),
                shard_cohort_rows(mesh, inputs.fill(batch)),
                shard_cohort_rows(mesh, inputs.ones(masks)),
                shard_cohort_rows(mesh, inputs.ones(sizes)), LR)
        return Program(step, args, zero3)
    bspec = batch_spec(model, mesh, shape.global_batch)
    if shape.kind == "prefill":
        batch = S.prefill_batch_specs(cfg, shape)
        fn, specs = make_prefill_step(model, mesh, zero3=zero3)(shapes,
                                                                batch)
        args = (local(inputs.params(), specs),
                {k: rules.local_shard(v, bspec, mesh)
                 for k, v in inputs.fill(batch).items()})
        return Program(fn, args, zero3)
    window = window_for(cfg, shape)
    tok, _, cache = S.decode_specs(model, shape, window=window)
    fn, (specs, c_specs) = make_serve_step(model, mesh, zero3=zero3,
                                           window=window)(
        shapes, cache, shape.global_batch)
    if not inputs.meta:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 window=window)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                       device=mesh.device)
    args = (local(inputs.params(), specs),
            rules.local_shard(inputs.fill(tok), bspec, mesh), pos,
            shard_cache(model, mesh, cache, c_specs))
    return Program(fn, args, zero3)


def program_facts(name: str, prog: Program) -> ProgramFacts:
    """One run of the program under the auditor (the params are its weight
    argument)."""
    return extract_facts(name, prog.fn, prog.args, weight_argnums=(0,))


# ---------------------------------------------------------------------------
# The reference's entry points
# ---------------------------------------------------------------------------

def lower_pair(arch_name: str, shape_name: str, multi_pod: bool,
               runtime: RuntimeConfig = RuntimeConfig(),
               sel_frac: float = 0.0, mesh=None) -> dict:
    """Run the pair once on ``mesh`` (a fake world's; else a production
    mesh of its own, torn down afterwards) and return its report."""
    if mesh is None:
        with dry_mesh(*production_mesh_shape(multi_pod)) as mesh:
            return lower_pair(arch_name, shape_name, multi_pod, runtime,
                              sel_frac, mesh)
    cfg = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    sel_idx = sel_indices(cfg, sel_frac)
    n_chips = math.prod(mesh.shape.values())
    t0 = time.perf_counter()  # repro: allow[nondeterminism] -- run-time telemetry only
    prog = build_program(cfg, shape, mesh, runtime, sel_idx=sel_idx)
    f = program_facts(f"{arch_name}/{shape_name}", prog)
    t_run = time.perf_counter() - t0  # repro: allow[nondeterminism] -- run-time telemetry only

    flops = f.flops * n_chips            # whole-step totals
    hbm_bytes = f.hbm_bytes * n_chips
    coll_total = f.collective_bytes * n_chips
    terms = R.roofline_terms(flops, hbm_bytes, coll_total, n_chips)
    n_params, n_active = param_counts(cfg)
    mflops = model_flops(shape, n_active)
    return {
        "arch": arch_name, "shape": shape_name,
        "opts": opts_of(runtime, sel_idx), "mesh": mesh_name(mesh),
        "n_chips": n_chips, "zero3": bool(prog.zero3),
        "kind": shape.kind, "tokens": tokens_of(shape),
        "n_params": n_params, "n_active_params": n_active,
        "lower_s": round(t_run, 2),
        "flops": flops, "hbm_bytes": hbm_bytes,
        "collective_bytes": coll_total,
        "collective_by_kind": {k: v * n_chips
                               for k, v in f.collective_by_kind.items()},
        "collective_counts": dict(f.collective_counts),
        # rank 0's (per-device) facts under the budget manifest's keys
        # (repro_torch.analysis.program)
        "unrolled_cost_analysis": budget_row(f),
        "kernel_launches": dict(f.kernel_launches),
        "roofline": terms,
        "dominant": R.dominant_term(terms),
        "model_flops": mflops,
        "useful_flops_frac": (mflops / flops) if flops else None,
        "memory": {"argument_bytes": f.arg_bytes,
                   "output_bytes": f.out_bytes,
                   "temp_bytes": f.temp_bytes},
    }


def run_one(arch: str, shape: str, multi_pod: bool, save: bool = True,
            runtime: RuntimeConfig = RuntimeConfig(),
            sel_frac: float = 0.0, mesh=None,
            out_dir: str = OUT_DIR) -> dict:
    report = lower_pair(arch, shape, multi_pod, runtime=runtime,
                        sel_frac=sel_frac, mesh=mesh)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("memory", "unrolled_cost_analysis")},
                     indent=None, default=str), flush=True)
    print("memory:", report["memory"], flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fname = report_name(arch, shape, report["mesh"], report["opts"])
        with open(os.path.join(out_dir, fname), "w") as fh:
            json.dump(report, fh, indent=1)
    return report


def opt_runtime(sel_frac: float) -> RuntimeConfig:
    """The ``--opt`` levers (the reference's): tensor parallelism over
    ``model``, chunk remat, per-sample moe dispatch, and the structural
    upload when ``sel_frac`` selects rows."""
    return RuntimeConfig(tp_constraints=True, remat_scores=True,
                         moe_local_dispatch=True, sel_upload=sel_frac > 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="enable §Perf levers (tp constraints + chunk remat "
                         "+ per-sample moe dispatch): tensor parallelism "
                         "over 'model' for the language models of the "
                         "dense, vlm, ssm, hybrid, moe and audio families "
                         "(MLA split by heads; whisper's encoder, decoder "
                         "and cross-attention by heads); the classifiers' "
                         "(CLIP, XLM-R) steps raise")
    ap.add_argument("--sel-frac", type=float, default=0.0,
                    help="static selected-layer fraction for sel_upload")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the JSON reports (default "
                         "build/dryrun/)")
    args = ap.parse_args(argv)

    runtime = opt_runtime(args.sel_frac) if args.opt else RuntimeConfig()
    if args.all:
        archs = ASSIGNED_ARCHS if args.arch is None else [args.arch]
        shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    else:
        archs, shapes = [args.arch], [args.shape]
    failures = []
    with dry_mesh(*production_mesh_shape(args.multi_pod)) as mesh:
        for a in archs:
            for s in shapes:
                try:
                    run_one(a, s, args.multi_pod, runtime=runtime,
                            sel_frac=args.sel_frac, mesh=mesh,
                            out_dir=args.out)
                except Exception as e:  # repro: allow[exception-swallow] -- --continue-on-error collects each pair's failure and exits 1
                    if not (args.all and args.continue_on_error):
                        raise
                    failures.append((a, s, repr(e)))
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
