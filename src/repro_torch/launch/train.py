"""Distributed FL training CLI: the fl_step on a mesh of processes
(counterpart of ``repro/launch/train.py``).

One process per client coordinate, launched by ``torch.distributed.run``
(NCCL on the card, gloo with ``--device cpu``); each process runs its
client's rows of the round.  On one host:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 4 -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --layers 4 --d-model 128 --rounds 20 \\
        --data-axis 2 --model-axis 2

Every round each rank gathers the full params, probes its own client
(``Client.probe``: the ``layer_grad_norm`` kernel on the card), and the
probe rows are all-gathered so every rank runs the same
``strategy.select``; the ranks then check that their masks agree before
the step runs, and each prints them.  Rank 0 prints the round line, and
at the end its kernel launches (``kernels.ops.LAUNCHES``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.api.strategy import SelectionContext, get_strategy
from repro_torch.bridge import gather_params
from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
from repro_torch.core.client import Client
from repro_torch.core.strategies import ProbeReport
from repro_torch.data.synthetic import (FederatedTaskConfig,
                                        SyntheticFederatedData)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (join_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.model import Model
from repro_torch.sharding import rules
from repro_torch.sharding.fl_step import (all_gather_dim, make_fl_train_step,
                                          shard_cohort_rows)


def say(line: str) -> None:
    """One line to stdout in one write, so the lines of ranks sharing a
    terminal or pipe never run into each other (``print`` may write the
    text and its newline apart)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def gather_probe_rows(row: dict, reqs: tuple, mesh) -> list[dict]:
    """Every client's probe row (L floats per requested key), on every
    rank: this rank's row all-gathered over the client axes, in client
    order."""
    mine = torch.from_numpy(np.stack([row[k] for k in reqs])).float()
    caxes = rules.client_axes(mesh)
    rows = all_gather_dim(mine[None].to(mesh.device), 0,
                          mesh.group(caxes)).cpu().numpy()
    return [{k: r[j] for j, k in enumerate(reqs)} for r in rows]


def check_same_on_ranks(masks: np.ndarray, device) -> None:
    """Raise unless every rank of the world selected the same masks."""
    mine = torch.from_numpy(np.ascontiguousarray(masks, np.float32)).to(device)
    every = torch.empty(dist.get_world_size() * mine.numel(),
                        dtype=mine.dtype, device=device)
    dist.all_gather_into_tensor(every, mine.view(-1))
    if not bool((every.view((-1,) + tuple(mine.shape)) == mine).all()):
        raise RuntimeError(f"rank {dist.get_rank()}: the ranks selected "
                           f"different masks")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--per-client-batch", type=int, default=4)
    ap.add_argument("--strategy", default="ours_unified",
                    help="any registered strategy name (repro_torch.api)")
    ap.add_argument("--budget", type=int, default=2)
    ap.add_argument("--lam", type=float, default=10.0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="0 = the world over --model-axis")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)

    # resolve the strategy up front: unknown names fail fast with the
    # registered list + nearest-match suggestion
    strategy = get_strategy(args.strategy)
    device = resolve_device(args.device)

    if args.production:
        mesh = make_production_mesh(device=device)
        cfg = get_arch(args.arch)
    else:
        d = args.data_axis or max(join_world(device) // args.model_axis, 1)
        mesh = make_host_mesh(d, args.model_axis, device=device)
        cfg = reduced(get_arch(args.arch), n_layers=args.layers,
                      d_model=args.d_model)
    runtime = RuntimeConfig(remat=False, seq_chunk=max(args.seq, 16))
    model = Model(cfg, runtime, device=mesh.device)
    caxes = rules.client_axes(mesh)
    clients = rules.n_clients(mesh)
    me = mesh.index(caxes)
    rank0 = dist.get_rank() == 0
    if rank0:
        say(f"mesh={mesh.shape} cohort={clients} arch={cfg.name}")

    full = model.init(0)
    step_fn, specs = make_fl_train_step(model, mesh, zero3=True)(full)
    params = rules.shard_tree(full, specs, mesh)
    del full

    data = SyntheticFederatedData(FederatedTaskConfig(
        n_clients=clients, vocab_size=cfg.vocab_size, seq_len=args.seq,
        objective="lm", skew="feature"))
    L = model.n_selectable
    sizes = shard_cohort_rows(
        mesh, torch.from_numpy(data.sizes[:clients].astype(np.float32)))
    probe_client = Client(Model(cfg, runtime, device=mesh.device))
    # the strategy's declared probe requirements trim the per-client probe
    reqs = tuple(k for k in ProbeReport.KEYS
                 if k in strategy.probe_requirements)

    for t in range(args.rounds):
        t0 = time.time()  # repro: allow[nondeterminism] -- round wall-clock telemetry only
        if reqs:
            host_params = gather_params(params, specs, mesh)
            # every client's probe batch is drawn on every rank, so each
            # rank's data streams stay those of a single controller
            probe_batches = [data.client_batch(i, 4) for i in range(clients)]
            row = probe_client.probe(
                host_params, _to_device(probe_batches[me], mesh.device), reqs)
            del host_params
            probe = ProbeReport.from_rows(gather_probe_rows(row, reqs, mesh))
        else:
            probe = ProbeReport(grad_sq_norms=np.zeros((clients, L)))
        ctx = SelectionContext(client_ids=np.arange(clients), round=t,
                               lam=args.lam, n_layers=L)
        masks = np.asarray(strategy.select(probe, args.budget, ctx),
                           np.float32)
        check_same_on_ranks(masks, mesh.device)
        say(f"[rank {dist.get_rank()}] round {t} client {me} masks="
            f"{masks.astype(int).tolist()}")

        batch_np = np.stack([
            data.client_batch(i, args.per_client_batch)["tokens"]
            for i in range(clients)])
        batch = shard_cohort_rows(mesh, {"tokens": torch.from_numpy(batch_np)})
        params, metrics = step_fn(params, batch,
                                  shard_cohort_rows(mesh,
                                                    torch.from_numpy(masks)),
                                  sizes, args.lr)
        if rank0:
            say(f"[round {t:3d}] loss={float(metrics['loss']):.4f} "
                f"union={float(metrics['union_frac']):.2f} "
                f"({time.time() - t0:.2f}s)")  # repro: allow[nondeterminism] -- round wall-clock telemetry only
    if rank0:
        say(f"[launches] {json.dumps(dict(ops.LAUNCHES))}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
