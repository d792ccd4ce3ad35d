"""Multi-process gloo worlds for the distributed port's tests.

:func:`run_world` starts ``n`` processes of this file (``torch`` and the
port only: no JAX in a child), joined through a file store in a
temporary directory; each runs the same list of cases on its rank of a
mesh and writes its results there.  The parent waits at most
``timeout`` seconds and kills the world rather than hang.
:func:`run_dry` runs cases the same way on rank 0 of a fake world
(``launch.mesh.dry_mesh``, the meta device) in one process of its own.

A case is a dict with ``kind`` (a key of :data:`CASES`) and its inputs as
numpy arrays; a case function returns a dict of numpy arrays and numbers.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(n: int, mesh: dict, cases: list, timeout: float = 300.0):
    """Run ``cases`` on a world of ``n`` gloo processes over ``mesh``
    ({"data": …, "model": …[, "pod": …]}); returns each rank's results,
    by rank."""
    return _run(n, mesh, cases, timeout)


def run_dry(mesh: dict, cases: list, timeout: float = 300.0) -> dict:
    """Run ``cases`` on rank 0 of a fake world over ``mesh`` in one child
    process: ``{"results": [...], "error": repr of what a case raised or
    None, "initialized_after": whether a process group outlived the
    world}``."""
    return _run(0, mesh, cases, timeout)[0]


def _run(n: int, mesh: dict, cases: list, timeout: float):
    """``n`` gloo ranks, or one fake-world process for ``n`` = 0."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.pkl"), "wb") as f:
            pickle.dump({"mesh": mesh, "cases": cases}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), tmp, str(r), str(n)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(max(n, 1))]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
                logs.append(out)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"the world of {n} did not finish in "
                                 f"{timeout} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
        results = []
        for r in range(max(n, 1)):
            with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


# ---------------------------------------------------------------------------
# The child side
# ---------------------------------------------------------------------------

def _model(case):
    """The case's reduced arch (``experts``: at most that many experts,
    ``heads``: (H, K) replaced, ``vocab``: the vocabulary's size replaced,
    as the parent builds it), with ``tp`` as
    ``RuntimeConfig.tp_constraints`` and ``local`` as its
    ``moe_local_dispatch``."""
    import dataclasses

    from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
    from repro_torch.models.model import Model
    cfg = reduced(get_arch(case["arch"]), n_layers=case.get("layers", 4),
                  d_model=case.get("d_model", 64),
                  max_experts=case.get("experts", 4))
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, n_heads=case["heads"][0],
                                  n_kv_heads=case["heads"][1])
    if case.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab_size=case["vocab"])
    rt = RuntimeConfig(remat=case.get("remat", False), seq_chunk=16,
                       sel_upload=case.get("sel_upload", False),
                       tp_constraints=case.get("tp", False),
                       moe_local_dispatch=case.get("local", False))
    return Model(cfg, rt, device="cpu")


def _layout(model, mesh):
    from repro_torch.sharding.fl_step import storage_layout
    return storage_layout(model, mesh)


def _numpy_tree(tree):
    from repro_torch.bridge import params_to_numpy
    return params_to_numpy(tree)


def _step_inputs(case, mesh):
    import torch

    from repro_torch.sharding.fl_step import shard_cohort_rows
    batch = shard_cohort_rows(mesh, {k: torch.from_numpy(v)
                                     for k, v in case["batch"].items()})
    masks = shard_cohort_rows(mesh, torch.from_numpy(case["masks"]))
    sizes = shard_cohort_rows(mesh, torch.from_numpy(case["sizes"]))
    return batch, masks, sizes


def _finish_step(new_local, metrics, specs, mesh, layout=None):
    """The step's results, its collectives counted before the gather of
    the full tree adds its own."""
    from repro_torch.bridge import gather_params
    from repro_torch.sharding.fl_step import COLLECTIVES
    collectives = dict(COLLECTIVES)
    full = gather_params(new_local, specs, mesh, layout=layout)
    return {"full": _numpy_tree(full), "local": _numpy_tree(new_local),
            "loss": float(metrics["loss"]),
            "union_frac": float(metrics["union_frac"]),
            "collectives": collectives}


def case_fl_step(case, mesh):
    """One τ = 1 step (``make_fl_train_step``)."""
    from repro_torch.bridge import params_to_local
    from repro_torch.sharding.fl_step import (make_fl_train_step,
                                              reset_collectives)
    model = _model(case)
    build = make_fl_train_step(model, mesh, zero3=case["zero3"],
                               sel_idx=case.get("sel_idx"))
    step, specs = build(case["params"])
    layout = _layout(model, mesh)
    local = params_to_local(case["params"], specs, mesh, layout=layout)
    batch, masks, sizes = _step_inputs(case, mesh)
    reset_collectives()
    new, metrics = step(local, batch, masks, sizes, case["lr"])
    return _finish_step(new, metrics, specs, mesh, layout)


def case_fl_step_tau(case, mesh):
    """One τ > 1 step (``make_fl_train_step_tau``)."""
    from repro_torch.bridge import params_to_local
    from repro_torch.kernels import ops
    from repro_torch.sharding.fl_step import (make_fl_train_step_tau,
                                              reset_collectives)
    model = _model(case)
    build = make_fl_train_step_tau(model, mesh, sel_idx=case["sel_idx"],
                                   tau=case["tau"], zero3=case["zero3"])
    step, specs = build(case["params"])
    layout = _layout(model, mesh)
    local = params_to_local(case["params"], specs, mesh, layout=layout)
    batch, masks, sizes = _step_inputs(case, mesh)
    reset_collectives()
    ops.reset_launches()
    new, metrics = step(local, batch, masks, sizes, case["lr"])
    out = _finish_step(new, metrics, specs, mesh, layout)
    out["launches"] = dict(ops.LAUNCHES)
    return out


def case_store_rows(case, mesh):
    """The store's warm rows (``warm_rows_device`` on the mesh) drive the
    step exactly as the same masks given as plain host rows."""
    import numpy as np
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.core.state import ClientStateStore
    from repro_torch.sharding.fl_step import make_fl_train_step
    model = _model(case)
    store = ClientStateStore(100_000, case["masks"].shape[1])
    cohort = np.asarray(case["cohort"])
    store.set_warm_rows(cohort, case["masks"], t=0)
    rows, valid = store.warm_rows_device(cohort, mesh)
    step, specs = make_fl_train_step(model, mesh, zero3=True)(case["params"])
    local = params_to_local(case["params"], specs, mesh)
    batch, masks, sizes = _step_inputs(case, mesh)
    new_a, _ = step(local, batch, rows, sizes, case["lr"])
    new_b, _ = step(local, batch, masks, sizes, case["lr"])
    err = max(float((a - b).abs().max()) for a, b in zip(
        _leaves(new_a), _leaves(new_b)))
    return {"rows": rows.numpy(), "valid": valid, "err": err,
            "rows_equal": bool(torch.equal(rows, masks))}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def case_prefill(case, mesh):
    """Mesh prefill: this rank's rows of the batch (``tokens``, and a vlm's
    stub ``patches`` or whisper's stub ``frames`` where the case has
    them), their logits."""
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.serve import batch_spec, make_prefill_step
    model = _model(case)
    batch = {k: torch.from_numpy(case[k])
             for k in ("tokens", "patches", "frames") if k in case}
    tokens = batch["tokens"]
    prefill, specs = make_prefill_step(model, mesh, zero3=case["zero3"])(
        case["params"], batch)
    local = params_to_local(case["params"], specs, mesh,
                            layout=_layout(model, mesh))
    b_spec = batch_spec(model, mesh, tokens.shape[0])
    mine = {k: rules.local_shard(v, b_spec, mesh) for k, v in batch.items()}
    return {"logits": prefill(local, mine).numpy(),
            "rows": rules.local_shard(torch.arange(tokens.shape[0]), b_spec,
                                      mesh).numpy()}


def case_decode(case, mesh):
    """Greedy decode through the mesh serve step, from a prompt fed one
    token a step: this rank's rows' tokens and last logits.  whisper's
    case carries its filled cross cache (``cross_kv``: full ``k`` / ``v``
    (L, B, enc_seq, K, hd), as the parent filled it from the reference's
    encoder), which ``shard_cache`` lays out with the rest."""
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.serve import (batch_spec, make_serve_step,
                                            shard_cache)
    model = _model(case)
    prompt = torch.from_numpy(case["prompt"])              # (B, P)
    B, P = prompt.shape
    steps = case["steps"]
    cache = model.init_cache(B, P + steps)
    if "cross_kv" in case:
        cache["cross_kv"] = {k: torch.from_numpy(v)
                             for k, v in case["cross_kv"].items()}
    serve, (specs, c_specs) = make_serve_step(
        model, mesh, zero3=case["zero3"])(case["params"], cache, B)
    local = params_to_local(case["params"], specs, mesh,
                            layout=_layout(model, mesh))
    cache = shard_cache(model, mesh, cache, c_specs)
    b_spec = batch_spec(model, mesh, B)
    prompt = rules.local_shard(prompt, b_spec, mesh)
    out, tok = [], prompt[:, 0]
    mine = {k: tuple(v.shape) for k, v in cache.get("cross_kv", {}).items()}
    for t in range(P + steps - 1):
        pos = torch.tensor(t, dtype=torch.int32)
        nxt, logits, cache = serve(local, tok, pos, cache)
        tok = prompt[:, t + 1] if t + 1 < P else nxt
        if t + 1 >= P:
            out.append(nxt)
    return {"tokens": torch.stack(out, 1).numpy(), "logits": logits.numpy(),
            "rows": rules.local_shard(torch.arange(B), b_spec, mesh).numpy(),
            "cross_kv_shapes": mine}


def case_tp_round_trip(case, mesh):
    """Tensor-parallel storage of the full params: this rank's shards,
    its model slices (the shards gathered over ``data``), the full tree
    gathered back, and its head counts."""
    from repro_torch.bridge import gather_params, params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import gather_tree
    model = _model(case)
    layout = _layout(model, mesh)
    specs = rules.params_pytree_specs(model.cfg, case["params"],
                                      zero3=case["zero3"],
                                      mesh_shape=dict(mesh.shape))
    local = params_to_local(case["params"], specs, mesh, layout=layout)
    return {"local": _numpy_tree(local),
            "model_slice": _numpy_tree(gather_tree(local, specs, mesh)),
            "full": _numpy_tree(gather_params(local, specs, mesh,
                                              layout=layout)),
            "mode": layout.mode}


def case_tp_ssm_block(case, mesh):
    """One Mamba2 block's parallel form on this rank (f32): its model
    slice of each full leaf of ``case["row"]`` (the storage of a spec
    without ZeRO-3, so the data ranks hold the same), viewed as the step's
    row hook views it (``ModelAxis.view_row``: B | C gathered over
    ``model``, the replicated vectors narrowed), the block on
    ``case["x"]`` with the gate norm's statistic summed over ``model``,
    g, and the gradients for ``case["dy"]``: x + the block, dx and each
    local leaf's gradient."""
    import torch

    from repro_torch.models.model import _take
    from repro_torch.models.ssd import mamba2_fwd
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import model_axis, storage_layout
    model = _model(case)
    cfg, layout = model.cfg, storage_layout(model, mesh)
    axis = model_axis(layout, mesh)
    stacked = {k: torch.from_numpy(v)[None] for k, v in case["row"].items()}
    specs = rules.params_pytree_specs(cfg, {"blocks": stacked}, zero3=False,
                                      mesh_shape=dict(mesh.shape))["blocks"]
    local = {k: rules.tp_local_shard(v, specs[k], mesh, layout,
                                     ("blocks", k))[0].clone()
             .requires_grad_() for k, v in stacked.items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    y, _ = mamba2_fwd(_take(axis.view_row(local, specs), "ssm_"), x, cfg,
                      tp=axis)
    out = x + axis.reduce(y)
    grads = torch.autograd.grad(out, [x, *local.values()],
                                torch.from_numpy(case["dy"]))
    return {"out": out.detach().numpy(), "dx": grads[0].numpy(),
            "grads": {k: g.numpy() for k, g in zip(local, grads[1:])}}


def case_tp_moe_grads(case, mesh):
    """The loss of ``case["tokens"]`` (every rank the same batch) under the
    moe family's parallel form, its params stored without ZeRO-3 (the data
    ranks hold the same model slices): the loss, the routers' aux loss
    and the gradients of the rank's ``blocks`` leaves ``case["names"]``
    (by default its router and ``moe_ln``, replicated over ``model``, and
    its ``moe_wi_e`` slice; MLA's ``attn_ln``, ``attn_kv_ln`` and
    ``w_dkv`` / ``w_krope`` slices where named)."""
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import (model_axis, storage_layout,
                                              view_shared)
    model = _model(case)
    layout = storage_layout(model, mesh)
    axis = model_axis(layout, mesh)
    specs = rules.params_pytree_specs(model.cfg, case["params"], zero3=False,
                                      mesh_shape=dict(mesh.shape))
    local = params_to_local(case["params"], specs, mesh, layout=layout)
    names = case.get("names", ("moe_router", "moe_ln", "moe_wi_e"))
    wrt = {nm: local["blocks"][nm].detach().requires_grad_()
           for nm in names}
    params = view_shared({**local, "blocks": {**local["blocks"], **wrt}},
                         specs, axis)
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    hook = (lambda pl, idx, seg: axis.view_row(pl, specs[seg]))
    h, aux, prefix = model.hidden_seq(params, batch, tp=axis,
                                      layer_hook=hook)
    loss = model.loss_from_hidden(params, h, aux, prefix, batch, tp=axis)
    grads = torch.autograd.grad(loss, list(wrt.values()))
    return {"loss": float(loss), "aux": float(aux),
            "grads": {nm: g.numpy() for nm, g in zip(names, grads)},
            "expert_parallel": layout.expert_parallel}


def case_tp_vlm_grads(case, mesh):
    """A vlm language model's loss of ``case["batch"]`` (every rank the same
    rows) under its parallel form, its params stored without ZeRO-3 (the
    data ranks hold the same model slices): the loss, the loss again with
    the prefix's hidden rows moved (the loss reads the text positions
    only), and the gradients of the rank's ``patch_proj`` slice, of the
    whole ``patch_proj`` it gathers over ``model`` and of its ``blocks``
    row's ``attn_ln``."""
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import (model_axis, storage_layout,
                                              view_shared)
    model = _model(case)
    axis = model_axis(storage_layout(model, mesh), mesh)
    specs = rules.params_pytree_specs(model.cfg, case["params"], zero3=False,
                                      mesh_shape=dict(mesh.shape))
    local = params_to_local(case["params"], specs, mesh,
                            layout=storage_layout(model, mesh))
    proj = local["embed"]["patch_proj"].detach().requires_grad_()
    ln = local["blocks"]["attn_ln"].detach().requires_grad_()
    params = view_shared({**local, "embed": {**local["embed"],
                                             "patch_proj": proj},
                          "blocks": {**local["blocks"], "attn_ln": ln}},
                         specs, axis)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    hook = (lambda pl, idx, seg: axis.view_row(pl, specs[seg]))
    h, aux, prefix = model.hidden_seq(params, batch, tp=axis,
                                      layer_hook=hook)
    loss = model.loss_from_hidden(params, h, aux, prefix, batch, tp=axis)
    moved = model.loss_from_hidden(
        params, torch.cat([h[:, :prefix] + 1.0, h[:, prefix:]], 1), aux,
        prefix, batch, tp=axis)
    whole = params["embed"]["patch_proj"]
    g_proj, g_whole, g_ln = torch.autograd.grad(loss, [proj, whole, ln])
    return {"loss": float(loss), "moved_prefix_loss": float(moved),
            "prefix_len": prefix, "mode": axis.mode,
            "grads": {"patch_proj": g_proj.numpy(),
                      "patch_proj_whole": g_whole.numpy(),
                      "attn_ln": g_ln.numpy()}}


def case_tp_audio_grads(case, mesh):
    """whisper's loss of ``case["batch"]`` (``frames`` and ``tokens``,
    every rank the same rows) under its parallel form, its params stored
    without ZeRO-3 (the data ranks hold the same model slices): the loss,
    the gradient of every stored leaf (the rank's slices of the split
    ones) and of the whole ``frame_proj`` the rank gathers over
    ``model``, and the rank's storage of ``case["want"]`` (the
    single-host gradients, full) to hold them against."""
    import torch

    from repro_torch.bridge import params_to_local
    from repro_torch.sharding import rules
    from repro_torch.sharding.fl_step import (model_axis, storage_layout,
                                              view_shared)
    from repro_torch.tree import tree_items
    model = _model(case)
    layout = storage_layout(model, mesh)
    axis = model_axis(layout, mesh)
    specs = rules.params_pytree_specs(model.cfg, case["params"], zero3=False,
                                      mesh_shape=dict(mesh.shape))
    local = params_to_local(case["params"], specs, mesh, layout=layout)
    local = {g: {k: v.detach().requires_grad_() for k, v in sub.items()}
             if isinstance(sub, dict) else sub.detach().requires_grad_()
             for g, sub in local.items()}
    params = view_shared(local, specs, axis)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    hook = (lambda pl, idx, seg: axis.view_row(pl, specs[seg]))
    h, aux, prefix = model.hidden_seq(params, batch, tp=axis,
                                      layer_hook=hook)
    loss = model.loss_from_hidden(params, h, aux, prefix, batch, tp=axis)
    leaves = tree_items(local)
    whole = params["embed"]["frame_proj"]
    grads = torch.autograd.grad(loss, [t for _, t in leaves] + [whole])
    want = params_to_local(case["want"], specs, mesh, layout=layout)
    return {"loss": float(loss), "mode": axis.mode,
            "vocab_split": axis.vocab_split,
            "grads": {"/".join(p): g.numpy()
                      for (p, _), g in zip(leaves, grads)},
            "frame_proj_whole": grads[-1].numpy(),
            "want_whole": case["want"]["embed"]["frame_proj"],
            "want": {"/".join(p): t.numpy() for p, t in tree_items(want)}}


def case_dryrun_facts(case, mesh):
    """``launch.dryrun.build_program`` of a reduced arch at a small
    ``ShapeConfig`` on this mesh (meta stand-ins on a fake world, seeded
    tensors on gloo), run once under the auditor: its fact row.  With
    ``zero3`` the ZeRO-3 threshold is 0, so the base is stored sharded;
    ``experts`` caps a moe arch's experts, ``local`` is its
    ``moe_local_dispatch``."""
    from repro_torch.configs.base import (RuntimeConfig, ShapeConfig,
                                          get_arch, reduced)
    from repro_torch.launch import dryrun
    if case.get("zero3"):
        dryrun.ZERO3_THRESHOLD_BYTES = 0
    cfg = reduced(get_arch(case["arch"]), n_layers=case.get("layers", 2),
                  d_model=case.get("d_model", 64),
                  max_experts=case.get("experts", 4))
    rt = RuntimeConfig(remat=case.get("remat", False), seq_chunk=16,
                       tp_constraints=case.get("tp", False),
                       moe_local_dispatch=case.get("local", False))
    prog = dryrun.build_program(cfg, ShapeConfig(*case["shape"]), mesh, rt,
                                kernel_mode=case.get("kernel_mode"))
    return {"facts": dryrun.program_facts(case["name"], prog).to_dict(),
            "zero3": prog.zero3}


def case_dryrun_pair(case, mesh):
    """``launch.dryrun.lower_pair`` of a full-width pair on this mesh
    (``opt``: the CLI's ``--opt`` levers)."""
    from repro_torch.launch.dryrun import lower_pair, opt_runtime
    from repro_torch.configs.base import RuntimeConfig
    runtime = opt_runtime(0.0) if case.get("opt") else RuntimeConfig()
    return lower_pair(case["arch"], case["shape"], False, runtime, mesh=mesh)


def case_dry_refused(case, mesh):
    """A dry mesh asked for inside this (gloo) world: the error it raises,
    and whether the world is intact after it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import dry_mesh
    try:
        with dry_mesh((2, 2), ("data", "model")):
            return {"error": None}
    except RuntimeError as e:
        return {"error": str(e), "backend": dist.get_backend(),
                "world": dist.get_world_size()}


def case_fail(case, mesh):
    raise RuntimeError(case.get("message", "a case failed"))


CASES = {"fl_step": case_fl_step, "fl_step_tau": case_fl_step_tau,
         "store_rows": case_store_rows, "prefill": case_prefill,
         "decode": case_decode, "dryrun_facts": case_dryrun_facts,
         "dryrun_pair": case_dryrun_pair, "dry_refused": case_dry_refused,
         "tp_round_trip": case_tp_round_trip,
         "tp_ssm_block": case_tp_ssm_block,
         "tp_moe_grads": case_tp_moe_grads,
         "tp_vlm_grads": case_tp_vlm_grads,
         "tp_audio_grads": case_tp_audio_grads, "fail": case_fail}


def _mesh_dims(m: dict) -> tuple:
    names = (("pod",) if m.get("pod") else ()) + ("data", "model")
    return tuple(m[a] for a in names), names


def _dry_child(tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import dry_mesh
    with open(os.path.join(tmp, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    results, error = [], None
    try:
        with dry_mesh(*_mesh_dims(job["mesh"])) as mesh:
            for c in job["cases"]:
                results.append(CASES[c["kind"]](c, mesh))
    except Exception as e:  # recorded for the parent to assert on
        error = repr(e)
    with open(os.path.join(tmp, "out_0.pkl"), "wb") as f:
        pickle.dump({"results": results, "error": error,
                     "initialized_after": dist.is_initialized()}, f)


def _child(tmp: str, rank: int, n: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    with open(os.path.join(tmp, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=n)
    m = job["mesh"]
    mesh = make_host_mesh(m["data"], m["model"], pod=m.get("pod", 0),
                          device="cpu")
    coords = {a: mesh.coord(a) for a in mesh.axis_names}
    results = [dict(CASES[c["kind"]](c, mesh), coords=coords)
               for c in job["cases"]]
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    if int(sys.argv[3]) == 0:
        _dry_child(sys.argv[1])
    else:
        _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
