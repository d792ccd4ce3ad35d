"""The port's train CLI (repro_torch.launch.train) under
``torch.distributed.run`` on the CPU, and the mesh constructors' refusals.

Two gloo ranks run two rounds of the reference CLI's defaults (reduced
TinyLlama, 4 layers, d_model 128): each rank probes its own client, the
probe rows are all-gathered, both ranks select and must agree on the
masks.  The launcher runs in a session of its own with a timeout, so a
hang fails the test instead of the run.
"""
import json
import math
import os
import re
import signal
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        # the ranks' own lines on stdout; warnings and the launcher's log
        # on stderr, where they cannot break a line the test reads
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"the CLI did not finish in {timeout} s")
    assert p.returncode == 0, (out + err)[-6000:]
    return out


def test_cli_two_ranks_agree_on_masks_and_train():
    out = _launch(["--device", "cpu", "--rounds", "2"])
    assert "mesh={'data': 2, 'model': 1} cohort=2 arch=tinyllama-1.1b" in out
    losses = [float(m) for m in re.findall(r"^\[round +\d+\] loss=(\S+)", out,
                                           re.M)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    masks = re.findall(r"^\[rank (\d)\] round (\d) client (\d) masks=(.*)$",
                       out, re.M)
    by_round = {}
    for rank, rnd, client, m in masks:
        assert rank == client                      # one client per rank
        by_round.setdefault(rnd, {})[rank] = m
    assert sorted(by_round) == ["0", "1"]
    for rnd, seen in by_round.items():
        assert sorted(seen) == ["0", "1"] and seen["0"] == seen["1"], rnd
        rows = json.loads(seen["0"])
        assert len(rows) == 2 and all(sum(r) == 2 for r in rows)  # budget 2
    assert re.search(r"^\[launches\] \{", out, re.M)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a GPU")
def test_cli_without_a_gpu_raises_at_the_default_device():
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--rounds", "1"])
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a GPU")
def test_mesh_refusals():
    """A card mesh without a card and a mesh whose size is not the
    world's raise; a gloo world of 1 takes (1, 1) and (1, 1, 1) meshes."""
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(1, 1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert (mesh.coord("data"), mesh.index(("data",))) == (0, 0)
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_host_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="needs 256 processes"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 processes"):
            make_production_mesh(multi_pod=True, device="cpu")
        pod = make_host_mesh(1, 1, pod=1, device="cpu")
        assert pod.axis_names == ("pod", "data", "model")
        assert pod.group(("pod", "data")) is not None
    finally:
        dist.destroy_process_group()
