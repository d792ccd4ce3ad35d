"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped): sound runs come out correct with every metric the cell lists;
the command refuses to run without a card; the import guard names what it
finds."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

import fedbench.run as R  # noqa: E402
from fedbench.harness.tiny import tiny_cell  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one thread each, so that test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,trace", [(n, t) for n in CELLS
                                        for t in (0, 1)])
def test_a_sound_tiny_run_is_correct(name, trace):
    cell = tiny_cell(name)
    out = R.run_cell(cell, 2**31 + 77, 0.05, bool(trace), device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["checks"]) == set(cell.spec["limits"])
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    if trace:
        # on the CPU no kernel runs and the allocator keeps no peak
        assert {m["name"] for m in cell.per_layer} - set(out["metrics"]) \
            <= {"ssd_scan_roofline", "peak_mem_gb"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "fedbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_import_guard_compares_whole_top_level_names():
    clean = ["repro_torch", "repro_torch.models", "jaxtyping", "numpy"]
    assert R.forbidden_modules(clean) == []
    assert R.forbidden_modules(clean + ["repro.core", "jax.numpy"]) == [
        "jax", "repro"]
