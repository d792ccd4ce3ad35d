"""A whole tiny run of a cell on the CPU with the timed path broken
underneath (``fedbench/harness/faults.py``) comes out not correct, once
for each fault the cell can have.  One chip only, so no exchange between
chips to leave out."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

import fedbench.run as R  # noqa: E402
from fedbench.harness.faults import FAULTS, SELECTION_FAULTS  # noqa: E402
from fedbench.harness.tiny import tiny_cell  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one thread each, so that test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cases():
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cell = tiny_cell(w["name"])
        solves = cell.traffic["strategy"] != "top"
        for fault in FAULTS + (SELECTION_FAULTS if solves else ()):
            yield pytest.param(w["name"], fault,
                               id=f"{w['name']}-{fault.__name__}")


@pytest.mark.parametrize("name,fault", list(cases()))
def test_a_broken_timed_path_is_not_correct(name, fault):
    torch.manual_seed(0)
    out = R.run_cell(tiny_cell(name), 2**31 + 91, 0.05, False,
                     device="cpu", sabotage=fault)
    assert not out["correct"], out["checks"]
