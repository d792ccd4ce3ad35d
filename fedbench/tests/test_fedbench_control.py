"""The control at a size a test run holds: the reference one precision
lower (fp8 operands) put in the program's place reads over the cell's
limits; the reference, the traffic and the yardstick import nothing of
the program, of JAX or of the JAX package."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

from fedbench.control import control_readings  # noqa: E402
from fedbench.harness.tiny import tiny_cell  # noqa: E402

OURS = "mamba2-370m.round.ours"
FORBIDDEN = {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one thread each, so that test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_fp8_control_fails_the_cells_limits():
    cell = tiny_cell(OURS)
    got = control_readings(cell, 2**31 + 5, ["fp8"], "cpu")["fp8"]
    limits = cell.spec["limits"]
    assert any(v > limits[k] for k, v in got.items()), got


def test_masks_on_reversed_utilities_fail_the_masks_limit():
    cell = tiny_cell(OURS)
    got = control_readings(cell, 2**31 + 5, ["reversed"], "cpu")
    assert got["reversed"]["masks"] > cell.spec["limits"]["masks"], got


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("folder", ["reference", "traffic", "work",
                                    "metrics"])
def test_the_yardstick_imports_nothing_of_the_program(folder):
    for path in sorted((ROOT / "fedbench" / folder).glob("*.py")):
        assert not _imports(path) & FORBIDDEN, path


def test_the_loaded_reference_pulls_in_nothing_of_the_program():
    code = ("import sys; import fedbench.reference.ssm, "
            "fedbench.reference.rounds, "
            "fedbench.harness.follow, fedbench.harness.readings, "
            "fedbench.traffic.generator; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout)) & FORBIDDEN
