"""The port's configs, parameter layout and weight bridge against the JAX
package, and the port's isolation from JAX."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models.model import init_params as jax_init_params
from repro_torch.bridge import params_to_numpy, params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.models.model import init_params as torch_init_params

REPO = os.path.join(os.path.dirname(__file__), "..")
ARCHS = jcfg.all_arch_names(include_paper=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    """Every architecture's config, and its reduced variant, is the
    reference's field for field."""
    want, got = jcfg.get_arch(arch), tcfg.get_arch(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduced(got, n_layers=3, d_model=64)) == \
        dataclasses.asdict(jcfg.reduced(want, n_layers=3, d_model=64))
    assert dataclasses.asdict(tcfg.RuntimeConfig()) == \
        dataclasses.asdict(jcfg.RuntimeConfig())


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _host_f32(tree):
    return {k: _host_f32(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def _jax_params(arch, dtype="float32"):
    cfg = dataclasses.replace(
        jcfg.reduced(jcfg.get_arch(arch), n_layers=3, d_model=64), dtype=dtype)
    return cfg, jax_init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "codeqwen1_5_7b",
                                  "paligemma_3b"])
def test_init_params_layout_matches_reference(arch):
    """Same paths, key order, shapes and types as the JAX init."""
    cfg, jp = _jax_params(arch)
    gen = torch.Generator().manual_seed(0)
    tp = torch_init_params(tcfg.reduced(tcfg.get_arch(arch), n_layers=3,
                                        d_model=64), gen, "cpu")
    want = [(path, tuple(a.shape), str(a.dtype)) for path, a in _leaves(jp)]
    got = [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _leaves(tp)]
    assert got == want


@pytest.mark.parametrize("arch,dtype", [("tinyllama_1_1b", "float32"),
                                        ("codeqwen1_5_7b", "float32"),
                                        ("tinyllama_1_1b", "bfloat16")])
def test_round_trip_is_exact(arch, dtype):
    """numpy → torch → numpy gives back every leaf bit for bit, in the same
    key order; bf16 crosses as f32 and is cast back."""
    _, jp = _jax_params(arch, dtype)
    host = _host_f32(jp)          # jax.tree.map would sort the keys
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    tp = params_to_torch(host, "cpu", dtype=tdt)
    back = params_to_numpy(tp)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(host)]
    for (path, a), (_, b) in zip(_leaves(host), _leaves(back)):
        assert b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if tdt is not None:
        assert all(t.dtype == tdt for _, t in _leaves(tp))
    # JAX bf16 arrays cross directly too
    direct = params_to_torch(jp, "cpu")
    for (path, a), (_, t) in zip(_leaves(tp), _leaves(direct)):
        assert torch.equal(a, t), path


def test_port_imports_no_jax_and_no_reference():
    """Importing every repro_torch module leaves neither ``jax`` nor the
    ``repro`` package in sys.modules."""
    code = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 25, names
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
