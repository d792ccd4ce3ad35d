"""The port's base+delta matmul (repro_torch/kernels) against the JAX
package's Pallas kernel (interpret mode) and its jnp twin, on the same
numpy-seeded inputs.  The CUDA kernel itself runs only on the card
(chip_smoke.py); here its plain version and the dispatch are checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_matmul import (base_delta_matmul_2d,
                                        base_delta_matmul_2d_jnp)
from repro_torch.bridge import params_to_torch
from repro_torch.kernels import delta_matmul as tdmm
from repro_torch.kernels import ops as tops

# (B, d, f, C, block_f, dtype): the shapes of tests/test_kernels.py
DELTA_MM_CASES = [
    (4, 64, 128, 2, None, "float32"),
    (6, 128, 512, 4, 128, "float32"),
    (3, 32, 100, 1, 64, "float32"),
    (4, 64, 256, 3, None, "bfloat16"),
    (2, 16, 48, 2, 32, "bfloat16"),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, d, f, C, dtype, seed=5, slots=None):
    """numpy-seeded inputs as (jax arrays, torch tensors): x/w in ``dtype``,
    dw rounded to ``dtype`` for JAX and handed to the port as f32."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    w = rng.standard_normal((d, f)).astype(np.float32)
    dw = (rng.standard_normal((C, d, f)) * 0.1).astype(np.float32)
    if slots is None:
        slots = rng.permutation(B)[:C].astype(np.int32)
        if C > 1:
            slots[-1] = -1
    jx, jw, jdw = (jnp.asarray(a, dtype) for a in (x, w, dw))
    tx, tw, tdw = (params_to_torch({"a": np.asarray(a)}, "cpu")["a"]
                   for a in (jx, jw, jdw))
    return ((jx, jw, jdw, jnp.asarray(slots)),
            (tx, tw, tdw.float(), torch.from_numpy(np.asarray(slots))))


def _close(got: torch.Tensor, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,d,f,C,block_f,dtype", DELTA_MM_CASES)
def test_plain_matches_pallas_interpret(B, d, f, C, block_f, dtype):
    (jx, jw, jdw, js), targs = _inputs(B, d, f, C, dtype)
    want = base_delta_matmul_2d(jx, jw, jdw, js, block_f=block_f,
                                interpret=True)
    got = tdmm.base_delta_matmul_2d_torch(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (B, f)
    _close(got, want, dtype)


@pytest.mark.parametrize("B,d,f,C,block_f,dtype", DELTA_MM_CASES)
def test_plain_matches_jnp_twin(B, d, f, C, block_f, dtype):
    (jx, jw, jdw, js), targs = _inputs(B, d, f, C, dtype)
    want = base_delta_matmul_2d_jnp(jx, jw, jdw, js, block_f=block_f)
    _close(tdmm.base_delta_matmul_2d_torch(*targs), want, dtype)


def test_plain_repeated_slot_adds_every_entry():
    """Two entries naming slot 1 both add, in entry order."""
    slots = np.array([1, -1, 1], np.int32)
    (jx, jw, jdw, js), targs = _inputs(3, 32, 64, 3, "float32", slots=slots)
    want = base_delta_matmul_2d_jnp(jx, jw, jdw, js)
    _close(tdmm.base_delta_matmul_2d_torch(*targs), want, "float32")


def test_ops_decode_layout_matches_2d():
    """(B,1,d) decode activations give the (B,d) result with a seq axis."""
    _, (x, w, dw, slots) = _inputs(3, 16, 32, 2, "float32")
    out3 = tops.base_delta_matmul(x[:, None], w, dw, slots)
    out2 = tops.base_delta_matmul(x, w, dw, slots)
    assert out3.shape == (3, 1, 32)
    torch.testing.assert_close(out3[:, 0], out2, atol=0, rtol=0)


def test_ops_empty_table_is_plain_product():
    _, (x, w, dw, _) = _inputs(3, 16, 32, 2, "float32")
    empty = torch.full((2,), -1, dtype=torch.int32)
    out = tops.base_delta_matmul(x, w, dw, empty, mode="torch")
    torch.testing.assert_close(out, x @ w, atol=1e-5, rtol=1e-5)


def test_ops_cpu_tensor_takes_plain_version_without_launch():
    _, args = _inputs(4, 64, 128, 2, "float32")
    tops.reset_launches()
    out = tops.base_delta_matmul(*args)
    assert tops.LAUNCHES["base_delta_matmul"] == 0
    torch.testing.assert_close(out, tdmm.base_delta_matmul_2d_torch(*args),
                               atol=0, rtol=0)


def test_cuda_mode_on_cpu_tensor_raises():
    _, args = _inputs(4, 64, 128, 2, "float32")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.base_delta_matmul(*args, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tdmm.base_delta_matmul_2d(*args)
    with pytest.raises(ValueError, match="mode must be"):
        tops.base_delta_matmul(*args, mode="pallas")
    assert tops.LAUNCHES["base_delta_matmul"] == 0
