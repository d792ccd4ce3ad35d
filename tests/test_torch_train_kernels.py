"""The port's training kernels (repro_torch/kernels: layer_grad_norm,
masked_update) against the JAX package's Pallas kernels (interpret mode)
and their jnp twins, on the same numpy-seeded inputs.  The CUDA kernels
run only on the card (chip_smoke.py); here their plain versions, the
pytree wrappers in ``ops`` and the dispatch are checked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.layer_grad_norm import (layer_sq_norms_2d,
                                           layer_sq_norms_2d_jnp)
from repro.kernels.masked_update import (masked_sgd_update_2d,
                                         masked_sgd_update_2d_jnp)
from repro_torch.bridge import params_to_torch
from repro_torch.kernels import layer_grad_norm as tlgn
from repro_torch.kernels import masked_update as tmu
from repro_torch.kernels import ops as tops

NORM_CASES = [(1, 7), (3, 4096), (8, 5000), (2, 17)]   # tests/test_kernels.py
DTYPES = ["float32", "bfloat16"]
LR = 0.1


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as (jax array in ``dtype``, the same values as a
    torch tensor in ``dtype``): bf16 rounding happens once, in JAX."""
    ja = jnp.asarray(a, dtype)
    return ja, params_to_torch({"a": np.asarray(ja)}, "cpu")["a"].to(
        getattr(torch, dtype))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at magnitude |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x.float()), e - 8)


@pytest.mark.parametrize("L,F", NORM_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ref", ["pallas_interpret", "jnp"])
def test_layer_sq_norms_plain_matches_reference(L, F, dtype, ref):
    g = np.random.RandomState(L * 31 + F).standard_normal((L, F))
    jg, tg = _pair(g.astype(np.float32), dtype)
    want = (layer_sq_norms_2d(jg, interpret=True) if ref == "pallas_interpret"
            else layer_sq_norms_2d_jnp(jg))
    got = tlgn.layer_sq_norms_2d_torch(tg)
    assert got.dtype == torch.float32 and got.shape == (L,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("L,F", NORM_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ref", ["pallas_interpret", "jnp"])
def test_masked_update_plain_matches_reference(L, F, dtype, ref):
    """Against the jnp twin (two rounded f32 operations, the kernel's
    order): equal bit for bit.  Against the interpreted Pallas kernel,
    which XLA contracts into one fused multiply-add, within rtol 1e-6 in
    f32 and one bf16 ulp, both relative to the operands' scale
    |p| + lr·|g| (a result that cancels to near zero has no relative
    precision of its own)."""
    rng = np.random.RandomState(L * 17 + F)
    p = rng.standard_normal((L, F)).astype(np.float32)
    g = rng.standard_normal((L, F)).astype(np.float32)
    mask = (np.arange(L) % 2).astype(np.float32)
    mask[0] = 1.0
    (jp, tp), (jg, tg) = _pair(p, dtype), _pair(g, dtype)
    jm = jnp.asarray(mask)
    want = (masked_sgd_update_2d(jp, jg, jm, LR, interpret=True)
            if ref == "pallas_interpret"
            else masked_sgd_update_2d_jnp(jp, jg, jm, LR))
    got = tmu.masked_sgd_update_2d_torch(tp, tg, torch.from_numpy(mask), LR)
    assert got.dtype == tp.dtype and got.shape == tp.shape
    want_t = torch.from_numpy(np.array(want, np.float32))
    if ref == "jnp":
        assert torch.equal(got.float(), want_t)
    else:
        scale = tp.float().abs() + LR * tg.float().abs()
        tol = 1e-6 * scale if dtype == "float32" else _bf16_ulp(scale)
        assert bool(((got.float() - want_t).abs() <= tol).all())
    # rows with mask 0 come back unchanged, exactly
    for row in np.flatnonzero(mask == 0):
        assert torch.equal(got[row], tp[row])


def test_masked_update_zero_mask_still_poisons_non_finite_grads():
    """The reference computes p − 0·g: a non-finite g gives NaN even where
    the layer is frozen (the fault slice's finite guard relies on it)."""
    p = torch.ones((2, 4))
    g = torch.tensor([[np.inf, 1.0, 1.0, 1.0], [1.0, 1.0, np.nan, 1.0]])
    out = tmu.masked_sgd_update_2d_torch(p, g, torch.zeros(2), LR)
    assert torch.isnan(out[0, 0]) and torch.isnan(out[1, 2])
    assert torch.equal(out[0, 1:], p[0, 1:])


def _tree(seed):
    """A stacked pytree of L=3 layers with leaves of several ranks."""
    rng = np.random.RandomState(seed)
    return {"wq": rng.standard_normal((3, 8, 16)).astype(np.float32),
            "ln": rng.standard_normal((3, 8)).astype(np.float32),
            "bias": rng.standard_normal((3, 4, 4, 2)).astype(np.float32)}


def test_ops_layer_grad_norms_matches_reference():
    tree = _tree(1)
    want = jops.layer_grad_norms({k: jnp.asarray(v) for k, v in tree.items()},
                                 mode="jnp")
    got = tops.layer_grad_norms(params_to_torch(tree, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ops_masked_sgd_update_matches_reference():
    p, g = _tree(2), _tree(3)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want = jops.masked_sgd_update({k: jnp.asarray(v) for k, v in p.items()},
                                  {k: jnp.asarray(v) for k, v in g.items()},
                                  jnp.asarray(mask), LR, mode="jnp")
    got = tops.masked_sgd_update(params_to_torch(p, "cpu"),
                                 params_to_torch(g, "cpu"),
                                 torch.from_numpy(mask), LR)
    assert list(got) == list(p)
    for k in p:
        assert got[k].shape == p[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_cpu_tensors_leave_launch_counts_untouched():
    tops.reset_launches()
    tree = params_to_torch(_tree(4), "cpu")
    tops.layer_grad_norms(tree)
    tops.masked_sgd_update(tree, tree, torch.ones(3), LR)
    assert tops.LAUNCHES == {k: 0 for k in tops.LAUNCHES}
    assert {"layer_grad_norm", "masked_update"} <= set(tops.LAUNCHES)


def test_cuda_mode_on_cpu_tensor_raises():
    tree = params_to_torch(_tree(5), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tops.layer_grad_norms(tree, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.masked_sgd_update(tree, tree, torch.ones(3), LR, mode="cuda")
    with pytest.raises(ValueError, match="mode"):
        tops.layer_grad_norms(tree, mode="pallas")
    assert tops.LAUNCHES["layer_grad_norm"] == 0
