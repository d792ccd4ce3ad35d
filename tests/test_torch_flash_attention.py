"""The port's flash attention (repro_torch.kernels.flash_attention and
repro_torch.kernels.ops.flash_attention) against the JAX package's
``flash_attention_jnp`` twin, its Pallas kernel in interpret mode, the
dense oracle ``ref.flash_attention_ref`` and ``jax.grad`` of that oracle,
on the same numpy-seeded inputs.  The CUDA kernels run only on the card
(chip_smoke.py); here the plain forward and backward and the autograd
wrapper's dispatch are checked.

Tolerances: the forward as the reference's own kernel tests hold it (2e-5
for f32, 2e-2 for bf16: one rounding of the output); the backward within
1e-5 in f32 (dense sums of at most S terms taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.flash_attention import flash_attention_jnp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# tests/test_kernels.py::ATTN_CASES: (B, H, K, S, D, causal, window, dtype)
ATTN_CASES = [
    (2, 4, 2, 128, 64, True, 0, "float32"),
    (1, 4, 4, 256, 64, False, 0, "float32"),
    (2, 8, 2, 128, 128, True, 64, "float32"),
    (1, 2, 1, 256, 64, True, 96, "float32"),
    (1, 4, 2, 128, 64, True, 0, "bfloat16"),
]
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_TOL = 1e-5


def _qkv(B, H, K, S, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32))


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``; bf16
    rounding happens once, in JAX."""
    ja = jnp.asarray(a, dtype)
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(
        getattr(torch, dtype))


def _assert_close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize(
    "B,H,K,S,D,causal,window,dtype,block",
    [(*c, 64) for c in ATTN_CASES]
    + [(1, 2, 1, 128, 256, True, 0, "float32", 64),      # Gemma's head dim
       (1, 2, 1, 1024, 64, True, 0, "float32", 128)])    # the TPU's blocks
def test_plain_forward_matches_jnp_twin(B, H, K, S, D, causal, window, dtype,
                                        block):
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(a, dtype) for a in _qkv(B, H, K, S, D, seed=S + D + H))
    want = flash_attention_jnp(jq, jk, jv, causal=causal, window=window,
                               block_q=block, block_k=block)
    got, lse = tfa.flash_attention_torch(tq, tk, tv, causal=causal,
                                         window=window, block_q=block,
                                         block_k=block)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _assert_close(got, want, FWD_TOL[dtype])


def _lse_ref(q, k, causal, window):
    """log Σ exp over the visible scores, dense numpy in f64."""
    B, H, S, D = q.shape
    kf = np.repeat(k, H // k.shape[1], axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) / np.sqrt(D)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    s = np.where(ok, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0),
                                           (False, 32)])
def test_plain_forward_ragged_s_matches_oracle(causal, window):
    """S = 200 is no multiple of the 128 blocks: the plain version masks the
    ragged last block itself.  Held against the dense oracle, which takes
    any S, and lse against a dense f64 log-sum-exp."""
    B, H, K, S, D = 2, 4, 2, 200, 64
    q, k, v = _qkv(B, H, K, S, D, seed=11)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    got, lse = tfa.flash_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    _assert_close(got, want, FWD_TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal, window),
                               rtol=1e-5, atol=1e-5)


def test_plain_forward_matches_pallas_kernel_interpret():
    B, H, K, S, D = 1, 4, 2, 128, 64
    q, k, v = _qkv(B, H, K, S, D, seed=5)
    want = fa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=48, block_q=64, block_k=64,
                     interpret=True)
    got, _ = tfa.flash_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=48,
        block_q=64, block_k=64)
    _assert_close(got, want, FWD_TOL["float32"])


def _model_layout(a: np.ndarray) -> torch.Tensor:
    """(B,H,S,D) numpy → (B,S,H,D) torch leaf that requires grad."""
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3))).requires_grad_()


@pytest.mark.parametrize("H,K,S,causal,window", [
    (4, 4, 64, True, 0),         # causal
    (4, 4, 64, True, 16),        # sliding window
    (4, 4, 48, False, 0),        # bidirectional (the classifier)
    (8, 2, 72, True, 0),         # GQA, four q heads per kv head
    (6, 3, 40, False, 24),       # GQA, bidirectional with a window
])
def test_plain_backward_matches_jax_grad(H, K, S, causal, window):
    """Through ops.flash_attention's autograd.Function (model layout)
    against jax.grad of the dense oracle, f32."""
    B, D = 2, 32
    q, k, v = _qkv(B, H, K, S, D, seed=H * 100 + S)
    w = np.random.RandomState(3).standard_normal((B, H, S, D)).astype(
        np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                               window=window) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_model_layout(a) for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (B, S, H, D)
    (out * torch.from_numpy(w).transpose(1, 2)).sum().backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref_g).transpose(0, 2, 1, 3),
            atol=BWD_TOL, rtol=BWD_TOL)


def test_plain_backward_bf16_keeps_types():
    q, k, v = _qkv(1, 4, 2, 32, 64, seed=9)
    tq, tk, tv = (_model_layout(a).detach().bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=True)
    out.float().square().sum().backward()
    assert out.dtype == torch.bfloat16
    for t in (tq, tk, tv):
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
        assert torch.isfinite(t.grad.float()).all()


@pytest.mark.parametrize("mode", [None, "torch"])
def test_dispatch_cpu_and_torch_mode_take_the_plain_versions(monkeypatch,
                                                             mode):
    """A CPU tensor, or mode="torch", reaches the plain forward and backward
    and launches nothing."""
    calls = []
    for name in ("flash_attention_torch", "flash_attention_bwd_torch"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    tops.reset_launches()
    q, k, v = (_model_layout(a) for a in _qkv(1, 4, 2, 16, 8, seed=1))
    tops.flash_attention(q, k, v, causal=True, mode=mode).sum().backward()
    assert calls == ["flash_attention_torch", "flash_attention_bwd_torch"]
    assert tops.LAUNCHES == {n: 0 for n in tops.LAUNCHES}
    assert {"flash_attention", "flash_attention_bwd"} <= set(tops.LAUNCHES)


def test_kernel_mode_refuses_cpu_tensors():
    """mode="cuda" on CPU tensors raises before any build; so do the
    kernels' entry points themselves."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 64, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    lse = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, v, q, lse, q)


def test_no_grad_runs_only_the_forward(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("backward ran under no_grad")
    monkeypatch.setattr(tfa, "flash_attention_bwd_torch", boom)
    q, k, v = (_model_layout(a) for a in _qkv(1, 2, 1, 8, 8, seed=4))
    with torch.no_grad():
        out = tops.flash_attention(q, k, v)
    assert not out.requires_grad
