"""The port's SSD scan and Mamba2 block (repro_torch.kernels.ssd_scan,
repro_torch.kernels.ops.ssd, repro_torch.models.ssd) against the JAX
package's Pallas kernel (interpret mode), its jnp twin and its model
functions, on the same numpy-seeded inputs.  The CUDA kernel runs only on
the card (chip_smoke.py); here the plain version, the autograd wrapper and
its recomputed backward are checked.

Tolerances: f32 sums taken in another order agree to ~1e-6 of the output's
scale, so f32 outputs are held within rtol 1e-5 and an atol of 1e-5 of
that scale (1e-4 absolute where the reference's own test uses it); bf16
outputs within one bf16 rounding (rtol/atol 1e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.kernels import ops as jops
from repro.kernels.ssd_scan import ssd_scan, ssd_scan_jnp
from repro.models import ssd as jssd
from repro_torch.configs import base as tcfg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd_scan
from repro_torch.models import ssd as tssd

# the reference's functions, compiled once each (faster than eager dispatch)
_jssd_chunked = jax.jit(jssd.ssd_chunked, static_argnums=6)

# tests/test_kernels.py::SSD_CASES: (BH, S, P, N, chunk, dtype)
SSD_CASES = [
    (4, 128, 64, 32, 32, "float32"),
    (2, 256, 32, 64, 64, "float32"),
    (6, 64, 64, 16, 16, "float32"),
    (2, 128, 64, 32, 128, "float32"),   # single chunk
    (2, 128, 32, 32, 32, "bfloat16"),
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _pair(a: np.ndarray, dtype: str = "float32"):
    """(jax array, torch tensor) of the same values in ``dtype``; bf16
    rounding happens once, in JAX."""
    ja = jnp.asarray(a, dtype)
    return ja, _t(ja).to(getattr(torch, dtype))


def _scan_inputs(BH, S, P, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((BH, S, P))
    dt = np.log1p(np.exp(rng.standard_normal((BH, S))))       # softplus
    A = -np.exp(rng.uniform(-1.0, 0.5, (BH,)))
    Bm = rng.standard_normal((BH, S, N)) * 0.5
    Cm = rng.standard_normal((BH, S, N)) * 0.5
    D = np.ones((BH,))
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("BH,S,P,N,chunk,dtype", SSD_CASES)
@pytest.mark.parametrize("ref", ["pallas_interpret", "jnp"])
def test_ssd_scan_plain_matches_reference(BH, S, P, N, chunk, dtype, ref):
    x, dt, A, Bm, Cm, D = _scan_inputs(BH, S, P, N, seed=BH * 7 + S)
    (jx, tx), (jdt, tdt), (jB, tB), (jC, tC) = (
        _pair(v, dtype) for v in (x, dt, Bm, Cm))
    jA, tA = _pair(A)
    jD, tD = _pair(D)
    fn = (lambda *a, chunk: ssd_scan(*a, chunk=chunk, interpret=True)) \
        if ref == "pallas_interpret" else ssd_scan_jnp
    want = np.asarray(fn(jx, jdt, jA, jB, jC, jD, chunk=chunk), np.float32)
    got = tssd_scan.ssd_scan_torch(tx, tdt, tA, tB, tC, tD, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == (BH, S, P)
    # f32: sums of up to 128·N products in another order, held to 1e-5 of
    # the output's largest magnitude (~30 here); bf16: one rounding
    scale = float(np.abs(want).max())
    tol = (1e-5, 1e-5 * scale) if dtype == "float32" else (1e-2, 1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol[0],
                               atol=tol[1])


def _model_inputs(b, s, h, p, g, n, seed):
    """Model-layout inputs as in tests/test_kernels.py:332."""
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
            np.float32),
        A_log=rng.uniform(-1.0, 1.0, (h,)).astype(np.float32),
        B=(rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32),
        C=(rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32),
        D=rng.uniform(0.5, 1.5, (h,)).astype(np.float32))


_ORDER = ("x", "dt", "A_log", "B", "C", "D")


@pytest.mark.parametrize("s,chunk", [(64, 32), (64, 64), (48, 16)])
def test_ssd_chunked_matches_reference_with_groups(s, chunk):
    """y and final_state, G = 2 < H = 4 heads, an initial state too."""
    ins = _model_inputs(2, s, 4, 32, 2, 16, seed=s + chunk)
    init = np.random.RandomState(5).standard_normal((2, 4, 32, 16)).astype(
        np.float32)
    for state0 in (None, init):
        yj, fj = _jssd_chunked(*(jnp.asarray(ins[k]) for k in _ORDER),
                                  chunk, None if state0 is None
                                  else jnp.asarray(state0))
        yt, ft = tssd.ssd_chunked(*(_t(ins[k]) for k in _ORDER), chunk,
                                  None if state0 is None else _t(state0))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                                   atol=1e-5)


def test_ops_ssd_matches_model_path():
    """The port's copy of tests/test_kernels.py:332 (atol 1e-4): the
    wrapper against the reference's ssd_chunked, and against the
    reference's own wrapper in its jnp mode."""
    ins = _model_inputs(2, 64, 4, 32, 2, 16, seed=4)
    y_ref, _ = _jssd_chunked(*(jnp.asarray(ins[k]) for k in _ORDER), 32)
    y_ops = jops.ssd(*(jnp.asarray(ins[k]) for k in _ORDER), chunk=32,
                     mode="jnp")
    with torch.no_grad():
        got = tops.ssd(*(_t(ins[k]) for k in _ORDER), chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_ops), atol=1e-5,
                               rtol=1e-5)


def test_ops_ssd_backward_matches_jax_grad():
    """Gradients of the autograd wrapper (kernel-or-plain forward, backward
    recomputed through the model function) for x, dt, A_log, B, C, D
    against jax.grad through the reference's ssd_chunked."""
    ins = _model_inputs(2, 64, 4, 16, 2, 8, seed=9)
    w = np.random.RandomState(10).standard_normal((2, 64, 4, 16)).astype(
        np.float32)

    def jloss(*a):
        y, _ = jssd.ssd_chunked(*a, 16)
        return jnp.sum(y * w)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *(jnp.asarray(ins[k]) for k in _ORDER))
    tin = [_t(ins[k]).requires_grad_() for k in _ORDER]
    loss = (tops.ssd(*tin, chunk=16) * _t(w)).sum()
    got = torch.autograd.grad(loss, tin)
    for name, g, gw in zip(_ORDER, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_ops_ssd_counts_no_launch_on_the_cpu_and_cuda_mode_raises():
    ins = {k: _t(v) for k, v in _model_inputs(1, 16, 2, 8, 1, 8, 0).items()}
    tops.reset_launches()
    with torch.no_grad():
        tops.ssd(*(ins[k] for k in _ORDER), chunk=8)
    assert tops.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd(*(ins[k] for k in _ORDER), chunk=8, mode="cuda")


# ---------------------------------------------------------------------------
# Mamba2 block pieces
# ---------------------------------------------------------------------------

def _cfgs():
    jc = jcfg.reduced(jcfg.get_arch("mamba2_370m"), n_layers=2, d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("mamba2_370m"), n_layers=2, d_model=32)
    return jc, tc


def _block_params(cfg, seed):
    rng = np.random.RandomState(seed)
    shapes = jssd.mamba2_param_shapes(cfg)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    p["A_log"] = rng.uniform(-1.0, 1.0, shapes["A_log"]).astype(np.float32)
    return p


def test_param_shapes_match_reference():
    jc, tc = _cfgs()
    assert tssd.mamba2_param_shapes(tc) == jssd.mamba2_param_shapes(jc)
    assert tssd.mamba2_cache_shapes(tc, 3) == jssd.mamba2_cache_shapes(jc, 3)
    full_j = jcfg.get_arch("mamba2_370m")
    full_t = tcfg.get_arch("mamba2_370m")
    assert tssd.mamba2_param_shapes(full_t) == \
        jssd.mamba2_param_shapes(full_j)


def test_causal_conv_and_conv_decode_match_reference():
    rng = np.random.RandomState(2)
    u = rng.standard_normal((2, 12, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tssd._causal_conv(_t(u), _t(w), _t(b)).numpy(),
        np.asarray(jssd._causal_conv(*map(jnp.asarray, (u, w, b)))),
        rtol=1e-6, atol=1e-6)
    got, got_c = tssd._conv_decode(_t(u[:, :1]), _t(cache), _t(w), _t(b))
    want, want_c = jssd._conv_decode(*map(jnp.asarray,
                                          (u[:, :1], cache, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_ssd_decode_step_matches_reference():
    ins = _model_inputs(2, 1, 4, 16, 2, 8, seed=3)
    state = np.random.RandomState(6).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    yj, sj = jssd.ssd_decode_step(jnp.asarray(state),
                                  *(jnp.asarray(ins[k]) for k in _ORDER))
    yt, st = tssd.ssd_decode_step(_t(state), *(_t(ins[k]) for k in _ORDER))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("branch", ["sequence", "decode"])
def test_mamba2_fwd_matches_reference(branch):
    jc, tc = _cfgs()
    p = _block_params(jc, seed=12)
    rng = np.random.RandomState(13)
    S = 64 if branch == "sequence" else 1      # 64 = two chunks of 32
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    cache = None
    if branch == "decode":
        shp = jssd.mamba2_cache_shapes(jc, 2)
        cache = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shp.items()}
    want, want_c = jax.jit(lambda p, x, c: jssd.mamba2_fwd(p, x, jc, cache=c))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if cache is None
        else {k: jnp.asarray(v) for k, v in cache.items()})
    with torch.no_grad():
        got, got_c = tssd.mamba2_fwd(
            {k: _t(v) for k, v in p.items()}, _t(x), tc,
            cache=None if cache is None
            else {k: _t(v) for k, v in cache.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    if cache is None:
        assert got_c is None and want_c is None
    else:
        for k in want_c:
            np.testing.assert_allclose(got_c[k].numpy(),
                                       np.asarray(want_c[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
