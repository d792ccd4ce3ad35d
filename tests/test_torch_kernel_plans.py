"""Host-side choices of the port's delta_matmul and ssd_scan kernels, which
the CPU can check although the kernels run only on the card: the
delta_matmul grid (``delta_matmul.plan``: column tiles × d-splits), the
ssd_scan route (``ssd_scan.route``), the bf16 hi/lo split that carries the
tensor-core scan's f32 factors, a plain replay of that kernel's products
against the JAX package's ``ssd_scan_jnp``, and the launch counts, which
stay 0 on the CPU.

Tolerances: hi + lo is within 2⁻¹⁶ of v, relative (hi is v rounded to 8
significant bits, lo the remainder rounded to 8 more).  The replay, whose
products carry every f32 factor as hi + lo, is held within 1e-4 of the
output's largest magnitude against the f32 reference: each product is
within ~2⁻¹⁶ (1.5e-5) relative, over sums of up to 64 terms and a state
carried through three chunks."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_jnp
from repro_torch.configs.base import get_arch
from repro_torch.kernels import _build
from repro_torch.kernels import delta_matmul as tdmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.model import _block_shapes

H100_BLOCK_SLOTS = 2 * 132


def _tinyllama_projections():
    cfg = get_arch("tinyllama_1_1b")
    return [(name, shp) for name, shp in _block_shapes(cfg, "dense").items()
            if len(shp) == 2]


def _csrc_int(name: str, const: str) -> int:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return int(re.search(rf"constexpr int {const} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# delta_matmul: the grid
# ---------------------------------------------------------------------------

def test_tinyllama_has_the_six_projection_shapes():
    shapes = sorted(shp for _, shp in _tinyllama_projections())
    assert shapes == sorted([(2048, 2048), (2048, 256), (2048, 256),
                             (2048, 2048), (2048, 11264), (5632, 2048)])


@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("name,shape", _tinyllama_projections())
def test_plan_fills_the_card_at_every_tinyllama_shape(B, name, shape):
    d, f = shape
    p = tdmm.plan(B, d, f)
    assert p.blocks >= H100_BLOCK_SLOTS, (name, p)
    assert p.rows >= tdmm.MIN_ROWS
    assert p.col_tiles * p.col_tile >= f > (p.col_tiles - 1) * p.col_tile
    assert p.col_tile == p.lanes_per_row * tdmm.LANE_COLS


@pytest.mark.parametrize("d,f", [(2048, 2048), (2048, 256), (2048, 11264),
                                 (5632, 2048), (2048, 100), (64, 64),
                                 (1, 7), (33, 72), (700, 1030), (5000, 9),
                                 (100000, 1 << 20)])
def test_plan_splits_cover_d_exactly_once(d, f):
    p = tdmm.plan(4, d, f)
    ranges = [(k * p.rows, min((k + 1) * p.rows, d)) for k in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == d
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 1 <= p.rows <= tdmm.MAX_ROWS and p.splits <= 65535
    assert p.lanes_per_row in tdmm.LANES_PER_ROW


def test_plan_is_a_function_of_the_shape_alone(monkeypatch):
    """The same grid, and so the same bits, on any card: the plan never asks
    the device, and repeats itself."""
    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    for d, f in [(2048, 2048), (2048, 256), (5632, 2048)]:
        assert tdmm.plan(4, d, f) == tdmm.plan(4, d, f)
        assert tdmm.plan(1, d, f) == tdmm.plan(16, d, f)


@pytest.mark.parametrize("B,d,f", [(0, 8, 8), (17, 8, 8), (4, 0, 8),
                                   (4, 8, 0)])
def test_plan_raises_on_what_the_kernel_does_not_take(B, d, f):
    with pytest.raises(ValueError, match="plan"):
        tdmm.plan(B, d, f)


def test_plan_constants_match_the_kernel_source():
    assert _csrc_int("delta_matmul", "kMaxRows") == tdmm.MAX_ROWS
    assert _csrc_int("delta_matmul", "kVec") == tdmm.LANE_COLS
    # the launch function takes lanes per row 32, 16 and 8
    src = (_build.CSRC / "delta_matmul.cu").read_text()
    assert "lpr != 32 && lpr != 16 && lpr != 8" in src
    assert tdmm.LANES_PER_ROW == (32, 16, 8)


# ---------------------------------------------------------------------------
# ssd_scan: the route and the hi/lo split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 128, "mma"),     # Mamba2-370M
    (torch.bfloat16, 64, 64, "mma"),      # Zamba2's state
    (torch.bfloat16, 16, 16, "mma"),      # the reduced configs
    (torch.bfloat16, 48, 48, "mma"),
    (torch.bfloat16, 24, 128, "simt"),    # P not a multiple of 16
    (torch.bfloat16, 64, 8, "simt"),      # N not a multiple of 16
    (torch.float32, 64, 128, "simt"),     # f32: the exact kernel
    (torch.float32, 16, 16, "simt"),
])
def test_ssd_route_by_type_and_shape(dtype, P, N, want):
    assert tssd.route(dtype, P, N) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_ssd_route_raises_on_what_no_kernel_takes(dtype):
    with pytest.raises(ValueError, match="no kernel takes"):
        tssd.route(dtype, 64, 128)


def test_ssd_routes_match_the_launch_functions_numbering():
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert tssd.ROUTES == ("simt", "mma")
    assert "route 0: SIMT" in src and "route 1: tensor cores" in src


def _split_bf16(v: torch.Tensor):
    """An f32 tensor as two bf16 terms, ``hi = bf16(v)`` and ``lo =
    bf16(v − hi)``, as ``csrc/ssd_scan.cu``'s ``split_bf16`` hands each f32
    factor of a product to ``mma.sync``."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 1e4, 3e30])
def test_hi_lo_split_is_within_2_to_the_minus_16(scale):
    rng = np.random.RandomState(3)
    v = torch.from_numpy((rng.standard_normal(4096) * scale)
                         .astype(np.float32))
    hi, lo = _split_bf16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, v.to(torch.bfloat16))
    err = (hi.float() + lo.float() - v).abs()
    assert bool((err <= v.abs() * 2.0 ** -16).all())
    # hi alone is only one bf16 rounding away
    assert float((hi.float() - v).abs().max()) > float(err.max()) * 16


# ---------------------------------------------------------------------------
# the tensor-core scan's products, replayed in plain PyTorch
# ---------------------------------------------------------------------------

def _two(v: torch.Tensor):
    hi, lo = _split_bf16(v)
    return hi.float(), lo.float()


def _mma_replay(x, dt, A, Bm, Cm, D, chunk, split=True):
    """What ``csrc/ssd_scan.cu``'s tensor-core kernel computes, product by
    product, on the model layout (head h reads group h // (H/G)): x, B and
    C exact, each f32 factor as bf16 hi + lo (``split=False``: hi alone),
    f32 sums; y before its final rounding."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    rep = h // g
    two = _two if split else (lambda v: (v.to(torch.bfloat16).float(),
                                         torch.zeros_like(v)))
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    y = torch.empty(b, s, h, p)
    for bi in range(b):
        for hh in range(h):
            grp = hh // rep
            state = torch.zeros(p, n)
            for s0 in range(0, s, chunk):
                xc, dtc = x[bi, s0:s0 + chunk, hh], dt[bi, s0:s0 + chunk, hh]
                Bc, Cc = Bm[bi, s0:s0 + chunk, grp], Cm[bi, s0:s0 + chunk, grp]
                cs = torch.cumsum(dtc * A[hh], 0)
                yc = torch.zeros(chunk, p)
                if s0 > 0:                 # C @ state^T, the state split
                    sh, sl = two(state)
                    yc = (Cc @ sh.T + Cc @ sl.T) * torch.exp(cs)[:, None]
                scores = Cc @ Bc.T         # both exact: one product
                m = torch.where(lower, scores * torch.exp(cs[:, None]
                                                          - cs[None, :])
                                * dtc[None, :], 0.0)
                mh, ml = two(m)
                yc = yc + mh @ xc + ml @ xc
                y[bi, s0:s0 + chunk, hh] = yc + xc * D[hh]
                w = dtc * torch.exp(cs[-1] - cs)
                wh, wl = two(Bc * w[:, None])
                state = state * torch.exp(cs[-1]) + xc.T @ wh + xc.T @ wl
    return y


def _replay_inputs(b, s, h, p, g, n, seed):
    """numpy-seeded model-layout inputs, x, B and C rounded to bf16 (as the
    kernel reads them) but held in f32, A = −exp(A_log)."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    x = bf(rng.standard_normal((b, s, h, p)))
    Bm = bf(rng.standard_normal((b, s, g, n)) * 0.5)
    Cm = bf(rng.standard_normal((b, s, g, n)) * 0.5)
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, s, h)) - 2.0)).astype(np.float32))
    A = torch.from_numpy(-np.exp(rng.uniform(-3.0, 0.0, (h,)))
                         .astype(np.float32))
    D = torch.from_numpy(rng.uniform(0.5, 1.5, (h,)).astype(np.float32))
    return x, dt, A, Bm, Cm, D


def _jnp_reference(x, dt, A, Bm, Cm, D, chunk):
    """ssd_scan_jnp on the per-head layout, f32, back in model layout."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    heads = lambda t: np.repeat(t.numpy(), h // g, axis=2).transpose(
        0, 2, 1, 3).reshape(b * h, s, n)
    y = ssd_scan_jnp(
        jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, p)),
        jnp.asarray(dt.numpy().transpose(0, 2, 1).reshape(b * h, s)),
        jnp.asarray(np.tile(A.numpy(), b)), jnp.asarray(heads(Bm)),
        jnp.asarray(heads(Cm)), jnp.asarray(np.tile(D.numpy(), b)),
        chunk=chunk)
    return np.asarray(y, np.float32).reshape(b, h, s, p).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 16, 2, 32, 32),     # three chunks, G 2: the state crosses two
    (1, 128, 2, 32, 1, 64, 32),    # four chunks
    (1, 64, 4, 16, 4, 16, 64),     # one chunk, a group per head
])
def test_mma_replay_matches_the_jnp_reference(b, s, h, p, g, n, chunk):
    ins = _replay_inputs(b, s, h, p, g, n, seed=s + h)
    want = _jnp_reference(*ins, chunk=chunk)
    got = _mma_replay(*ins, chunk=chunk).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_mma_replay_needs_the_lo_terms():
    """With hi alone (f32 factors rounded to bf16) the same replay misses
    the 1e-4 limit by far: the lo terms are what keep the f32 answer."""
    ins = _replay_inputs(2, 96, 4, 16, 2, 32, seed=100)
    want = _jnp_reference(*ins, chunk=32)
    scale = float(np.abs(want).max())
    err_split = np.abs(_mma_replay(*ins, chunk=32).numpy() - want).max()
    err_hi = np.abs(_mma_replay(*ins, chunk=32, split=False).numpy()
                    - want).max()
    assert err_split <= 1e-4 * scale < err_hi


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

def test_launch_counters_have_the_ssd_routes():
    assert {"ssd_scan", "ssd_scan_mma", "ssd_scan_simt",
            "base_delta_matmul"} <= set(tops.LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_launch_is_counted_on_the_cpu(dtype):
    rng = np.random.RandomState(0)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    tops.reset_launches()
    with torch.no_grad():
        tops.ssd(t(1, 32, 2, 16), t(1, 32, 2).float().abs(),
                 t(2).float(), t(1, 32, 1, 16), t(1, 32, 1, 16),
                 t(2).float(), chunk=16)
        tops.base_delta_matmul(t(4, 1, 32), t(32, 48),
                               t(2, 32, 48).float(),
                               torch.tensor([1, -1], dtype=torch.int32))
    assert tops.LAUNCHES == {k: 0 for k in tops.LAUNCHES}


def test_cuda_mode_on_cpu_tensors_raises_for_both_kernels():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tops.base_delta_matmul(x, torch.zeros(32, 48),
                               torch.zeros(2, 32, 48),
                               torch.tensor([1, -1], dtype=torch.int32),
                               mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd(torch.zeros(1, 32, 2, 16), torch.ones(1, 32, 2),
                 torch.zeros(2), torch.zeros(1, 32, 1, 16),
                 torch.zeros(1, 32, 1, 16), torch.ones(2), chunk=16,
                 mode="cuda")
    assert tops.LAUNCHES["ssd_scan_mma"] == tops.LAUNCHES["ssd_scan_simt"] == 0
