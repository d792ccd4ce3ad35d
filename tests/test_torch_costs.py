"""The port's §4.3 cost model (repro_torch.core.costs) against the JAX
package's (repro.core.costs): the same reports, exactly, over a grid of
Eq. (16)/(17) arguments and over the per-layer parameter counts of reduced
TinyLlama with several masks; and the three checks of
tests/test_substrates.py on the port."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.configs import base as jcfg
from repro.core import costs as jcosts
from repro.core import masks as jmasks
from repro.models import model as jmodel
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core import costs as tcosts
from repro_torch.core import masks as tmasks

UNIFORM_GRID = list(itertools.product(
    (2, 24), (1, 3), (1, 5), (1.0, 2.5), (1, 2), (1, 4), (1, 3), (16, 32)))


def _same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("L,R,tau,b,sel_period,sel_batches,local_batches,bits",
                         UNIFORM_GRID[::7] + UNIFORM_GRID[-3:])
def test_uniform_matches_reference(L, R, tau, b, sel_period, sel_batches,
                                   local_batches, bits):
    kw = dict(sel_period=sel_period, sel_batches=sel_batches,
              local_batches=local_batches, bits_per_param=bits)
    _same(tcosts.backward_cost_uniform(L, R, tau, b, **kw),
          jcosts.backward_cost_uniform(L, R, tau, b, **kw))


@pytest.fixture(scope="module")
def tinyllama_layer_params():
    """count_layer_params of reduced TinyLlama in both packages, on the
    same parameters (the port's through the bridge)."""
    cfg = jcfg.reduced(jcfg.get_arch("tinyllama_1_1b"), n_layers=4,
                       d_model=64)
    jp = jmodel.Model(cfg, jcfg.RuntimeConfig()).init(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tc = tcfg.reduced(tcfg.get_arch("tinyllama_1_1b"), n_layers=4,
                      d_model=64)
    mine = tmasks.count_layer_params(params_to_torch(host, "cpu"), tc)
    ref = np.asarray(jmasks.count_layer_params(jp, cfg))
    np.testing.assert_array_equal(mine, ref)
    return mine


@pytest.mark.parametrize("mask", [(1, 1, 1, 1), (0, 0, 0, 0), (1, 0, 0, 0),
                                  (0, 1, 1, 0), (0, 0, 0, 1)])
@pytest.mark.parametrize("tau,tokens,sel_period,sel_batches,bits",
                         [(2, 1024, 1, 1, 32), (5, 16, 3, 2, 16)])
def test_exact_matches_reference(tinyllama_layer_params, mask, tau, tokens,
                                 sel_period, sel_batches, bits):
    m = np.asarray(mask, np.float32)
    kw = dict(bits_per_param=bits, tokens_per_batch=tokens,
              sel_period=sel_period, sel_batches=sel_batches)
    _same(tcosts.backward_cost_exact(tinyllama_layer_params, m, tau, **kw),
          jcosts.backward_cost_exact(tinyllama_layer_params, m, tau, **kw))


def test_eq16_eq17_ratios():
    L, R, tau = 24, 2, 5
    rep = tcosts.backward_cost_uniform(L, R, tau)
    assert rep.compute_flops == pytest.approx(R * tau + L - 1)
    assert rep.ratio_compute == pytest.approx((R * tau + L - 1) / (L * tau))
    assert rep.ratio_transmit == pytest.approx(R / L)


def test_selection_period_reduces_probe_cost():
    a = tcosts.backward_cost_uniform(24, 1, 5, sel_period=1)
    b = tcosts.backward_cost_uniform(24, 1, 5, sel_period=2)
    assert b.select_flops == pytest.approx(a.select_flops / 2)
    assert b.compute_flops < a.compute_flops


def test_exact_cost_uses_layer_sizes():
    layer_params = np.array([100, 200, 300])
    mask = np.array([0, 1, 0], np.float32)
    rep = tcosts.backward_cost_exact(layer_params, mask, tau=2,
                                     bits_per_param=32)
    assert rep.transmit_bits == 200 * 32
    assert rep.ratio_transmit == pytest.approx(200 / 600)
