"""The port's Model.decode_step against the JAX package's, step by step,
on the same parameters (crossed through the bridge) and numpy-seeded
tokens: scalar-position and per-slot caches, and delta decode over an
overlay built by the JAX DeltaOverlay."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JRuntime
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.launch.serve import demo_store as jdemo_store
from repro.models.model import Model as JModel
from repro.serve import DeltaOverlay as JOverlay
from repro_torch.bridge import params_to_torch
from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
from repro_torch.models.model import Model

ARCHS = ["tinyllama_1_1b", "codeqwen1_5_7b"]    # codeqwen: qkv_bias
ATOL, RTOL = 1e-5, 1e-4
STEPS = 8


def _host(tree):
    """Leaves to numpy, keeping key order (jax.tree.map sorts dict keys)."""
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _worlds(arch):
    jm = JModel(jreduced(jget_arch(arch), n_layers=3, d_model=64),
                JRuntime(remat=False, seq_chunk=16))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(reduced(get_arch(arch), n_layers=3, d_model=64),
               RuntimeConfig(remat=False, seq_chunk=16), device="cpu")
    return jm, jp, tm, params_to_torch(_host(jp), "cpu")


def _check_cache(tc, jc):
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][key].numpy(),
                                   np.asarray(jc["blocks"][key]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tc["blocks"]["pos"].numpy(),
                                  np.asarray(jc["blocks"]["pos"]))


def _check_logits(tl, jl, step):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL, err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_scalar_position_cache(arch):
    jm, jp, tm, tp = _worlds(arch)
    B = 2
    rng = np.random.RandomState(3)
    jc, tc = jm.init_cache(B, STEPS), tm.init_cache(B, STEPS)
    jstep = jax.jit(jm.decode_step)
    for t in range(STEPS):
        toks = rng.randint(0, jm.cfg.vocab_size, B).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(toks), jnp.int32(t), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks),
                                torch.tensor(t, dtype=torch.int32), tc)
        _check_logits(tl, jl, t)
    _check_cache(tc, jc)


def _per_slot_run(jm, jp, tm, tp, delta=None):
    """8 steps over a per-slot cache, slots at staggered positions, with
    slot 1 refilled (reset to position 0) half way."""
    B = 3
    rng = np.random.RandomState(4)
    jc = jm.init_cache(B, 16, per_slot=True)
    tc = tm.init_cache(B, 16, per_slot=True)
    jdelta, tdelta = delta if delta is not None else (None, None)
    jstep = jax.jit(jm.decode_step)
    pos = np.array([0, 2, 5], np.int32)
    for t in range(STEPS):
        if t == 4:
            jc = jm.reset_slot(jc, 1)
            tc = tm.reset_slot(tc, 1)
            pos[1] = 0
        toks = rng.randint(0, jm.cfg.vocab_size, B).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(toks), jnp.asarray(pos), jc,
                       delta=jdelta)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks),
                                torch.from_numpy(pos.copy()), tc,
                                delta=tdelta)
        _check_logits(tl, jl, t)
        pos += 1
    _check_cache(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_per_slot_cache_staggered(arch):
    _per_slot_run(*_worlds(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_delta_decode_matches_reference_overlay(arch):
    """Three users' deltas resident in one batch (and one anonymous entry
    range left empty): the JAX overlay's table, copied across, gives the
    same logits through the port's plain base+delta projection."""
    jm, jp, tm, tp = _worlds(arch)
    store = jdemo_store(jm, jp, users=3, layers_per_user=2, seed=0)
    ov = JOverlay(jm, capacity=3)
    for slot, uid in enumerate([2, 0, 1]):
        assert ov.try_admit(slot, store.get(uid))
    ov.release(2)                      # stale rows stay, owner -1 masks them
    dev = ov.device()
    tdelta = {"slots": torch.from_numpy(np.asarray(dev["slots"]).copy()),
              "leaves": params_to_torch(_host(dev["leaves"]), "cpu")}
    assert (tdelta["slots"] >= 0).any() and (tdelta["slots"] < 0).any()
    _per_slot_run(jm, jp, tm, tp, delta=(dev, tdelta))
