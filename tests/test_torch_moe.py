"""The port's moe modules (``models/moe.py``, ``models/mla.py``) against the
JAX package's on the same inputs: numpy from a seed, crossed as f32.

MoE: the reduced deepseek layer (4 experts, top-2, one shared expert,
d_model 64, expert width 256) and the reduced grok layer (4 experts,
top-2, gelu, no shared expert), 2 × 16 tokens; outputs, aux loss, dropped
fraction and every gradient through ``jax.grad``, dropless (capacity factor
8) and with drops (0.25), routed over the whole batch and per sample
(``local_dispatch``); the dispatch against every-expert ``moe_fwd_dense``
when nothing drops; a router with two equal experts (the lower index
wins, as ``lax.top_k`` orders them); two runs bit for bit.  MLA (ranks
64/16/32/32, 4 heads): the sequence forward in one piece and by query
chunks, and the absorbed-matmul decode over the shared-position cache and
the per-slot serving cache.

Tolerances: f32 throughout; outputs and gradients atol 1e-5 / rtol 1e-4
(sums in another order), aux loss and dropped fraction rtol 1e-6, the
tie's expert ids exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs import base as tcfg
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe

ATOL, RTOL = 1e-5, 1e-4
STAT_RTOL = 1e-6
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced layers are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, **kw):
    return (dataclasses.replace(jcfg.reduced(jcfg.get_arch(arch), d_model=64),
                                **kw),
            dataclasses.replace(tcfg.reduced(tcfg.get_arch(arch), d_model=64),
                                **kw))


def _moe_params(cfg, seed: int) -> dict:
    """Layer weights at scales that route decisively: norm scales ~0.1,
    the router N(0, 1), projections ~1/sqrt(fan-in)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shp in sorted(jmoe.moe_param_shapes(cfg).items()):
        scale = (0.1 if name == "ln" else 1.0 if name == "router"
                 else 1.0 / np.sqrt(shp[-2]))
        out[name] = (rng.standard_normal(shp) * scale).astype(np.float32)
    return out


def _tp(host: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in host.items()}


def _x(seed: int, d: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=msg)


CASES = [(arch, cf, local)
         for arch in ("deepseek_v2_lite_16b", "grok_1_314b")
         for cf in (8.0, 0.25) for local in (False, True)]


@pytest.mark.parametrize("arch,cf,local", CASES)
def test_moe_fwd_and_gradients_match_reference(arch, cf, local):
    """Output, aux loss and dropped fraction, then the gradient of
    Σ out·r + aux for every leaf and the input, against ``jax.grad``."""
    jc, tc = _cfgs(arch, capacity_factor=cf)
    host = _moe_params(jc, 3)
    x = _x(4, jc.d_model)
    r = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, st = jmoe.moe_fwd(p, xx, jc, local_dispatch=local)
        return jnp.sum(out * r) + st.aux_loss, (out, st)
    (_, (jout, jst)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in host.items()}, jnp.asarray(x))

    tp = {k: v.requires_grad_() for k, v in _tp(host).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, st = tmoe.moe_fwd(tp, tx, tc, local_dispatch=local)
    _close(out, jout, "out")
    np.testing.assert_allclose(st.aux_loss.item(), float(jst.aux_loss),
                               rtol=STAT_RTOL)
    np.testing.assert_allclose(st.dropped_frac.item(),
                               float(jst.dropped_frac), rtol=STAT_RTOL)
    assert (float(jst.dropped_frac) > 0) == (cf < 1), "drops as designed"
    loss = (out * torch.from_numpy(r)).sum() + st.aux_loss
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        _close(g, jgp[k], k)
    _close(grads[-1], jgx, "x")


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "grok_1_314b"])
def test_dispatch_matches_every_expert_when_dropless(arch):
    """Capacity factor 8 drops nothing: the sort-based dispatch equals
    running every expert on every token (the port's plain version and the
    reference's)."""
    jc, tc = _cfgs(arch, capacity_factor=8.0)
    host = _moe_params(jc, 6)
    x = _x(7, jc.d_model)
    out, st = tmoe.moe_fwd(_tp(host), torch.from_numpy(x), tc)
    dense, dst = tmoe.moe_fwd_dense(_tp(host), torch.from_numpy(x), tc)
    assert st.dropped_frac.item() == 0.0
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert dst.aux_loss.item() == st.aux_loss.item()
    jdense, _ = jmoe.moe_fwd_dense({k: jnp.asarray(v) for k, v in
                                    host.items()}, jnp.asarray(x), jc)
    _close(dense, jdense, "moe_fwd_dense")


def test_router_ties_take_the_lower_expert():
    """Experts 1 and 2 have the same router column, so every token's
    probabilities for them are bit-equal: where the pair straddles the
    top-2 boundary, expert 1 is taken and 2 is not, as ``lax.top_k``
    orders ties."""
    jc, tc = _cfgs("grok_1_314b", capacity_factor=8.0)
    host = _moe_params(jc, 8)
    host["router"][:, 2] = host["router"][:, 1]
    h2d = np.random.RandomState(9).standard_normal(
        (64, jc.d_model)).astype(np.float32)
    tw, ti, taux = tmoe._route(torch.from_numpy(h2d),
                               torch.from_numpy(host["router"]), tc)
    jw, ji, jaux = jmoe._route(jnp.asarray(h2d), jnp.asarray(host["router"]),
                               jc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, "top-k weights")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=STAT_RTOL)
    sel = ti.numpy()
    straddle = [t for t in range(64) if (1 in sel[t]) != (2 in sel[t])]
    assert straddle, "some token's top-2 cuts the tie"
    assert all(1 in sel[t] and 2 not in sel[t] for t in straddle)
    x = _x(10, jc.d_model)
    out, _ = tmoe.moe_fwd(_tp(host), torch.from_numpy(x), tc)
    jout, _ = jmoe.moe_fwd({k: jnp.asarray(v) for k, v in host.items()},
                           jnp.asarray(x), jc)
    _close(out, jout, "out with tied experts")


def test_two_runs_are_bit_equal():
    """The dispatch, the ordered combine and their backward repeat bit for
    bit (the card's synchronous-versus-pipelined check relies on it)."""
    jc, tc = _cfgs("deepseek_v2_lite_16b", capacity_factor=0.5)
    host = _moe_params(jc, 11)
    x = _x(12, tc.d_model)
    runs = []
    for _ in range(2):
        tp = {k: v.requires_grad_() for k, v in _tp(host).items()}
        out, st = tmoe.moe_fwd(tp, torch.from_numpy(x), tc)
        g = torch.autograd.grad(out.square().sum() + st.aux_loss,
                                [tp[k] for k in sorted(tp)])
        runs.append((out, st, g))
    (o1, s1, g1), (o2, s2, g2) = runs
    assert torch.equal(o1, o2) and torch.equal(s1.aux_loss, s2.aux_loss)
    assert s1.dropped_frac.item() > 0
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_capacity_matches_reference():
    for arch in ("deepseek_v2_lite_16b", "grok_1_314b"):
        jfull, tfull = jcfg.get_arch(arch), tcfg.get_arch(arch)
        for n in (1, 4, 6, 2048, 4096):
            assert tmoe.capacity(n, tfull) == jmoe.capacity(n, jfull)
    # DeepSeek-V2-Lite: the round's 4 × 512 tokens, a 4-slot decode step
    assert tmoe.capacity(2048, tcfg.get_arch("deepseek_v2_lite_16b")) == 240
    assert tmoe.capacity(4, tcfg.get_arch("deepseek_v2_lite_16b")) == 6


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_world():
    jc, tc = _cfgs("deepseek_v2_lite_16b")
    rng = np.random.RandomState(13)
    host = {}
    for name, shp in sorted(jmla.mla_param_shapes(jc).items()):
        scale = 0.1 if len(shp) == 1 else 1.0 / np.sqrt(shp[0])
        host[name] = (rng.standard_normal(shp) * scale).astype(np.float32)
    return jc, tc, host


@pytest.mark.parametrize("seq,chunk", [(16, 1024), (32, 8)],
                         ids=["full", "chunked"])
def test_mla_sequence_matches_reference(mla_world, seq, chunk):
    jc, tc, host = mla_world
    x = np.random.RandomState(14).standard_normal(
        (B, seq, jc.d_model)).astype(np.float32)
    pos = np.arange(seq, dtype=np.int32)
    want, _ = jmla.mla_fwd({k: jnp.asarray(v) for k, v in host.items()},
                           jnp.asarray(x), jc, positions=jnp.asarray(pos),
                           seq_chunk=chunk)
    got = tmla.mla_fwd(_tp(host), torch.from_numpy(x), tc,
                       positions=torch.from_numpy(pos), seq_chunk=chunk)
    _close(got, want, f"mla seq {seq} chunk {chunk}")


def _mla_cache(cfg, W, per_slot):
    return {"ckv": np.zeros((B, W, cfg.kv_lora_rank), np.float32),
            "krope": np.zeros((B, W, cfg.qk_rope_dim), np.float32),
            "pos": np.full((B, W) if per_slot else (W,),
                           np.iinfo(np.int32).max, np.int32)}


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_mla_absorbed_decode_matches_reference(mla_world, per_slot):
    """Token-by-token decode over a ring cache of 8 (12 steps: the ring
    wraps), in place in the port, against the reference's returned cache;
    per slot, the two rows start 3 positions apart.  The first steps are
    also held against the expanded sequence path."""
    jc, tc, host = mla_world
    W, steps = 8, 12
    x = np.random.RandomState(15).standard_normal(
        (B, steps, jc.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    tp = _tp(host)
    jcache = {k: jnp.asarray(v) for k, v in _mla_cache(jc, W, per_slot).items()}
    tcache = {k: torch.from_numpy(v) for k, v in
              _mla_cache(tc, W, per_slot).items()}
    start = np.array([0, 3], np.int32) if per_slot else 0
    outs = []
    for t in range(steps):
        cp = (start + t).astype(np.int32) if per_slot else np.int32(t)
        positions = cp[:, None] if per_slot else cp[None]
        jout, jcache = jmla.mla_fwd(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                    positions=jnp.asarray(positions),
                                    cache=jcache, cache_pos=jnp.asarray(cp))
        got = tmla.mla_fwd(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                           positions=torch.from_numpy(np.asarray(positions)),
                           cache=tcache, cache_pos=torch.from_numpy(
                               np.asarray(cp)))
        _close(got, jout, f"decode step {t}")
        outs.append(got)
    for k in tcache:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    if not per_slot:
        seq = tmla.mla_fwd(tp, torch.from_numpy(x[:, :W]), tc,
                           positions=torch.arange(W, dtype=torch.int32))
        np.testing.assert_allclose(torch.cat(outs[:W], 1).numpy(),
                                   seq.numpy(), atol=1e-4, rtol=1e-4)
