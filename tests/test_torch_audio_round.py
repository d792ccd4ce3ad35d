"""The port's audio family (reduced whisper-medium: 2 encoder and 2 decoder
layers, d_model 32, enc_seq 16, decoder seq 8) through the round's parts
against the JAX package's on shared weights and numpy-seeded ``frames``
and ``tokens``: ``Client.probe_cohort`` (the per-layer ‖g‖² of both
segments, and every probe stat), the "ours" masks solved from them,
``Client.cohort_update`` on the dense program and at cuts 1 (mid-encoder),
2 (the boundary) and 3 (deep), masked against dense at every cut, which
plain kernels the CPU path calls and how often, and the refused delta and
per-slot serving paths.

The reference has no whisper task (``SyntheticFederatedData`` makes no
frames) and its ``SlotServer`` cannot serve whisper, so the round is the
reference's ``Model`` plus ``Client``, as tests/test_masked_engine.py
drives it.

Tolerances: f32 throughout; probe stats rtol 1e-5, masks exactly, params
and losses atol 1e-5 (masked against dense too, as the reference's
tests/test_masked_engine.py asks)."""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.api import strategy as jstrat
from repro.configs import base as jcfg
from repro.core.client import Client as JClient
from repro.models import model as jmodel
from repro_torch.api import strategy as tstrat
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.client import Client as TClient
from repro_torch.kernels import layer_grad_norm as lgn
from repro_torch.kernels import masked_update as mu
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import DeltaOverlay

LR = 0.01
ATOL = 1e-5
N, TAU, BATCH, SEQ = 3, 2, 2, 8
ENC_LEAVES, DEC_LEAVES = 8, 13


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, lead: tuple, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"frames": rng.standard_normal(
                lead + (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.randint(0, cfg.vocab_size,
                                  lead + (BATCH, SEQ)).astype(np.int32)}


@pytest.fixture(scope="module")
def world():
    rt = dict(remat=False, seq_chunk=4)
    jc = jcfg.reduced(jcfg.get_arch("whisper_medium"), n_layers=2,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("whisper_medium"), n_layers=2,
                      d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(**rt))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(**rt), device="cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return dict(jm=jm, tm=tm, jp=jp, host=host,
                batches=_batches(jc, (N, TAU), 3),
                probe_batches=_batches(jc, (N, 1), 4),
                sizes=np.array([8.0, 5.0, 11.0]),
                jclient=JClient(jm), tclient=TClient(tm))


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _tp(host):
    return params_to_torch(host, "cpu")


def _max_err(a, b):
    """Largest |a − b| over two trees (torch or JAX leaves)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_max_err(a[k], b[k]) for k in a)
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())


@pytest.mark.parametrize("reqs", [
    ("grad_sq_norms",),
    ("grad_sq_norms", "param_sq_norms", "grad_means", "grad_vars"),
], ids=["ours", "all"])
def test_probe_cohort_matches_reference(world, reqs):
    """The probe's stats for 3 clients over both segments (the encoder's
    2 rows, then the decoder's 2), against the reference's."""
    want = world["jclient"].probe_cohort(world["jp"], world["probe_batches"],
                                         reqs)
    got = world["tclient"].probe_cohort(_tp(world["host"]),
                                        _t(world["probe_batches"]), reqs)
    assert set(got) == set(want) == set(reqs)
    for k in want:
        assert got[k].shape == (N, 4) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("budget", [1, 2])
def test_ours_masks_match_reference(world, budget):
    """(P1) solved by "ours" from each package's probe: the same masks,
    within the budget, in mask order over the encoder and the decoder."""
    reqs = ("grad_sq_norms",)
    want = world["jclient"].probe_cohort(world["jp"], world["probe_batches"],
                                         reqs)
    got = world["tclient"].probe_cohort(_tp(world["host"]),
                                        _t(world["probe_batches"]), reqs)
    ids = np.arange(N)
    jm = jstrat.get_strategy("ours").select(
        jstrat.ProbeReport(grad_sq_norms=want["grad_sq_norms"]), budget,
        jstrat.SelectionContext(client_ids=ids, lam=1.0))
    tm = tstrat.get_strategy("ours").select(
        tstrat.ProbeReport(grad_sq_norms=got["grad_sq_norms"]), budget,
        tstrat.SelectionContext(client_ids=ids, lam=1.0))
    np.testing.assert_array_equal(tm, jm)
    assert tm.shape == (N, 4) and (tm.sum(1) == budget).all()


def _masks(cut: int) -> np.ndarray:
    """Rows that differ above the cut, none below it."""
    m = np.zeros((N, 4), np.float32)
    m[:, cut:] = 1.0
    m[1, cut] = 0.0
    return m


@pytest.mark.parametrize("cut", [None, 1, 2, 3],
                         ids=["dense", "mid_encoder", "boundary", "deep"])
def test_cohort_update_matches_reference(world, cut):
    """One cohort round step (τ 2, Eq.(5)-(7), the Eq.(6) apply): the
    port's params and losses against the reference's ``Client`` at the
    same cut; rows below the cut unchanged."""
    masks = _masks(cut or 0)
    want_p, want_l = world["jclient"].cohort_update(
        world["jp"], world["batches"], masks, world["sizes"], LR, cut=cut)
    got_p, got_l = world["tclient"].cohort_update(
        _tp(world["host"]), _t(world["batches"]), masks, world["sizes"], LR,
        cut=cut)
    assert _max_err(got_p, want_p) < ATOL
    np.testing.assert_allclose(got_l, want_l, atol=ATOL)
    host = world["host"]
    assert _max_err(got_p["embed"], host["embed"]) == 0.0
    if cut is not None and cut >= 2:
        assert _max_err(got_p["enc_blocks"], host["enc_blocks"]) == 0.0
    if cut == 1:
        assert _max_err({k: v[:1] for k, v in got_p["enc_blocks"].items()},
                        {k: v[:1] for k, v in host["enc_blocks"].items()}) \
            == 0.0
        assert _max_err(got_p["enc_blocks"], host["enc_blocks"]) > 0


def test_masked_equals_dense_at_every_cut_in_the_port(world):
    """The mask-aware program at each cut (the frozen prefix without a
    graph) against the dense one on the same masks, within 1e-5."""
    client = world["tclient"]
    tb = _t(world["batches"])
    for cut in range(5):
        masks = _masks(cut) if cut < 4 else np.zeros((N, 4), np.float32)
        p_d, l_d = client.cohort_update(_tp(world["host"]), tb, masks,
                                        world["sizes"], LR)
        p_m, l_m = client.cohort_update(_tp(world["host"]), tb, masks,
                                        world["sizes"], LR, cut=cut)
        assert _max_err(p_d, p_m) < ATOL, f"cut={cut}"
        np.testing.assert_allclose(l_m, l_d, atol=ATOL)


def test_cpu_path_calls_the_plain_kernels(world):
    """On CPU tensors every kernel wrapper takes its plain version and
    counts no launch: the probe reduces 21 leaves (8 encoder, 13 decoder)
    per client; a τ step at cut 1 updates the encoder's 8 leaves (rows
    above the cut) and the decoder's 13, at cut 2 the decoder's only.
    Forcing the kernels on a CPU tensor raises."""
    client = world["tclient"]
    calls = {"norm": [], "update": []}
    orig_n, orig_u = lgn.layer_sq_norms_2d_torch, mu.masked_sgd_update_2d_torch

    def norm(g):
        calls["norm"].append(g.shape[0])
        return orig_n(g)

    def update(p, g, m, lr):
        calls["update"].append(p.shape[0])
        return orig_u(p, g, m, lr)
    ops.reset_launches()
    with mock.patch.object(lgn, "layer_sq_norms_2d_torch", norm), \
            mock.patch.object(mu, "masked_sgd_update_2d_torch", update):
        client.probe_cohort(_tp(world["host"]), _t(world["probe_batches"]),
                            ("grad_sq_norms",))
        assert calls["norm"] == [2] * (N * (ENC_LEAVES + DEC_LEAVES))
        for cut, want in ((1, [1] * ENC_LEAVES + [2] * DEC_LEAVES),
                          (2, [2] * DEC_LEAVES), (3, [1] * DEC_LEAVES)):
            calls["update"].clear()
            client.cohort_update(_tp(world["host"]), _t(world["batches"]),
                                 _masks(cut), world["sizes"], LR, cut=cut)
            assert calls["update"] == want * (N * TAU), cut
    assert all(v == 0 for v in ops.LAUNCHES.values())
    g = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.layer_grad_norms({"w": g}, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.masked_sgd_update({"w": g}, {"w": g}, torch.ones(2), LR,
                              mode="cuda")


def test_delta_and_per_slot_serving_are_refused(world):
    """whisper has no delta decode (the dense and vlm stacks only, as the
    reference's ``supports_delta_decode``), and its per-slot decode is
    refused, so ``SlotServer`` refuses it in delta mode at construction
    and in shared mode at its first step."""
    jm, tm = world["jm"], world["tm"]
    assert not jmodel.supports_delta_decode(jm.cfg)
    assert not tmodel.supports_delta_decode(tm.cfg)
    tp = _tp(world["host"])
    store = tserve.demo_store(tm, tp, users=2, layers_per_user=1, seed=0)
    with pytest.raises(ValueError, match="delta-decode"):
        tserve.SlotServer(tm, tp, 2, 8, mode="delta", store=store,
                          device="cpu")
    with pytest.raises(ValueError, match="delta-decode"):
        DeltaOverlay(tm, 2, device="cpu")
    with pytest.raises(ValueError, match="delta-decode"):
        tm.decode_step(tp, torch.zeros(2, dtype=torch.long),
                       torch.tensor(0, dtype=torch.int32),
                       tm.init_cache(2, 4), delta={})
    srv = tserve.SlotServer(tm, tp, 2, 8, mode="shared", device="cpu")
    with pytest.raises(ValueError, match="one shared position"):
        srv.run([tserve.Request(0, [1, 2, 3], 2)])
