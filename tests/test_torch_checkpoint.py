"""The port's checkpoints against the JAX package's: the same on-disk format
(npz keys, descr, manifest keys/dtypes/shapes/checksums, bf16 as 2-byte
words), partial and strict restore, tmp sweeps, a corrupted latest step
falling back, resume parity, checkpoints crossing between the two packages
(masks exact, params within 1e-5) and extract_delta."""
import json
import os
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import base as jcfg
from repro.core.server import FLServer as JServer
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro_torch import ckpt as tckpt
from repro_torch.api.experiment import Experiment
from repro_torch.bridge import params_to_torch
from repro_torch.configs import base as tcfg
from repro_torch.core.server import FLServer as TServer
from repro_torch.core.server import History
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model as tmodel

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models are tiny: one intra-op thread runs them faster,
    and the suite runs several test files at once in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_host(seed=0):
    rng = np.random.RandomState(seed)
    return {"blocks": {"w": rng.randn(3, 4, 2).astype(np.float32),
                       "b": rng.randn(3, 2).astype(np.float32)},
            "embed": rng.randn(5, 4).astype(np.float32)}


def _npz_members(path) -> dict[str, bytes]:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_format_equals_reference(tmp_path, dtype):
    """The same tree saved by both packages: identical manifests and npz
    members (bf16 under descr '<V2' as raw 2-byte words)."""
    host = _mixed_host()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    extra = {"round": 2, "note": "x"}
    jtree = {"params": jax.tree.map(lambda a: jnp.asarray(a, jd), host),
             "client": {"gen": np.asarray(3, np.int64),
                        "stat/grad_sq_norms": np.ones((4, 3), np.float32)}}
    ttree = {"params": params_to_torch(host, "cpu", td),
             "client": {"gen": np.asarray(3, np.int64),
                        "stat/grad_sq_norms": np.ones((4, 3), np.float32)}}
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(dj, 2, jtree, extra=extra)
    tckpt.save_checkpoint(dt, 2, ttree, extra=extra)
    mj, mt = _manifest(dj, 2), _manifest(dt, 2)
    assert mt == mj
    assert mt["dtypes"]["params/embed"] == dtype
    assert mt["keys"] == sorted(mt["keys"])
    got = _npz_members(os.path.join(dt, "step_00000002", "arrays.npz"))
    want = _npz_members(os.path.join(dj, "step_00000002", "arrays.npz"))
    assert list(got) == list(want)
    assert got == want
    if dtype == "bfloat16":
        assert b"'descr': '<V2'" in got["params|embed.npy"]


def test_bf16_round_trip_and_reading_reference_archives(tmp_path):
    host = _mixed_host(1)
    tp = params_to_torch(host, "cpu", torch.bfloat16)
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, 0, tp)
    template = {"blocks": {"w": torch.zeros(3, 4, 2, dtype=torch.bfloat16),
                           "b": torch.zeros(3, 2, dtype=torch.bfloat16)},
                "embed": torch.zeros(5, 4, dtype=torch.bfloat16)}
    out, manifest = tckpt.restore_checkpoint(d, template)
    for a, b in ((out["blocks"]["w"], tp["blocks"]["w"]),
                 (out["blocks"]["b"], tp["blocks"]["b"]),
                 (out["embed"], tp["embed"])):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert manifest["skipped"] == [] and len(manifest["restored"]) == 3
    assert tckpt.verify_checkpoint(d, 0) == (True, "ok")
    # a reference-written bf16 archive reads back bit for bit
    dj = str(tmp_path / "j")
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), host)
    jckpt.save_checkpoint(dj, 0, jtree)
    out_j, _ = tckpt.restore_checkpoint(dj, template)
    assert torch.equal(out_j["embed"].float(),
                       torch.from_numpy(np.asarray(jtree["embed"],
                                                   np.float32)))
    assert tckpt.verify_checkpoint(dj, 0) == (True, "ok")


def test_partial_and_strict_restore(tmp_path):
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, 0, {"w": torch.ones(3)})
    out, manifest = tckpt.restore_checkpoint(
        d, {"w": torch.zeros(3), "opt": torch.full((2,), 7.0)}, partial=True)
    assert torch.equal(out["w"], torch.ones(3))
    assert torch.equal(out["opt"], torch.full((2,), 7.0))
    assert manifest["restored"] == ["w"] and manifest["skipped"] == ["opt"]
    with pytest.raises(KeyError, match="partial=True"):
        tckpt.restore_checkpoint(d, {"w": torch.zeros(3),
                                     "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="template"):
        tckpt.restore_checkpoint(d, {"w": torch.zeros(4)})


def test_step_discovery_and_tmp_sweep(tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(os.path.join(d, "tmporphan"))         # an interrupted save
    tckpt.save_checkpoint(d, 3, {"w": torch.ones(2)})
    assert not os.path.exists(os.path.join(d, "tmporphan"))
    os.makedirs(os.path.join(d, "step_final"))        # stray entries
    os.makedirs(os.path.join(d, "step_"))
    assert tckpt.latest_step(d) == 3
    assert tckpt.all_checkpoint_steps(d) == [3]
    os.makedirs(os.path.join(d, "tmpagain"))
    assert tckpt.sweep_tmp_dirs(d) == [os.path.join(d, "tmpagain")]
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint_arrays(str(tmp_path / "empty"))


def test_verify_detects_damage(tmp_path):
    d = str(tmp_path / "c")
    for s in (1, 2):
        tckpt.save_checkpoint(d, s, {"w": torch.arange(64.0)})
    path = os.path.join(d, "step_00000002", "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[raw.index(b"\x93NUMPY") + 200] ^= 0xFF        # one flipped byte
    open(path, "wb").write(bytes(raw))
    ok, why = tckpt.verify_checkpoint(d, 2)
    assert not ok and ("checksum" in why or "unreadable" in why)
    step, skipped = tckpt.latest_intact_step(d)
    assert step == 1 and [s for s, _ in skipped] == [2]
    open(os.path.join(d, "step_00000001", "manifest.json"), "w").write("{")
    assert tckpt.latest_intact_step(d)[0] is None


# ---------------------------------------------------------------------------
# the server: resume parity, fallback, crossing between the packages
# ---------------------------------------------------------------------------

TASK = dict(n_clients=12, n_classes=10, seq_len=8, samples_per_client=16,
            skew="label", objective="classification")


@pytest.fixture(scope="module")
def world():
    jc = jcfg.reduced(jcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    tc = tcfg.reduced(tcfg.get_arch("xlm_roberta_base"), n_layers=4,
                      d_model=32)
    jm = jmodel.Model(jc, jcfg.RuntimeConfig(remat=False, seq_chunk=16))
    tm = tmodel.Model(tc, tcfg.RuntimeConfig(remat=False, seq_chunk=16),
                      device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jm, tm, jp, host


def _fl(mod, period=1, rounds=6):
    return mod.FLConfig(n_clients=12, cohort_size=4, rounds=rounds,
                        local_steps=2, lr=0.01, batch_size=4,
                        strategy="ours", budget=2, selection_period=period,
                        lam=1.0, seed=29)


def _tdata(tm):
    return tsyn.SyntheticFederatedData(tsyn.FederatedTaskConfig(
        vocab_size=tm.cfg.vocab_size, **TASK))


def _jdata(jm):
    return jsyn.SyntheticFederatedData(jsyn.FederatedTaskConfig(
        vocab_size=jm.cfg.vocab_size, **TASK))


def _records_equal(h_a, h_b, atol=ATOL):
    assert len(h_a.records) == len(h_b.records)
    for ra, rb in zip(h_a.records, h_b.records):
        assert ra.round == rb.round
        np.testing.assert_array_equal(ra.cohort, rb.cohort)
        np.testing.assert_array_equal(ra.mask_matrix, rb.mask_matrix)
        assert ra.train_loss == pytest.approx(rb.train_loss, abs=atol)
        assert ra.test_loss == pytest.approx(rb.test_loss, abs=atol)


def _param_err(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max(_param_err(a[k], b[k]) for k in a)
    aa = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    bb = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(aa.astype(np.float32) - bb.astype(np.float32)).max())


@pytest.mark.parametrize("engine,depth,period", [
    ("sequential", 1, 1),
    ("vectorized", 1, 1),
    ("vectorized", 3, 1),      # deep lookahead crosses the barrier
    ("vectorized", 2, 2),      # the stats cache survives save/restore
])
def test_resume_parity(world, tmp_path, engine, depth, period):
    """6 rounds straight == 3 + save + a fresh server and task + restore +
    3: cohorts, masks and stream draws exact, params within 1e-5."""
    _, tm, _, host = world
    fl = _fl(tcfg, period)
    d = str(tmp_path / "ckpt")
    data_s = _tdata(tm)
    p_straight, h_straight = TServer(
        tm, fl, data_s, engine=engine, pipeline_depth=depth).run(
            params_to_torch(host, "cpu"), rounds=6)
    TServer(tm, fl, _tdata(tm), engine=engine, pipeline_depth=depth,
            checkpoint_dir=d, checkpoint_every=3).run(
                params_to_torch(host, "cpu"), rounds=3)
    assert tckpt.latest_step(d) == 3
    data_r = _tdata(tm)
    srv_r = TServer(tm, fl, data_r, engine=engine, pipeline_depth=depth,
                    checkpoint_dir=d, checkpoint_every=3)
    p_mid, start, hist = srv_r.restore_state(params_to_torch(host, "cpu"))
    assert start == 3 and len(hist.records) == 3
    p_resumed, h_resumed = srv_r.run(p_mid, rounds=6, start=start,
                                     history=hist)
    _records_equal(h_resumed, h_straight)
    assert _param_err(p_resumed, p_straight) < ATOL
    np.testing.assert_array_equal(data_r.stream_positions(),
                                  data_s.stream_positions())


def test_checkpoint_contents_and_fallback(world, tmp_path):
    """What rides a checkpoint (the reference's namespaces), and a flipped
    byte in the latest step falling back to the previous one."""
    _, tm, _, host = world
    d = str(tmp_path / "ckpt")
    srv = TServer(tm, _fl(tcfg, rounds=4), _tdata(tm), pipeline_depth=2,
                  checkpoint_dir=d, checkpoint_every=2)
    srv.run(params_to_torch(host, "cpu"))
    assert tckpt.all_checkpoint_steps(d) == [2, 4]
    flat, manifest = tckpt.load_checkpoint_arrays(d)
    assert any(k.startswith("params/") for k in flat)
    assert "client/warm" in flat and "client/gen" in flat
    assert flat["server_rng/keys"].shape == (624,)
    assert "task/streams/positions" in flat and "task/test_rng/keys" in flat
    extra = manifest["extra"]
    assert extra["round"] == 4 and len(extra["history"]["records"]) == 4
    assert set(extra["select_stats"]) == set(srv.select_stats)
    assert History.from_json(extra["history"]).records[3].round == 3

    path = os.path.join(d, "step_00000004", "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    fresh = TServer(tm, _fl(tcfg, rounds=4), _tdata(tm), checkpoint_dir=d)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, start, hist = fresh.restore_state(params_to_torch(host, "cpu"))
    assert start == 2 and len(hist.records) == 2
    assert fresh.select_stats["ckpt_fallbacks"] == 1
    assert any("step 4" in str(w.message) for w in caught)


@pytest.fixture(scope="module")
def ref_straight(world):
    """The reference's uninterrupted 4-round pipelined run."""
    jm, _, jp, _ = world
    return JServer(jm, _fl(jcfg, rounds=4), _jdata(jm),
                   pipeline_depth=2).run(jp)


def test_reference_checkpoint_resumes_in_the_port(world, ref_straight,
                                                  tmp_path):
    """The reference checkpoints round 2 of 4; the port restores it and
    runs rounds 2–3: masks equal the uninterrupted reference run's."""
    jm, tm, jp, host = world
    d = str(tmp_path / "ckpt")
    p_ref, h_ref = ref_straight
    JServer(jm, _fl(jcfg, rounds=4), _jdata(jm), pipeline_depth=2,
            checkpoint_dir=d, checkpoint_every=2).run(jp, rounds=2)
    srv = TServer(tm, _fl(tcfg, rounds=4), _tdata(tm), pipeline_depth=2,
                  checkpoint_dir=d, checkpoint_every=2)
    p_mid, start, hist = srv.restore_state(params_to_torch(host, "cpu"))
    assert start == 2
    p_got, h_got = srv.run(p_mid, start=start, history=hist)
    _records_equal(h_got, h_ref)
    assert _param_err(p_got, p_ref) < ATOL


def test_port_checkpoint_resumes_in_the_reference(world, ref_straight,
                                                  tmp_path):
    jm, tm, jp, host = world
    d = str(tmp_path / "ckpt")
    p_ref, h_ref = ref_straight
    TServer(tm, _fl(tcfg, rounds=4), _tdata(tm), pipeline_depth=2,
            checkpoint_dir=d, checkpoint_every=2).run(
                params_to_torch(host, "cpu"), rounds=2)
    jsrv = JServer(jm, _fl(jcfg, rounds=4), _jdata(jm), pipeline_depth=2,
                   checkpoint_dir=d, checkpoint_every=2)
    p_mid, start, hist = jsrv.restore_state(jp)
    assert start == 2
    p_got, h_got = jsrv.run(p_mid, start=start, history=hist)
    _records_equal(h_got, h_ref)
    assert _param_err(jax.tree.map(np.asarray, p_got), p_ref) < ATOL


def test_experiment_auto_resume(world, tmp_path):
    """Experiment(checkpoint_dir=…) resumes transparently: 2 rounds, a
    fresh Experiment runs to 4 — equal to 4 straight; a checkpoint at the
    horizon returns the restored state."""
    _, tm, _, host = world
    d = str(tmp_path / "ckpt")

    def exp(ckpt):
        return Experiment(tm, _tdata(tm), "ours", rounds=4, cohort_size=4,
                          local_steps=2, batch_size=4, budget=2, lam=1.0,
                          seed=29, checkpoint_dir=ckpt, checkpoint_every=2,
                          device="cpu")

    p_straight, h_straight = exp(None).run(params_to_torch(host, "cpu"))
    exp(d).run(params_to_torch(host, "cpu"), rounds=2)
    p_resumed, h_resumed = exp(d).run(params_to_torch(host, "cpu"))
    _records_equal(h_resumed, h_straight)
    assert _param_err(p_resumed, p_straight) < ATOL
    p_again, h_again = exp(d).run(params_to_torch(host, "cpu"))
    assert len(h_again.records) == 4
    assert _param_err(p_again, p_resumed) < 1e-7


def test_extract_delta_matches_reference(world, tmp_path):
    jm, tm, jp, host = world
    rng = np.random.RandomState(3)
    tuned = jax.tree.map(np.copy, host)
    tuned["blocks"]["attn_wq"][1] += rng.randn(
        *tuned["blocks"]["attn_wq"][1].shape).astype(np.float32)
    tuned["blocks"]["mlp_wo"][3] += 0.5
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 5, {"params": params_to_torch(tuned, "cpu"),
                                 "client": {"gen": np.asarray(1)}})
    got = tckpt.extract_delta(d, params_to_torch(host, "cpu"), tm.cfg)
    want = jckpt.extract_delta(d, jp, jm.cfg)
    np.testing.assert_array_equal(got.layers, want.layers)
    assert got.layers.tolist() == [1, 3]
    assert set(got.segments) == set(want.segments)
    for path, (idx, leaves) in want.segments.items():
        np.testing.assert_array_equal(got.segments[path][0], idx)
        for name, arr in leaves.items():
            np.testing.assert_allclose(got.segments[path][1][name],
                                       np.asarray(arr), rtol=0, atol=1e-6)
