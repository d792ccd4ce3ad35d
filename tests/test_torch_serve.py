"""The port's SlotServer, DeltaOverlay and demo_store against the JAX
package's on the same world: generated token ids, overlay bookkeeping and
the capacity-exhaustion drop must be exactly the reference's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JRuntime
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serve import DeltaOverlay as JOverlay
from repro.serve import DeltaStore as JStore
from repro.serve import delta_from_params as jdelta_from_params
from repro_torch.bridge import params_to_torch
from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model
from repro_torch.serve import DeltaOverlay, DeltaStore


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def worlds():
    jm = JModel(jreduced(jget_arch("tinyllama_1_1b"), n_layers=3,
                         d_model=64), JRuntime(remat=False, seq_chunk=16))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(reduced(get_arch("tinyllama_1_1b"), n_layers=3, d_model=64),
               RuntimeConfig(remat=False, seq_chunk=16), device="cpu")
    return jm, jp, tm, params_to_torch(_host(jp), "cpu")


def _requests(mod, vocab, users):
    rng = np.random.RandomState(1)
    return [mod.Request(i, rng.randint(0, vocab, 4).tolist(), 5,
                        user_id=(i % users if users else -1))
            for i in range(7)]


def test_demo_store_records_are_byte_identical(worlds):
    jm, jp, tm, tp = worlds
    js = jserve.demo_store(jm, jp, users=3, layers_per_user=2, seed=0)
    ts = tserve.demo_store(tm, tp, users=3, layers_per_user=2, seed=0)
    assert ts.users() == js.users()
    for uid in js.users():
        jr, tr = js.get(uid), ts.get(uid)
        np.testing.assert_array_equal(tr.layers, jr.layers)
        (jrows, jleaves), (trows, tleaves) = (jr.segments["blocks"],
                                              tr.segments["blocks"])
        np.testing.assert_array_equal(trows, jrows)
        assert list(tleaves) == list(jleaves)
        for name in jleaves:
            assert tleaves[name].dtype == np.float32
            np.testing.assert_array_equal(tleaves[name], jleaves[name])


@pytest.mark.parametrize("mode", ["shared", "delta", "dense"])
def test_slot_server_generates_reference_tokens(worlds, mode):
    """7 requests through 3 slots, staggered refills: the same token ids as
    the JAX SlotServer in every mode."""
    jm, jp, tm, tp = worlds
    users = 0 if mode == "shared" else 3
    jstore = tstore = None
    if users:
        jstore = jserve.demo_store(jm, jp, users=3, layers_per_user=2, seed=0)
        tstore = tserve.demo_store(tm, tp, users=3, layers_per_user=2, seed=0)
    jdone, jstats = jserve.SlotServer(jm, jp, 3, 16, mode=mode,
                                      store=jstore).run(
        _requests(jserve, jm.cfg.vocab_size, users))
    tdone, tstats = tserve.SlotServer(tm, tp, 3, 16, mode=mode, store=tstore,
                                      device="cpu").run(
        _requests(tserve, tm.cfg.vocab_size, users))
    assert len(tdone) == len(jdone) == 7
    assert [(r.rid, r.generated) for r in tdone] == \
        [(r.rid, r.generated) for r in jdone]
    assert tstats["steps"] == jstats["steps"]
    assert tstats["gen_tokens"] == jstats["gen_tokens"] == 35


def test_overlay_bookkeeping_matches_reference(worlds):
    """Admit, refuse, release and re-admit leave the same owner table."""
    jm, jp, tm, tp = worlds
    host = _host(jp)
    tuned = dict(host)
    tuned["blocks"] = {k: v + np.float32(0.01)
                       for k, v in host["blocks"].items()}
    jrec = jdelta_from_params(jp, tuned, jm.cfg, layers=[0, 2])
    trec = tserve.DeltaStore(tm.cfg).put_from_params(0, tp, tuned,
                                                     layers=[0, 2])
    jov, tov = JOverlay(jm, capacity=2), DeltaOverlay(tm, 2, device="cpu")
    for op, slot in [("admit", 0), ("admit", 1), ("admit", 2),
                     ("release", 0), ("admit", 2), ("release", 1),
                     ("admit", 0)]:
        if op == "admit":
            assert tov.try_admit(slot, trec) == jov.try_admit(slot, jrec)
        else:
            jov.release(slot)
            tov.release(slot)
        np.testing.assert_array_equal(tov.slot_ids, jov.slot_ids)
        assert tov.entries == jov.entries
    jdev, tdev = jov.device(), tov.device()
    np.testing.assert_array_equal(tdev["slots"].numpy(),
                                  np.asarray(jdev["slots"]))
    for name, leaf in jdev["leaves"].items():
        np.testing.assert_array_equal(tdev["leaves"][name].numpy(),
                                      np.asarray(leaf))


@pytest.mark.parametrize("admit_retries,n_done,n_dropped",
                         [(2, 1, 2), (30, 3, 0)])
def test_capacity_exhaustion_drop_matches_reference(worlds, admit_retries,
                                                    n_done, n_dropped):
    """One user whose delta fills a capacity-1 overlay, three requests for
    it: the same requests are served or dropped as by the reference."""
    jm, jp, tm, tp = worlds
    host = _host(jp)
    tuned = dict(host)
    tuned["blocks"] = {k: v + np.float32(0.01)
                       for k, v in host["blocks"].items()}
    jstore, tstore = JStore(jm.cfg), DeltaStore(tm.cfg)
    jstore.put_from_params(0, jp, tuned, layers=[0, 1])
    tstore.put_from_params(0, tp, tuned, layers=[0, 1])
    results = []
    for mod, model, params, store, kw in (
            (jserve, jm, jp, jstore, {}),
            (tserve, tm, tp, tstore, {"device": "cpu"})):
        srv = mod.SlotServer(model, params, slots=2, max_seq=16, mode="delta",
                             store=store, capacity=1,
                             admit_retries=admit_retries, **kw)
        done, stats = srv.run([mod.Request(i, [1, 2, 3], 4, user_id=0)
                               for i in range(3)])
        results.append(([(r.rid, r.generated) for r in done],
                        [r.rid for r in srv.dropped],
                        stats["dropped_requests"]))
    assert results[1] == results[0]
    assert len(results[1][0]) == n_done and results[1][2] == n_dropped


@pytest.mark.parametrize("entry", ["Model", "SlotServer", "DeltaOverlay",
                                   "main"])
def test_entry_points_refuse_cpu_fallback(worlds, entry, monkeypatch):
    """Without CUDA, an entry point that is not given device='cpu' raises
    instead of quietly running on the CPU."""
    _, _, tm, tp = worlds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "Model":
            Model(tm.cfg)
        elif entry == "SlotServer":
            tserve.SlotServer(tm, tp, 3, 16)
        elif entry == "DeltaOverlay":
            DeltaOverlay(tm, 2)
        else:
            tserve.main(["--requests", "1"])
