"""The port's serving faults against the JAX package's, on the serving world
of tests/test_faults.py (reduced TinyLlama: 3 layers, d 64): capacity
exhaustion, slot strikes (requeued, then dropped), delta-upload retries
with the all-or-nothing rollback of a failed admit.  Done and dropped
request ids, generated tokens, the servers' and the overlays' stats and
the injectors' stats must be exactly the reference's; everything runs on
the CPU through the kernels' plain versions."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as JRuntime
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.faults import FaultInjector as JInjector
from repro.faults import FaultPlan as JPlan
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serve import DeltaOverlay as JOverlay
from repro.serve import DeltaStore as JStore
from repro.serve import delta_from_params as jdelta_from_params
from repro_torch.bridge import params_to_torch
from repro_torch.configs.base import RuntimeConfig, get_arch, reduced
from repro_torch.faults import FaultInjector, FaultPlan
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model
from repro_torch.serve import DeltaOverlay, DeltaStore, delta_from_params


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def worlds():
    jm = JModel(jreduced(jget_arch("tinyllama_1_1b"), n_layers=3,
                         d_model=64), JRuntime(remat=False, seq_chunk=16))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(reduced(get_arch("tinyllama_1_1b"), n_layers=3, d_model=64),
               RuntimeConfig(remat=False, seq_chunk=16), device="cpu")
    return jm, jp, tm, params_to_torch(_host(jp), "cpu")


def _two_layer_records(worlds):
    """The same two-layer user delta in both packages' record types."""
    jm, jp, tm, tp = worlds
    tuned = _host(jp)
    tuned["blocks"] = {k: v + 0.01 for k, v in tuned["blocks"].items()}
    jrec = jdelta_from_params(jp, tuned, jm.cfg, layers=[0, 1])
    trec = delta_from_params(tp, tuned, tm.cfg, layers=[0, 1])
    return jrec, trec


def _outcome(done, stats, srv):
    """What a serve run must reproduce: ids and tokens of the finished and
    dropped requests, and the stats without the wall-clock ones."""
    return ([(r.rid, list(r.generated)) for r in done],
            sorted(r.rid for r in srv.dropped),
            {k: v for k, v in stats.items()
             if k not in ("wall_s", "tok_per_s")})


def _pair(worlds, mode, requests, plan=None, jstore=None, tstore=None,
          **kw):
    """The same requests through both packages' SlotServer."""
    jm, jp, tm, tp = worlds
    jinj = JInjector(JPlan(**plan)) if plan is not None else None
    tinj = FaultInjector(FaultPlan(**plan)) if plan is not None else None
    jsrv = jserve.SlotServer(jm, jp, mode=mode, store=jstore, injector=jinj,
                             **kw)
    tsrv = tserve.SlotServer(tm, tp, mode=mode, store=tstore, injector=tinj,
                             device="cpu", **kw)
    jout = _outcome(*jsrv.run(requests(jserve)), jsrv)
    tout = _outcome(*tsrv.run(requests(tserve)), tsrv)
    return (tout, tsrv, tinj), (jout, jsrv, jinj)


@pytest.mark.parametrize("admit_retries,n_done,n_dropped",
                         [(2, 1, 2), (30, 3, 0)])
def test_capacity_exhaustion_matches_reference(worlds, admit_retries, n_done,
                                               n_dropped):
    """One user whose delta fills the capacity-1 overlay, three requests
    for it: the head is retried ``admit_retries`` times then dropped, or
    admitted once the running request releases."""
    jrec, trec = _two_layer_records(worlds)
    jstore, tstore = JStore(worlds[0].cfg), DeltaStore(worlds[2].cfg)
    jstore.put(0, jrec)
    tstore.put(0, trec)
    (tout, tsrv, _), (jout, _, _) = _pair(
        worlds, "delta",
        lambda mod: [mod.Request(i, [1, 2, 3], 4, user_id=0)
                     for i in range(3)],
        jstore=jstore, tstore=tstore, slots=2, max_seq=16, capacity=1,
        admit_retries=admit_retries)
    assert tout == jout
    assert len(tout[0]) == n_done
    assert tout[2]["dropped_requests"] == n_dropped == len(tsrv.dropped)
    assert all(len(toks) == 4 for _, toks in tout[0])


def test_slot_faults_requeue_then_drop(worlds):
    (tout, _, tinj), (jout, _, jinj) = _pair(
        worlds, "shared",
        lambda mod: [mod.Request(i, [1, 2, 3], 4) for i in range(3)],
        plan=dict(seed=21, slot_fault_rate=1.0), slots=2, max_seq=16,
        max_slot_retries=1)
    assert tout == jout
    assert not tout[0]
    assert tout[2]["dropped_requests"] == 3
    assert tout[2]["slot_failures"] == 3 * (1 + 1)
    assert tinj.stats == jinj.stats and tinj.stats["slot_faults"] > 0


def test_slot_faults_recoverable_at_low_rate(worlds):
    (tout, _, tinj), (jout, _, jinj) = _pair(
        worlds, "shared",
        lambda mod: [mod.Request(i, [1, 2, 3], 4) for i in range(4)],
        plan=dict(seed=3, slot_fault_rate=0.1), slots=2, max_seq=32,
        max_slot_retries=50)
    assert tout == jout
    assert len(tout[0]) == 4 and tout[2]["dropped_requests"] == 0
    assert tout[2]["slot_failures"] > 0
    assert all(len(toks) == 4 for _, toks in tout[0])
    assert tinj.stats == jinj.stats


def test_struck_requests_rerun_to_the_fault_free_tokens(worlds):
    """A struck request reruns from its prompt: its tokens equal the
    fault-free run's."""
    def reqs(mod):
        rng = np.random.RandomState(1)
        return [mod.Request(i, rng.randint(0, 512, 4).tolist(), 5)
                for i in range(6)]
    _, _, tm, tp = worlds
    clean, _ = tserve.SlotServer(tm, tp, 3, 16, device="cpu").run(
        reqs(tserve))
    srv = tserve.SlotServer(
        tm, tp, 3, 16, max_slot_retries=50, device="cpu",
        injector=FaultInjector(FaultPlan(seed=3, slot_fault_rate=0.2)))
    done, stats = srv.run(reqs(tserve))
    assert stats["slot_failures"] > 0
    assert sorted((r.rid, r.generated) for r in done) == \
        sorted((r.rid, r.generated) for r in clean)


def test_delta_serving_under_upload_and_slot_faults(worlds):
    """Delta mode with both serving faults on, as the card's smoke run
    drives it: the same outcome and stats as the reference, every request
    finished, and the overlay's retries equal to the injector's upload
    faults."""
    jm, jp, tm, tp = worlds
    jstore = jserve.demo_store(jm, jp, users=3, layers_per_user=2, seed=0)
    tstore = tserve.demo_store(tm, tp, users=3, layers_per_user=2, seed=0)

    def reqs(mod):
        rng = np.random.RandomState(1)
        return [mod.Request(i, rng.randint(0, 512, 4).tolist(), 5,
                            user_id=i % 3) for i in range(7)]
    (tout, tsrv, tinj), (jout, jsrv, jinj) = _pair(
        worlds, "delta", reqs,
        plan=dict(seed=2, upload_fail_rate=0.3, slot_fault_rate=0.05),
        jstore=jstore, tstore=tstore, slots=3, max_seq=16,
        max_slot_retries=50)
    assert tout == jout
    assert len(tout[0]) == 7
    assert tinj.stats == jinj.stats
    assert tsrv.overlay.stats == jsrv.overlay.stats
    assert tsrv.overlay.stats["upload_retries"] == \
        tinj.stats["upload_faults"] > 0
    assert tsrv.overlay.stats["failed_admits"] == 0


def test_disabled_injector_serves_as_none(worlds):
    def reqs(mod):
        return [mod.Request(i, [1, 2, 3], 4) for i in range(3)]
    _, _, tm, tp = worlds
    outs = []
    for inj in (None, FaultInjector(FaultPlan(enabled=False,
                                              slot_fault_rate=1.0))):
        srv = tserve.SlotServer(tm, tp, 2, 16, injector=inj, device="cpu")
        outs.append(_outcome(*srv.run(reqs(tserve)), srv))
    assert outs[0] == outs[1]


def test_overlay_upload_retries_and_rollback(worlds):
    jm, _, tm, _ = worlds
    jrec, trec = _two_layer_records(worlds)

    # permanent failure: the admit rolls back whole
    jinj = JInjector(JPlan(seed=0, upload_fail_rate=1.0))
    tinj = FaultInjector(FaultPlan(seed=0, upload_fail_rate=1.0))
    jov = JOverlay(jm, capacity=2, injector=jinj, max_upload_retries=2)
    tov = DeltaOverlay(tm, capacity=2, injector=tinj, max_upload_retries=2,
                       device="cpu")
    assert not jov.try_admit(0, jrec)
    assert not tov.try_admit(0, trec)
    assert tov.stats == jov.stats == {"upload_retries": 2,
                                      "failed_admits": 1}
    assert tov.n_entries == 0 and tov.entries[0] == []
    assert tinj.stats == jinj.stats and tinj.stats["upload_faults"] == 3

    # transient failures: bounded retries absorb them
    jinj = JInjector(JPlan(seed=2, upload_fail_rate=0.4))
    tinj = FaultInjector(FaultPlan(seed=2, upload_fail_rate=0.4))
    jov = JOverlay(jm, capacity=2, injector=jinj, max_upload_retries=10)
    tov = DeltaOverlay(tm, capacity=2, injector=tinj, max_upload_retries=10,
                       device="cpu")
    assert jov.try_admit(0, jrec) and tov.try_admit(0, trec)
    assert tov.n_entries == trec.n_layers == 2
    assert tov.stats == jov.stats
    assert tinj.stats["upload_faults"] == tov.stats["upload_retries"] > 0
    np.testing.assert_array_equal(tov.slot_ids, jov.slot_ids)
    for name, leaf in tov.leaves.items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jov.leaves[name]))


def test_rollback_after_a_partial_admit(worlds):
    """The second entry write fails for good after the first succeeded:
    the first entry is freed again and nothing of the user stays live."""
    _, _, tm, _ = worlds
    _, trec = _two_layer_records(worlds)

    class SecondWriteFails:
        enabled = True

        def __init__(self):
            self.calls = 0

        def maybe_fail_upload(self, seq):
            self.calls += 1
            if seq >= 1:
                from repro_torch.faults import TransientFault
                raise TransientFault(f"write {seq}")
    inj = SecondWriteFails()
    ov = DeltaOverlay(tm, capacity=2, injector=inj, max_upload_retries=1,
                      device="cpu")
    assert not ov.try_admit(0, trec)
    assert ov.n_entries == 0 and ov.entries[0] == []
    assert ov.stats == {"upload_retries": 1, "failed_admits": 1}
    assert inj.calls == 3
    assert (ov.device()["slots"] == -1).all()
