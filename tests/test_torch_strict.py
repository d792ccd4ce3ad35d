"""Strict-mode tripwires over the port's streaming round loop (the
counterpart of tests/test_strict.py; repro_torch.analysis.strict).

On the CPU the transfer guard is a dispatch mode that raises on the ops the
card's ``torch.cuda.set_sync_debug_mode("error")`` flags (``.item()``,
``nonzero``, a boolean-mask index) and a torch-function mode that raises on
the readback methods (``.cpu()``, ``.numpy()``, ``.tolist()``); the retrace
sentinel watches ``kernels.ops.cache_stats()``.  The strict region is
always forced here (the reference's conftest fixture arms only under
REPRO_STRICT=1; this file defines its own, so tests/conftest.py stays as it
is)."""
import numpy as np
import pytest
import torch

from repro_torch.analysis.strict import (HostSyncError, RetraceSentinel,
                                         strict_enabled, strict_region)
from repro_torch.configs.base import FLConfig, RuntimeConfig, get_arch, reduced
from repro_torch.core.client import HostCopy
from repro_torch.core.server import FLServer
from repro_torch.data.synthetic import (FederatedTaskConfig,
                                        SyntheticFederatedData)
from repro_torch.kernels import delta_matmul, ops
from repro_torch.models.model import Model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes here are tiny, and the suite runs
    files in parallel workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def strict_mode():
    """``with strict_mode("label"): ...`` arms both tripwires under
    REPRO_STRICT=1, or always with ``force=True``."""
    def region(label="strict-region", force: bool = False):
        return strict_region(label, enabled=force or strict_enabled(),
                             device="cpu")
    return region


def _world():
    cfg = reduced(get_arch("xlm_roberta_base"), n_layers=2, d_model=32)
    model = Model(cfg, RuntimeConfig(remat=False, seq_chunk=16),
                  device="cpu")
    task = FederatedTaskConfig(n_clients=8, n_classes=10,
                               vocab_size=cfg.vocab_size, seq_len=8,
                               samples_per_client=16, skew="label",
                               objective="classification")
    fl = FLConfig(n_clients=8, cohort_size=3, rounds=4, local_steps=2,
                  lr=0.01, batch_size=4, strategy="ours", budget=1, lam=1.0,
                  seed=0)
    return model, model.init(0), task, fl


@pytest.mark.parametrize("depth", [1, 4])
def test_round_loop_strict_no_syncs_no_retraces(strict_mode, depth):
    """A warm run, then an identically configured run under the strict
    region at pipeline depth 1 and 4: no host sync on the main thread, no
    cache grows, and the same summary."""
    model, params, task, fl = _world()
    warm = FLServer(model, fl, SyntheticFederatedData(task),
                    pipeline_depth=depth)
    _, h_warm = warm.run(params)

    srv = FLServer(model, fl, SyntheticFederatedData(task),
                   pipeline_depth=depth)
    with strict_mode(f"round loop depth={depth}", force=True):
        _, h_strict = srv.run(params)
    assert h_warm.summary() == h_strict.summary()


def test_pipelined_loop_with_a_blocking_readback_trips(strict_mode,
                                                       monkeypatch):
    """The loop's evaluation, read back on the main thread (``.cpu()``
    rather than through ``HostCopy``), trips the guard: the test above
    would fail if the loop waited on the card."""
    model, params, task, fl = _world()
    srv = FLServer(model, fl, SyntheticFederatedData(task), pipeline_depth=1)
    evaluate_raw = type(srv.client).evaluate_raw

    def blocking(self, *a, **k):
        loss, acc = evaluate_raw(self, *a, **k)
        return loss.cpu(), acc
    monkeypatch.setattr(type(srv.client), "evaluate_raw", blocking)
    with pytest.raises(HostSyncError, match=r"Tensor\.cpu"):
        with strict_mode("pipelined loop", force=True):
            srv.run(params, rounds=1)


def test_synchronous_loop_trips_the_guard(strict_mode):
    """The synchronous loop reads losses back each round: the guard says
    so (the pipelined loop above does not)."""
    model, params, task, fl = _world()
    srv = FLServer(model, fl, SyntheticFederatedData(task), pipeline=False)
    with pytest.raises(HostSyncError, match="host sync inside sync loop"):
        with strict_mode("sync loop", force=True):
            srv.run(params, rounds=1)


def test_strict_region_trips_on_item(strict_mode):
    """The guard guards: ``.item()`` raises inside the region and passes
    outside it; so do ``nonzero`` and a boolean-mask index."""
    x = torch.arange(4.0)
    assert x.sum().item() == 6.0
    for fn in (lambda: x.sum().item(), lambda: float(x[0]),
               lambda: torch.nonzero(x), lambda: x[x > 1]):
        with pytest.raises(HostSyncError, match="host sync inside tripwire"):
            with strict_mode("tripwire", force=True):
                fn()
    with strict_mode("tripwire", force=True):
        y = (x * 2 + 1).sum()
    assert y.item() == 16.0


@pytest.mark.parametrize("read", ["cpu", "numpy", "tolist", "asarray"])
def test_strict_region_trips_on_a_readback(strict_mode, read):
    """A readback method raises inside the region (on the CPU no op is
    dispatched for it), and ``HostCopy.to_numpy``, the sanctioned
    readback, passes."""
    x = torch.arange(4.0)
    fn = {"cpu": x.cpu, "numpy": x.numpy, "tolist": x.tolist,
          "asarray": lambda: np.asarray(x)}[read]
    with pytest.raises(HostSyncError, match="blocking readback"):
        with strict_mode("tripwire", force=True):
            fn()
    with strict_mode("tripwire", force=True):
        host = HostCopy({"x": x * 2}).to_numpy()
    np.testing.assert_array_equal(host["x"], [0.0, 2.0, 4.0, 6.0])


def test_disabled_region_is_a_no_op(strict_mode, monkeypatch):
    monkeypatch.delenv("REPRO_STRICT", raising=False)
    with strict_mode("off"):
        assert torch.ones(2).sum().item() == 2.0
    monkeypatch.setenv("REPRO_STRICT", "1")
    with pytest.raises(HostSyncError):
        with strict_mode("on"):
            torch.ones(2).sum().item()


def test_retrace_sentinel_trips_on_new_cache_entry():
    """A per-shape cache entry made inside the region is reported as a
    retrace, naming the cache that grew."""
    delta_matmul.plan.cache_clear()
    delta_matmul.plan(4, 64, 96)
    with RetraceSentinel("warm"):
        delta_matmul.plan(4, 64, 96)            # cached: no growth
    with pytest.raises(AssertionError,
                       match=r"retrace inside cold run: .*"
                             r"delta_matmul\.plan: 1->2"):
        with RetraceSentinel("cold run"):
            delta_matmul.plan(4, 64, 112)
    assert set(ops.cache_stats()) >= {"_build.load_library",
                                      "delta_matmul.plan"}


def test_cuda_guard_restores_the_sync_debug_mode(monkeypatch):
    """On the card the region sets the sync-debug mode to "error" and puts
    the previous mode back on exit, also when the block raises (the mode
    setters are stubbed here: there is no card)."""
    from repro_torch.analysis import strict
    state = {"mode": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: state.update(mode=m))
    seen = []
    with strict.no_implicit_transfers(True, "card", device="cuda"):
        seen.append(state["mode"])
    with pytest.raises(ValueError):
        with strict.no_implicit_transfers(True, "card", device="cuda"):
            raise ValueError("inside")
    assert seen == ["error"] and state["mode"] == 0
