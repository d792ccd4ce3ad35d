"""The yardstick's arithmetic against hand counts at tiny shapes: the
scan's operations and bounds, a step's and a round's operations, and the
trace's reduction."""
import pytest

from fedbench.harness import trace
from fedbench.harness.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S
from fedbench.work import ssm

C = dict(n_layers=2, d_model=4, ssm_expand=2, ssm_heads=2, ssm_groups=1,
         ssm_state=2, ssm_conv=2, ssm_chunk=2, vocab_size=10)


def test_ssd_flops_by_hand():
    # s 4 at chunk 2: 2 chunks of 3 causal pairs × (n + p), one state pass
    # of q·n·p twice (the state and its read)
    assert ssm.ssd_flops(1, 4, 1, 1, 1, 2) == 2 * (2 * 3 * 2 + 2 * 1 * 2)
    assert ssm.ssd_flops(2, 2, 3, 4, 5, 2) == 2 * 2 * 3 * (1 * 3 * 9)


def test_ssd_bound_takes_the_larger_term():
    b, s = 1, 4
    # h 2, p 4, g 1, n 2: bytes 2·4·2·4·2 + 2·4·1·2·2 + 4·2·4 + 2·2·4
    nbytes = 128 + 32 + 32 + 16
    ops = ssm.ssd_flops(b, s, 2, 4, 2, 2)
    assert ssm.ssd_bound(C, b, s) == pytest.approx(
        max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bfloat16"]))


def test_scan_bound_sums_a_scan_per_row_per_forward():
    one = ssm.ssd_bound(C, 4, 8)
    # two rows; two forwards at batch 4 and one at batch 8 (linear in b
    # but for A and D, read once a scan)
    got = ssm.scan_bound(C, [(4, 8), (4, 8), (8, 8)])
    assert got == pytest.approx(2 * (2 * one + ssm.ssd_bound(C, 8, 8)))
    assert ssm.scan_bound(C, []) == 0


def test_row_parts_by_hand():
    p = ssm.row_parts(C, 1, 2)
    # d 4, d_in 8, h 2, g·n 2: in_proj 4 → 2·8 + 2·2 + 2 = 22 columns
    assert p["in"] == 2 * 2 * 4 * 22
    assert p["conv"] == 2 * 2 * 2 * (8 + 4)
    assert p["out"] == 2 * 2 * 8 * 4
    assert p["scan"] == ssm.ssd_flops(1, 2, 2, 4, 2, 2)


def test_step_flops_forward_backward_and_masks():
    order = ssm.units(C, 1, 2)
    p = ssm.row_parts(C, 1, 2)
    row, head = sum(p.values()), ssm.head(C, 1, 2)
    assert head == 2 * 1 * 4 * 10
    fwd = 2 * row + head
    assert ssm.step_flops(order, head, None, ()) == fwd
    act = p["in"] + p["conv"] + 2 * p["scan"] + p["out"]
    wgt = p["in"] + p["conv"] + p["out"]
    # top row only: its activation gradients but its input's, its weights
    assert ssm.step_flops(order, head, 1, {1}) == \
        fwd + head + act - p["in"] + wgt
    # both rows, only the lower one's weights
    assert ssm.step_flops(order, head, 0, {0}) == \
        fwd + head + 2 * act - p["in"] + wgt


def test_round_flops_adds_probe_update_and_eval():
    traffic = {"seq_len": 2, "fl": {"batch_size": 1, "selection_batches": 1,
                                    "local_steps": 2},
               "data": {"test_samples": 3}}
    masks = [[0, 1], [0, 1]]
    order = ssm.units(C, 1, 2)
    head = ssm.head(C, 1, 2)
    probe = ssm.step_flops(order, head, 0, {0, 1})
    update = ssm.step_flops(order, head, 1, {1})
    ev = ssm.step_flops(ssm.units(C, 3, 2), ssm.head(C, 3, 2), None, ())
    assert ssm.round_flops(C, traffic, masks, 2) == \
        2 * probe + 2 * 2 * update + ev
    assert ssm.round_flops(C, traffic, masks, 0) == 2 * 2 * update + ev


def test_trace_reduce_by_hand():
    ops = [("k_a", 20, 40), ("k_b", 35, 45), ("k_a", 60, 90)]
    out = trace.reduce(100, ops)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(55e-9)
    assert out["by_name"]["k_a"] == pytest.approx(50e-9)
    assert out["device_ops"][0][0] == "k_a"
    assert [g[0] for g in out["idle_gaps"]] == [
        "before k_a", "before k_a", "after the last operation"]
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx(
        [20e-9, 15e-9, 10e-9])
    assert trace.kernel_seconds(out, ["k_b"]) == pytest.approx(10e-9)
    # a kernel that ends after the host returned stretches the window
    assert trace.reduce(50, ops)["window_s"] == pytest.approx(90e-9)
