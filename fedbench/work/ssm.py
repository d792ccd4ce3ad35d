"""Operations and bytes of the ssm family's federated round, from shapes
and masks alone (the yardstick of ``round_mfu`` and ``ssd_scan_roofline``).

A round needs: the probe (per probe client and selection batch, a forward
and a backward with every layer's weight gradient), the update (per client
and local step, a forward, activation gradients from the head down to the
round's cut and weight gradients of the client's selected layers only) and
the eval forward.  Products count 2 per multiply-add; element-wise work is
not counted, nor is anything recomputed.  The scan's count is
:func:`ssd_flops` (a copy of the port's ``kernels.ops.ssd_flops``) and its
backward, whose inputs are all activations, twice that.

:func:`ssd_bound` is a copy of the port's ``chip_smoke.py`` ``ssd_bound``:
the larger of the scan's bytes (x, B/C, dt, A, D read once, y written
once) over HBM bandwidth and its operations over the bf16 peak.
"""
from __future__ import annotations

from fedbench.harness.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S


def dims(c: dict):
    d = c["d_model"]
    d_in = c["ssm_expand"] * d
    h = c["ssm_heads"]
    return d, d_in, h, d_in // h, c["ssm_groups"], c["ssm_state"], c["ssm_conv"]


def ssd_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """One scan at chunk q: the causal half of each chunk's Q × Q products
    and the inter-chunk terms (none for the first chunk, no state update
    after the last)."""
    nc, tri = s // q, q * (q + 1) // 2
    return 2 * b * h * (nc * tri * (n + p) + 2 * (nc - 1) * q * n * p)


def ssd_bound(c: dict, b: int, s: int, elem: int = 2) -> float:
    """Least seconds for one scan of a (b, s) batch in bf16."""
    _, _, h, p, g, n, _ = dims(c)
    q = min(c["ssm_chunk"], s)
    nbytes = (2 * b * s * h * p * elem + 2 * b * s * g * n * elem
              + b * s * h * 4 + 2 * h * 4)
    return max(nbytes / HBM_BYTES_PER_S,
               ssd_flops(b, s, h, p, n, q) / PEAK_OPS_PER_S["bfloat16"])


def row_parts(c: dict, b: int, s: int) -> dict:
    """A Mamba2 row's forward products on a (b, s) batch: the input
    projection (its input's gradient is ``in``), the conv, the scan and the
    output projection."""
    d, d_in, h, p, g, n, K = dims(c)
    T = b * s
    return {"in": 2 * T * d * (2 * d_in + 2 * g * n + h),
            "conv": 2 * T * K * (d_in + 2 * g * n),
            "scan": ssd_flops(b, s, h, p, n, min(c["ssm_chunk"], s)),
            "out": 2 * T * d_in * d}


def head(c: dict, b: int, s: int) -> int:
    return 2 * b * (s - 1) * c["d_model"] * c["vocab_size"]


def units(c: dict, b: int, s: int) -> list:
    """The compute order: per unit its mask index ``u``, its forward
    products ``fwd``, those whose weights take a gradient (``weights``),
    the one that reads the unit's input (``input``: no gradient at the
    lowest unit) and those whose every operand is an activation (``both``:
    their backward is twice their forward)."""
    parts = row_parts(c, b, s)
    return [dict(u=i, fwd=parts, weights=("in", "conv", "out"), input="in",
                 both=("scan",)) for i in range(c["n_layers"])]


def step_flops(order: list, head_f: int, lowest, selected) -> int:
    """One forward and the backward this step needs: activation gradients
    for every unit from position ``lowest`` up (but the lowest unit's input
    gradient), weight gradients of the ``selected`` mask indices only."""
    fwd = sum(sum(x["fwd"].values()) for x in order) + head_f
    if lowest is None:
        return fwd
    bwd = head_f
    for pos, x in enumerate(order[lowest:], start=lowest):
        for k, v in x["fwd"].items():
            if k in x["both"]:
                bwd += 2 * v
            elif not (pos == lowest and k == x["input"]):
                bwd += v
        if x["u"] in selected:
            bwd += sum(x["fwd"][k] for k in x["weights"])
    return fwd + bwd


def lowest_position(order: list, mask_indices):
    pos = [k for k, x in enumerate(order) if x["u"] in mask_indices]
    return min(pos) if pos else None


def round_flops(c: dict, traffic: dict, masks, n_probe: int,
                unit_fn=units) -> int:
    """The operations one round needs (``masks`` (cohort, L) 0/1)."""
    fl, s = traffic["fl"], traffic["seq_len"]
    b = fl["batch_size"]
    order = unit_fn(c, b, s)
    hf = head(c, b, s)
    L = len(masks[0])
    everything = set(range(L))
    probe = n_probe * fl["selection_batches"] * step_flops(
        order, hf, lowest_position(order, everything), everything)
    union = {l for row in masks for l in range(L) if row[l]}
    cut = lowest_position(order, union)
    update = sum(fl["local_steps"] * step_flops(
        order, hf, cut, {l for l in range(L) if row[l]}) for row in masks)
    n_eval = traffic["data"]["test_samples"]
    ev = step_flops(unit_fn(c, n_eval, s), head(c, n_eval, s), None, ())
    return probe + update + ev


def scan_bound(c: dict, forwards) -> float:
    """Least seconds of the scans a stretch needs: one per Mamba2 row per
    sequence forward, ``forwards`` the (batch, sequence) shape of each."""
    return c["n_layers"] * sum(ssd_bound(c, b, s) for b, s in forwards)
