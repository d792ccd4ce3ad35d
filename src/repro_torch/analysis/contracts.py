"""Program-level contracts over the audited fact table (counterpart of
``repro/analysis/contracts.py``, DESIGN.md §11).

Each contract is a pure function ``facts -> [Violation]`` over the
``{name: ProgramFacts}`` table the auditor (``analysis/program.py``)
produced; the five contracts, their thresholds and their messages are the
reference's, so one table gives the same violations in both packages.
They encode *relations* that hold across versions and devices, not
absolute numbers.

| contract                      | invariant                                 |
|-------------------------------|-------------------------------------------|
| cut-monotone                  | masked-cut FLOPs strictly decrease with   |
|                               | the cut; cut=L is forward-only            |
| delta-weight-traffic          | serve_decode_delta weight bytes are       |
|                               | B-independent and linear in capacity C;   |
|                               | the dense baseline scales with B          |
| donation-honored              | every declared-donated leaf is written in |
|                               | place and handed back                     |
| dtype-discipline              | no f64 anywhere; bf16-configured decode   |
|                               | keeps its cache in bf16                   |
| collective-transfer-allowlist | single-host programs contain zero         |
|                               | collectives and zero host transfers;      |
|                               | sharded programs only mesh-declared       |
|                               | collective kinds                          |
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

# forward-only / full-training FLOPs ratio bound: theory says ≈(L+head)/(3L)
# ≈ 0.33 for block-dominated configs at remat=False; 0.6 leaves headroom
# for the loss head while still proving the backward is gone.
FORWARD_ONLY_MAX_FRAC = 0.6
# weight traffic equality across batch sizes is exact in the op-level
# model; the slack only covers float accounting.
B_INDEPENDENCE_RTOL = 0.005
C_LINEARITY_RTOL = 0.02
DENSE_SCALE_RTOL = 0.10


@dataclass
class Violation:
    contract: str
    program: str
    message: str

    def to_dict(self) -> dict:
        return {"contract": self.contract, "program": self.program,
                "message": self.message}


def _by_kind(facts: Dict, kind: str) -> list:
    return [f for f in facts.values() if f.meta.get("kind") == kind]


def _configs(rows) -> list:
    return sorted({f.meta.get("config", "?") for f in rows})


# -- 1. masked-cut FLOPs monotone, cut=L forward-only ------------------------

def check_cut_monotone(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    rows = _by_kind(facts, "fl_step_masked")
    for cfg in _configs(rows):
        series = sorted((f.meta["cut"], f) for f in rows
                        if f.meta.get("config") == cfg)
        if len(series) < 2:
            continue
        for (c0, f0), (c1, f1) in zip(series, series[1:]):
            if not f1.flops < f0.flops:
                out.append(Violation(
                    "cut-monotone", f1.name,
                    f"FLOPs not strictly decreasing in cut: cut={c1} has "
                    f"{f1.flops:.3g} >= cut={c0}'s {f0.flops:.3g}"))
        first_cut, first = series[0]
        last_cut, last = series[-1]
        L = last.meta.get("n_selectable")
        if first_cut == 0 and L is not None and last_cut == L:
            frac = last.flops / max(first.flops, 1.0)
            if frac > FORWARD_ONLY_MAX_FRAC:
                out.append(Violation(
                    "cut-monotone", last.name,
                    f"cut={last_cut} should be forward-only but costs "
                    f"{frac:.0%} of cut=0 (limit "
                    f"{FORWARD_ONLY_MAX_FRAC:.0%}) — backward not elided?"))
    return out


# -- 2. delta serve weight traffic: B-independent, C-linear ------------------

def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1.0)


def check_delta_traffic(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    rows = _by_kind(facts, "serve_decode_delta")
    for cfg in _configs(rows):
        mine = [f for f in rows if f.meta.get("config") == cfg]
        # B-independence at every capacity
        caps = sorted({f.meta["capacity"] for f in mine})
        for C in caps:
            bs = sorted((f.meta["batch"], f) for f in mine
                        if f.meta["capacity"] == C)
            for (b0, f0), (b1, f1) in zip(bs, bs[1:]):
                if _rel(f0.weight_bytes, f1.weight_bytes) > B_INDEPENDENCE_RTOL:
                    out.append(Violation(
                        "delta-weight-traffic", f1.name,
                        f"weight bytes depend on batch: B={b0} reads "
                        f"{f0.weight_bytes:.3g}, B={b1} reads "
                        f"{f1.weight_bytes:.3g} (C={C})"))
        # C-linearity (equal increments, positive slope) at the first batch
        if len(caps) >= 3:
            b0 = min(f.meta["batch"] for f in mine)
            w = {f.meta["capacity"]: f.weight_bytes for f in mine
                 if f.meta["batch"] == b0}
            incs = [w[c1] - w[c0] for c0, c1 in zip(caps, caps[1:])]
            name = f"{cfg}/serve_decode_delta/B{b0}"
            if any(i <= 0 for i in incs):
                out.append(Violation(
                    "delta-weight-traffic", name,
                    f"weight bytes not increasing in capacity: {w}"))
            elif _rel(incs[0], incs[-1]) > C_LINEARITY_RTOL:
                out.append(Violation(
                    "delta-weight-traffic", name,
                    f"weight bytes not linear in capacity: increments "
                    f"{[f'{i:.3g}' for i in incs]}"))
    # contrast: the dense baseline MUST scale with B — if it stopped, the
    # provenance walk (and thus the B-independence above) proves nothing
    dense = _by_kind(facts, "serve_decode_dense")
    for cfg in _configs(dense):
        bs = sorted((f.meta["batch"], f) for f in dense
                    if f.meta.get("config") == cfg)
        for (b0, f0), (b1, f1) in zip(bs, bs[1:]):
            want = f0.weight_bytes * (b1 / b0)
            if _rel(f1.weight_bytes, want) > DENSE_SCALE_RTOL:
                out.append(Violation(
                    "delta-weight-traffic", f1.name,
                    f"dense baseline weight bytes should scale ~{b1}/{b0}x "
                    f"with batch, got {f0.weight_bytes:.3g} -> "
                    f"{f1.weight_bytes:.3g}"))
    return out


# -- 3. donation honored -----------------------------------------------------

def check_donation(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    for f in facts.values():
        if f.donated_declared == 0:
            continue
        if f.donation_applied < f.donated_declared:
            out.append(Violation(
                "donation-honored", f.name,
                f"{f.donated_declared} leaves declared donated but only "
                f"{f.donation_applied} written in place and handed back — "
                f"donated buffer is silently copied"))
    return out


# -- 4. dtype discipline -----------------------------------------------------

def check_dtypes(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    for f in facts.values():
        if "float64" in f.jaxpr_dtypes or f.hlo_dtypes.get("f64"):
            out.append(Violation(
                "dtype-discipline", f.name,
                f"f64 present (op dtypes {f.jaxpr_dtypes}, f64 tensor "
                f"count {f.hlo_dtypes.get('f64', 0)}) — nothing in the "
                f"repo computes in double"))
        if (f.meta.get("dtype") == "bfloat16"
                and str(f.meta.get("kind", "")).startswith("serve_decode")):
            n_f32 = sum(1 for d in f.out_dtypes if d == "float32")
            if "bfloat16" not in f.out_dtypes or n_f32 > 1:
                out.append(Violation(
                    "dtype-discipline", f.name,
                    f"bf16-configured decode leaks f32: {n_f32} float32 "
                    f"outputs (cache must stay bfloat16; only the logits "
                    f"may widen)"))
    return out


# -- 5. collective / transfer allowlist --------------------------------------

def check_isolation(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    for f in facts.values():
        allowed = set(f.meta.get("allowed_collectives", ()))
        if f.meta.get("single_host"):
            if f.collective_counts:
                out.append(Violation(
                    "collective-transfer-allowlist", f.name,
                    f"single-host program contains collectives: "
                    f"{f.collective_counts}"))
            if f.transfer_ops:
                out.append(Violation(
                    "collective-transfer-allowlist", f.name,
                    f"host transfer ops inside the program: "
                    f"{f.transfer_ops}"))
        else:
            extra = set(f.collective_counts) - allowed
            if extra:
                out.append(Violation(
                    "collective-transfer-allowlist", f.name,
                    f"collective kinds {sorted(extra)} not in the "
                    f"mesh-declared allowlist {sorted(allowed)}"))
            if f.transfer_ops:
                out.append(Violation(
                    "collective-transfer-allowlist", f.name,
                    f"host transfer ops inside the program: "
                    f"{f.transfer_ops}"))
    return out


CONTRACTS = {
    "cut-monotone": check_cut_monotone,
    "delta-weight-traffic": check_delta_traffic,
    "donation-honored": check_donation,
    "dtype-discipline": check_dtypes,
    "collective-transfer-allowlist": check_isolation,
}


def check_all(facts: Dict) -> List[Violation]:
    out: List[Violation] = []
    for fn in CONTRACTS.values():
        out.extend(fn(facts))
    return out
