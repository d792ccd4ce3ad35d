"""Roofline terms of a step on H100s (counterpart of the roofline
arithmetic of ``repro/sharding/hlo_analysis.py``: ``roofline_terms`` and
``dominant_term``, lines 78–89).

The reference reads its FLOPs, HBM bytes and collective bytes from XLA's
compiled HLO and prices them at a TPU v5e's rates; the port's counts come
from one eager run (``analysis/facts.py``) and are priced at the card it
runs on, an NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit.  The rates are
NVIDIA's data-sheet figures, not measurements: 989 TFLOP/s of dense bf16
(67 TFLOP/s of f32 on the CUDA cores), 3.35 TB/s of HBM3 and 450 GB/s per
direction of NVLink 4 (18 links of 25 GB/s).  The collective term is a
floor: a 16 × 16 or 2 × 16 × 16 mesh spans many nodes of eight cards, and
the links between nodes (InfiniBand, 50 GB/s a card at 400 Gb/s) are
slower than NVLink.  HLO parsing (``collective_stats``) is not ported:
eager PyTorch has no HLO, and the facts count the c10d ops instead.
"""
from __future__ import annotations

PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
PEAK_FLOPS = PEAK_OPS_PER_S["bfloat16"]   # dense bf16 per card
HBM_BYTES_PER_S = 3.35e12                  # HBM3 per card
NVLINK_BYTES_PER_S = 450e9                 # NVLink 4, per direction


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int) -> dict:
    """The three per-step roofline terms, in seconds, of whole-step totals
    spread over ``n_chips`` cards."""
    return {
        "compute_s": flops / (n_chips * PEAK_FLOPS),
        "memory_s": hbm_bytes / (n_chips * HBM_BYTES_PER_S),
        "collective_s": coll_bytes / (n_chips * NVLINK_BYTES_PER_S),
    }


def dominant_term(terms: dict) -> str:
    """``"compute"``, ``"memory"`` or ``"collective"``: the largest term."""
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k]).replace("_s", "")
