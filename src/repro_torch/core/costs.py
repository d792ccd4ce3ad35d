"""Computational & communication cost model (§4.3, Table 3; counterpart of
``repro/core/costs.py``).

    Cost_sel  = b(L−1) + bRτ = b(Rτ + L − 1)      (Eq. 16)
    Cost_full = bLτ                                (Eq. 17)
    comms_sel / comms_full = R / L                 (uniform layer sizes)

plus exact per-layer accounting (non-uniform layer sizes, selection period,
probe batch count) from per-layer parameter counts
(``core/masks.py::count_layer_params``).  Host numpy only, the reference's
float64 arithmetic line for line.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CostReport:
    compute_flops: float          # backward FLOPs per client per round
    select_flops: float           # the selection step's share
    transmit_bits: float          # upload per client per round
    ratio_compute: float          # vs full fine-tuning
    ratio_transmit: float


def backward_cost_uniform(L: int, R: int, tau: int, b: float = 1.0,
                          *, sel_period: int = 1, sel_batches: int = 1,
                          local_batches: int = 1,
                          bits_per_param: int = 32) -> CostReport:
    """Eq. (16)/(17) with the §4.3 extensions (Sel. Period / Sel. Batch).

    ``b`` = backward FLOPs per layer per batch.  The probe uses
    ``sel_batches`` batches every ``sel_period`` rounds; fine-tuning uses
    ``local_batches`` per step.  Layers are uniform with one abstract
    parameter each, so upload = R selected layers × ``bits_per_param``; the
    dimensionless R/L is ``ratio_transmit``.
    """
    select = b * (L - 1) * (sel_batches / local_batches) / sel_period
    finetune = b * R * tau
    full = b * L * tau
    return CostReport(
        compute_flops=select + finetune,
        select_flops=select,
        transmit_bits=(R / L) * bits_per_param * L,
        ratio_compute=(select + finetune) / full,
        ratio_transmit=R / L,
    )


def backward_cost_exact(layer_params: np.ndarray, mask: np.ndarray, tau: int,
                        *, bits_per_param: int = 32, tokens_per_batch: int = 1,
                        sel_period: int = 1, sel_batches: int = 1) -> CostReport:
    """Exact accounting from per-layer parameter counts.

    Backward FLOPs per layer ≈ 4·params·tokens (dL/dx and dL/dW matmuls);
    upload = selected parameter count × bits.
    """
    flops_l = 4.0 * layer_params.astype(np.float64) * tokens_per_batch
    R_params = float(np.sum(layer_params * mask))
    select = float(np.sum(flops_l[:-1])) * sel_batches / sel_period
    finetune = float(np.sum(flops_l * mask)) * tau
    full = float(np.sum(flops_l)) * tau
    return CostReport(
        compute_flops=select + finetune,
        select_flops=select,
        transmit_bits=R_params * bits_per_param,
        ratio_compute=(select + finetune) / full,
        ratio_transmit=R_params / float(np.sum(layer_params)),
    )
