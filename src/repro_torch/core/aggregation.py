"""Per-layer delta rows (counterpart of ``repro/core/aggregation.py``).

This slice ports only :func:`apply_delta_rows` (reference line 214), which
``DeltaStore.materialize`` needs; Eq.(5)–(7) aggregation comes with the
training slice.
"""
from __future__ import annotations

import torch


def apply_delta_rows(params: dict, rows: dict, deltas: dict,
                     scale: float = 1.0) -> dict:
    """Scatter additive per-layer delta rows into the full tree.

    ``rows`` maps a segment path to the (k,) local layer indices a user
    fine-tuned, ``deltas`` to the matching ``{leaf_name: (k, *shape)}`` rows
    (host numpy or tensors).  Returns a new tree; segments absent from
    ``rows`` pass through as the same tensors — exactly the frozen layers.
    """
    out = {}
    for key, sub in params.items():
        if key not in rows:
            out[key] = sub
            continue
        out[key] = {}
        for name, p in sub.items():
            idx = torch.as_tensor(rows[key], dtype=torch.long, device=p.device)
            d = torch.as_tensor(deltas[key][name], device=p.device)
            out[key][name] = p.index_add(0, idx, scale * d.to(p.dtype))
    return out
