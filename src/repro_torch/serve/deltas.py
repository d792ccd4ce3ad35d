"""Per-user sparse selected-layer deltas: records, export and the store
(counterpart of ``repro/serve/deltas.py``; host numpy code).

A :class:`DeltaRecord` holds a user's ``{(layer_idx, Δ_layer)}`` rows keyed
by the global mask index order of :func:`layer_layout`; a
:class:`DeltaStore` maps user ids to records and materialises a user's
private full-parameter copy (the dense serving baseline and the serving
parity oracle) via :func:`apply_delta_rows`.  Parameters may be torch
tensors on any device or numpy arrays; delta rows are always host f32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregation import apply_delta_rows
from repro_torch.models.model import layer_layout


def _rows_f32(a, idx) -> np.ndarray:
    """Rows ``idx`` of a leaf as host float32 numpy (only those rows cross
    to the host when the leaf is a tensor on the card)."""
    if isinstance(a, torch.Tensor):
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=a.device)
        return a.index_select(0, i).float().cpu().numpy()
    return np.asarray(a, np.float32)[idx]


def mask_index_map(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Global mask index → (segment path, local row), in mask-index order."""
    out = []
    for seg in layer_layout(cfg):
        out.extend((seg.path, r) for r in range(seg.count))
    return out


@dataclass
class DeltaRecord:
    """One user's sparse selected-layer delta.

    ``layers``: (k,) sorted global mask indices; ``segments``: per segment
    path, the (k_path,) local row indices plus ``{leaf_name: (k_path, …)}``
    delta rows (host numpy, f32).
    """
    layers: np.ndarray
    segments: dict[str, tuple[np.ndarray, dict[str, np.ndarray]]] = \
        field(default_factory=dict)

    @property
    def n_layers(self) -> int:
        return int(self.layers.size)

    @property
    def nbytes(self) -> int:
        return sum(leaf.nbytes for _, leaves in self.segments.values()
                   for leaf in leaves.values())

    def rows(self) -> dict[str, np.ndarray]:
        return {path: rows for path, (rows, _) in self.segments.items()}

    def leaves(self) -> dict[str, dict[str, np.ndarray]]:
        return {path: leaves for path, (_, leaves) in self.segments.items()}


def delta_from_params(base, tuned, cfg: ArchConfig,
                      layers: Optional[Iterable[int]] = None,
                      atol: float = 0.0) -> DeltaRecord:
    """Diff ``tuned`` against ``base`` into a sparse :class:`DeltaRecord`.

    ``layers``: global mask indices to export; ``None`` auto-detects the
    rows where any leaf moved by more than ``atol``.
    """
    idx_map = mask_index_map(cfg)
    if layers is None:
        layers = []
        for gi, (path, row) in enumerate(idx_map):
            moved = any(
                np.max(np.abs(_rows_f32(tuned[path][name], [row])
                              - _rows_f32(base[path][name], [row])),
                       initial=0.0) > atol
                for name in base[path])
            if moved:
                layers.append(gi)
    layers = np.asarray(sorted(int(l) for l in layers), np.int32)

    segments: dict[str, list[int]] = {}
    for gi in layers:
        path, row = idx_map[gi]
        segments.setdefault(path, []).append(row)
    out = {}
    for path, rows in segments.items():
        idx = np.asarray(rows, np.int32)
        leaves = {name: _rows_f32(tuned[path][name], idx)
                  - _rows_f32(base[path][name], idx)
                  for name in base[path]}
        out[path] = (idx, leaves)
    return DeltaRecord(layers=layers, segments=out)


class DeltaStore:
    """user id → :class:`DeltaRecord`; the FL-output side of serving."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self._records: dict[int, DeltaRecord] = {}

    def put(self, user_id: int, record: DeltaRecord) -> None:
        self._records[int(user_id)] = record

    def put_from_params(self, user_id: int, base, tuned,
                        layers: Optional[Iterable[int]] = None,
                        atol: float = 0.0) -> DeltaRecord:
        rec = delta_from_params(base, tuned, self.cfg, layers=layers,
                                atol=atol)
        self.put(user_id, rec)
        return rec

    def get(self, user_id: int) -> Optional[DeltaRecord]:
        return self._records.get(user_id)

    def users(self) -> list[int]:
        return sorted(self._records)

    def __contains__(self, user_id: int) -> bool:
        return int(user_id) in self._records

    def __len__(self) -> int:
        return len(self._records)

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self._records.values())

    def materialize(self, params, user_id: int):
        """The user's private full-parameter copy (base + their delta rows):
        what dense per-user serving builds per request, and the oracle the
        batched delta path is tested against."""
        rec = self._records.get(user_id)
        if rec is None:
            return params
        return apply_delta_rows(params, rec.rows(), rec.leaves())
