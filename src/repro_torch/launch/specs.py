"""Meta-device input stand-ins for every (arch × input-shape) pair
(counterpart of ``repro/launch/specs.py``).

``torch.device("meta")`` tensors take the place of the reference's
``jax.ShapeDtypeStruct``: shape and dtype, no storage.  Training batches
use the FL layout (clients, per_client, seq) where ``clients`` = product
of the mesh's client axes (pod×data); serve shapes follow the assignment
table verbatim.  The mesh is read for its ``shape`` and ``axis_names``
only.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import Model

_META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def n_clients_on(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names
                     if a in ("pod", "data"))


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """FL training batch: (clients, per_client, seq)."""
    clients = n_clients_on(mesh)
    if shape.global_batch % clients:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {clients} clients")
    pcb = shape.global_batch // clients
    S = shape.seq_len
    if cfg.family == "vlm":
        text = S - cfg.n_prefix_tokens
        return {"tokens": meta((clients, pcb, text), torch.int32),
                "patches": meta((clients, pcb, cfg.n_prefix_tokens,
                                 cfg.d_model), torch.bfloat16)}
    if cfg.family == "audio":
        return {"tokens": meta((clients, pcb, S), torch.int32),
                "frames": meta((clients, pcb, cfg.enc_seq, cfg.d_model),
                               torch.bfloat16)}
    return {"tokens": meta((clients, pcb, S), torch.int32)}


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        return {"tokens": meta((B, S - cfg.n_prefix_tokens), torch.int32),
                "patches": meta((B, cfg.n_prefix_tokens, cfg.d_model),
                                torch.bfloat16)}
    if cfg.family == "audio":
        return {"tokens": meta((B, S), torch.int32),
                "frames": meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)}
    return {"tokens": meta((B, S), torch.int32)}


def decode_specs(model: Model, shape: ShapeConfig, *, window: int = 0):
    """(tokens, pos, cache) stand-ins for the serve step: the cache is
    ``Model.init_cache``'s layout, built on the meta device."""
    B = shape.global_batch
    on_meta = Model(model.cfg, model.runtime, device=_META,
                    kernel_mode=model.kernel_mode)
    cache = on_meta.init_cache(B, shape.seq_len, window=window)
    return meta((B,), torch.int32), meta((), torch.int32), cache


def fl_round_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   n_layers: int) -> tuple:
    """(batch, masks, sizes, lr) stand-ins for the FL train step."""
    clients = n_clients_on(mesh)
    batch = train_batch_specs(cfg, shape, mesh)
    masks = meta((clients, n_layers), torch.float32)
    sizes = meta((clients,), torch.float32)
    lr = meta((), torch.float32)
    return batch, masks, sizes, lr
