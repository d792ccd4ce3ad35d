"""PyTorch/CUDA port of the ``repro`` package (JAX on TPU), module by module.

Each module names the reference module it answers to.  The port imports
``torch`` and ``numpy`` only: never ``jax`` and nothing of ``repro``.  Entry
points run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller passes
    ``device="cpu"``.  Raises when CUDA is asked for and absent, so nothing
    quietly carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
