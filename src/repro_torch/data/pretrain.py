"""Foundation-model surrogate: short AdamW pretraining on the balanced task
(counterpart of ``repro/data/pretrain.py``).

The paper fine-tunes *pretrained* models.  Offline there are no such
checkpoints, so a run first pretrains the model on the task's balanced
global distribution (``pretrain_batch``: no client skew) with AdamW, which
gives layers of different fine-tuning importance, then runs Algorithm 1 on
the non-IID clients with SGD.  Every param is differentiated (embeddings,
norms and head too), on the model's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.client import host_to_device
from repro_torch.models.model import Model
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map


def pretrain(model: Model, params: dict, data, steps: int = 150,
             lr: float = 3e-3, batch_size: int = 64,
             verbose: bool = False) -> dict:
    """``steps`` AdamW steps on ``data.pretrain_batch(batch_size)``."""
    opt = adamw(lr)
    state = opt.init(params)
    for it in range(steps):
        batch = {k: host_to_device(v, model.device)
                 for k, v in data.pretrain_batch(batch_size).items()}
        wrt = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = model.loss(wrt, batch)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(wrt)))
        grads = tree_map(lambda _: next(leaves), wrt)
        del wrt
        updates, state = opt.update(grads, state, params)
        del grads
        params = apply_updates(params, updates)
        if verbose and (it + 1) % 50 == 0:
            print(f"  pretrain step {it+1}: loss {loss.item():.4f}")
    return params
