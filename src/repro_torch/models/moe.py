"""Mixture-of-Experts layer with sort-based token dispatch (counterpart of
``repro/models/moe.py``).

* :func:`moe_fwd` — top-k routing, then a *sort-based* dispatch of the
  routed (token, expert) pairs into ``(E, C)`` capacity slots (a stable
  argsort by expert, the rank inside each expert's group by
  ``searchsorted``, pairs past the capacity ``C`` into a drop bin at
  ``E·C`` that is trimmed off); every expert runs on its C slots as one
  batched product (:func:`_expert_ffn`).
* :func:`moe_fwd_dense` — every expert on every token, gate-combined: the
  plain version the dispatch is held against when nothing is dropped.

Two choices keep the port's results repeatable on the card, where the
reference's primitives promise an order PyTorch's do not:

* **Top-k ties.**  ``lax.top_k`` puts the lower expert index first among
  equal probabilities; ``torch.topk`` promises no order.  :func:`_route`
  takes the first k of a stable descending sort, and the gathered values
  carry the gradient to the router's probabilities.
* **The combine.**  The reference scatter-adds the slots' outputs into
  their tokens in slot order (ascending expert id) in the output type;
  ``index_add_`` on CUDA adds atomically, in an order that changes from
  run to run.  :func:`_dispatch_2d` gathers each token's ≤ k weighted slot
  outputs and adds them in ascending expert order instead.  The gathers'
  backward writes each slot once (the drop bin is a constant zero row), and
  the tokens' gradient through ``h2d[token_of]`` goes through PyTorch's
  sorted index backward, so a step's gradients repeat bit for bit too.

The load-balance auxiliary loss is Switch-Transformer's E · Σ_e f_e · p_e.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import act_fn, rms_norm


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor       # scalar load-balance loss
    dropped_frac: torch.Tensor   # fraction of routed pairs dropped by capacity


def moe_param_shapes(cfg: ArchConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gated = cfg.mlp_act != "gelu_plain"
    wi_cols = 2 * ff if gated else ff
    shapes = {
        "ln": (d,),
        "router": (d, E),
        "wi_e": (E, d, wi_cols),
        "wo_e": (E, ff, d),
    }
    if cfg.n_shared_experts:
        shapes.update({
            "wi_s": (d, wi_cols * cfg.n_shared_experts),
            "wo_s": (ff * cfg.n_shared_experts, d),
        })
    return shapes


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens:
    max(⌈T·k/E·cf⌉, k), host arithmetic on static counts."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


def _gated(h: torch.Tensor, ff: int, act_name: str) -> torch.Tensor:
    """The FFN's hidden activation: ``act(gate)·up`` over the [gate|up]
    halves, or ``act(h)`` for the non-gated ``gelu_plain``."""
    act = act_fn(act_name)
    if act_name == "gelu_plain":
        return act(h)
    return act(h[..., :ff]) * h[..., ff:]


def _expert_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                act_name: str) -> torch.Tensor:
    """x: (E, C, d), wi: (E, d, {1,2}·ff), wo: (E, ff, d) → (E, C, d): one
    batched product per projection over all experts."""
    return torch.bmm(_gated(torch.bmm(x, wi), wo.shape[1], act_name), wo)


def _route(h2d: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """(top_w (T,k) in h2d's type, top_idx (T,k), aux_loss).  The top k of
    a stable descending sort: among equal probabilities the lower expert
    index comes first, as ``lax.top_k`` orders them."""
    k, E = cfg.top_k, cfg.n_experts
    logits = (h2d @ router).float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    # Switch load-balance loss: E · Σ_e f_e · p_e (f has no gradient)
    f = torch.nn.functional.one_hot(top_idx, E).float().sum(1).mean(0)
    p = probs.mean(0)
    aux = E * (f * p).sum() * cfg.router_aux_weight
    return top_w.to(h2d.dtype), top_idx, aux


def _shared_experts(p: dict, h2d: torch.Tensor, cfg: ArchConfig):
    """The always-on shared experts (deepseek-v2) as one wide FFN."""
    return _gated(h2d @ p["wi_s"], p["wo_s"].shape[0], cfg.mlp_act) \
        @ p["wo_s"]


def moe_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig,
            local_dispatch: bool = False):
    """Sort-based MoE block. x: (B, S, d) → ((B, S, d), MoEStats).

    ``local_dispatch``: route each sample on its own (the reference's vmap
    over B), with a per-sample capacity ⌈S·k/E·cf⌉; the aux loss and the
    dropped fraction are the means over the samples.  Otherwise the
    capacity is shared by all B·S tokens of the batch."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if local_dispatch:
        C = capacity(S, cfg)
        outs, auxs, drops = zip(*(_dispatch_2d(p, h[b], cfg, C)
                                  for b in range(B)))
        out2d = torch.stack(outs)
        aux, dropped = torch.stack(auxs).mean(), torch.stack(drops).mean()
    else:
        out2d, aux, dropped = _dispatch_2d(p, h.reshape(B * S, d), cfg,
                                           capacity(B * S, cfg))
        out2d = out2d.reshape(B, S, d)
    if cfg.n_shared_experts:
        out2d = out2d + _shared_experts(p, h.reshape(B * S, d),
                                        cfg).reshape(B, S, d)
    return out2d, MoEStats(aux, dropped)


def _dispatch_2d(p: dict, h2d: torch.Tensor, cfg: ArchConfig, C: int):
    """Core sort-based dispatch over flat tokens. h2d: (T, d) →
    ((T, d), aux, dropped_frac)."""
    T, d = h2d.shape
    k, E = cfg.top_k, cfg.n_experts
    dev = h2d.device
    top_w, top_idx, aux = _route(h2d, p["router"], cfg)

    # --- sort-based dispatch: group the T·k pairs by expert --------------
    n = T * k
    flat_e = top_idx.reshape(n)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    # rank within the expert's group: position − first index of its value
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)       # E·C = drop bin

    # slot → token table (the drop bin's duplicate writes trimmed off)
    token_of = torch.zeros(E * C + 1, dtype=torch.long, device=dev) \
        .index_put_((slot,), st)[:-1]
    valid = torch.zeros(E * C + 1, dtype=torch.bool, device=dev) \
        .index_put_((slot,), keep)[:-1]
    expert_in = torch.where(valid[:, None], h2d[token_of],
                            torch.zeros((), dtype=h2d.dtype, device=dev))
    expert_out = _expert_ffn(expert_in.reshape(E, C, d), p["wi_e"],
                             p["wo_e"], cfg.mlp_act)

    # --- ordered combine: each token's slots in ascending expert order ----
    slot_of = torch.empty_like(slot).index_put_((order,), slot)  # (t, j)
    by_expert = torch.argsort(top_idx, dim=1)      # a token's experts differ
    tok_slot = slot_of.reshape(T, k).gather(1, by_expert)
    tok_w = top_w.gather(1, by_expert) * (tok_slot < E * C)
    rows = torch.cat([expert_out.reshape(E * C, d),
                      torch.zeros((1, d), dtype=expert_out.dtype,
                                  device=dev)])[tok_slot]       # (T, k, d)
    weighted = rows * tok_w[..., None]
    out2d = weighted[:, 0]
    for j in range(1, k):
        out2d = out2d + weighted[:, j]
    dropped = 1.0 - keep.float().sum() / n
    return out2d, aux, dropped


def moe_fwd_dense(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Plain version: every expert on every token, gate-combined (no
    capacity, nothing dropped)."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h2d = h.reshape(T, d)
    top_w, top_idx, aux = _route(h2d, p["router"], cfg)
    all_out = _expert_ffn(h2d.expand(E, T, d), p["wi_e"], p["wo_e"],
                          cfg.mlp_act)                          # (E, T, d)
    gates = torch.zeros((T, E), dtype=x.dtype, device=x.device) \
        .scatter(1, top_idx, top_w)
    out2d = torch.einsum("te,etd->td", gates, all_out)
    if cfg.n_shared_experts:
        out2d = out2d + _shared_experts(p, h2d, cfg)
    return out2d.reshape(B, S, d), MoEStats(
        aux, torch.zeros((), dtype=torch.float32, device=x.device))
