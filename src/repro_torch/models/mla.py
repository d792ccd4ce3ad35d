"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of
``repro/models/mla.py``, arXiv:2405.04434).

K and V are compressed into a low-rank latent ``c_kv`` (rank
``kv_lora_rank``) plus one RoPE key channel shared by the heads.  The
decode cache stores only ``(c_kv, k_rope)``: ``kv_lora + qk_rope_dim``
values per token instead of ``2·H·hd``.

The sequence forward (training, prefill) re-expands the latent through
``w_ukv`` and attends in plain PyTorch, in one piece or by query chunks of
``seq_chunk``, as the reference does: it calls no kernel there.  The port's
flash kernel takes one head dim for q, k and v, and MLA's are 192 (nope +
rope) and 128 (ROADMAP.md).  Decode folds ``w_ukv`` into the query and
the output (the absorbed matmuls, DeepSeek-V2 §2.1.2), so attention runs
against the latent cache directly, and writes the token's latent into the
cache **in place** (the reference returns a new cache).

``tp`` (``sharding.tensor_parallel.ModelAxis``) is the parallel form over
``model``: with its heads split (``tp.attn_split``) a rank computes its
``tp.n_heads`` heads of ``wq``, of the ``w_ukv`` expansion (or the
absorbed decode) and of ``wo``, a partial sum the caller reduces, and the
latent ``c_kv`` / ``k_rope`` whole from whole ``w_dkv`` / ``w_krope`` /
``kv_ln``; Megatron's f (``tp.copy``) wraps the normed input of ``wq``
and the latent where the rank's heads read it, so that the gradient of
the latent path, whole on every rank, is counted once.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (_mask_bias, _mask_bias_per_slot,
                                       apply_rope, rms_norm, rope_tables)


def mla_param_shapes(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "ln": (d,),
        "wq": (d, H * qk),
        "w_dkv": (d, cfg.kv_lora_rank),                    # down: x -> latent
        "kv_ln": (cfg.kv_lora_rank,),
        "w_krope": (d, cfg.qk_rope_dim),                   # shared rope key
        "w_ukv": (cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
        "wo": (H * cfg.v_head_dim, d),
    }


def _expand_kv(p: dict, ckv: torch.Tensor, cfg: ArchConfig, H: int):
    """(B,S,lora) → k_nope (B,S,H,nope), v (B,S,H,v_dim) of ``w_ukv``'s H
    heads."""
    B, S, _ = ckv.shape
    kv = (ckv @ p["w_ukv"]).reshape(B, S, H,
                                    cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def _attend(q_nope, q_rope, k_nope, k_rope, v, bias, scale):
    """q (B,Sq,H,·), k_nope/v (B,Sk,H,·), k_rope (B,Sk,1,rope), bias
    (Sq,Sk): f32 softmax, weights cast to v's type."""
    lg = (torch.einsum("bqhn,bshn->bhqs", q_nope, k_nope)
          + torch.einsum("bqhr,bsxr->bhqs", q_rope, k_rope)).float()
    w = torch.softmax(lg * scale + bias[None, None], dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshv->bqhv", w, v)


def mla_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
            positions: torch.Tensor, cache: Optional[dict] = None,
            cache_pos: Optional[torch.Tensor] = None, seq_chunk: int = 1024,
            window: int = 0, tp=None) -> torch.Tensor:
    """MLA sub-block forward (pre-norm, causal; the caller adds the
    residual).  Returns the block's output (with ``tp`` splitting the
    heads, this model coordinate's partial sum); a decode cache is
    updated in place.

    cache: {"ckv": (B,W,lora), "krope": (B,W,rope), "pos": (W,) int32} —
    the token's latent goes to ring index ``cache_pos % W``; with the
    per-slot serving cache (``pos`` (B, W), ``cache_pos`` (B,)) every batch
    row writes its own index."""
    B, S, _ = x.shape
    H = cfg.n_heads if tp is None else tp.n_heads
    f = tp.copy if tp is not None and tp.attn_split else (lambda t: t)
    nope, rope_d, v_dim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(nope + rope_d)

    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (f(h) @ p["wq"]).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_tables(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    ckv = f(rms_norm(h @ p["w_dkv"], p["kv_ln"], cfg.norm_eps))  # (B,S,lora)
    k_rope = f(apply_rope((h @ p["w_krope"]).reshape(B, S, 1, rope_d), cos,
                          sin))

    if cache is not None:
        return _absorbed_decode(p, q_nope, q_rope, ckv, k_rope, cfg,
                                positions, cache, cache_pos, window,
                                scale) @ p["wo"]

    k_nope, v = _expand_kv(p, ckv, cfg, H)
    if S > seq_chunk and S % seq_chunk == 0:
        outs = []
        for c in range(S // seq_chunk):
            sl = slice(c * seq_chunk, (c + 1) * seq_chunk)
            bias = _mask_bias(positions[sl], positions, causal=True,
                              window=window)
            outs.append(_attend(q_nope[:, sl], q_rope[:, sl], k_nope,
                                k_rope, v, bias, scale))
        out = torch.cat(outs, dim=1)
    else:
        bias = _mask_bias(positions, positions, causal=True, window=window)
        out = _attend(q_nope, q_rope, k_nope, k_rope, v, bias, scale)
    return out.reshape(B, S, H * v_dim) @ p["wo"]


def _absorbed_decode(p, q_nope, q_rope, ckv, k_rope, cfg, positions, cache,
                     cache_pos, window, scale) -> torch.Tensor:
    """Write the token's latent into the cache, then attend against the
    latent with ``w_ukv`` folded into q and the output: O(W·lora) per
    token instead of expanding (W, H, nope + v), over the H heads of
    ``q_nope`` and ``w_ukv``.  Returns (B,1,H·v)."""
    B, S, H = q_nope.shape[:3]
    lora = cfg.kv_lora_rank
    nope, v_dim = cfg.qk_nope_dim, cfg.v_head_dim
    cckv, ckr, cpos = cache["ckv"], cache["krope"], cache["pos"]
    W = cckv.shape[1]
    if cpos.dim() == 2:
        # per-slot serving cache: S == 1, cache_pos (B,), pos rows (B, W)
        slot = (cache_pos % W).long()
        bidx = torch.arange(B, device=q_nope.device)
        cckv.index_put_((bidx, slot), ckv[:, 0].to(cckv.dtype))
        ckr.index_put_((bidx, slot), k_rope[:, 0, 0].to(ckr.dtype))
        cpos.index_put_((bidx, slot), cache_pos.to(torch.int32))
        bias = _mask_bias_per_slot(positions, cpos, causal=True,
                                   window=window,
                                   k_valid=cpos <= cache_pos[:, None])
        bias = bias[:, None]
    else:
        slot = (cache_pos % W).long().reshape(1)
        cckv.index_copy_(1, slot, ckv.to(cckv.dtype))
        ckr.index_copy_(1, slot, k_rope[:, :, 0].to(ckr.dtype))
        cpos.index_copy_(0, slot, cache_pos.reshape(1).to(torch.int32))
        bias = _mask_bias(positions, cpos, causal=True, window=window,
                          k_valid=cpos <= cache_pos)[None, None]
    w_ukv = p["w_ukv"].reshape(lora, H, nope + v_dim)
    q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, w_ukv[..., :nope])
    lg = (torch.einsum("bqhl,bsl->bhqs", q_eff, cckv)
          + torch.einsum("bqhr,bsr->bhqs", q_rope, ckr)).float()
    wgt = torch.softmax(lg * scale + bias, dim=-1)
    ctx = torch.einsum("bhqs,bsl->bqhl", wgt.to(cckv.dtype), cckv)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_ukv[..., nope:])
    return out.reshape(B, S, H * v_dim)
