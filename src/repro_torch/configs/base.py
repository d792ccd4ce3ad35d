"""Configuration for the PyTorch port (counterpart of ``repro/configs/base.py``).

A data-only copy of the reference's :class:`ArchConfig`, :func:`reduced`,
:class:`ShapeConfig` with ``INPUT_SHAPES``, :class:`FLConfig`, :class:`RuntimeConfig`
and the architecture registry; ``get_arch`` loads
``repro_torch.configs.<id>``.  The port never imports ``repro``, so it keeps
its own copy.  ``RuntimeConfig.use_pallas`` is carried over with the rest of
the fields but the port never reads it: kernel choice follows the tensor's
device.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    """A transformer/SSM architecture, selectable via ``--arch <name>``."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int                    # decoder blocks (for enc-dec: decoder)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    source: str = ""                 # citation for the assignment

    # --- MLP ---
    mlp_act: str = "silu"            # silu => SwiGLU, gelu => GeGLU
    qkv_bias: bool = False           # qwen-style attention bias

    # --- MoE ---
    n_experts: int = 0               # routed experts (0 = dense MLP)
    n_shared_experts: int = 0        # deepseek shared experts
    top_k: int = 0
    first_dense: int = 0             # leading dense blocks (deepseek-v2: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance aux loss

    # --- MLA (deepseek multi-head latent attention) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0               # SSD heads; default d_inner // 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0              # hybrid: 1 shared attn block per k ssm blocks

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # fixed encoder frames (whisper: 1500)

    # --- VLM prefix (paligemma) ---
    n_prefix_tokens: int = 0         # stub patch embeddings

    # --- attention variant ---
    sliding_window: int = 0          # 0 = full causal; >0 = window size
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # task head: "lm" (causal next-token) or "classification" (pooled head).
    # The paper's own models (CLIP / XLM-R) are classification fine-tunes.
    task: str = "lm"
    n_classes: int = 0

    # numerics
    dtype: str = "bfloat16"          # compute / param dtype on target HW

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads if self.ssm_heads else max(1, self.d_inner // 64)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_encoder(self) -> bool:
        return self.n_enc_layers > 0

    def n_selectable_layers(self) -> int:
        """Length of the paper's masking vector m_i ∈ {0,1}^L for this arch.

        One entry per decoder block, plus encoder blocks (whisper), plus the
        shared attention block for hybrids (zamba2's shared block counts once:
        it is a single set of weights).
        """
        n = self.n_layers
        if self.has_encoder:
            n += self.n_enc_layers
        if self.family == "hybrid" and self.attn_every > 0:
            n += 1  # the shared attention block
        return n

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return replace(self, sliding_window=window)

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.family == "ssm", (
            f"{self.name}: n_heads={self.n_heads} not a multiple of kv={self.n_kv_heads}")
        if self.n_experts:
            assert self.top_k > 0, f"{self.name}: MoE needs top_k"
        if self.family == "hybrid":
            assert self.ssm_state > 0 and self.attn_every > 0
        if self.family == "vlm":
            assert self.n_prefix_tokens > 0
        if self.family == "audio":
            assert self.n_enc_layers > 0 and self.enc_seq > 0


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ArchConfig:
    """A smoke-test variant of the same family: ≤2 layers, d_model≤512, ≤4 experts."""
    d = min(d_model, cfg.d_model)
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = 1 if cfg.n_kv_heads == 1 else max(1, min(2, cfg.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    changes = dict(
        n_layers=n_layers,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=(64 if cfg.head_dim else None),
        dtype="float32",
    )
    if cfg.n_experts:
        changes.update(n_experts=min(cfg.n_experts, max_experts),
                       top_k=min(cfg.top_k, 2),
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       first_dense=min(cfg.first_dense, 1))
    if cfg.use_mla:
        changes.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
    if cfg.ssm_state:
        changes.update(ssm_state=min(cfg.ssm_state, 16), ssm_heads=4, ssm_chunk=32)
    if cfg.family == "hybrid":
        changes.update(attn_every=2, n_layers=max(3, n_layers + 1))
    if cfg.has_encoder:
        changes.update(n_enc_layers=2, enc_seq=16)
    if cfg.n_prefix_tokens:
        changes.update(n_prefix_tokens=8)
    if cfg.sliding_window:
        changes.update(sliding_window=16)
    if cfg.task == "classification":
        changes.update(n_classes=cfg.n_classes)
    return replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def lowers(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Federated learning setup (the paper)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLConfig:
    """Algorithm 1 + Problem (P1) hyper-parameters."""

    n_clients: int = 100            # N
    cohort_size: int = 20           # |S_t|
    rounds: int = 50                # T
    local_steps: int = 1            # tau
    lr: float = 0.01                # eta
    batch_size: int = 64

    # Layer selection
    strategy: str = "ours"          # ours | top | bottom | both | snr | rgn | full
    budget: int = 1                 # R (identical-resource scenario)
    budgets: Optional[Tuple[int, ...]] = None   # heterogeneous per-client R_i
    lam: float = 10.0               # lambda in (P1)
    selection_period: int = 1       # re-select every k rounds ("Sel. Period")
    selection_batches: int = 1      # batches used for the probe gradient ("Sel. Batch")
    seed: int = 0

    # Layer freezing (paper §B.2: embeddings and classifier frozen)
    freeze_embed: bool = True
    freeze_head: bool = True

    def budget_of(self, i: int) -> int:
        if self.budgets is not None:
            return self.budgets[i % len(self.budgets)]
        return self.budget


# ---------------------------------------------------------------------------
# Distributed runtime
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RuntimeConfig:
    """How a step is laid out on the mesh."""

    multi_pod: bool = False
    zero3: bool = True               # shard frozen base over the client axes
    remat: bool = True               # activation checkpointing per block
    use_pallas: bool = False         # use Pallas kernels (TPU) vs jnp reference
    seq_chunk: int = 1024            # query-chunk for lax attention (prefill)
    unified_selection: bool = True   # static union layer set per round (server-regulated)

    # ---- §Perf levers (default OFF = paper-faithful naive baseline) ----
    tp_constraints: bool = False     # Megatron-style sharding constraints on
                                     # the model axis inside the FL step
    remat_scores: bool = False       # checkpoint each attention query-chunk
                                     # (never materialise all chunks' scores)
    sel_upload: bool = False         # structural R/L upload: backward
                                     # collective over the selected sub-stack
                                     # only (requires static selected set)
    moe_local_dispatch: bool = False # per-sample MoE routing (vmap over
                                     # batch): sort/scatter stay local to the
                                     # data shard instead of a global sort


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ASSIGNED_ARCHS: tuple[str, ...] = (
    "tinyllama_1_1b",
    "grok_1_314b",
    "smollm_360m",
    "zamba2_7b",
    "codeqwen1_5_7b",
    "paligemma_3b",
    "deepseek_v2_lite_16b",
    "mamba2_370m",
    "gemma_7b",
    "whisper_medium",
)

PAPER_ARCHS: tuple[str, ...] = (
    "clip_vit_b32",       # paper: CLIP ViT on CIFAR-10 / DomainNet
    "xlm_roberta_base",   # paper: XGLUE-NC
    "llama2_7b",          # paper: QA datasets
)

_ALIASES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "grok-1-314b": "grok_1_314b",
    "smollm-360m": "smollm_360m",
    "zamba2-7b": "zamba2_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "paligemma-3b": "paligemma_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-370m": "mamba2_370m",
    "gemma-7b": "gemma_7b",
    "whisper-medium": "whisper_medium",
    "clip-vit-b32": "clip_vit_b32",
    "xlm-roberta-base": "xlm_roberta_base",
    "llama2-7b": "llama2_7b",
}


def get_arch(name: str) -> ArchConfig:
    """Load ``CONFIG`` from ``repro_torch.configs.<name>`` (accepts dashed ids)."""
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_arch_names(include_paper: bool = False) -> tuple[str, ...]:
    return ASSIGNED_ARCHS + (PAPER_ARCHS if include_paper else ())
