"""Grok-1 314B — 8 experts top-2 MoE [hf:xai-org/grok-1].

Data-only copy of ``repro/configs/grok_1_314b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,        # GQA
    head_dim=128,
    d_ff=32768,          # per-expert FFN width
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    mlp_act="gelu",
    tie_embeddings=True,
    logit_softcap=30.0,
    source="hf:xai-org/grok-1",
)
