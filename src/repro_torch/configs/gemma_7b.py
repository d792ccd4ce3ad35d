"""Gemma-7B — GeGLU, head_dim=256 (≠ d_model/H) [arXiv:2403.08295].

Data-only copy of ``repro/configs/gemma_7b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,         # qkv width 4096 != d_model
    d_ff=24576,
    vocab_size=256000,
    mlp_act="gelu",       # GeGLU
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
