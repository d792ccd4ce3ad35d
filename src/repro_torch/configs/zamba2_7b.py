"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 total selectable SSM blocks with one *shared* attention block applied every
``attn_every`` SSM blocks (zamba2's parameter-shared transformer block).

Data-only copy of ``repro/configs/zamba2_7b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,          # mamba2 blocks
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,        # the shared attention block is MHA
    d_ff=14336,           # FFN of the shared block
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,         # shared attn applied after every 6th mamba block
    sliding_window=4096,  # long_500k: windowed KV for the shared block
    mlp_act="gelu",
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
