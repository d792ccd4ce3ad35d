"""Mamba2-370M — SSD (state-space duality), attention-free [arXiv:2405.21060].

Data-only copy of ``repro/configs/mamba2_370m.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    d_ff=0,               # no MLP: mamba2 block is the whole layer
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_heads=32,         # d_inner(2048) / headdim(64)
    ssm_chunk=128,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
