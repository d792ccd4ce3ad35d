"""TinyLlama-1.1B — llama2-arch small [arXiv:2401.02385].

Data-only copy of ``repro/configs/tinyllama_1_1b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,        # GQA
    d_ff=5632,
    vocab_size=32000,
    mlp_act="silu",
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2401.02385",
)
