"""LLaMA-2-7B — the paper's QA-datasets model.

Data-only copy of ``repro/configs/llama2_7b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    mlp_act="silu",
    tie_embeddings=False,
    source="paper §5.1 (Touvron et al., 2023)",
)
