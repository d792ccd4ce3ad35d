"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

Data-only copy of ``repro/configs/smollm_360m.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,        # GQA
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
