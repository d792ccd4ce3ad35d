"""PaliGemma-3B — SigLIP vision encoder (stubbed) + gemma decoder [arXiv:2407.07726].

Per the assignment carve-out the SigLIP tower + projector are a stub:
``input_specs`` provides (B, n_prefix_tokens, d_model) patch embeddings; we
implement the gemma-2b language backbone that consumes them (prefix-LM).

Data-only copy of ``repro/configs/paligemma_3b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,         # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    n_prefix_tokens=256,  # 224px/14 patches -> 256 SigLIP tokens
    mlp_act="gelu",       # GeGLU
    tie_embeddings=True,
    source="arXiv:2407.07726",
)
