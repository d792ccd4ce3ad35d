"""XLM-RoBERTa-Base — the paper's XGLUE-NC model (text classification).

Data-only copy of ``repro/configs/xlm_roberta_base.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlm-roberta-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=250002,
    task="classification",
    n_classes=10,          # XGLUE-NC: 10 news classes
    mlp_act="gelu_plain",
    rope_theta=0.0,        # learned absolute positions
    tie_embeddings=False,
    source="paper §5.1 (Conneau et al., 2019)",
)
