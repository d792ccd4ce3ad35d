"""CodeQwen1.5-7B — qwen1.5 arch (attention QKV bias) [hf:Qwen/CodeQwen1.5-7B].

Data-only copy of ``repro/configs/codeqwen1_5_7b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,       # per the assignment (qwen1.5 MHA-style kv)
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,       # qwen1.5 signature
    mlp_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/CodeQwen1.5-7B",
)
