"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].

MLA with kv_lora_rank=512; first block dense; 2 shared + 64 routed experts,
top-6, per-expert FFN width 1408.

Data-only copy of ``repro/configs/deepseek_v2_lite_16b.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,        # MLA: kv heads == heads after up-projection
    d_ff=1408,            # per routed expert
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    mlp_act="silu",
    tie_embeddings=False,
    source="arXiv:2405.04434",
)
