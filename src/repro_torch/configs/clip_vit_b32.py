"""CLIP ViT-B/32 vision backbone — the paper's CIFAR-10 / DomainNet model.

Image tower only, used as an encoder-classifier for the FL experiments (the
paper fine-tunes CLIP's transformer layers with a fixed classifier). The patch
embedding is a stub per the frontend carve-out: ``input_specs`` provides
(B, 50, 768) patch embeddings (49 patches + CLS at 224px/32).

Data-only copy of ``repro/configs/clip_vit_b32.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="clip-vit-b32",
    family="vlm",          # prefix-only encoder over stubbed patch embeds
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=10,         # classification head (CIFAR-10)
    n_prefix_tokens=50,
    task="classification",
    n_classes=10,
    mlp_act="gelu_plain",
    rope_theta=0.0,        # learned positions in ViT; stubbed into embeds
    tie_embeddings=False,
    source="paper §5.1 (Radford et al., 2021)",
)
