"""Whisper-medium — encoder-decoder, conv/mel frontend stubbed [arXiv:2212.04356].

Per the assignment carve-out the mel-spectrogram + conv feature extractor are a
stub: ``input_specs`` provides (B, enc_seq, d_model) frame embeddings; we
implement the encoder/decoder transformer backbone with cross-attention.

Data-only copy of ``repro/configs/whisper_medium.py`` (the port imports no ``repro``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder blocks
    n_enc_layers=24,
    enc_seq=1500,         # 30s of audio at 50 frames/s
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_act="gelu_plain", # whisper uses plain GELU MLP (not gated)
    rope_theta=0.0,       # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
