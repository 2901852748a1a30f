"""whisper-large-v3 [arXiv:2212.04356] — encoder-decoder, audio.

32L encoder + 32L decoder, d_model=1280 20H (kv=20, heads of 64)
d_ff=5120 vocab=51866, layernorm + gelu. The conv audio frontend is a
stub: the encoder takes 1536 precomputed frame embeddings (1500 mel
frames padded with zeros to 1536), ``enc_embeds`` (B, 1536, d). The
adapter's L axis spans encoder and decoder (64 layers); its M axis
holds the cross-attention q / v beside the self-attention's.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    norm_kind="layernorm",
    encoder_layers=32,
    encoder_seq=1536,
    frontend="audio_stub",
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
        encoder_layers=2, encoder_seq=16, param_dtype=torch.float32,
        compute_dtype=torch.float32).validate()
