"""paligemma-3b [arXiv:2407.07726] — SigLIP + gemma backbone.

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216; gemma-style
GeGLU, head_dim=256. The SigLIP vision tower is a stub: the caller passes
256 precomputed patch embeddings (``embeds``), which are prepended to the
text sequence.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp="geglu",
    frontend="patch_stub",
    frontend_seq=256,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=128,
        frontend_seq=8, param_dtype=torch.float32,
        compute_dtype=torch.float32).validate()
