"""gemma-7b [arXiv:2403.08295].

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000, GeGLU,
head_dim=256 (q_dim 4096 != d_model — exercises MetaTT's boundary slicing).
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=128,
        param_dtype=torch.float32, compute_dtype=torch.float32).validate()
