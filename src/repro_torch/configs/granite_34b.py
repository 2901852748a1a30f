"""granite-34b [arXiv:2405.04324] — llama-arch code model, MQA.

88L d_model=6144 48H (GQA kv=1, MQA: a group of 48) d_ff=24576
vocab=49152, gelu MLP. The v projection is 6144 -> 128 against q's
6144 -> 6144, so the v adapter's output is the narrow slice of MetaTT's
boundary core.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=128,
        param_dtype=torch.float32, compute_dtype=torch.float32).validate()
