"""kimi-k2-1t-a32b [arXiv:2501.kimi2; paper-table, unverified tier].

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840,
MoE 384 experts top-8 + 1 shared expert — ~1T total, ~32B active.
Capacity factor 1.25 (the JAX package's choice for top-8 of 384). Its
head_dim is 112: the card serves it through the d = 112 instances of K3,
K4, #8 and #8q and trains it through those of #5, #6 and #7 (the d = 128
kernels on tiles padded in shared memory).
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    block_pattern=(("attn", "moe"),),
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_capacity_factor=1.25,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=128, num_experts=8,
        experts_per_token=2, num_shared_experts=1, param_dtype=torch.float32,
        compute_dtype=torch.float32).validate()
