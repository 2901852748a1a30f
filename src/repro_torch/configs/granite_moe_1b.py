"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155,
MoE 32 experts top-8, swiglu. The routers are f32, the expert banks
(24, 32, 1024, 512) / (24, 32, 512, 1024) in the parameter dtype.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=(("attn", "moe"),),
    num_experts=32,
    experts_per_token=8,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=128, num_experts=4,
        experts_per_token=2, param_dtype=torch.float32,
        compute_dtype=torch.float32).validate()
