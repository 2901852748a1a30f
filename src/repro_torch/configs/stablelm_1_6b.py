"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352, swiglu,
tied readout, bf16.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
        param_dtype=torch.float32, compute_dtype=torch.float32).validate()
