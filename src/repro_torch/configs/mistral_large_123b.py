"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8: a group of 12) d_ff=28672 vocab=32768,
swiglu. The v projection is 12288 -> 1024 against q's 12288 -> 12288.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=4, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=128,
        param_dtype=torch.float32, compute_dtype=torch.float32).validate()
