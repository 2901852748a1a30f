"""The paper's own fine-tuning targets: RoBERTa-base / RoBERTa-large
(Liu et al. 2019), field for field the JAX package's
``src/repro/configs/roberta.py`` with torch dtypes.

As in the JAX package, the reproduction runs a causal LM of RoBERTa's
dimensions (the zoo is decoder-shaped): 12 layers x 768 (base) and
24 x 1024 (large), MHA heads of 64, a gelu MLP of 3072 / 4096, layernorm,
vocab 50265, f32 weights and compute. Adapter parameter counts depend only
on (D, L, M, H, r) and equal the paper's Table 1 column.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG_BASE = ModelConfig(
    name="roberta-base",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50265,
    mlp="gelu",
    norm_kind="layernorm",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
).validate()

CONFIG_LARGE = ModelConfig(
    name="roberta-large",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50265,
    mlp="gelu",
    norm_kind="layernorm",
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
).validate()

CONFIG = CONFIG_BASE


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG_BASE, name="roberta-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128).validate()
