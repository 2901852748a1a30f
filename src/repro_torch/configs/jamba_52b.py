"""jamba-v0.1-52b [arXiv:2403.19887] — Mamba+attention 1:7, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=65536.
Super-block of 8 layers: 1 attention + 7 mamba, MoE every 2nd layer
(positions 1,3,5,7) — 4 super-blocks. The mamba mixers (d_inner 8192,
d_state 16, dt_rank 256, conv 4) are plain PyTorch around K1
(``models/mamba.py``); the attention layer runs the d = 128 instances of
K3 / #5, #6, #7 and K4 at G = 4. A super-block is 12.76 B parameters
(25.5 GB in bf16), so the card runs it at 1 of its 4 super-blocks.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

_PATTERN = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_PATTERN,
    num_experts=16,
    experts_per_token=2,
    mamba_d_state=16,
    mamba_expand=2,
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128, num_experts=4,
        experts_per_token=2, param_dtype=torch.float32,
        compute_dtype=torch.float32).validate()
