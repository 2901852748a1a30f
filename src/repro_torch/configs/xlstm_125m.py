"""xlstm-125m [arXiv:2405.04517] — sLSTM + mLSTM blocks, no FFN (d_ff=0).

12L d_model=768 4H (heads of 192) vocab=50304, alternating mLSTM / sLSTM
blocks: 6 super-blocks of (mLSTM, sLSTM). The mixers are plain PyTorch
around K1 / K2 (``models/xlstm.py``); decode is the recurrent form from
zero states.
"""
import dataclasses

import torch

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(("mlstm", "none"), ("slstm", "none")),
).validate()


def smoke_config(name: str = "") -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=4, vocab_size=128,
        param_dtype=torch.float32, compute_dtype=torch.float32).validate()
