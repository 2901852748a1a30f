"""Architecture registry. ``get_config("<arch-id>")`` returns the full
config, ``get_smoke_config`` the reduced same-family config the CPU tests
use. The port carries the architectures of its slices so far: stablelm-1.6b,
gemma-7b (heads of 256), the paper's own RoBERTa targets (one module,
two ids), granite-34b (MQA, a GQA group of 48), mistral-large-123b
(a group of 12), the MoE models granite-moe-1b-a400m and kimi-k2, the
hybrid mamba / attention jamba-v0.1-52b, xlstm-125m (mLSTM / sLSTM), the
encoder-decoder whisper-large-v3 and paligemma-3b (a prefix of patch
embeddings before the text)."""
from __future__ import annotations

import importlib

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "gemma-7b": "gemma_7b",
    "roberta-base": "roberta",
    "roberta-large": "roberta",
    "granite-34b": "granite_34b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "jamba-v0.1-52b": "jamba_52b",
    "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3",
    "paligemma-3b": "paligemma_3b",
}

ALL_IDS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    mod = _mod(name)
    if name == "roberta-large":
        return mod.CONFIG_LARGE
    if name == "roberta-base":
        return mod.CONFIG_BASE
    return mod.CONFIG


def get_smoke_config(name: str):
    return _mod(name).smoke_config(name)
