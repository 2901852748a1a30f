"""Model-level API (counterpart of ``src/repro/models/model.py``):
adapter-spec construction and init."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.core.metatt import MetaTTConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.peft import api as peft_api


def matrix_dims(cfg: ModelConfig) -> dict:
    """matrix type -> (d_in, d_out) for every adaptable linear map of the
    attention + dense-FFN decoders the port runs."""
    transformer.check_supported(cfg)
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    out = {"attn_q": (d, q), "attn_k": (d, kv), "attn_v": (d, kv),
           "attn_o": (q, d)}
    if ff:
        out.update({"ffn_gate": (d, ff), "ffn_up": (d, ff),
                    "ffn_down": (ff, d)})
    return out


def default_matrices(cfg: ModelConfig, variant: str = "4d") -> tuple:
    """Paper default: attention q/v (App. A.2)."""
    transformer.check_supported(cfg)
    return ("attn_q", "attn_v")


def build_adapter_spec(run: RunConfig) -> peft_api.AdapterSpec:
    cfg = run.model
    if run.adapter_kind == "none":
        return peft_api.NONE
    if run.adapter_kind != "metatt":
        raise NotImplementedError(
            f"adapter kind {run.adapter_kind!r} is not ported yet")
    if run.adapter_variant not in ("4d", "4+1d"):
        raise NotImplementedError(
            f"MetaTT variant {run.adapter_variant!r} is not ported yet")
    types = run.adapter_matrices or default_matrices(cfg,
                                                     run.adapter_variant)
    dims = matrix_dims(cfg)
    unknown = [t for t in types if t not in dims]
    if unknown:
        raise ValueError(f"{cfg.name}: matrix types {unknown} not present")
    extra = ({"num_tasks": max(run.num_tasks, 1)}
             if run.adapter_variant == "4+1d" else {})
    acfg = MetaTTConfig(
        num_layers=cfg.total_layers, matrix_types=tuple(types),
        d_in=tuple(dims[t][0] for t in types),
        d_out=tuple(dims[t][1] for t in types), rank=run.adapter_rank,
        variant=run.adapter_variant, alpha=run.adapter_alpha, **extra)
    return peft_api.AdapterSpec(kind="metatt", cfg=acfg)


def init_params(cfg: ModelConfig, spec: peft_api.AdapterSpec,
                generator: Optional[torch.Generator] = None, *,
                device=None) -> dict:
    """{"base", "adapter", "frozen"}, drawn from ``generator`` on
    ``device`` (None: the CUDA device, raising without one)."""
    dev = resolve_device(device)
    base = transformer.init_base_params(cfg, generator, device=dev)
    adapter, frozen = peft_api.init_adapter(spec, generator, device=dev)
    return {"base": base, "adapter": adapter, "frozen": frozen}


def tensors(tree) -> list:
    """Every tensor leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
