"""Unified adapter API (counterpart of ``src/repro/peft/api.py``), for the
MetaTT and ``none`` kinds:

  trainable, frozen = init_adapter(spec, generator, device=...)
  broadcast, per_layer = adapter_factors(spec, trainable, frozen)
  dy = adapter_delta(spec, broadcast, per_layer_l, x, m, task=...)
  a, b, alpha = lora_form_factors(spec, broadcast, per_layer_l, m, task=...)
  n = count_trainable(spec, trainable)

``per_layer`` leaves have a leading L axis; callers pass the layer's slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import metatt as _metatt
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """kind: "metatt" | "none"; cfg: the per-kind config."""
    kind: str
    cfg: Any = None

    @property
    def matrix_types(self) -> tuple:
        return () if self.kind == "none" else self.cfg.matrix_types

    def adapts(self, m: str) -> bool:
        return self.kind != "none" and m in self.cfg.matrix_types


NONE = AdapterSpec(kind="none")


def _check_kind(spec: AdapterSpec) -> None:
    if spec.kind not in ("metatt", "none"):
        raise NotImplementedError(
            f"adapter kind {spec.kind!r} is not ported yet (metatt, none)")


def init_adapter(spec: AdapterSpec, generator: Optional[torch.Generator]
                 = None, *, device=None) -> tuple:
    """(trainable, frozen) parameter dicts; ``frozen`` is {} for MetaTT."""
    _check_kind(spec)
    if spec.kind == "none":
        return {}, {}
    return _metatt.init_params(spec.cfg, generator, device=device), {}


def adapter_factors(spec: AdapterSpec, trainable, frozen) -> tuple:
    """(broadcast, per_layer): the per-step merge of the middle cores."""
    _check_kind(spec)
    if spec.kind == "none":
        return {}, None
    f = _metatt.step_factors(trainable, spec.cfg)
    return {"g1": f.g1, "g4": f.g4}, {"c": f.c}


def adapter_delta(spec: AdapterSpec, broadcast, layer_slice, x: torch.Tensor,
                  m: str, *, task=None) -> Optional[torch.Tensor]:
    """α·x·ΔW_{l,m} for matrix type ``m`` (None when ``m`` is not
    adapted). ``layer_slice`` is per_layer at this layer."""
    if not spec.adapts(m):
        return None
    _check_kind(spec)
    f = _metatt.StepFactors(g1=broadcast["g1"], c=None, g4=broadcast["g4"])
    p = _metatt.project_in(f, spec.cfg, x, m)
    return _metatt.delta_out(f, spec.cfg, p, layer_slice["c"], m, task=task)


def lora_form_factors(spec: AdapterSpec, broadcast, layer_slice, m: str, *,
                      task=None):
    """Fold this layer's adapter for ``m`` into ``(A, B, alpha)`` with
    Δy = α·(x·A)·B — the operands of the fused kernels. MetaTT folds
    A = G1·C[l(,t),m]; a (B,) task vector gives A a leading slot axis
    (the batched-A kernel's operand). Factors stay in parameter dtype;
    callers cast to the activation dtype. None when ``m`` is not adapted.
    """
    if not spec.adapts(m):
        return None
    _check_kind(spec)
    cfg = spec.cfg
    mi = cfg.m_index(m)
    d_in, d_out = cfg.d_in[mi], cfg.d_out[mi]
    c_lm = _metatt._task_slice(layer_slice["c"], cfg, mi, task)
    g1 = broadcast["g1"][:d_in]
    if c_lm.ndim == 2:
        # A (d_in, r) as the transposed view of Aᵀ = Cᵀ·G1ᵀ (r, d_in):
        # K-contiguous, the layout K1 streams with 16-byte copies
        a = (c_lm.T @ g1.T).T
    else:
        a = torch.einsum("dr,...rs->...ds", g1, c_lm)
    return a, broadcast["g4"][:, :d_out], cfg.alpha


def count_trainable(spec: AdapterSpec, trainable) -> int:
    """Number of trainable adapter parameters (every tensor leaf)."""
    return int(sum(x.numel() for x in leaves(trainable)))
