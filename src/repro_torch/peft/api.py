"""Unified adapter API (counterpart of ``src/repro/peft/api.py``): MetaTT
(the paper) and the baselines it compares against, LoRA, VeRA and LoTR.

  trainable, frozen = init_adapter(spec, generator, device=...)
  broadcast, per_layer = adapter_factors(spec, trainable, frozen)
  dy = adapter_delta(spec, broadcast, per_layer_l, x, m, task=...)
  a, b, alpha = lora_form_factors(spec, broadcast, per_layer_l, m, task=...)
  n = count_trainable(spec, trainable)

``per_layer`` leaves have a leading L axis; callers pass the layer's slice.
``frozen`` holds non-trainable method state (VeRA's shared random pair).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import merge as _merge
from repro_torch.core import metatt as _metatt
from repro_torch.peft import lora as _lora
from repro_torch.peft import lotr as _lotr
from repro_torch.peft import vera as _vera
from repro_torch.tree import leaves

KINDS = ("metatt", "lora", "vera", "lotr", "none")


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """kind: "metatt" | "lora" | "vera" | "lotr" | "none"; cfg: the
    per-kind config (dims, rank, alpha, matrix_types)."""
    kind: str
    cfg: Any = None

    @property
    def matrix_types(self) -> tuple:
        return () if self.kind == "none" else self.cfg.matrix_types

    def adapts(self, m: str) -> bool:
        return self.kind != "none" and m in self.cfg.matrix_types


NONE = AdapterSpec(kind="none")


def _check_kind(spec: AdapterSpec) -> None:
    if spec.kind not in KINDS:
        raise ValueError(f"unknown adapter kind {spec.kind!r}")


def init_adapter(spec: AdapterSpec, generator: Optional[torch.Generator]
                 = None, *, device=None) -> tuple:
    """(trainable, frozen) parameter dicts."""
    _check_kind(spec)
    if spec.kind == "none":
        return {}, {}
    if spec.kind == "metatt":
        return _metatt.init_params(spec.cfg, generator, device=device), {}
    if spec.kind == "lora":
        return _lora.init_params(spec.cfg, generator, device=device), {}
    if spec.kind == "vera":
        return _vera.init_params(spec.cfg, generator, device=device)
    return _lotr.init_params(spec.cfg, generator, device=device), {}


def adapter_factors(spec: AdapterSpec, trainable, frozen) -> tuple:
    """(broadcast, per_layer): the per-step precompute; per_layer leaves
    have a leading L axis."""
    _check_kind(spec)
    if spec.kind == "none":
        return {}, None
    if spec.kind == "metatt":
        f = _metatt.step_factors(trainable, spec.cfg)
        return {"g1": f.g1, "g4": f.g4}, {"c": f.c}
    if spec.kind == "lora":
        return {}, trainable          # a (L, M, Din, r), b (L, M, r, Dout)
    if spec.kind == "vera":
        return frozen, trainable      # frozen {"a", "b"}, trainable {"d", "g"}
    return {"u": trainable["u"], "v": trainable["v"]}, {"s": trainable["s"]}


def adapter_delta(spec: AdapterSpec, broadcast, layer_slice, x: torch.Tensor,
                  m: str, *, task=None) -> Optional[torch.Tensor]:
    """The low-rank update α·x·ΔW_{l,m} for matrix type ``m`` (None when
    ``m`` is not adapted). ``layer_slice`` is per_layer at this layer."""
    if not spec.adapts(m):
        return None
    _check_kind(spec)
    cfg = spec.cfg
    mi = cfg.m_index(m)
    if spec.kind == "metatt":
        # {"c"}: the live per-step factors; {"a"}: the lora runtime's
        # pre-folded A = α·G1·C (core/merge.py::to_lora_form)
        if "a" in layer_slice:
            return _merge.lora_form_delta(layer_slice["a"], broadcast["g4"],
                                          cfg, x, m, task=task)
        f = _metatt.StepFactors(g1=broadcast["g1"], c=None,
                                g4=broadcast["g4"])
        p = _metatt.project_in(f, cfg, x, m)
        return _metatt.delta_out(f, cfg, p, layer_slice["c"], m, task=task)
    if spec.kind == "lora":
        return _lora.delta(cfg, layer_slice, x, mi)
    if spec.kind == "vera":
        return _vera.delta(cfg, broadcast, layer_slice, x, mi)
    return _lotr.delta(cfg, broadcast, layer_slice, x, mi)


def _k_contiguous(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """lhs·rhs (d_in, r) as the transposed view of (rhs ᵀ·lhsᵀ), (r, d_in)
    contiguous: A K-contiguous, the layout K1 streams with 16-byte copies
    (and whose transpose, dx's B operand, is row-major)."""
    return (rhs.T @ lhs.T).T


def lora_form_factors(spec: AdapterSpec, broadcast, layer_slice, m: str, *,
                      task=None):
    """Fold this layer's adapter for ``m`` into ``(A, B, alpha)`` with
    Δy = α·(x·A)·B — the operands of the fused kernels. MetaTT folds
    A = G1·C[l(,t),m] (a (B,) task vector gives A a leading slot axis, the
    batched-A kernel's operand; the lora runtime's pre-folded {"a"} has α
    inside); LoRA is already (A, B) at α/r; VeRA folds A·diag(d) and
    B·diag(g); LoTR folds U·S and takes Vᵀ. The folds are differentiable:
    VeRA's d, g and LoTR's S get their gradients through K1's dA, dB.
    Factors stay in parameter dtype; callers cast to the activation
    dtype. None when ``m`` is not adapted."""
    if not spec.adapts(m):
        return None
    _check_kind(spec)
    cfg = spec.cfg
    mi = cfg.m_index(m)
    d_in, d_out = cfg.d_in[mi], cfg.d_out[mi]
    if spec.kind == "metatt":
        if "a" in layer_slice:
            a = _metatt._task_slice(layer_slice["a"], cfg, mi, task)
            return a[..., :d_in, :], broadcast["g4"][:, :d_out], 1.0
        c_lm = _metatt._task_slice(layer_slice["c"], cfg, mi, task)
        g1 = broadcast["g1"][:d_in]
        if c_lm.ndim == 2:
            a = _k_contiguous(g1, c_lm)
        else:
            a = torch.einsum("dr,...rs->...ds", g1, c_lm)
        return a, broadcast["g4"][:, :d_out], cfg.alpha
    if spec.kind == "lora":
        return (layer_slice["a"][mi][:d_in],
                layer_slice["b"][mi][:, :d_out], cfg.alpha / cfg.rank)
    if spec.kind == "vera":
        # (((x·A)⊙d)·B)⊙g == x·(A·diag(d))·(B·diag(g))
        a = broadcast["a"][:d_in] * layer_slice["d"][mi][None, :]
        b = broadcast["b"][:, :d_out] * layer_slice["g"][mi][None, :d_out]
        return a, b, cfg.alpha
    a = _k_contiguous(broadcast["u"][:d_in], layer_slice["s"][mi])
    return a, broadcast["v"][:d_out].T, cfg.alpha


def count_trainable(spec: AdapterSpec, trainable) -> int:
    """Number of trainable adapter parameters (every tensor leaf)."""
    return int(sum(x.numel() for x in leaves(trainable)))
