"""Kernel-dispatch layer: the one seam between model code and kernels
(counterpart of ``src/repro/kernels/dispatch.py``, forward only — the
backward kernels come with the training slice).

  KernelConfig -> resolve() -> KernelPolicy -> AdapterCtx.policy ->
  layers / attention / engine call the entry points below.

Unlike the JAX package, ``policy=None`` means the default policy (the
kernels), not a separate unfused path: every entry point runs the CUDA
kernels for CUDA tensors unless ``KernelConfig(backend="ref")`` asks for
the plain versions. ``fuse_linear=False`` / ``flash=False`` select the
unfused reference paths in ``models/`` (plain matmuls and softmax).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.config.base import KernelConfig
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Resolved dispatch decision."""
    backend: str = "kernel"        # kernel | ref
    require_cuda: bool = False     # KernelConfig(backend="cuda")
    fuse_linear: bool = True       # adapted_linear through the K1/K2 seam
    flash: bool = True             # attention through the K3/K4 seam


#: the kernels (CUDA tensors) / plain versions (CPU tensors)
DEFAULT = KernelPolicy()
#: the plain PyTorch versions on any device — the comparison leg
REF = KernelPolicy(backend="ref")


def resolve(cfg: Union[KernelConfig, KernelPolicy, None]) -> KernelPolicy:
    """KernelConfig -> KernelPolicy; None -> DEFAULT."""
    if cfg is None:
        return DEFAULT
    if isinstance(cfg, KernelPolicy):
        return cfg
    cfg = cfg.validate()
    return KernelPolicy(backend="ref" if cfg.backend == "ref" else "kernel",
                        require_cuda=cfg.backend == "cuda",
                        fuse_linear=cfg.fuse_linear, flash=cfg.flash)


def _pol(policy: Optional[KernelPolicy], t: torch.Tensor) -> KernelPolicy:
    pol = policy or DEFAULT
    if pol.require_cuda and not t.is_cuda:
        raise RuntimeError("KernelConfig(backend='cuda') got a tensor on "
                           f"{t.device}")
    return pol


def tt_linear(x, w, a, b, *, alpha: float = 1.0,
              policy: Optional[KernelPolicy] = None):
    """y = x·W + α·(x·A)·B. x (..., K); w (K, N); a (K, r); b (r, N)."""
    return ops.tt_linear(x, w, a, b, alpha=float(alpha),
                         backend=_pol(policy, x).backend)


def tt_linear_batched_a(x, w, a, b, *, alpha: float = 1.0,
                        policy: Optional[KernelPolicy] = None):
    """Per-row-A adapted linear (the 4+1d slot-task routing form).
    x (S, [1,] K); a (S, K, r). Decode shapes (one token per row) run the
    batched-A kernel; a (B, T>1, K) per-example task vector runs the
    batched einsum, as the JAX package does (no kernel for that shape)."""
    pol = _pol(policy, x)
    if x.ndim == 2 or (x.ndim == 3 and x.shape[1] == 1):
        return ops.tt_linear_batched_a(x, w, a, b, alpha=float(alpha),
                                       backend=pol.backend)
    xf = x.float()
    p = torch.einsum("b...k,bkr->b...r", xf, a.to(x.dtype).float())
    y = xf @ w.float() + float(alpha) * (p @ b.float())
    return y.to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    policy: Optional[KernelPolicy] = None):
    """GQA attention. q (B, T, H, d); k, v (B, S, KV, d) -> (B, T, H, d)."""
    return ops.flash_attention(q, k, v, causal=causal,
                               backend=_pol(policy, q).backend)


def decode_attention(q, k, v, pos, *,
                     policy: Optional[KernelPolicy] = None):
    """Cached single-token decode. q (B, 1, H, d); k, v (B, S, KV, d);
    pos scalar or (B,) -> (B, 1, H, d)."""
    return ops.decode_attention(q, k, v, pos,
                                backend=_pol(policy, q).backend)
