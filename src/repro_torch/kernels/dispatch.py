"""Kernel-dispatch layer: the one seam between model code and kernels
(counterpart of ``src/repro/kernels/dispatch.py``), forward and backward.

  KernelConfig -> resolve() -> KernelPolicy -> AdapterCtx.policy ->
  layers / attention / engine call the entry points below.

The entry points ``tt_linear``, ``tt_linear_batched_a`` (decode shape)
and ``flash_attention`` always go through an ``autograd.Function`` — the
counterparts of the JAX package's ``custom_vjp``s:

  _FusedTTLinear    forward K1; backward dx = K1(g, Wᵀ, Bᵀ, Aᵀ) (the same
                    kernel on transposed operands), dA, dB in f32, dW only
                    when asked for (never under PEFT).
  _FusedTTLinearBA  forward K2; backward f32 einsums (the JAX package has
                    no backward kernel for K2 either).
  _FusedFlash       forward #5 (K3 plus the per-row lse) when autograd
                    records, else K3; it saves q, k, v, out and lse —
                    nothing of size T×S — and its backward is #6 then #7.

The w8a16 linears (``tt_linear_q``, ``tt_linear_batched_a_q``) and the
attention decode kernels are inference only, as in the JAX package: their
raw wrappers raise on an input that requires grad. The raw wrappers under
the Functions raise on it too, so no path can cut the graph silently.
Each step of a Function runs the kernel for CUDA tensors and the plain
version for CPU tensors (or everywhere under ``backend="ref"``), so the
CPU tests exercise the same backward.

Unlike the JAX package, ``policy=None`` means the default policy (the
kernels), not a separate unfused path: every entry point runs the CUDA
kernels for CUDA tensors unless ``KernelConfig(backend="ref")`` asks for
the plain versions. ``fuse_linear=False`` / ``flash=False`` select the
unfused reference paths in ``models/`` (plain matmuls and softmax; for
the paged cache, the plain version of #8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.config.base import KernelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import quant as quant_lib


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


class _FusedTTLinear(torch.autograd.Function):
    """y = x·W + α·(x·A)·B through K1, both directions (the JAX package's
    ``_fused_tt_linear``)."""

    @staticmethod
    def forward(ctx, x, w, a, b, alpha: float, backend: str):
        ctx.alpha, ctx.backend = alpha, backend
        ctx.save_for_backward(x, w, a, b)
        return ops.tt_linear(x, w, a, b, alpha=alpha, backend=backend)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        alpha = ctx.alpha
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        dx = dw = da = db = None
        if need_x:
            # dx = g·Wᵀ + α·(g·Bᵀ)·Aᵀ: the same base matmul + rank-r
            # epilogue, so the backward's big GEMM stays on K1
            dx = ops.tt_linear(g, w.T, b.T, a.T, alpha=alpha,
                               backend=ctx.backend)
        if need_w or need_a or need_b:
            xf = x.reshape(-1, x.shape[-1]).float()
            gf = g.reshape(-1, g.shape[-1]).float()
            if need_w:          # the frozen base never asks (PEFT)
                dw = (xf.T @ gf).to(w.dtype)
            if need_a:
                da = (alpha * (xf.T @ (gf @ b.float().T))).to(a.dtype)
            if need_b:
                db = (alpha * ((xf @ a.float()).T @ gf)).to(b.dtype)
        return dx, dw, da, db, None, None


class _FusedTTLinearBA(torch.autograd.Function):
    """Per-row-A linear through K2; backward in f32 einsums (the JAX
    package's ``_fused_tt_linear_ba``)."""

    @staticmethod
    def forward(ctx, x, w, a, b, alpha: float, backend: str):
        ctx.alpha = alpha
        ctx.save_for_backward(x, w, a, b)
        return ops.tt_linear_batched_a(x, w, a, b, alpha=alpha,
                                       backend=backend)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        alpha = ctx.alpha
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        squeeze = x.ndim == 3
        xf = (x[:, 0] if squeeze else x).float()
        gf = (g[:, 0] if squeeze else g).float()
        af = a.float()
        gb = gf @ b.float().T                                   # (S, r)
        dx = dw = da = db = None
        if need_x:
            dx = gf @ w.float().T + alpha * torch.einsum("sr,skr->sk", gb,
                                                         af)
            dx = (dx[:, None] if squeeze else dx).to(x.dtype)
        if need_w:
            dw = (xf.T @ gf).to(w.dtype)
        if need_a:
            da = (alpha * torch.einsum("sk,sr->skr", xf, gb)).to(a.dtype)
        if need_b:
            p = torch.einsum("sk,skr->sr", xf, af)
            db = (alpha * (p.T @ gf)).to(b.dtype)
        return dx, dw, da, db, None, None


class _FusedFlash(torch.autograd.Function):
    """GQA attention: K3 when autograd does not record, else #5 forward and
    #6 / #7 backward (the JAX package's ``_fused_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, backend: str, train: bool):
        ctx.causal, ctx.backend = causal, backend
        if not train:
            return ops.flash_attention(q, k, v, causal=causal,
                                       backend=backend)
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                           backend=backend)
        # one (B, H, T) f32 residual buys a backward that never builds
        # the (T, S) scores
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse,
                                             g.contiguous(),
                                             causal=ctx.causal,
                                             backend=ctx.backend)
        return dq, dk, dv, None, None, None


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def tt_linear(x, w, a, b, *, alpha: float = 1.0,
              policy: Optional[KernelPolicy] = None):
    """y = x·W + α·(x·A)·B. x (..., K); w (K, N); a (K, r); b (r, N)."""
    return _FusedTTLinear.apply(x, w, a, b, float(alpha),
                                _pol(policy, x).backend)


def tt_linear_batched_a(x, w, a, b, *, alpha: float = 1.0,
                        policy: Optional[KernelPolicy] = None):
    """Per-row-A adapted linear (the 4+1d slot-task routing form).
    x (S, [1,] K); a (S, K, r). Decode shapes (one token per row) run the
    batched-A kernel; a (B, T>1, K) per-example task vector runs the
    batched einsum, as the JAX package does (no kernel for that shape)."""
    pol = _pol(policy, x)
    if x.ndim == 2 or (x.ndim == 3 and x.shape[1] == 1):
        return _FusedTTLinearBA.apply(x, w, a, b, float(alpha), pol.backend)
    xf = x.float()
    p = torch.einsum("b...k,bkr->b...r", xf, a.to(x.dtype).float())
    y = xf @ w.float() + float(alpha) * (p @ b.float())
    return y.to(x.dtype)


def tt_linear_q(x, wq, a, b, *, alpha: float = 1.0,
                policy: Optional[KernelPolicy] = None):
    """w8a16 adapted linear over a packed int8 base leaf (#9).
    wq: ``{"q8": int8 (K, N), "scale": f32 (G, N)}`` (kernels/quant.py);
    x, a, b as in ``tt_linear``. Inference only (no backward)."""
    return ops.tt_linear_q(x, wq["q8"], wq["scale"], a, b,
                           alpha=float(alpha),
                           backend=_pol(policy, x).backend)


def tt_linear_batched_a_q(x, wq, a, b, *, alpha: float = 1.0,
                          policy: Optional[KernelPolicy] = None):
    """w8a16 per-row-A adapted linear (slot-task routing over an int8
    base). Decode shapes run #10; a (B, T>1, K) block dequantizes W to
    x's dtype and runs the batched einsum, as the JAX package does."""
    pol = _pol(policy, x)
    if x.ndim == 2 or (x.ndim == 3 and x.shape[1] == 1):
        return ops.tt_linear_batched_a_q(x, wq["q8"], wq["scale"], a, b,
                                         alpha=float(alpha),
                                         backend=pol.backend)
    return tt_linear_batched_a(x, quant_lib.dequantize(wq, x.dtype), a, b,
                               alpha=alpha, policy=pol)


def flash_attention(q, k, v, *, causal: bool = True,
                    policy: Optional[KernelPolicy] = None):
    """GQA attention. q (B, T, H, d); k, v (B, S, KV, d) -> (B, T, H, d)."""
    return _FusedFlash.apply(q, k, v, causal, _pol(policy, q).backend,
                             _records(q, k, v))


def decode_attention(q, k, v, pos, *,
                     policy: Optional[KernelPolicy] = None):
    """Cached single-token decode (serving only: K4 has no backward, and
    its wrapper raises on an input that requires grad). q (B, 1, H, d);
    k, v (B, S, KV, d); pos scalar or (B,) -> (B, 1, H, d)."""
    return ops.decode_attention(q, k, v, pos,
                                backend=_pol(policy, q).backend)


def paged_decode_attention(q, k_cache, v_cache, tables, pos, *,
                           k_scale=None, v_scale=None,
                           policy: Optional[KernelPolicy] = None):
    """Paged-cache attention, decode and in-loop chunked prefill (serving
    only: #8 has no backward, and its wrapper raises on an input that
    requires grad). q (B, C, H, d); k_cache, v_cache (N, page, KV, d);
    tables (B, P) int block table; pos (B,) base positions
    -> (B, C, H, d). ``k_scale`` / ``v_scale``: (N, page, KV) per-cell
    scale pools of an int8 cache (#8q)."""
    return ops.paged_decode_attention(q, k_cache, v_cache, tables, pos,
                                      k_scale=k_scale, v_scale=v_scale,
                                      backend=_pol(policy, q).backend)
