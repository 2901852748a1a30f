"""Shared building blocks (counterpart of ``src/repro/models/layers.py``),
with the column- and row-parallel linears of serve-time tensor
parallelism (``sharding/rules.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels import quant as quant_lib
from repro_torch.peft import api as peft_api
from repro_torch.sharding import (get_serve_rp, get_serve_tp, serve_psum,
                                  serve_tp_slice)


@dataclasses.dataclass
class AdapterCtx:
    """Everything a layer needs to apply the global adapter: the static
    spec, the broadcast factors, this layer's slice of the per-layer
    factors, the task index (scalar or a (B,) vector; None without a task
    axis) and the dispatch policy (None -> ``dispatch.DEFAULT``)."""
    spec: peft_api.AdapterSpec
    broadcast: Any
    layer: Any
    task: Optional[Any] = None
    policy: Optional[dispatch.KernelPolicy] = None

    def at(self, layer_slice) -> "AdapterCtx":
        return AdapterCtx(self.spec, self.broadcast, layer_slice, self.task,
                          self.policy)


NO_ADAPTER = AdapterCtx(peft_api.NONE, {}, None)


def adapted_linear(x: torch.Tensor, w, ctx: AdapterCtx, m: str,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x·W (+ bias) + the adapter's delta for matrix type ``m``.

    Fused branch: the adapter folds to lora-form (A, B) and the base
    matmul plus the rank-r epilogue run as ONE kernel (K1, or K2 when a
    (B,) task vector gives A a slot axis). Unfused branch (unadapted
    matrices, or ``fuse_linear=False``): a plain matmul plus
    ``adapter_delta``.

    ``w`` may be a packed int8 leaf (``{"q8", "scale"}``,
    ``kernels/quant.py``; the engine quantizes the frozen base once):
    the fused branch then runs the w8a16 kernels (#9, or #10 for a slot
    axis), and the unfused branch dequantizes W to x's dtype for the
    plain matmul. Both branches, and the serve-TP linears below, pick
    their kernel in ``_apply_linear``.
    """
    pol = ctx.policy or dispatch.DEFAULT
    if pol.fuse_linear:
        form = _lora_form(ctx, m)
        if form is not None:
            y = _apply_linear(x, w, form, pol)
            return y if b is None else y + b.to(y.dtype)
    y = _apply_linear(x, w, None, pol)
    if b is not None:
        y = y + b.to(y.dtype)
    d = peft_api.adapter_delta(ctx.spec, ctx.broadcast, ctx.layer, x, m,
                               task=ctx.task)
    if d is not None:
        y = y + d.to(y.dtype)
    return y


def _apply_linear(x, w, form, pol):
    """x·W over a whole or sliced (possibly int8-packed) weight, plus the
    lora-form delta α·(x·A)·B when ``form`` is (A, B, α): the one place
    the adapted matmuls pick their kernel. Under a fusing policy the
    delta runs in the matmul's epilogue (K1, or K2 for a per-slot A;
    #9 / #10 over int8 W); else a plain matmul (int8 W dequantized) plus
    the two rank-r products, which the serve-TP linears need for their
    sliced factors (``adapted_linear`` adds ``adapter_delta`` instead, as
    JAX's does). No bias: the row-parallel linear adds it once after the
    all-reduce."""
    wq = quant_lib.is_quantized(w)
    if form is not None:
        fa, fb, alpha = form
        fa, fb = fa.to(x.dtype), fb.to(x.dtype)
        if pol.fuse_linear:
            if fa.ndim == 3:      # (B,) task vector: per-slot A operand
                return (dispatch.tt_linear_batched_a_q(
                    x, w, fa, fb, alpha=alpha, policy=pol) if wq else
                    dispatch.tt_linear_batched_a(
                        x, w.to(x.dtype), fa, fb, alpha=alpha, policy=pol))
            return (dispatch.tt_linear_q(x, w, fa, fb, alpha=alpha,
                                         policy=pol) if wq else
                    dispatch.tt_linear(x, w.to(x.dtype), fa, fb,
                                       alpha=alpha, policy=pol))
    y = x @ (quant_lib.dequantize(w, x.dtype) if wq else w.to(x.dtype))
    if form is None:
        return y
    p = torch.einsum("btk,bkr->btr", x, fa) if fa.ndim == 3 else x @ fa
    return y + alpha * (p @ fb)


def _lora_form(ctx: AdapterCtx, m: str):
    return (peft_api.lora_form_factors(ctx.spec, ctx.broadcast, ctx.layer,
                                       m, task=ctx.task)
            if ctx.spec.adapts(m) else None)


# ---------------------------------------------------------------------------
# row- / column-parallel serve-TP linears. The default serve TP keeps every
# matmul whole on every rank and all-gathers the attention heads instead;
# under ServeConfig(row_parallel=True) the FIRST matmul of a pair splits
# its output columns per rank (exact: no reduction order changes) and the
# SECOND splits its input rows, giving partial sums that one all-reduce
# adds. The all-reduce reorders the K-axis sum, so this mode is near
# parity, not bit-exact; the column-only mode is the oracle.
# ---------------------------------------------------------------------------


def _slice_w(w, axis: int):
    """This rank's stripe of a (possibly int8-packed) weight leaf along
    ``axis`` (negative, from the end). Packed leaves slice the int8 cells;
    per-output-channel scales slice with N (axis -1) and do not depend on
    K under a row slice (axis -2). Grouped scales tile K, so
    ``ServeConfig`` refuses row_parallel with group_size > 0."""
    if quant_lib.is_quantized(w):
        q = serve_tp_slice(w["q8"], w["q8"].ndim + axis)
        sc = w["scale"]
        if axis == -1:
            sc = serve_tp_slice(sc, sc.ndim - 1)
        return {"q8": q, "scale": sc}
    return serve_tp_slice(w, w.ndim + axis)


def serve_cp_linear(x: torch.Tensor, w, ctx: AdapterCtx, m: str,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-parallel adapted linear: this rank computes its contiguous
    N/tp output stripe (the weight's columns, the lora-form B's columns
    and the bias's slice). Exact column by column. ``adapted_linear``
    outside a serve-TP context."""
    if not get_serve_tp():
        return adapted_linear(x, w, ctx, m, b)
    form = _lora_form(ctx, m)
    if form is not None:
        fa, fb, alpha = form
        form = (fa, serve_tp_slice(fb, fb.ndim - 1), alpha)
    y = _apply_linear(x, _slice_w(w, -1), form,
                      ctx.policy or dispatch.DEFAULT)
    if b is not None:
        y = y + serve_tp_slice(b, b.ndim - 1).to(y.dtype)
    return y


def serve_rp_linear(x: torch.Tensor, w, ctx: AdapterCtx, m: str,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-parallel adapted linear: ``x`` arrives sharded on its last dim
    (this rank's K/tp contraction rows: attention's local head group, the
    FFN's local d_ff stripe); the weight's K rows and the lora-form A's
    rows (axis ``fa.ndim - 2``, so a per-slot A (B, K, r) slices its K
    too) slice to match, one all-reduce adds the partial outputs, and the
    bias adds once after. ``adapted_linear`` outside a serve-TP context
    (``x`` is then whole)."""
    if not get_serve_tp():
        return adapted_linear(x, w, ctx, m, b)
    form = _lora_form(ctx, m)
    if form is not None:
        fa, fb, alpha = form
        form = (serve_tp_slice(fa, fa.ndim - 2), fb, alpha)
    y = serve_psum(_apply_linear(x, _slice_w(w, -2), form,
                                 ctx.policy or dispatch.DEFAULT))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMS norm in f32 that scales by (1 + w) (weights init to zero)."""
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * (1.0 + w.float())).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * w.float() + b.float()).to(x.dtype)


def norm(x, weights: dict, eps: float):
    if "b" in weights:
        return layernorm(x, weights["w"], weights["b"], eps)
    return rmsnorm(x, weights["w"], eps)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split (llama) RoPE in f32. x (B, T, n_heads, hd); positions
    (B, T) or (T,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _silu(v):
    return v * torch.sigmoid(v)


def _gelu(v):
    return F.gelu(v, approximate="tanh")


def dense_ffn(x: torch.Tensor, w: dict, ctx: AdapterCtx, kind: str
              ) -> torch.Tensor:
    """kind: swiglu | geglu | gelu. Under row-parallel serve TP the FFN
    runs megatron-style: wg / wu column-parallel (each rank activates its
    own d_ff/tp stripe), wd row-parallel with the all-reduce epilogue."""
    if get_serve_rp():
        if kind in ("swiglu", "geglu"):
            act = _silu if kind == "swiglu" else _gelu
            h = act(serve_cp_linear(x, w["wg"], ctx, "ffn_gate")) \
                * serve_cp_linear(x, w["wu"], ctx, "ffn_up")
        elif kind == "gelu":
            h = _gelu(serve_cp_linear(x, w["wu"], ctx, "ffn_up"))
        else:
            raise ValueError(kind)
        return serve_rp_linear(h, w["wd"], ctx, "ffn_down")
    if kind in ("swiglu", "geglu"):
        act = _silu if kind == "swiglu" else _gelu
        g = act(adapted_linear(x, w["wg"], ctx, "ffn_gate"))
        u = adapted_linear(x, w["wu"], ctx, "ffn_up")
        h = g * u
    elif kind == "gelu":
        h = _gelu(adapted_linear(x, w["wu"], ctx, "ffn_up"))
    else:
        raise ValueError(kind)
    return adapted_linear(h, w["wd"], ctx, "ffn_down")


def embed_tokens(tokens: torch.Tensor, embed: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return embed[tokens].to(compute_dtype)


def lm_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout."""
    return h @ embed.to(h.dtype).T
