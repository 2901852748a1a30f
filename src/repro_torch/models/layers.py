"""Shared building blocks (counterpart of ``src/repro/models/layers.py``;
no serve-TP / row-parallel code)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels import quant as quant_lib
from repro_torch.peft import api as peft_api


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
    plain matmul.
    """
    pol = ctx.policy or dispatch.DEFAULT
    wq = quant_lib.is_quantized(w)
    if pol.fuse_linear and ctx.spec.adapts(m):
        form = peft_api.lora_form_factors(ctx.spec, ctx.broadcast, ctx.layer,
                                          m, task=ctx.task)
        if form is not None:
            fa, fb, alpha = form
            fa, fb = fa.to(x.dtype), fb.to(x.dtype)
            if fa.ndim == 3:      # (B,) task vector: per-slot A operand
                y = (dispatch.tt_linear_batched_a_q(x, w, fa, fb,
                                                    alpha=alpha, policy=pol)
                     if wq else
                     dispatch.tt_linear_batched_a(x, w.to(x.dtype), fa, fb,
                                                  alpha=alpha, policy=pol))
            else:
                y = (dispatch.tt_linear_q(x, w, fa, fb, alpha=alpha,
                                          policy=pol)
                     if wq else
                     dispatch.tt_linear(x, w.to(x.dtype), fa, fb,
                                        alpha=alpha, policy=pol))
            if b is not None:
                y = y + b.to(y.dtype)
            return y
    y = x @ (quant_lib.dequantize(w, x.dtype) if wq else w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    d = peft_api.adapter_delta(ctx.spec, ctx.broadcast, ctx.layer, x, m,
                               task=ctx.task)
    if d is not None:
        y = y + d.to(y.dtype)
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
    """kind: swiglu | geglu | gelu."""
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
