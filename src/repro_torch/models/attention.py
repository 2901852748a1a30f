"""GQA attention with RoPE and a dense KV cache (counterpart of
``src/repro/models/attention.py``: the train/prefill branch and the dense
single-token decode branch; paged, cross-attention and TP wait).

The flash route sends prefill to kernel K3 and decode to kernel K4
through ``kernels/dispatch.py``; without it (``KernelConfig(flash=False)``)
attention is the plain softmax over the full score matrix.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.layers import AdapterCtx, adapted_linear, apply_rope

NEG_INF = -1e30


def _flash_ok(ctx: AdapterCtx) -> bool:
    return (ctx.policy or dispatch.DEFAULT).flash


def _softmax_attend(q, k, v, mask, scale):
    """q (B, T, KV, G, hd), k/v (B, S, KV, hd), mask broadcastable to
    (B, KV, G, T, S) -> (B, T, KV, G, hd); scores and softmax in f32."""
    s = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _causal_mask(t, s, device):
    qi = torch.arange(t, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    return (qi >= ki)[None, None, None]


def attention(x: torch.Tensor, w: dict, ctx: AdapterCtx, cfg: ModelConfig,
              *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None):
    """Returns (y, new_cache).

    Prefill (``cache is None``): attends the T new tokens and returns their
    k/v as the new cache. Decode (``cache`` given, T == 1): writes the new
    k/v into ``cache`` IN PLACE at row b, cell cache_pos[b] (cells past the
    cache end are dropped, as the JAX scatter's mode="drop" does), attends
    cells [0, cache_pos[b]] and returns the same cache dict.
    """
    hd = cfg.resolved_head_dim
    n_h, n_kv = cfg.num_heads, cfg.num_kv_heads
    g = n_h // n_kv
    scale = hd ** -0.5
    b, t, _ = x.shape

    q = adapted_linear(x, w["wq"], ctx, "attn_q").reshape(b, t, n_h, hd)
    k = adapted_linear(x, w["wk"], ctx, "attn_k").reshape(b, t, n_kv, hd)
    v = adapted_linear(x, w["wv"], ctx, "attn_v").reshape(b, t, n_kv, hd)
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        if t != 1:
            raise NotImplementedError(
                "multi-token cached decode (the speculative verifier) is "
                "not ported yet")
        ck, cv = cache["k"], cache["v"]
        s_len = ck.shape[1]
        cp = torch.as_tensor(cache_pos, device=x.device).long()
        cp = cp.expand(b) if cp.ndim == 0 else cp
        keep = (cp < s_len)[:, None, None]
        rows = torch.arange(b, device=x.device)
        cell = cp.clamp(max=s_len - 1)
        # in-place cache write; a row whose position is past the end keeps
        # its old cell (the JAX scatter drops such writes)
        ck[rows, cell] = torch.where(keep, k[:, 0].to(ck.dtype), ck[rows, cell])
        cv[rows, cell] = torch.where(keep, v[:, 0].to(cv.dtype), cv[rows, cell])
        if _flash_ok(ctx):
            out = dispatch.decode_attention(q, ck, cv, cp, policy=ctx.policy)
        else:
            qh = q.reshape(b, 1, n_kv, g, hd)
            mask = (torch.arange(s_len, device=x.device)[None, :]
                    <= cp[:, None])[:, None, None, None, :]
            out = _softmax_attend(qh, ck, cv, mask, scale)
        out = out.reshape(b, t, n_h * hd)
        new_cache = cache
    else:
        if _flash_ok(ctx) and (not causal or t == k.shape[1]):
            out = dispatch.flash_attention(q, k, v, causal=causal,
                                           policy=ctx.policy)
        else:
            mask = _causal_mask(t, k.shape[1], x.device) if causal else None
            out = _softmax_attend(q.reshape(b, t, n_kv, g, hd), k, v, mask,
                                  scale)
        out = out.reshape(b, t, n_h * hd)
        new_cache = {"k": k, "v": v}
    y = adapted_linear(out, w["wo"], ctx, "attn_o")
    return y, new_cache


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype,
               device) -> dict:
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
