"""Plain PyTorch versions of every kernel (the allclose targets).

Each mirrors the dtype casts of its counterpart in the JAX package's
``kernels/ref.py`` / ``kernels/ops.py``: products of bf16 operands are
taken in f32 (exact), sums in f32, and the result is rounded once to the
input dtype. The CPU path of every kernel wrapper runs these; on the card
they are the comparison leg (``KernelConfig(backend="ref")``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import dequantize_int8

NEG = -1e30


def tt_linear_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """y = x·W + α·(x·A)·B with f32 accumulators; P = x·A stays f32."""
    xf = x.float()
    y = xf @ w.float()
    p = xf @ a.float()
    y = y + alpha * (p @ b.float())
    return y.to(x.dtype)


def tt_linear_batched_a_ref(x: torch.Tensor, w: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            alpha: float = 1.0) -> torch.Tensor:
    """Per-row A: y[s] = x[s]·W + α·(x[s]·A[s])·B. x (S, K); a (S, K, r)."""
    xf = x.float()
    p = torch.einsum("sk,skr->sr", xf, a.to(x.dtype).float())
    y = xf @ w.float()
    y = y + alpha * (p @ b.float())
    return y.to(x.dtype)


def tt_linear_q_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor,
                    alpha: float = 1.0) -> torch.Tensor:
    """w8a16 adapted linear: dequantize the int8 base (per-channel or
    grouped scales) to f32, then ``tt_linear_ref``."""
    return tt_linear_ref(x, dequantize_int8(wq, scale), a, b, alpha)


def tt_linear_batched_a_q_ref(x: torch.Tensor, wq: torch.Tensor,
                              scale: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor,
                              alpha: float = 1.0) -> torch.Tensor:
    """Per-row-A w8a16 adapted linear. x (S, K); a (S, K, r)."""
    return tt_linear_batched_a_ref(x, dequantize_int8(wq, scale), a, b,
                                   alpha)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, T|S, d) -> (B, H, T, d); softmax in f32, masked
    scores set to -1e30, probabilities rounded to v's dtype before P·V."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t, s_len = q.shape[2], k.shape[2]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s_len, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _scores(q, k, causal: bool, masked: float) -> torch.Tensor:
    """s = q·kᵀ·scale in f32, (B, H, T, S); causal masks ki > qi."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    if causal:
        t, s_len = q.shape[2], k.shape[2]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s_len, device=q.device)[None, :])
        s = s.masked_fill(~mask, masked)
    return s


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True):
    """Stats-emitting forward: q, k, v (B, H, T|S, d) -> (out (B, H, T, d),
    lse (B, H, T) f32). p = exp(s − lse), rounded to v's dtype before P·V
    (the JAX package's ``ops.flash_attention_fwd`` reference)."""
    s = _scores(q, k, causal, NEG)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor,
                            causal: bool = True):
    """Recompute-from-lse backward, the twin of the JAX package's
    ``kernels/ref.py::flash_attention_bwd_ref``: q, o, g (B, H, T, d);
    k, v (B, H, S, d) (heads already repeated); lse (B, H, T) f32.
    p = exp(s − lse), D = rowsum(g ⊙ o), ds = p·(dp − D)·scale, with p and
    ds rounded to the operand dtype before each product. Returns (dq, dk,
    dv) in f32, per query head: the caller sums GQA groups in f32 and
    rounds once, as the dk/dv kernel does."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, causal, -torch.inf) - lse.float()[..., None])
    delta = (g.float() * o.float()).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dq, dk, dv


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Single-token cached decode. q: (BH, d); k, v: (BH, S, d); pos: (BH,)
    — row i attends cache cells [0, pos[i]]."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bd,bsd->bs", q.float(), k.float()) * scale
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            <= pos.to(q.device)[:, None])
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bs,bsd->bd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, tables: torch.Tensor,
                               pos: torch.Tensor, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Block-table attention over a paged KV cache (the twin of the JAX
    package's ``paged_decode_attention_ref``).

    q: (B, C, H, d) — C co-batched query tokens per slot, slot b's query c
    at absolute position pos[b] + c; k_cache, v_cache: (N, page, KV, d)
    flat block pools; tables: (B, P) int logical-page -> physical-block map
    (entries may be an out-of-range sentinel: the gather clamps and the
    position mask hides whatever it reads); pos: (B,) base positions.
    Returns (B, C, H, d) in v's dtype: query c attends cache cells
    [0, pos[b] + c]; softmax in f32, p rounded to v's dtype before P·V.

    int8 leg (``k_scale`` / ``v_scale``: (N, page, KV) f32 per-cell scale
    pools): the pools are dequantized to f32 first, so p stays f32 through
    P·V, and the output is rounded once to q's dtype (the JAX package's
    ``ops.paged_decode_attention`` reference leg).
    """
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale[..., None]
        v_cache = v_cache.float() * v_scale[..., None]
        return paged_decode_attention_ref(q, k_cache, v_cache, tables,
                                          pos).to(q.dtype)
    b, c, h, d = q.shape
    n, _, kv, _ = k_cache.shape
    g = h // kv
    tbl = tables.long().clamp(0, n - 1)
    # (B, P, page, KV, d) -> (B, S, KV, d), S = P * page cells in
    # logical-position order — same valid set, same order as a dense cache
    kg = k_cache[tbl].reshape(b, -1, kv, d)
    vg = v_cache[tbl].reshape(b, -1, kv, d)
    if g > 1:
        kg = kg.repeat_interleave(g, dim=2)
        vg = vg.repeat_interleave(g, dim=2)
    s = torch.einsum("bchd,bshd->bhcs", q.float(), kg.float()) * d ** -0.5
    ki = torch.arange(kg.shape[1], device=q.device)
    qpos = (pos.to(q.device).long()[:, None]
            + torch.arange(c, device=q.device)[None, :])       # (B, C)
    mask = ki[None, None, :] <= qpos[:, :, None]                # (B, C, S)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", p.to(vg.dtype).float(),
                       vg.float())
    return out.to(vg.dtype)
