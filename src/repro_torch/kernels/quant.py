"""Symmetric int8 quantization of the frozen serving state (counterpart of
``src/repro/kernels/quant.py``, the same rules bit for bit).

MetaTT freezes the base model, so at serving time the base matmul weights
and the KV cache are read-only bytes; int8 halves them against bf16.

  * ``quantize_int8`` / ``dequantize_int8`` — symmetric int8 of a weight
    matrix ``(..., K, N)``, one f32 scale per output channel
    (``group_size=0``) or per ``group_size``-row K group:
    ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(w / scale), ±127)``.
  * ``quantize_linear`` / ``is_quantized`` / ``dequantize`` — the packed
    ``{"q8": int8, "scale": f32}`` leaf that replaces a raw weight in the
    base tree. The group size follows from the shapes.
  * ``quantize_base`` — packs the attention wq/wk/wv/wo and dense-FFN
    wu/wd/wg leaves of a base tree (embeddings, norms, MoE routers and
    expert banks ``e_*`` / shared experts ``s_*`` stay at full precision,
    as in the JAX package: a MoE model's int8 base packs its attention
    projections only). The engine calls it once at construction.
  * ``quantize_kv`` — per-cell (token × kv-head) int8 of the paged KV
    cache at write time, amax over head_dim. Every write is independent,
    and the scales live in the same block layout as the cells, so prefix
    sharing and copy-on-write carry them with the cells.

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
arithmetic is f32 in the same order, so both packages give the same int8
values and scales.
"""
from __future__ import annotations

from typing import Any

import torch

#: container marker key — a dict leaf carrying this key is a packed weight
QKEY = "q8"

#: weight-dict keys eligible for base quantization (the dense matmul path;
#: MoE expert banks, shared experts and routers are not among them)
_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wu", "wd", "wg"})

_EPS = 1e-8


def quantize_int8(w: torch.Tensor, group_size: int = 0):
    """w (..., K, N) -> (q int8 (..., K, N), scale f32 (..., G, N)).
    ``group_size=0``: G = 1; otherwise G = K // group_size, and a group
    size that does not divide K raises."""
    *lead, k, n = w.shape
    if group_size:
        if k % group_size:
            raise ValueError(
                f"group_size={group_size} does not divide K={k}")
        g = k // group_size
    else:
        g = 1
    wf = w.float().reshape(*lead, g, k // g, n)
    amax = wf.abs().amax(dim=-2)                            # (..., G, N)
    scale = amax.clamp(min=_EPS) / 127.0
    q = torch.round(wf / scale[..., :, None, :]).clamp(-127, 127)
    return q.to(torch.int8).reshape(*lead, k, n), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_int8`` (up to the rounding error): f32 out."""
    *lead, k, n = q.shape
    g = scale.shape[-2]
    qf = q.float().reshape(*lead, g, k // g, n)
    return (qf * scale[..., :, None, :]).reshape(*lead, k, n)


def quantize_linear(w: torch.Tensor, group_size: int = 0) -> dict:
    """Pack one weight leaf into the ``{"q8", "scale"}`` container."""
    q, scale = quantize_int8(w, group_size)
    return {QKEY: q, "scale": scale}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and QKEY in w


def dequantize(w: dict, dtype=torch.float32) -> torch.Tensor:
    """Unpack a ``{"q8", "scale"}`` container to a dense matrix."""
    return dequantize_int8(w[QKEY], w["scale"]).to(dtype)


def quantize_base(base: dict, *, group_size: int = 0) -> dict:
    """A NEW base tree whose attention wq/wk/wv/wo and dense-FFN wu/wd/wg
    leaves, shaped ``(nb, K, N)``, are ``{"q8", "scale"}`` containers;
    everything else passes through untouched. A matrix whose K the group
    size does not divide is quantized per output channel."""
    def qdict(d: dict) -> dict:
        out = {}
        for key, v in d.items():
            if key in _QUANT_KEYS and isinstance(v, torch.Tensor) \
                    and v.ndim == 3:
                gs = group_size if (group_size
                                    and v.shape[-2] % group_size == 0) else 0
                out[key] = quantize_linear(v, group_size=gs)
            else:
                out[key] = v
        return out

    def qblocks(blocks: list) -> list:
        return [{name: (qdict(sub) if name in ("mixer", "ffn", "xattn")
                        else sub) for name, sub in blk.items()}
                for blk in blocks]

    out = dict(base)
    out["blocks"] = qblocks(base["blocks"])
    if "enc_blocks" in base:
        out["enc_blocks"] = qblocks(base["enc_blocks"])
    return out


def quantize_kv(x: torch.Tensor):
    """Per-cell KV quantization: x (..., d) -> (int8 (..., d), f32 (...)).
    All-zero vectors quantize to q = 0 with the epsilon scale and come back
    as exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=_EPS) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale
