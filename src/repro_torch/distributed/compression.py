"""Gradient compression of the adapter gradients (counterpart of
``src/repro/distributed/compression.py``).

Two schemes, each applied as a round trip — what would arrive after a
compressed all-reduce:
  * int8: per-tensor symmetric quantization, scale = max|x| / 127 (at
    least 1e-12 / 127), q = clip(round(x / scale), ±127); rounding half
    to even, as ``jnp.round``;
  * topk: keep the ``topk_frac`` largest magnitudes (at least one), with
    error feedback: what was dropped rides to the next step in an f32
    residual. Ties keep the lower index, as ``jax.lax.top_k`` does (a
    stable sort; ``torch.topk`` promises no order among equals).

``GradCompressor`` is the transform the train step applies between the
gradients and AdamW when ``TrainConfig.grad_compression != "none"``. The
collective itself (``compressed_psum``) waits for multi-GPU training.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


def int8_encode(x: torch.Tensor) -> tuple:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_encode(x: torch.Tensor, frac: float) -> tuple:
    """(kept values, their flat indices — largest magnitude first, the
    lower index first among equals —, x's shape)."""
    flat = x.reshape(-1)
    k = max(int(frac * flat.numel()), 1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx, tuple(x.shape)


def topk_decode(kept: torch.Tensor, idx: torch.Tensor,
                shape: tuple) -> torch.Tensor:
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=kept.dtype,
                      device=kept.device)
    out[idx] = kept
    return out.reshape(shape)


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    kind: str = "none"        # none | int8 | topk
    topk_frac: float = 0.1

    def __post_init__(self):
        if self.kind not in ("none", "int8", "topk"):
            raise ValueError(f"unknown grad_compression {self.kind!r}")

    def init_residual(self, grads) -> Any:
        """f32 zeros shaped like ``grads`` (topk), else None."""
        if self.kind != "topk":
            return None
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads)

    def __call__(self, grads, residual=None) -> tuple:
        """(the gradients after the round trip, in their dtype; the new
        residual)."""
        if self.kind == "none":
            return grads, residual
        if self.kind == "int8":
            def rt(g):
                return int8_decode(*int8_encode(g.float())).to(g.dtype)
            return tree_map(rt, grads), residual
        outs = []
        for g, r in zip(leaves(grads), leaves(residual)):
            acc = g.float() + r
            dec = topk_decode(*topk_encode(acc, self.topk_frac))
            outs.append((dec.to(g.dtype), acc - dec))
        it_g, it_r = iter(o[0] for o in outs), iter(o[1] for o in outs)
        return (tree_map(lambda _: next(it_g), grads),
                tree_map(lambda _: next(it_r), grads))
