"""LoRA baseline (Hu et al. 2021; counterpart of ``src/repro/peft/lora.py``).

Per adapted matrix (layer l, type m): ΔW_{l,m} = A_{l,m}·B_{l,m} scaled
by α/r, A ~ N(0, 1/d_in_max), B = 0. Parameter count 2·L·M·D·r — the
product-across-modes scaling MetaTT's sum-across-modes improves on
(paper §2.4). Stored stacked as in the JAX package: a (L, M, d_in_max, r),
b (L, M, r, d_out_max), matrix m reading a[..., :d_in(m), :] and
b[..., :d_out(m)].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    num_layers: int
    matrix_types: tuple
    d_in: tuple
    d_out: tuple
    rank: int
    alpha: float = 8.0
    dtype: Any = torch.float32

    @property
    def num_matrices(self) -> int:
        return len(self.matrix_types)

    @property
    def d_in_max(self) -> int:
        return max(self.d_in)

    @property
    def d_out_max(self) -> int:
        return max(self.d_out)

    def m_index(self, name: str) -> int:
        return self.matrix_types.index(name)

    def num_params(self) -> int:
        """The paper's effective count, over the true per-matrix dims."""
        r = self.rank
        return sum(self.num_layers * (di * r + r * do)
                   for di, do in zip(self.d_in, self.d_out))


def paper_count(D: int, L: int, M: int, r: int) -> int:
    """2LMDr (paper §2.4)."""
    return 2 * L * M * D * r


def init_params(cfg: LoRAConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    dev = resolve_device(device)
    l, m, r = cfg.num_layers, cfg.num_matrices, cfg.rank
    a = torch.randn((l, m, cfg.d_in_max, r), generator=generator,
                    dtype=cfg.dtype, device=dev) / math.sqrt(cfg.d_in_max)
    b = torch.zeros((l, m, r, cfg.d_out_max), dtype=cfg.dtype, device=dev)
    return {"a": a, "b": b}


def delta(cfg: LoRAConfig, layer_slice: dict, x: torch.Tensor,
          mi: int) -> torch.Tensor:
    a = layer_slice["a"][mi][: x.shape[-1]]
    b = layer_slice["b"][mi][:, : cfg.d_out[mi]]
    scale = cfg.alpha / cfg.rank
    return scale * ((x @ a.to(x.dtype)) @ b.to(x.dtype))
