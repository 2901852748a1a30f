"""LoTR baseline (Bershatsky et al. 2024; counterpart of
``src/repro/peft/lotr.py``).

ΔW_{l,m} = U·S_{l,m}·Vᵀ with shared end factors U (d_in, r), V (d_out, r)
and a per-(layer, matrix) core S (r, r). Count 2Dr + L·M·r² — MetaTT-4D
with the (L, M) axes merged into one core. Init: U, V normal, S = 0
(ΔW = 0 at init).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoTRConfig:
    num_layers: int
    matrix_types: tuple
    d_in: tuple
    d_out: tuple
    rank: int
    alpha: float = 1.0
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
        r = self.rank
        return (self.d_in_max * r + self.d_out_max * r
                + self.num_layers * self.num_matrices * r * r)


def paper_count(D: int, L: int, M: int, r: int) -> int:
    """2Dr + LMr²."""
    return 2 * D * r + L * M * r * r


def init_params(cfg: LoTRConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    dev = resolve_device(device)
    r = cfg.rank
    u = torch.randn((cfg.d_in_max, r), generator=generator, dtype=cfg.dtype,
                    device=dev) / math.sqrt(cfg.d_in_max)
    v = torch.randn((cfg.d_out_max, r), generator=generator, dtype=cfg.dtype,
                    device=dev) / math.sqrt(r)
    s = torch.zeros((cfg.num_layers, cfg.num_matrices, r, r),
                    dtype=cfg.dtype, device=dev)
    return {"u": u, "v": v, "s": s}


def delta(cfg: LoTRConfig, broadcast: dict, layer_slice: dict,
          x: torch.Tensor, mi: int) -> torch.Tensor:
    u = broadcast["u"][: x.shape[-1]].to(x.dtype)
    vt = broadcast["v"][: cfg.d_out[mi]].T.to(x.dtype)
    s = layer_slice["s"][mi].to(x.dtype)
    return cfg.alpha * (((x @ u) @ s) @ vt)
