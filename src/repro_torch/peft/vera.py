"""VeRA baseline (Kopiczko et al., ICLR 2024; counterpart of
``src/repro/peft/vera.py``).

One pair of frozen random matrices A (d_in, r), B (r, d_out) is shared by
every layer and matrix type; only per-(l, m) scaling vectors train:

  Δy = (((x·A) ⊙ d_{l,m})·B) ⊙ g_{l,m}

d starts at ``d_init`` and g at 0 (ΔW = 0 at init). Trainable count
L·M·(r + D). The frozen pair is drawn from
``torch.Generator().manual_seed(cfg.seed)`` on the CPU, then moved: like
the JAX package's, it derives from the config and is never checkpointed
(the two packages draw different numbers; tests carry the JAX pair
across).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VeRAConfig:
    num_layers: int
    matrix_types: tuple
    d_in: tuple
    d_out: tuple
    rank: int
    d_init: float = 0.1
    alpha: float = 1.0
    seed: int = 0          # the frozen A / B derive from this
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
        """Trainable only (the frozen shared pair is excluded, as in the
        paper)."""
        return sum(self.num_layers * (self.rank + do) for do in self.d_out)


def paper_count(D: int, L: int, M: int, r: int) -> int:
    """L·M·(r + D)."""
    return L * M * (r + D)


def init_params(cfg: VeRAConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> tuple:
    """(trainable {"d", "g"}, frozen {"a", "b"}). ``generator`` is unused:
    the frozen pair comes from ``cfg.seed`` alone."""
    dev = resolve_device(device)
    l, m, r = cfg.num_layers, cfg.num_matrices, cfg.rank
    trainable = {
        "d": torch.full((l, m, r), cfg.d_init, dtype=cfg.dtype, device=dev),
        "g": torch.zeros((l, m, cfg.d_out_max), dtype=cfg.dtype, device=dev),
    }
    fgen = torch.Generator().manual_seed(cfg.seed)
    a = torch.randn((cfg.d_in_max, r), generator=fgen, dtype=cfg.dtype)
    b = torch.randn((r, cfg.d_out_max), generator=fgen, dtype=cfg.dtype)
    frozen = {"a": (a / math.sqrt(cfg.d_in_max)).to(dev),
              "b": (b / math.sqrt(r)).to(dev)}
    return trainable, frozen


def delta(cfg: VeRAConfig, broadcast: dict, layer_slice: dict,
          x: torch.Tensor, mi: int) -> torch.Tensor:
    a = broadcast["a"][: x.shape[-1]].to(x.dtype)
    b = broadcast["b"][:, : cfg.d_out[mi]].to(x.dtype)
    d = layer_slice["d"][mi].to(x.dtype)
    g = layer_slice["g"][mi][: cfg.d_out[mi]].to(x.dtype)
    return cfg.alpha * ((((x @ a) * d) @ b) * g)
