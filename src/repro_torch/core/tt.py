"""Tensor-train (TT) algebra (counterpart of ``src/repro/core/tt.py``).

A TT of order ``d`` represents ``G[i1, ..., id]`` as a product of cores
``C_k`` of shape ``(r_{k-1}, n_k, r_k)`` with ``r_0 = r_d = 1``. This slice
carries what serving needs: validation, materialization (tests) and the
random TT the smoke runs serve.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

Cores = list  # list[torch.Tensor], each (r_{k-1}, n_k, r_k)


def validate_cores(cores: Sequence[torch.Tensor]) -> None:
    """Raise ValueError unless ``cores`` is a well-formed TT."""
    if not cores:
        raise ValueError("empty TT")
    if cores[0].shape[0] != 1 or cores[-1].shape[-1] != 1:
        raise ValueError(
            f"boundary ranks must be 1, got {cores[0].shape[0]} and "
            f"{cores[-1].shape[-1]}")
    for k in range(len(cores) - 1):
        if cores[k].ndim != 3 or cores[k + 1].ndim != 3:
            raise ValueError("TT cores must be rank-3 (r_prev, n, r_next)")
        if cores[k].shape[-1] != cores[k + 1].shape[0]:
            raise ValueError(
                f"bond mismatch between core {k} and {k+1}: "
                f"{tuple(cores[k].shape)} vs {tuple(cores[k+1].shape)}")


def materialize(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract a TT back into the dense tensor ``(n_1, ..., n_d)``
    (tests / tiny dims only)."""
    validate_cores(cores)
    out = cores[0]
    for core in cores[1:]:
        out = torch.tensordot(out, core, dims=([-1], [0]))
    return out.reshape(out.shape[1:-1])


def random_tt(generator: Optional[torch.Generator], shape: Sequence[int],
              rank: Union[int, Sequence[int]], scale: float = 0.2, *,
              device=None) -> Cores:
    """Random-normal f32 TT with the given mode sizes and (uniform or
    per-bond) ranks, drawn from ``generator`` on ``device`` (the
    generator's device when ``device`` is None)."""
    if device is None and generator is not None:
        device = generator.device
    dev = resolve_device(device)
    d = len(shape)
    if isinstance(rank, int):
        bonds = [1] + [rank] * (d - 1) + [1]
    else:
        bonds = [1] + list(rank) + [1]
        if len(bonds) != d + 1:
            raise ValueError("rank list must have d-1 entries")
    return [scale * torch.randn((bonds[k], shape[k], bonds[k + 1]),
                                generator=generator, device=dev,
                                dtype=torch.float32)
            for k in range(d)]
