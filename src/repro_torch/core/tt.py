"""Tensor-train (TT) algebra (counterpart of ``src/repro/core/tt.py``).

A TT of order ``d`` represents ``G[i1, ..., id]`` as a product of cores
``C_k`` of shape ``(r_{k-1}, n_k, r_k)`` with ``r_0 = r_d = 1``. Validation,
materialization (tests), the random TT the smoke runs serve, and the
neighbour-core merge, truncated-SVD resplit and canonicalization the DMRG
sweep (``core/dmrg.py``) is built from. Shape-changing operations
(truncation) are host-driven: a chosen rank is read back to the host.
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


def ranks(cores: Sequence[torch.Tensor]) -> tuple:
    """Internal bond dimensions (r_1, ..., r_{d-1})."""
    return tuple(int(c.shape[-1]) for c in cores[:-1])


def mode_sizes(cores: Sequence[torch.Tensor]) -> tuple:
    return tuple(int(c.shape[1]) for c in cores)


def num_params(cores: Sequence[torch.Tensor]) -> int:
    return int(sum(c.numel() for c in cores))


def materialize(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract a TT back into the dense tensor ``(n_1, ..., n_d)``
    (tests / tiny dims only)."""
    validate_cores(cores)
    out = cores[0]
    for core in cores[1:]:
        out = torch.tensordot(out, core, dims=([-1], [0]))
    return out.reshape(out.shape[1:-1])


def slice_matrix(cores: Sequence[torch.Tensor],
                 idx: Sequence[int]) -> torch.Tensor:
    """Dense matrix ``G[:, idx..., :]`` of a TT whose first and last modes
    are the matrix dimensions and whose middle modes ``idx`` indexes:
    for MetaTT-4d cores (D_in, L, M, D_out) and idx (l, m), ΔW_{l,m}
    (D_in, D_out)."""
    if len(idx) != len(cores) - 2:
        raise ValueError(f"need {len(cores) - 2} middle indices, "
                         f"got {len(idx)}")
    out = cores[0][0]                       # (n1, r1)
    for core, i in zip(cores[1:-1], idx):
        out = out @ core[:, i, :]
    return out @ cores[-1][..., 0]


def merge_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MERGE of Algorithm 1: neighbouring cores -> one 4-tensor
    ``(r_prev, n_a, n_b, r_next)``."""
    return torch.einsum("iar,rbj->iabj", a, b)


def split_merged(merged: torch.Tensor, rank: Optional[int] = None, *,
                 left_orthogonal: bool = True, rtol: Optional[float] = None,
                 max_rank: Optional[int] = None):
    """tSVD + resplit of Algorithm 1 (one step of a DMRG sweep).

    merged (r_prev, n_a, n_b, r_next). ``rank`` is a hard target bond rank;
    if None the rank is the number of singular values above ``rtol`` times
    the largest (at least 1, at most ``max_rank``). ``left_orthogonal``:
    the left factor is the isometry U (left-to-right sweep), else the left
    factor absorbs S (right-to-left sweep, line 9 of Algorithm 1).
    Returns (core_a (r_prev, n_a, r), core_b (r, n_b, r_next), sigma).
    """
    r_prev, n_a, n_b, r_next = merged.shape
    mat = merged.reshape(r_prev * n_a, n_b * r_next)
    u, s, vt = torch.linalg.svd(mat, full_matrices=False)
    if rank is None:
        if rtol is None:
            raise ValueError("need rank or rtol")
        keep = max(int((s > rtol * s[0]).sum()), 1)
        if max_rank is not None:
            keep = min(keep, max_rank)
    else:
        keep = min(rank, s.shape[0])
    u, s, vt = u[:, :keep], s[:keep], vt[:keep, :]
    if left_orthogonal:
        a, b = u, s[:, None] * vt
    else:
        a, b = u * s[None, :], vt
    return a.reshape(r_prev, n_a, keep), b.reshape(keep, n_b, r_next), s


def truncation_error(merged: torch.Tensor, rank: int) -> torch.Tensor:
    """Frobenius error of the rank-``rank`` tSVD of a merged pair: by
    Eckart–Young, sqrt of the sum of the dropped squared singular
    values."""
    r_prev, n_a, n_b, r_next = merged.shape
    s = torch.linalg.svdvals(merged.reshape(r_prev * n_a, n_b * r_next))
    return torch.sqrt(torch.sum(s[rank:] ** 2))


def left_canonicalize(cores: Cores) -> Cores:
    """QR sweep left→right so every core but the last is a left isometry
    (ranks kept): the canonical form a right-to-left truncation wants."""
    out = list(cores)
    for k in range(len(out) - 1):
        r_prev, n, r_next = out[k].shape
        q, r = torch.linalg.qr(out[k].reshape(r_prev * n, r_next))
        out[k] = q.reshape(r_prev, n, q.shape[1])
        out[k + 1] = torch.tensordot(r, out[k + 1], dims=([1], [0]))
    return out


def tt_norm(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Frobenius norm of the full tensor, by transfer matrices (no
    materialization)."""
    env = None
    for c in cores:
        env = (torch.einsum("inr,ins->rs", c, c) if env is None
               else torch.einsum("ij,inr,jns->rs", env, c, c))
    return torch.sqrt(torch.abs(env[0, 0]))


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
