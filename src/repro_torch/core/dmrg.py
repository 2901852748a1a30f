"""DMRG-inspired rank-adaptive sweep (paper §3.3, Algorithm 1;
counterpart of ``src/repro/core/dmrg.py``).

Starting from a (sufficiently high-rank) TT, a sweep merges neighbouring
cores, truncates with an SVD to a target rank, and re-splits:

  left→right:  G_i ← U,   G_{i+1} ← S·Vᵀ     (i = 1 .. d-1)
  right→left:  G_{i-1} ← U·S,   G_i ← Vᵀ     (i = d .. 2)

The bond ranks, and so the parameter shapes, change. AdamW moments can be
transported through the sweep (``moments=``): every two-site step replaces
the pair (a, b) with (a', b') related by per-side transfer matrices (old ≈
new · transfer, by pseudo-inverse projection); first moments map through
them linearly, second moments through their elementwise squares (which
keeps them non-negative). See ``optim/adamw.py::carry_state`` and
``train/trainer.py``. Also: adaptive truncation by relative singular-value
tolerance (``rtol``), a left-canonicalization pre-pass, and per-bond rank
schedules; ``two_site_sweep`` also descends a loss at each bond. The
sweep runs on the cores' device in their dtype; SVD signs
are the backend's own, so factors differ from the JAX package's by a sign
per bond while the tensors they represent agree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import tt
from repro_torch.core.metatt import Params


@dataclasses.dataclass(frozen=True)
class SweepResult:
    params: Params
    ranks: tuple
    # singular-value spectra per bond from the final (right-to-left) pass
    spectra: tuple
    # transported optimizer moments, mirroring ``moments=`` with the
    # post-sweep core shapes (None when not requested)
    moments: Optional[tuple] = None


def _transport_pair(mom_cores, i, old_a, old_b, new_a, new_b) -> None:
    """Transport the moment cores at bond ``i`` through one two-site
    update. ``mom_cores`` is ``(mu_list, nu_list)``, mutated in place."""
    ra, rn = old_a.shape[-1], new_a.shape[-1]
    f32 = torch.float32
    t = torch.linalg.pinv(new_a.reshape(-1, rn).to(f32)) \
        @ old_a.reshape(-1, ra).to(f32)                       # (r_new, r_old)
    s = old_b.reshape(ra, -1).to(f32) \
        @ torch.linalg.pinv(new_b.reshape(rn, -1).to(f32))    # (r_old, r_new)
    mu, nu = mom_cores
    for lst, ca, cb in ((mu, t.T, s.T), (nu, t.T ** 2, s.T ** 2)):
        lst[i] = (lst[i].reshape(-1, ra).to(f32) @ ca).reshape(new_a.shape)
        lst[i + 1] = (cb @ lst[i + 1].reshape(ra, -1).to(f32)
                      ).reshape(new_b.shape)


def dmrg_sweep(params: Params,
               target_rank: Union[int, Sequence[int], None] = None, *,
               rtol: Optional[float] = None, max_rank: Optional[int] = None,
               canonicalize: bool = False,
               moments: Optional[tuple] = None) -> SweepResult:
    """One full DMRG sweep (Algorithm 1). Host-driven: changes shapes.

    target_rank: hard per-bond target (int -> uniform); None -> adaptive
        from singular values via ``rtol`` (capped at ``max_rank``).
    canonicalize: QR left-canonicalize first.
    moments: optional ``(mu, nu)`` params-like trees (AdamW moments),
        transported through every two-site step and returned on
        ``SweepResult.moments`` with the post-sweep shapes.
    """
    cores = list(params["cores"])
    d = len(cores)
    nbonds = d - 1
    if target_rank is None and rtol is None:
        raise ValueError("need target_rank or rtol")
    if isinstance(target_rank, int):
        targets = [target_rank] * nbonds
    elif target_rank is not None:
        targets = list(target_rank)
        if len(targets) != nbonds:
            raise ValueError(f"need {nbonds} per-bond targets")
    else:
        targets = [None] * nbonds

    mom_cores = None
    if moments is not None:
        mom_cores = tuple(list(m["cores"]) for m in moments)

    if canonicalize:
        if mom_cores is None:
            cores = tt.left_canonicalize(cores)
        else:
            # inline QR pass so each gauge move transports the moments too
            for i in range(d - 1):
                r_prev, n, r_next = cores[i].shape
                q, r = torch.linalg.qr(cores[i].reshape(r_prev * n, r_next))
                new_a = q.reshape(r_prev, n, q.shape[1])
                new_b = torch.tensordot(r, cores[i + 1], dims=([1], [0]))
                _transport_pair(mom_cores, i, cores[i], cores[i + 1],
                                new_a, new_b)
                cores[i], cores[i + 1] = new_a, new_b

    # left -> right (lines 1-5): G_i <- U (isometry), G_{i+1} <- S Vt
    for i in range(d - 1):
        merged = tt.merge_pair(cores[i], cores[i + 1])
        a, b, _ = tt.split_merged(merged, targets[i], left_orthogonal=True,
                                  rtol=rtol, max_rank=max_rank)
        if mom_cores is not None:
            _transport_pair(mom_cores, i, cores[i], cores[i + 1], a, b)
        cores[i], cores[i + 1] = a, b

    # right -> left (lines 6-10): G_{i-1} <- U S, G_i <- Vt
    spectra = [None] * nbonds
    for i in range(d - 1, 0, -1):
        merged = tt.merge_pair(cores[i - 1], cores[i])
        a, b, s = tt.split_merged(merged, targets[i - 1],
                                  left_orthogonal=False, rtol=rtol,
                                  max_rank=max_rank)
        if mom_cores is not None:
            _transport_pair(mom_cores, i - 1, cores[i - 1], cores[i], a, b)
        cores[i - 1], cores[i] = a, b
        spectra[i - 1] = s

    out = dict(params)
    out["cores"] = cores
    out_moments = None
    if moments is not None:
        out_moments = tuple({**dict(m), "cores": list(mc)}
                            for m, mc in zip(moments, mom_cores))
    return SweepResult(params=out, ranks=tt.ranks(cores),
                       spectra=tuple(spectra), moments=out_moments)


@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """Epoch -> target-rank schedule for interspersed DMRG sweeps: ranks
    come down slowly from a high start (paper Fig. 2 / App. C), a sweep
    right after each chosen epoch; AdamW trains at fixed shapes between."""
    milestones: tuple  # ((epoch, rank), ...) sorted by epoch

    @staticmethod
    def linear(start_rank: int, end_rank: int, start_epoch: int,
               every: int = 1, step: int = 1) -> "RankSchedule":
        ms, r, e = [], start_rank, start_epoch
        while r > end_rank:
            r = max(end_rank, r - step)
            ms.append((e, r))
            e += every
        return RankSchedule(tuple(ms))

    def rank_after_epoch(self, epoch: int) -> Optional[int]:
        """Target rank if a sweep is scheduled right after ``epoch``."""
        for e, r in self.milestones:
            if e == epoch:
                return r
        return None

    @property
    def final_rank(self) -> int:
        return self.milestones[-1][1]


def _exact_pair(merged: torch.Tensor) -> tuple:
    """Cores (a, b) with merge_pair(a, b) == merged exactly, at the bond
    min(r_prev·n_a, n_b·r_next) that ``tt.split_merged``'s full-rank split
    has: merged itself on the larger side, an identity on the smaller.
    Linear in ``merged``, so a loss differentiated through it gives
    ∂loss/∂merged with no SVD in the way."""
    r0, na, nb, r1 = merged.shape
    eye = dict(dtype=merged.dtype, device=merged.device)
    if r0 * na <= nb * r1:
        return (torch.eye(r0 * na, **eye).reshape(r0, na, r0 * na),
                merged.reshape(r0 * na, nb, r1))
    return (merged.reshape(r0, na, nb * r1),
            torch.eye(nb * r1, **eye).reshape(nb * r1, nb, r1))


def two_site_sweep(params: Params, loss_fn, target_rank: int, *,
                   inner_steps: int = 3, lr: float = 1e-2) -> SweepResult:
    """Two-site DMRG with local loss optimization (paper App. C's second
    extension): at each bond, merge the neighbouring cores, take
    ``inner_steps`` plain gradient steps on the MERGED tensor against
    ``loss_fn(params)`` with every other core frozen, then tSVD-split back
    to ``target_rank``. Left to right, then right to left: exactly
    2·(d−1)·inner_steps gradient calls. Host-driven (shapes change).

    The JAX package differentiates the local loss through an exact SVD
    resplit of the merged tensor. The loss depends on the pair only
    through their product, so that gradient is ∂loss/∂merged, which this
    port takes through ``_exact_pair`` instead: the same numbers wherever
    the SVD's derivative is finite, and finite where it is not — a merged
    pair of zeros (a zero-initialised core) has all singular values equal,
    and ``torch.linalg.svd``'s backward divides by their gaps.

    loss_fn: {"cores": [...]} -> scalar tensor."""
    cores = [c.detach() for c in params["cores"]]
    d = len(cores)

    def local_grad(merged, i):
        m = merged.detach().requires_grad_(True)
        cs = list(cores)
        cs[i], cs[i + 1] = _exact_pair(m)
        (g,) = torch.autograd.grad(loss_fn({"cores": cs}), m)
        return g

    spectra = [None] * (d - 1)
    for left, bonds in ((True, range(d - 1)), (False, range(d - 2, -1, -1))):
        for i in bonds:
            merged = tt.merge_pair(cores[i], cores[i + 1])
            for _ in range(inner_steps):
                merged = merged - lr * local_grad(merged, i)
            a, b, sv = tt.split_merged(merged, target_rank,
                                       left_orthogonal=left)
            cores[i], cores[i + 1] = a, b
            spectra[i] = sv
    out = dict(params)
    out["cores"] = cores
    return SweepResult(params=out, ranks=tt.ranks(cores),
                       spectra=tuple(spectra))


def reconstruction_error(params: Params, swept: Params) -> float:
    """Relative Frobenius error ||G - G̃|| / ||G|| between two TTs of the
    same mode sizes, in TT form, on the host in float64 (the
    ‖a‖² − 2⟨a,b⟩ + ‖b‖² form cancels badly in f32 when the TTs are
    close)."""
    a = [c.detach().cpu().double().numpy() for c in params["cores"]]
    b = [c.detach().cpu().double().numpy() for c in swept["cores"]]

    def inner(x, y):
        env = None
        for cx, cy in zip(x, y):
            env = (np.einsum("inr,ins->rs", cx, cy) if env is None
                   else np.einsum("ij,inr,jns->rs", env, cx, cy))
        return env[0, 0]

    aa, ab, bb = inner(a, a), inner(a, b), inner(b, b)
    num = np.sqrt(max(aa - 2 * ab + bb, 0.0))
    den = np.sqrt(max(aa, 1e-300))
    return float(num / den)
