"""AdamW + schedules + clipping (counterpart of
``src/repro/optim/adamw.py``), functional on nested dicts of tensors.

The paper's setup: AdamW with weight_decay 0.0, warmup_ratio 0.06, grad
clip 3.0 (App. A.3 / B / D). Moments are f32 whatever the parameter
dtype. The scalar arithmetic (bias corrections, schedule) is done in f32
0-d tensors, as the JAX package does it, so both give the same updates;
those scalars live on the CPU and enter the device math as 0-d operands,
without a host-device copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.config.base import OptimizerConfig
from repro_torch.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass
class AdamWState:
    step: int             # updates taken so far
    mu: Any               # f32 tree like params
    nu: Any


def init_state(params) -> AdamWState:
    z = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    return AdamWState(step=0, mu=z, nu=tree_map(torch.clone, z))


def reinit_state(params) -> AdamWState:
    """Fresh moments after a DMRG rank change (paper §3.3)."""
    return init_state(params)


def carry_state(state: AdamWState, mu, nu) -> AdamWState:
    """Warm-moment carry across a DMRG resplit: install moments that were
    transported through the sweep (``core/dmrg.py`` ``moments=``) and keep
    the step counter — a sweep is a reparameterization, not a restart, so
    bias correction does not rewind. Second moments are clamped at 0."""
    return AdamWState(step=state.step,
                      mu=tree_map(lambda m: m.to(F32), mu),
                      nu=tree_map(lambda v: v.to(F32).clamp(min=0.0), nu))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), n


def make_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable:
    """step (int) -> lr, a 0-d f32 tensor: linear warmup over
    ``warmup_ratio`` of the steps, then linear / cosine decay or
    constant."""
    warm = max(int(cfg.warmup_ratio * total_steps), 1)
    if cfg.schedule not in ("linear", "cosine", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    def sched(step: int) -> torch.Tensor:
        s = torch.tensor(float(step), dtype=F32)
        warm_lr = cfg.lr * (s + 1) / warm
        frac = torch.clamp((s - warm) / max(total_steps - warm, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            decay = 1.0 - frac
        else:
            decay = torch.ones((), dtype=F32)
        return torch.where(s < warm, warm_lr, cfg.lr * decay)

    return sched


def update(grads, state: AdamWState, params, cfg: OptimizerConfig,
           lr: torch.Tensor):
    """One AdamW step. Returns (new_params, new_state, grad_norm)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    b1, b2 = cfg.betas
    t = state.step + 1
    tf = torch.tensor(float(t), dtype=F32)
    bc1 = 1 - torch.tensor(b1, dtype=F32) ** tf
    bc2 = 1 - torch.tensor(b2, dtype=F32) ** tf

    def upd(p, g, m, v):
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * step).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state.mu), leaves(state.nu))]
    new_p, new_m, new_v = (_like(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(step=t, mu=new_m, nu=new_v), gnorm


def _like(tree, flat: list):
    """``flat`` (in ``leaves`` order) put back into ``tree``'s structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)
