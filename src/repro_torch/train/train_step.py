"""The PEFT train step (counterpart of ``src/repro/train/train_step.py``).

Gradients are taken with respect to the adapter tree only: the frozen
base weights carry ``requires_grad=False`` (no grads, no optimizer state,
no master copy). Supports microbatch gradient accumulation, remat per
super-block and gradient compression (``distributed/compression.py``,
applied between the gradients and AdamW, the top-k residual carried in
``TrainState.residual``). ``make_full_ft_step`` is the paper's full
fine-tuning baseline: it differentiates the base weights instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.config.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.distributed.compression import GradCompressor
from repro_torch.kernels import dispatch
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.peft import api as peft_api
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class TrainState:
    adapter: Any
    opt: adamw.AdamWState
    residual: Any          # top-k compression error feedback (or None)
    step: int


def init_train_state(adapter,
                     compressor: GradCompressor = GradCompressor()
                     ) -> TrainState:
    return TrainState(adapter=adapter, opt=adamw.init_state(adapter),
                      residual=compressor.init_residual(adapter), step=0)


def reinit_after_dmrg(state: TrainState, new_adapter,
                      compressor: GradCompressor = GradCompressor(),
                      moments=None) -> TrainState:
    """Rank change: rebuild the optimizer state (and the compression
    residual) for the new core shapes. ``moments``: ``(mu, nu)``
    transported through the sweep — the warm path keeps Adam statistics
    and the step counter. Without them, the paper's §3.3 fresh
    re-initialization (bias correction restarts)."""
    if moments is not None:
        opt = adamw.carry_state(state.opt, *moments)
    else:
        opt = adamw.init_state(new_adapter)
    return TrainState(adapter=new_adapter, opt=opt,
                      residual=compressor.init_residual(new_adapter),
                      step=state.step)


def _split(batch: dict, n: int) -> list:
    """n microbatches of consecutive rows; scalars (a task id) are shared."""
    parts = [{} for _ in range(n)]
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(f"batch of {v.shape[0]} rows does not split "
                                 f"into {n} microbatches")
            for p, c in zip(parts, v.chunk(n)):
                p[k] = c
        else:
            for p in parts:
                p[k] = v
    return parts


def make_train_step(cfg: ModelConfig, spec: peft_api.AdapterSpec,
                    opt_cfg: OptimizerConfig, train_cfg: TrainConfig,
                    total_steps: int, *, kernels=None,
                    device=None) -> Callable:
    """fn(state, base, frozen, batch) -> (state, metrics). ``batch``
    holds tensors on ``device``: tokens (B, T), mask (B, T), optional
    task, an encoder-decoder's enc_embeds (B, S, d) and a VLM's prefix
    embeds (B, Tp, d) (each travels with its microbatch). ``kernels``: a
    KernelConfig / KernelPolicy (None: the kernels for CUDA tensors, both
    directions)."""
    if train_cfg.remat not in ("none", "block"):
        raise ValueError(f"unknown remat {train_cfg.remat!r}")
    schedule = adamw.make_schedule(opt_cfg, total_steps)
    compressor = GradCompressor(train_cfg.grad_compression)
    remat = train_cfg.remat != "none"
    policy = dispatch.resolve(kernels)

    def grad_fn(adapter, base, frozen, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True), adapter)
        loss, metrics = model_lib.loss_fn(params, base, frozen, batch, cfg,
                                          spec, remat=remat, policy=policy,
                                          device=device)
        ps = leaves(params)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, gs)]
        it = iter(gs)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), adapter))

    def step_fn(state: TrainState, base, frozen, batch):
        if any(t.requires_grad for t in leaves(base)):
            raise ValueError("base weights must have requires_grad=False")
        nmb = train_cfg.microbatch
        if nmb and nmb > 1:
            grads = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                             state.adapter)
            loss_val, ms = 0.0, []
            for mb in _split(batch, nmb):
                lval, m, g = grad_fn(state.adapter, base, frozen, mb)
                grads = tree_map(torch.add, grads, g)
                loss_val = loss_val + lval
                ms.append(m)
            grads = tree_map(lambda g: g / nmb, grads)
            loss_val = loss_val / nmb
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss_val, metrics, grads = grad_fn(state.adapter, base, frozen,
                                               batch)
        grads, residual = compressor(grads, state.residual)
        lr = schedule(state.opt.step)
        new_adapter, new_opt, gnorm = adamw.update(
            grads, state.opt, state.adapter, opt_cfg, lr)
        new_state = TrainState(adapter=new_adapter, opt=new_opt,
                               residual=residual, step=state.step + 1)
        return new_state, dict(metrics, loss=loss_val, grad_norm=gnorm, lr=lr)

    return step_fn


def make_full_ft_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                      train_cfg: TrainConfig, total_steps: int, *,
                      kernels=None, device=None) -> Callable:
    """The full fine-tuning baseline (paper Table 1 "FT" row): no
    adapter (``peft_api.NONE``), the base weights differentiated.
    fn(base, opt_state, batch) -> (base, opt_state, metrics), with
    ``opt_state = adamw.init_state(base)``. Attention runs through the
    training kernels (#5 / #6 / #7 on CUDA tensors); the projections are
    plain ``torch.matmul``, as the JAX package leaves them to XLA."""
    if train_cfg.remat not in ("none", "block"):
        raise ValueError(f"unknown remat {train_cfg.remat!r}")
    schedule = adamw.make_schedule(opt_cfg, total_steps)
    remat = train_cfg.remat != "none"
    policy = dispatch.resolve(kernels)
    spec = peft_api.NONE

    def step_fn(base, opt_state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True), base)
        loss, metrics = model_lib.loss_fn({}, params, {}, batch, cfg, spec,
                                          remat=remat, policy=policy,
                                          device=device)
        ps = leaves(params)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(ps, gs)])
        grads = tree_map(lambda _: next(it), base)
        lr = schedule(opt_state.step)
        new_base, new_opt, gnorm = adamw.update(grads, opt_state, base,
                                                opt_cfg, lr)
        return new_base, new_opt, dict(
            {k: v.detach() for k, v in metrics.items()},
            loss=loss.detach(), grad_norm=gnorm)

    return step_fn
