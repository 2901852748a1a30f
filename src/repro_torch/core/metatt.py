"""MetaTT adapters (counterpart of ``src/repro/core/metatt.py``).

One global tensor train parameterizes the low-rank update of every
adapted linear map:

  MetaTT-4D     ΔW[D_in, L, M, D_out]
  MetaTT-5D     ΔW[D_in, L, M, H, D_out/H]  (head axis)
  MetaTT-(4+1)D ΔW[D_in, L, T, M, D_out]   (task axis)
  MetaTT-(4+E)D ΔW[D_in, L, E, M, D_out]   (expert axis, the paper's §4
                "expert partitions"; MoE models)

The hot-path contraction merges the activation-independent middle cores
once (``step_factors``): C[l, (t|e,) m] = G2[l]·(G3[t|e]·)G3/4[m] (5D
also folds the head core into the right boundary), then per matrix
Δy = α·((x·G1)·C[l, (t|e,) m])·G4. Under 4+ed only the MoE expert
down-projection indexes the expert axis (by the expert that owns each
capacity block, ``models/moe.py``); every other matrix type reads expert
slice 0, or the slice a task index names, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.device import resolve_device

Params = dict  # {"cores": [c0, c1, ...]}


@dataclasses.dataclass(frozen=True)
class MetaTTConfig:
    """Static configuration of a MetaTT adapter (variants 4d, 5d, 4+1d
    and 4+ed). 5d: ``num_heads`` is the query head count and ``head_dim`` its
    width; matrix types with fewer output columns read the leading ones."""
    num_layers: int
    matrix_types: tuple
    d_in: tuple
    d_out: tuple
    rank: int
    variant: str = "4d"
    alpha: float = 1.0
    num_heads: int = 0
    head_dim: int = 0
    num_tasks: int = 0
    num_experts: int = 0
    init: str = ""
    dtype: Any = torch.float32

    @property
    def num_matrices(self) -> int:
        return len(self.matrix_types)

    @property
    def d_in_max(self) -> int:
        return max(self.d_in)

    @property
    def d_out_max(self) -> int:
        if self.variant == "5d":
            return self.num_heads * self.head_dim
        return max(self.d_out)

    @property
    def mode_sizes(self) -> tuple:
        L, M = self.num_layers, self.num_matrices
        if self.variant == "4d":
            return (self.d_in_max, L, M, self.d_out_max)
        if self.variant == "5d":
            return (self.d_in_max, L, M, self.num_heads, self.head_dim)
        if self.variant == "4+1d":
            return (self.d_in_max, L, self.num_tasks, M, self.d_out_max)
        if self.variant == "4+ed":
            return (self.d_in_max, L, self.num_experts, M, self.d_out_max)
        raise ValueError(f"unknown MetaTT variant {self.variant!r}")

    @property
    def default_init(self) -> str:
        return "-".join(["ze"] + ["id"] * (len(self.mode_sizes) - 1))

    @property
    def init_scheme(self) -> str:
        return self.init or self.default_init

    def m_index(self, name: str) -> int:
        return self.matrix_types.index(name)

    def num_params(self) -> int:
        shapes = self.mode_sizes
        d = len(shapes)
        bonds = [1] + [self.rank] * (d - 1) + [1]
        return int(sum(bonds[k] * shapes[k] * bonds[k + 1]
                       for k in range(d)))


# the paper's closed-form parameter counts (§2.4)

def paper_count_4d(D: int, L: int, M: int, r: int) -> int:
    """MetaTT-4D: 2Dr + (L+M)r²."""
    return 2 * D * r + (L + M) * r * r


def paper_count_5d(D: int, H: int, L: int, M: int, r: int) -> int:
    """MetaTT-5D: (D + D/H)r + (L+M+H)r²."""
    return (D + D // H) * r + (L + M + H) * r * r


def paper_count_lora(D: int, L: int, M: int, r: int) -> int:
    """LoRA: 2LMDr."""
    return 2 * L * M * D * r


def _init_core(generator, tok: str, shape, dtype, device):
    r_prev, n, r_next = shape
    if tok == "ze":
        return torch.zeros(shape, dtype=dtype, device=device)
    if tok == "id":
        if r_prev == 1:
            return torch.eye(n, r_next, dtype=dtype, device=device)[None]
        if r_next == 1:
            return torch.eye(r_prev, n, dtype=dtype,
                             device=device)[:, :, None]
        eye = torch.eye(r_prev, r_next, dtype=dtype, device=device)
        return eye[:, None, :].expand(shape).contiguous()
    if tok == "no":
        return 0.2 * torch.randn(shape, generator=generator, dtype=dtype,
                                 device=device)
    raise ValueError(f"unknown init token {tok!r}")


def init_params(cfg: MetaTTConfig, generator: Optional[torch.Generator]
                = None, *, device=None) -> Params:
    """Paper App. A.1 init; at least one zero core keeps ΔW == 0."""
    dev = resolve_device(device)
    shapes = cfg.mode_sizes
    d = len(shapes)
    toks = cfg.init_scheme.split("-")
    if len(toks) != d:
        raise ValueError(
            f"init scheme {cfg.init_scheme!r} has {len(toks)} tokens for a "
            f"{d}-core TT")
    if "ze" not in toks:
        raise ValueError(
            "at least one core must be zero-initialized so that ΔW == 0 at "
            "the start of fine-tuning (paper App. A.1)")
    bonds = [1] + [cfg.rank] * (d - 1) + [1]
    return {"cores": [
        _init_core(generator, toks[k], (bonds[k], shapes[k], bonds[k + 1]),
                   cfg.dtype, dev) for k in range(d)]}


@dataclasses.dataclass
class StepFactors:
    """g1 (d_in_max, r), c (L, [T|E,] M, r, r), g4 (r, d_out_max)."""
    g1: torch.Tensor
    c: Optional[torch.Tensor]
    g4: torch.Tensor


def step_factors(params: Params, cfg: MetaTTConfig) -> StepFactors:
    """Merge the middle cores once per step (activation-independent)."""
    cores = params["cores"]
    g1 = cores[0][0]
    if cfg.variant == "4d":
        c = torch.einsum("alb,bmc->lmac", cores[1], cores[2])
        g4 = cores[3][..., 0]
    elif cfg.variant == "5d":
        c = torch.einsum("alb,bmc->lmac", cores[1], cores[2])
        # the head core folds into the right boundary: (r, H, hd) -> (r, H·hd)
        bh = torch.einsum("chr,rd->chd", cores[3], cores[4][..., 0])
        g4 = bh.reshape(bh.shape[0], -1)
    elif cfg.variant in ("4+1d", "4+ed"):
        # order (D, L, T|E, M, D): C[l, t, m] = G2[l]·G3[t]·G4[m]
        c = torch.einsum("alb,btc,cmd->ltmad", cores[1], cores[2], cores[3])
        g4 = cores[4][..., 0]
    else:
        raise NotImplementedError(f"MetaTT variant {cfg.variant!r}")
    return StepFactors(g1=g1, c=c, g4=g4)


def _task_slice(c_l: torch.Tensor, cfg: MetaTTConfig, mi: int, task):
    """C[l, (t|e,) m]: scalar task -> (r, r); (B,) task vector -> (B, r,
    r). 4+ed reads expert slice 0 without a task (its expert axis is
    indexed by expert only inside the MoE layers)."""
    if cfg.variant == "4+1d":
        if task is None:
            raise ValueError("variant 4+1d needs a task index")
        return c_l[task, mi]
    if cfg.variant == "4+ed":
        return c_l[0 if task is None else task, mi]
    return c_l[mi]


def is_batched(task) -> bool:
    return isinstance(task, torch.Tensor) and task.ndim >= 1


def project_in(f: StepFactors, cfg: MetaTTConfig, x: torch.Tensor,
               m: str) -> torch.Tensor:
    """P = x · G1[:d_in(m)]."""
    d_in = cfg.d_in[cfg.m_index(m)]
    g1 = f.g1 if d_in == f.g1.shape[0] else f.g1[:d_in]
    return x @ g1.to(x.dtype)


def delta_out(f: StepFactors, cfg: MetaTTConfig, p: torch.Tensor,
              c_l: torch.Tensor, m: str, *,
              task: Union[torch.Tensor, int, None] = None) -> torch.Tensor:
    """α · (P · C[l, t(b), m]) · G4[:, :d_out(m)]; a (B,) task vector
    gathers one C slice per row (the engine's per-request routing)."""
    mi = cfg.m_index(m)
    c_lm = _task_slice(c_l, cfg, mi, task).to(p.dtype)
    d_out = cfg.d_out[mi]
    g4 = f.g4 if d_out == f.g4.shape[1] else f.g4[:, :d_out]
    if cfg.variant in ("4+1d", "4+ed") and is_batched(task):
        q = torch.einsum("b...r,brs->b...s", p, c_lm)
    else:
        q = p @ c_lm
    return cfg.alpha * (q @ g4.to(p.dtype))


def take_task_slice(c: torch.Tensor, task) -> torch.Tensor:
    """One task's column of the live factor ``StepFactors.c`` (L, T, M, r,
    r): the task mode is axis 1, and this (L, M, r, r) slice is all that
    one task adds to the shared TT (paper Eq. (4)/(6)). The serving
    adapter registry (serving/adapter_registry.py) pages these columns
    between the host and a fixed device slot pool."""
    return c[:, task]


def put_task_slice(pool: torch.Tensor, slot, col: torch.Tensor
                   ) -> torch.Tensor:
    """Write one task column into slot ``slot`` of a pooled factor (L, K,
    M, r, r), in place — the inverse of ``take_task_slice``. The pool's
    shape and storage never change. Returns ``pool``."""
    pool[:, slot].copy_(col, non_blocking=True)
    return pool


def apply(params: Params, cfg: MetaTTConfig, x: torch.Tensor, layer: int,
          m: str, *, task: Union[torch.Tensor, int, None] = None
          ) -> torch.Tensor:
    """The reference single-call path, α · x·G1·G2[l](·G3[t])·G3[m]·G4
    (Eq. (5)), through ``step_factors`` / ``project_in`` /
    ``delta_out``."""
    f = step_factors(params, cfg)
    return delta_out(f, cfg, project_in(f, cfg, x, m), f.c[layer], m,
                     task=task)


def materialize_delta(params: Params, cfg: MetaTTConfig, layer: int, m: str,
                      *, task: Optional[int] = None) -> torch.Tensor:
    """Dense ΔW_{l,m} (d_in(m), d_out(m)) — tests/small dims only."""
    mi = cfg.m_index(m)
    f = step_factors(params, cfg)
    c_lm = _task_slice(f.c[layer], cfg, mi, task)
    return cfg.alpha * (f.g1[: cfg.d_in[mi]] @ c_lm @ f.g4[:, : cfg.d_out[mi]])


def zero_at_init(params: Params, cfg: MetaTTConfig) -> bool:
    """The paper's init invariant: every ΔW slice is exactly zero."""
    f = step_factors(params, cfg)
    return bool(torch.all(f.g1 == 0) or torch.all(f.g4 == 0)
                or torch.all(f.c == 0))
