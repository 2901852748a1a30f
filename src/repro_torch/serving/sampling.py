"""Token sampling for the serving decode loop (counterpart of
``src/repro/serving/sampling.py``).

``process_logits`` is the one logits transform (repetition penalty ->
temperature -> top-k / top-p); ``sample`` draws from it with the engine's
``torch.Generator``. Greedy is generator-free and so token-identical to
the JAX package; the other methods draw from the same distributions with
another random stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """method: "greedy" | "temperature" | "top_k" | "top_p".
    ``repetition_penalty`` (CTRL-style) composes with every method: logits
    of already-emitted ids are divided by it when positive and multiplied
    when negative. 1.0 disables it."""
    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0

    def validate(self) -> "SamplingConfig":
        if self.method not in ("greedy", "temperature", "top_k", "top_p"):
            raise ValueError(f"unknown sampling method {self.method!r}")
        if self.method == "top_k" and self.top_k <= 0:
            raise ValueError("top_k sampling needs top_k >= 1")
        if self.method == "top_p" and not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p sampling needs 0 < top_p <= 1 (got {self.top_p})")
        if self.method != "greedy" and self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty={self.repetition_penalty} must be > 0 "
                "(1.0 disables it)")
        return self


def _top_p_mask(lg: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the highest-probability tokens whose cumulative mass BEFORE
    each token is < p (the top-1 token always survives)."""
    srt = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < p
    nkeep = keep.sum(dim=-1, keepdim=True).clamp(min=1)
    thresh = torch.gather(srt, -1, nkeep - 1)
    return torch.where(lg >= thresh, lg, torch.full_like(lg, NEG_INF))


def process_logits(logits: torch.Tensor, cfg: SamplingConfig, *,
                   penalty_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The logits transform the sampler draws from, in f32, any (..., V)."""
    lg = logits.float()
    if penalty_mask is not None and cfg.repetition_penalty != 1.0:
        rp = cfg.repetition_penalty
        pen = torch.where(lg > 0, lg / rp, lg * rp)
        lg = torch.where(penalty_mask, pen, lg)
    if cfg.method == "greedy":
        return lg
    lg = lg / cfg.temperature
    if cfg.method == "top_k":
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    elif cfg.method == "top_p":
        lg = _top_p_mask(lg, cfg.top_p)
    return lg


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplingConfig, *,
           penalty_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) -> sampled token ids (B,) int64."""
    lg = process_logits(logits, cfg, penalty_mask=penalty_mask)
    if cfg.method == "greedy":
        return torch.argmax(lg, dim=-1)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def token_probs(logits: torch.Tensor, cfg: SamplingConfig, *,
                penalty_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The exact (..., V) distribution ``sample`` draws from (greedy: a
    one-hot at the argmax)."""
    lg = process_logits(logits, cfg, penalty_mask=penalty_mask)
    if cfg.method == "greedy":
        return torch.nn.functional.one_hot(
            torch.argmax(lg, dim=-1), lg.shape[-1]).float()
    return torch.softmax(lg, dim=-1)


def history_mask(out: torch.Tensor, widx: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, cap) emitted-token buffer + (B,) valid counts -> (B, V) bool mask
    of already-emitted ids; columns >= widx[b] are ignored."""
    b, cap = out.shape
    valid = (torch.arange(cap, device=out.device)[None, :]
             < widx[:, None]).int()
    hits = torch.zeros((b, vocab), dtype=torch.int32, device=out.device)
    hits.scatter_add_(1, out.long().clamp(0, vocab - 1), valid)
    return hits > 0
