"""Speculative multi-token decode with a rank-truncated TT self-drafter
(counterpart of ``src/repro/serving/speculative.py``).

TT bond ranks nest: the leading ``draft_rank`` bond columns of the shared
cores (``g1[:, :r']``, ``c[..., :r', :r']``, ``g4[:r', :]``, or the
lora-form A's last axis) are the truncation the paper's DMRG sweeps
optimise over, and make a drafter that shares the frozen base (every
``draft_layer_stride``-th super-block of it), the KV layout, the task
routing and the sampling configuration with the target model.

Drafter construction runs once, at engine build, on the engine's weights
(int8-packed leaves included): views, no copies. The accept rules run in
the engine's step on device tensors.

  * greedy — commit the longest draft prefix matching the verifier's
    per-column argmax, plus the verifier's own next token. Column i of
    the one-pass verification depends only on tokens <= i, so the
    committed stream is the non-speculative greedy stream for ANY
    drafter: drafter quality moves throughput, never tokens.
  * sampling — rejection sampling: accept d_j with probability
    min(1, p_{j-1}(d_j) / q_j(d_j)); at the first rejection emit from the
    residual norm(max(p - q, 0)); if every draft survives, a bonus token
    from p_k. The committed tokens' law is sampling from p directly. The
    draws come from an explicit ``torch.Generator``: the same law as the
    JAX package's, another random stream.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.config.base import SpecConfig
from repro_torch.tree import tree_map


def truncate_factors(kind: str, broadcast, per_layer, draft_rank: int):
    """Rank-truncate an ``AdapterRuntime``'s (broadcast, per_layer) factor
    bundle to TT bond rank ``draft_rank`` (0 keeps the full rank):
      * metatt live:      broadcast {"g1": (Din, r), "g4": (r, Dout)},
                          per_layer {"c": (L, [T,] M, r, r)};
      * metatt lora-form: broadcast {"g4": (r, Dout)},
                          per_layer {"a": (L, [T,] M, Din, r)};
      * plain lora:       per_layer {"a": (L, M, Din, r),
                                     "b": (L, M, r, Dout)}.
    Other kinds (vera, lotr, merged, none) come back unchanged: the
    drafter then keeps the target's full-rank factors."""
    if draft_rank <= 0:
        return broadcast, per_layer
    rd = draft_rank
    bc = dict(broadcast) if broadcast else {}
    pl = dict(per_layer) if per_layer else None
    if kind == "metatt" and pl is not None:
        if "g1" in bc:
            bc["g1"] = bc["g1"][:, :rd]
        if "g4" in bc:
            bc["g4"] = bc["g4"][:rd, :]
        if "c" in pl:
            pl["c"] = pl["c"][..., :rd, :rd]
        if "a" in pl:
            pl["a"] = pl["a"][..., :rd]
        return bc, pl
    if kind == "lora" and pl is not None and "a" in pl and "b" in pl:
        return bc, {"a": pl["a"][..., :rd], "b": pl["b"][..., :rd, :]}
    return broadcast, per_layer


def _num_blocks(base) -> int:
    return base["blocks"][0]["norm1"]["w"].shape[0]


def stride_base(base, stride: int) -> Tuple[Any, int]:
    """Keep every ``stride``-th super-block of the frozen base (int8
    {"q8", "scale"} leaves too; their leading axis is the super-block).
    Returns (draft base, its super-block count); embed and final_norm are
    the target's own tensors."""
    nb = _num_blocks(base)
    if stride <= 1:
        return base, nb
    draft = dict(base)
    draft["blocks"] = tree_map(lambda a: a[::stride], base["blocks"])
    return draft, len(range(0, nb, stride))


def stride_per_layer(per_layer, nb: int, p: int, stride: int):
    """The adapter's per-layer factors (leading axis L = nb · p) cut to
    the drafter's layers: L -> (nb, p), every stride-th super-block,
    flattened back."""
    if per_layer is None or stride <= 1:
        return per_layer

    def one(a):
        g = a.reshape((nb, p) + tuple(a.shape[1:]))[::stride]
        return g.reshape((-1,) + tuple(a.shape[1:]))
    return tree_map(one, per_layer)


def build_drafter(spec_cfg: SpecConfig, adapter_kind: str, base, broadcast,
                  per_layer, pattern_len: int) -> Tuple[Any, Any, Any, int]:
    """(draft base, draft broadcast, draft per_layer, draft super-block
    count): the weights the engine's drafter steps read."""
    bc, pl = truncate_factors(adapter_kind, broadcast, per_layer,
                              spec_cfg.draft_rank)
    dbase, nb = stride_base(base, spec_cfg.draft_layer_stride)
    pl = stride_per_layer(pl, _num_blocks(base), pattern_len,
                          spec_cfg.draft_layer_stride)
    return dbase, bc, pl, nb


def greedy_verify(draft: torch.Tensor,
                  verify_argmax: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """draft (B, k) proposals; verify_argmax (B, k+1) the per-column argmax
    of the one-pass verification (column i scored after token i of
    [committed, d_1..d_k]). Returns (emitted (B, k+1), n_accepted (B,)):
    the emitted stream is the verifier's argmax stream."""
    acc = (draft == verify_argmax[:, :-1]).long()
    return verify_argmax, torch.cumprod(acc, dim=1).sum(dim=1)


def rejection_verify(generator: Optional[torch.Generator],
                     draft: torch.Tensor, draft_probs: torch.Tensor,
                     target_probs: torch.Tensor) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Rejection-sampling accept. draft (B, k) with d_j ~ q_j;
    draft_probs (B, k, V) the q_j; target_probs (B, k+1, V) the target's
    p_0..p_k. Returns (emitted (B, k+1), n_accepted (B,)):
    emitted[:, :n] are the accepted drafts, emitted[:, n] the correction
    (or bonus) draw; columns past n repeat it."""
    b, k = draft.shape
    u = torch.rand((b, k), generator=generator, device=draft.device)
    p_at_d = torch.gather(target_probs[:, :k], 2, draft[..., None])[..., 0]
    q_at_d = torch.gather(draft_probs, 2, draft[..., None])[..., 0]
    acc = u < torch.clamp(p_at_d / q_at_d.clamp(min=1e-20), max=1.0)
    n = torch.cumprod(acc.long(), dim=1).sum(dim=1)                 # (B,)
    v = target_probs.shape[-1]
    p_n = torch.gather(target_probs, 1, n[:, None, None].expand(b, 1, v))[:, 0]
    q_n = torch.gather(draft_probs, 1, n.clamp(max=k - 1)[:, None, None]
                       .expand(b, 1, v))[:, 0]
    res = (p_n - torch.where((n < k)[:, None], q_n,
                             torch.zeros_like(q_n))).clamp(min=0.0)
    z = res.sum(dim=-1, keepdim=True)
    res = torch.where(z > 0, res / z.clamp(min=1e-20), p_n)
    corr = torch.multinomial(res, 1, generator=generator)[:, 0]
    cols = torch.arange(k + 1, device=draft.device)[None, :]
    dpad = torch.nn.functional.pad(draft, (0, 1))
    emitted = torch.where(cols < n[:, None], dpad, corr[:, None])
    return emitted, n


def column_penalty_masks(base_mask: Optional[torch.Tensor],
                         draft: torch.Tensor, vocab: int):
    """Per-column repetition-penalty masks for the one-pass verification:
    column i governs the token after d_1..d_i, so its set is the emitted
    history plus that in-chunk prefix. base_mask (B, V) or None; draft
    (B, k). Returns (B, k+1, V), or None without a penalty."""
    if base_mask is None:
        return None
    oh = torch.nn.functional.one_hot(draft, vocab).bool()          # (B, k, V)
    cum = torch.cumsum(oh.int(), dim=1) > 0
    cum = torch.nn.functional.pad(cum, (0, 0, 1, 0))               # col 0
    return base_mask[:, None, :] | cum
