"""Inference-time core merging (paper §2.4; counterpart of
``src/repro/core/merge.py``).

"During inference, one can match the speeds of LoRA by adding a single
pre-computation step where one can merge the middle tensor cores with G1
or G4 once the adapters are trained."

``to_lora_form`` folds α and the middle cores into the left boundary: a
per-(layer[, task], matrix) A (d_in_max, r) and one shared B = G4, so the
serving "lora" runtime runs the same two rank-r products as LoRA.
``fold_into_dense`` goes one step further and adds ΔW into the frozen
weights (the "merged" runtime: no adapter work at serving time).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.metatt import MetaTTConfig, Params, step_factors


@dataclasses.dataclass
class LoRAForm:
    """Merged serving form, α folded into A."""
    a: torch.Tensor  # (L, [T,] M, d_in_max, r)
    b: torch.Tensor  # (r, d_out_max)

    def delta(self, cfg: MetaTTConfig, x, layer: int, m: str,
              task: Optional[int] = None):
        return lora_form_delta(self.a[layer], self.b, cfg, x, m, task=task)


def to_lora_form(params: Params, cfg: MetaTTConfig) -> LoRAForm:
    """A[l, (t,) m] = α·G1·C[l, (t,) m], B = G4. A is stored K-contiguous
    (each (d_in, r) slice the transposed view of a contiguous (r, d_in)),
    the layout K1 streams with 16-byte copies, as the live fold builds
    it (peft/api.py)."""
    f = step_factors(params, cfg)
    at = cfg.alpha * torch.einsum("dr,...rs->...sd", f.g1, f.c)
    return LoRAForm(a=at.contiguous().transpose(-1, -2), b=f.g4)


def lora_form_delta(a_l: torch.Tensor, b: torch.Tensor, cfg: MetaTTConfig,
                    x: torch.Tensor, m: str, *, task=None) -> torch.Tensor:
    """The delta from one layer's slice of ``to_lora_form`` factors:
    a_l ([T,] M, d_in_max, r), b (r, d_out_max); ``task`` a scalar or a
    per-request (B,) vector (4+1d routing; 4+ed reads expert slice 0
    without one)."""
    mi = cfg.m_index(m)
    if cfg.variant == "4+1d":
        if task is None:
            raise ValueError("variant 4+1d needs a task index")
        a = a_l[task, mi]
    elif cfg.variant == "4+ed":
        a = a_l[0 if task is None else task, mi]
    else:
        a = a_l[mi]
    a = a[..., : x.shape[-1], :].to(x.dtype)
    bb = b[:, : cfg.d_out[mi]].to(x.dtype)
    if a.ndim == 3:                   # (B, d_in, r): per-request task gather
        p = torch.einsum("b...d,bdr->b...r", x, a)
    else:
        p = x @ a
    return p @ bb


def lora_task_slice(a: torch.Tensor, task) -> torch.Tensor:
    """One task's column of a task-routed ``LoRAForm.a`` (L, T, M,
    d_in_max, r): the task mode is axis 1, as in the live factor."""
    return a[:, task]


def lora_task_put(pool: torch.Tensor, slot, col: torch.Tensor
                  ) -> torch.Tensor:
    """Write one lora-form task slice into slot ``slot`` of a pooled A
    (L, K, M, d_in_max, r), in place — the inverse of
    ``lora_task_slice``. Returns ``pool``."""
    pool[:, slot].copy_(col, non_blocking=True)
    return pool


def fold_into_dense(params: Params, cfg: MetaTTConfig, weights: dict, *,
                    task: Optional[int] = None, layers=None) -> dict:
    """A copy of ``weights`` (matrix type -> stacked (L', d_in, d_out))
    with ΔW added into each adapted matrix; ``layers`` names the global
    layer ids of the L' rows (None: 0 .. L - 1). The delta is cast to the
    weight's dtype and added there, as the JAX package does."""
    f = step_factors(params, cfg)
    c_full = f.c if layers is None else f.c[
        torch.as_tensor(list(layers), dtype=torch.long, device=f.c.device)]
    out = dict(weights)
    for mi, name in enumerate(cfg.matrix_types):
        if name not in weights:
            continue
        w = weights[name]
        c = c_full[:, task, mi] if task is not None else c_full[:, mi]
        delta = cfg.alpha * torch.einsum(
            "dr,lrs,se->lde", f.g1[: w.shape[1]], c, f.g4[:, : w.shape[2]])
        out[name] = w + delta.to(w.dtype)
    return out


# adapted matrix type -> (required mixer kind or None, block group, weight)
_FOLD_PATHS = {
    "attn_q": ("attn", "mixer", "wq"), "attn_k": ("attn", "mixer", "wk"),
    "attn_v": ("attn", "mixer", "wv"), "attn_o": ("attn", "mixer", "wo"),
    "xattn_q": (None, "xattn", "wq"), "xattn_k": (None, "xattn", "wk"),
    "xattn_v": (None, "xattn", "wv"), "xattn_o": (None, "xattn", "wo"),
    "ffn_gate": (None, "ffn", "wg"), "ffn_up": (None, "ffn", "wu"),
    "ffn_down": (None, "ffn", "wd"),
    "mamba_in": ("mamba", "mixer", "w_in"),
    "mamba_out": ("mamba", "mixer", "w_out"),
    "mlstm_q": ("mlstm", "mixer", "wq"), "mlstm_v": ("mlstm", "mixer", "wv"),
    "mlstm_o": ("mlstm", "mixer", "w_out"),
    "slstm_z": ("slstm", "mixer", "w_z"),
    "slstm_o": ("slstm", "mixer", "w_out"),
}


def _fold_block_list(params, cfg, blocks, pattern, layer_ids, task):
    """Fold ΔW into one block list (leaves (nb, d_in, d_out), one entry
    per pattern position; entry p holds layers p, P + p, 2P + p, ...)."""
    p_len = len(pattern)
    out = []
    for p, blk in enumerate(blocks):
        mixer_kind = pattern[p][0]
        nblk = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in blk.items()}
        weights, dests = {}, {}
        for name in cfg.matrix_types:
            req, grp, wn = _FOLD_PATHS[name]
            if req is not None and req != mixer_kind:
                continue
            if grp not in nblk or wn not in nblk[grp]:
                continue
            weights[name] = nblk[grp][wn]
            dests[name] = (grp, wn)
        if weights:
            merged = fold_into_dense(params, cfg, weights, task=task,
                                     layers=layer_ids[p::p_len])
            for name, (grp, wn) in dests.items():
                nblk[grp][wn] = merged[name]
        out.append(nblk)
    return out


def fold_transformer(params: Params, cfg: MetaTTConfig, base: dict,
                     model_cfg, *, task: Optional[int] = None) -> dict:
    """Fold ΔW into every adapted weight of a transformer base: all
    pattern positions and all super-blocks, and an encoder-decoder's
    encoder stack (layer ids 0 .. encoder_layers - 1; the decoder's
    follow them). Returns a new base tree. A
    4+1d (4+ed) adapter folds ONE task (expert) slice: ``task`` must be
    given; mixed-task serving needs the live or lora runtime. Every
    refusal raises before any weight is touched: ``moe_down`` (the
    expert banks) has no fold, nor have ``ffn_*`` adapters on a MoE
    block with shared experts."""
    unfoldable = [t for t in cfg.matrix_types if t not in _FOLD_PATHS]
    if unfoldable:
        raise ValueError(
            f"matrix types {unfoldable} cannot be folded into dense weights; "
            "serve them with the live or lora adapter runtime")
    if cfg.variant in ("4+1d", "4+ed") and task is None:
        raise ValueError(
            f"variant {cfg.variant} folds a single task/expert slice — pass "
            "task=<id> (mixed-task batches need the live/lora runtime)")
    if (any(f == "moe" and model_cfg.num_shared_experts
            for _, f in model_cfg.block_pattern)
            and any(t.startswith("ffn_") for t in cfg.matrix_types)):
        # the live path adapts the shared-expert FFN (models/moe.py runs
        # dense_ffn on s_wg / s_wu / s_wd): it has no fold, and skipping
        # it would silently diverge from live serving
        raise ValueError(
            "ffn_* adapters on a MoE block with shared experts cannot be "
            "folded; use the live or lora runtime")
    out = dict(base)
    off = model_cfg.encoder_layers if model_cfg.is_encdec else 0
    out["blocks"] = _fold_block_list(
        params, cfg, base["blocks"], model_cfg.block_pattern,
        list(range(off, off + model_cfg.num_layers)), task)
    if model_cfg.is_encdec and "enc_blocks" in base:
        # deferred: models.transformer -> peft.api -> core.merge is a cycle
        from repro_torch.models.transformer import ENC_PATTERN
        out["enc_blocks"] = _fold_block_list(
            params, cfg, base["enc_blocks"], ENC_PATTERN,
            list(range(model_cfg.encoder_layers)), task)
    return out
