"""Model-level API (counterpart of ``src/repro/models/model.py``):
adapter-spec construction, init, parameter counts and the PEFT training
objective (next-token CE over the frozen base plus the adapter)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.core.metatt import MetaTTConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.peft import api as peft_api
from repro_torch.peft.lora import LoRAConfig
from repro_torch.peft.lotr import LoTRConfig
from repro_torch.peft.vera import VeRAConfig
from repro_torch.tree import leaves


def matrix_dims(cfg: ModelConfig) -> dict:
    """matrix type -> (d_in, d_out) for every adaptable linear map of the
    models the port runs (attention, mamba, mLSTM and sLSTM mixers, an
    encoder-decoder's cross-attention ``xattn_*``, dense FFN or MoE;
    ``ffn_*`` of a MoE model are its shared experts, ``moe_down`` its
    expert down-projections)."""
    transformer.check_supported(cfg)
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    mixers = {m for m, _ in cfg.block_pattern}
    out = {}
    if "attn" in mixers or cfg.is_encdec:
        out.update({"attn_q": (d, q), "attn_k": (d, kv), "attn_v": (d, kv),
                    "attn_o": (q, d)})
    if cfg.is_encdec:
        out.update({"xattn_q": (d, q), "xattn_k": (d, kv),
                    "xattn_v": (d, kv), "xattn_o": (q, d)})
    if "mamba" in mixers:
        di = cfg.mamba_d_inner
        out.update({"mamba_in": (d, 2 * di), "mamba_out": (di, d)})
    if "mlstm" in mixers:
        out.update({"mlstm_q": (d, d), "mlstm_v": (d, d), "mlstm_o": (d, d)})
    if "slstm" in mixers:
        out.update({"slstm_z": (d, d), "slstm_o": (d, d)})
    if ff:
        out.update({"ffn_gate": (d, ff), "ffn_up": (d, ff),
                    "ffn_down": (ff, d)})
    if any(f == "moe" for _, f in cfg.block_pattern):
        out["moe_down"] = (ff, d)
    return out


def default_matrices(cfg: ModelConfig, variant: str = "4d") -> tuple:
    """Paper default: attention q/v (App. A.2), an encoder-decoder's
    cross-attention q / v beside them, and the JAX package's extensions
    for blocks without attention: a mamba model's in / out projections,
    an xLSTM model's mLSTM q / v and sLSTM z; 4+ed adds the expert
    down-projection, the matrix its expert axis indexes."""
    transformer.check_supported(cfg)
    mixers = {m for m, _ in cfg.block_pattern}
    out = ()
    if "attn" in mixers or cfg.is_encdec:
        out += ("attn_q", "attn_v")
    if cfg.is_encdec:
        out += ("xattn_q", "xattn_v")
    if "mamba" in mixers:
        out += ("mamba_in", "mamba_out")
    if "mlstm" in mixers:
        out += ("mlstm_q", "mlstm_v")
    if "slstm" in mixers:
        out += ("slstm_z",)
    return out + (("moe_down",) if variant == "4+ed" else ())


def build_adapter_spec(run: RunConfig) -> peft_api.AdapterSpec:
    """The adapter a RunConfig names: MetaTT (4d, 5d, 4+1d, 4+ed), LoRA,
    VeRA or LoTR over the adapted matrix types, with their per-type
    dims."""
    cfg = run.model
    if run.adapter_kind == "none":
        return peft_api.NONE
    types = run.adapter_matrices or default_matrices(cfg,
                                                     run.adapter_variant)
    dims = matrix_dims(cfg)
    unknown = [t for t in types if t not in dims]
    if unknown:
        raise ValueError(f"{cfg.name}: matrix types {unknown} not present")
    d_in = tuple(dims[t][0] for t in types)
    d_out = tuple(dims[t][1] for t in types)
    common = dict(num_layers=cfg.total_layers, matrix_types=tuple(types),
                  d_in=d_in, d_out=d_out, rank=run.adapter_rank)
    if run.adapter_kind == "metatt":
        extra = {}
        if run.adapter_variant == "5d":
            if max(d_out) > cfg.q_dim:
                raise ValueError(
                    "5d head-factorized output requires all adapted out dims "
                    f"<= H*head_dim={cfg.q_dim}")
            extra = dict(num_heads=cfg.num_heads,
                         head_dim=cfg.resolved_head_dim)
        elif run.adapter_variant == "4+1d":
            extra = dict(num_tasks=max(run.num_tasks, 1))
        elif run.adapter_variant == "4+ed":
            extra = dict(num_experts=cfg.num_experts)
        elif run.adapter_variant != "4d":
            raise ValueError(
                f"unknown MetaTT variant {run.adapter_variant!r}")
        acfg = MetaTTConfig(**common, variant=run.adapter_variant,
                            alpha=run.adapter_alpha, **extra)
    elif run.adapter_kind == "lora":
        acfg = LoRAConfig(**common, alpha=run.adapter_alpha * run.adapter_rank)
    elif run.adapter_kind == "vera":
        acfg = VeRAConfig(**common)
    elif run.adapter_kind == "lotr":
        acfg = LoTRConfig(**common, alpha=run.adapter_alpha)
    else:
        raise ValueError(f"unknown adapter kind {run.adapter_kind!r}")
    return peft_api.AdapterSpec(kind=run.adapter_kind, cfg=acfg)


def init_params(cfg: ModelConfig, spec: peft_api.AdapterSpec,
                generator: Optional[torch.Generator] = None, *,
                device=None) -> dict:
    """{"base", "adapter", "frozen"}, drawn from ``generator`` on
    ``device`` (None: the CUDA device, raising without one)."""
    dev = resolve_device(device)
    base = transformer.init_base_params(cfg, generator, device=dev)
    adapter, frozen = peft_api.init_adapter(spec, generator, device=dev)
    return {"base": base, "adapter": adapter, "frozen": frozen}


tensors = leaves  # every tensor leaf of a nested dict/list


def count_params(params: dict) -> dict:
    def n(tree):
        return int(sum(t.numel() for t in tensors(tree)))
    return {"base": n(params["base"]), "adapter": n(params["adapter"]),
            "frozen_adapter": n(params["frozen"])}


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    prefix_len: int = 0,
                    vocab_size: int = 0) -> torch.Tensor:
    """Next-token CE. logits (B, Tp + T, V) (Tp = ``prefix_len``, a VLM
    prefix of patch embeddings), tokens (B, T), mask (B, T) gating the
    prediction OF token j. Roll-and-mask form, as in the JAX package:
    the tokens are padded with Tp zeros in front, position p's target is
    token p+1 by a roll, and a position counts from max(Tp - 1, 0) to
    Tp + T - 2 (the last patch position predicts text token 0); the mask
    is padded with Tp ones and rolled the same way. f32 logsumexp; logit
    columns past ``vocab_size`` (the padded embedding rows) are masked to
    -1e30. The f32 copy of the logits is the only full-size temporary
    autograd keeps (for the logsumexp backward); the bf16 → f32 cast is
    freed once masked."""
    b, t = tokens.shape
    t_full = logits.shape[1]
    if prefix_len:
        tokens = torch.cat([tokens.new_zeros((b, prefix_len)), tokens], 1)
    targets = torch.roll(tokens, -1, dims=1)
    pos = torch.arange(t_full, device=tokens.device)
    valid = ((pos >= max(prefix_len - 1, 0))
             & (pos < prefix_len + t - 1)).float()
    valid = valid[None].expand(b, t_full)
    if mask is not None:
        m = mask.float()
        if prefix_len:
            m = torch.cat([m.new_ones((b, prefix_len)), m], 1)
        valid = valid * torch.roll(m, -1, dims=1)
    lg = logits.float()
    if vocab_size and logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=lg.device) >= vocab_size
        lg = lg.masked_fill(pad, -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    true = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    nll = (lse - true) * valid
    return nll.sum() / valid.sum().clamp(min=1.0)


def loss_fn(adapter, base, frozen, batch: dict, cfg: ModelConfig,
            spec: peft_api.AdapterSpec, *, remat: bool = False,
            aux_weight: Optional[float] = None, policy=None,
            device=None) -> tuple:
    """PEFT objective: (CE + aux_weight · Σ MoE aux losses, {"ce", aux
    terms}). ``aux_weight`` defaults to ``cfg.moe_aux_weight``; the aux
    terms (load balance, router z, each summed over layers) exist when
    ``cfg.moe_aux_weight`` > 0. Differentiate it with respect to the
    ``adapter`` tensors only; the base weights carry no grad. ``batch``:
    tokens (B, T), optional mask (B, T) and task, an encoder-decoder's
    enc_embeds (B, S, d), and a VLM's prefix ``embeds`` (B, Tp, d), whose
    Tp positions the loss skips (``next_token_loss(prefix_len=Tp)``)."""
    bc, per_layer = peft_api.adapter_factors(spec, adapter, frozen)
    out = transformer.forward(base, cfg, spec, bc, per_layer,
                              batch["tokens"], embeds=batch.get("embeds"),
                              enc_embeds=batch.get("enc_embeds"),
                              task=batch.get("task"), remat=remat,
                              policy=policy, device=device)
    prefix = 0 if batch.get("embeds") is None else batch["embeds"].shape[1]
    loss = next_token_loss(out.logits, batch["tokens"], batch.get("mask"),
                           prefix, vocab_size=cfg.vocab_size)
    if not out.aux:
        return loss, {"ce": loss}
    aux_weight = cfg.moe_aux_weight if aux_weight is None else aux_weight
    return (loss + aux_weight * sum(out.aux.values()),
            {"ce": loss, **out.aux})
