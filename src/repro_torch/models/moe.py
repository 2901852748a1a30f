"""Mixture-of-Experts FFN (counterpart of ``src/repro/models/moe.py``, its
local path: one device owns every expert; expert parallelism is not
ported).

Routing is softmax top-k, renormalized. Dispatch is capacity-based
(GShard): token-expert pairs are sorted by expert, each expert takes up
to C = int(capacity_factor · pairs / E) of them as one slot block of a
batched (E, C, d) × (E, d, ff) product, and the pairs past C are dropped
(their share of the combine is an exact zero). So what one token gets
depends on every other row of the same call — inactive engine slots,
pad columns and prompt tails included — exactly as in the JAX package.

Ties are resolved as the JAX package does: ``jax.lax.top_k`` puts the
lower expert index first among equal probabilities, and ``jnp.argsort``
is stable. Here both are stable sorts (``torch.sort(stable=True)``,
descending for the top-k), which keep the same order on every device.

MetaTT-(4+E)D (paper §4, "expert partitions") adapts the expert
down-projection with a TT delta whose middle r × r core is indexed by the
expert that owns each capacity block: one small batched product a layer.
The expert products, the router and that delta are plain PyTorch, as
they are ``jnp.einsum`` outside any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import AdapterCtx, _gelu, _silu, dense_ffn
from repro_torch.peft import api as peft_api


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among ties (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router(x: torch.Tensor, w_router: torch.Tensor, n_k: int) -> tuple:
    """x (N, d) -> (logits f32 (N, E), probs, top_p (N, k), top_i (N, k)):
    the logits are the product in x's dtype, cast to f32."""
    logits = (x @ w_router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, n_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return logits, probs, top_p, top_i


def aux_losses(logits, probs, top_i, num_experts: int) -> dict:
    """The Switch / GShard load-balance and router-z losses."""
    n = probs.shape[0]
    onehot = torch.nn.functional.one_hot(top_i, num_experts).float()
    frac_tokens = onehot.sum((0, 1)) / (n * top_i.shape[-1])
    frac_probs = probs.mean(0)
    lb = num_experts * torch.sum(frac_tokens * frac_probs)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"load_balance": lb, "router_z": z}


def expert_delta(ctx: AdapterCtx, h: torch.Tensor, d_out: int):
    """The adapter's delta on the expert down-projection, h (E, C, ff) ->
    (E, C, d) or None. 4+ed indexes C's expert axis by the expert owning
    each capacity block; other adapters apply one uniform delta."""
    spec = ctx.spec
    if not spec.adapts("moe_down"):
        return None
    cfg = spec.cfg
    if spec.kind == "metatt" and cfg.variant == "4+ed":
        mi = cfg.m_index("moe_down")
        g1 = ctx.broadcast["g1"][:h.shape[-1]].to(h.dtype)
        g4 = ctx.broadcast["g4"][:, :d_out].to(h.dtype)
        c_e = ctx.layer["c"][:, mi].to(h.dtype)            # (E, r, r)
        return cfg.alpha * (torch.bmm(h @ g1, c_e) @ g4)
    if isinstance(ctx.task, torch.Tensor) and ctx.task.ndim >= 1:
        # h's leading axis is experts: a per-request (B,) task vector
        # cannot be gathered against it
        raise NotImplementedError(
            "per-request task vectors cannot index the expert-sorted "
            "moe_down delta; use a scalar task")
    return peft_api.adapter_delta(spec, ctx.broadcast, ctx.layer, h,
                                  "moe_down", task=ctx.task)


def capacity(cfg: ModelConfig, pairs: int) -> int:
    """Slots an expert takes: int(capacity_factor · pairs / E) in [1,
    pairs]."""
    cap = int(cfg.moe_capacity_factor * pairs / max(cfg.num_experts, 1))
    return max(min(cap, pairs), 1)


def dispatch_plan(top_i: torch.Tensor, num_experts: int, cap: int) -> tuple:
    """The capacity dispatch of the (N, k) routed experts, from a stable
    sort of the flat pairs by expert: ``src`` (E, C), the token that
    fills slot (e, c); ``slot_valid`` (E, C); and ``dest`` (N · k,), the
    flat slot each pair reads back in (token, k) order — ``E · C`` (a
    zero row) for a pair past its expert's capacity. Nothing here reads
    a device value back to the host."""
    n, k = top_i.shape
    pairs = n * k
    dev = top_i.device
    flat_e = top_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    experts = torch.arange(num_experts, device=dev, dtype=se.dtype)
    seg_start = torch.searchsorted(se, experts)
    group = torch.searchsorted(se, experts, right=True) - seg_start
    pos = torch.arange(pairs, device=dev) - seg_start[se]
    dest = torch.empty_like(order)
    dest[order] = torch.where(pos < cap, se * cap + pos,
                              torch.full_like(se, num_experts * cap))
    slots = torch.arange(cap, device=dev)
    src = (order // k)[(seg_start[:, None] + slots[None])
                       .clamp(0, pairs - 1)]
    slot_valid = slots[None] < group[:, None]
    return src, slot_valid, dest


def moe_block(x, top_p, top_i, w_g, w_u, w_d, ctx: AdapterCtx,
              cfg: ModelConfig) -> torch.Tensor:
    """Capacity-dispatched expert FFN over every expert: x (N, d) ->
    (N, d)."""
    n, k = top_i.shape
    d, n_e = x.shape[-1], cfg.num_experts
    cap = capacity(cfg, n * k)
    src, slot_valid, dest = dispatch_plan(top_i, n_e, cap)
    disp = torch.where(slot_valid[..., None], x[src],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    act = _silu if cfg.mlp == "swiglu" else _gelu
    h = (act(torch.bmm(disp, w_g.to(x.dtype)))
         * torch.bmm(disp, w_u.to(x.dtype)))
    y = torch.bmm(h, w_d.to(x.dtype))                  # (E, C, d)
    delta = expert_delta(ctx, h, d)
    if delta is not None:
        y = y + delta.to(y.dtype)
    y_flat = torch.cat([y.reshape(n_e * cap, d), y.new_zeros((1, d))])
    # dropped pairs read the zero row; the gate weights are cast to the
    # compute dtype before the product and the sum over k runs there, as
    # in the JAX package
    y_pairs = y_flat[dest] * top_p.reshape(-1, 1).to(y.dtype)
    return y_pairs.reshape(n, k, d).sum(dim=1).to(x.dtype)


def moe_ffn(x: torch.Tensor, w: dict, ctx: AdapterCtx,
            cfg: ModelConfig) -> tuple:
    """x (B, T, d) -> (y (B, T, d), aux); aux is {} unless
    ``cfg.moe_aux_weight`` > 0. Shared experts (kimi-k2) run as a dense
    FFN beside the routed ones."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    logits, probs, top_p, top_i = router(xf, w["router"],
                                         cfg.experts_per_token)
    aux = (aux_losses(logits, probs, top_i, cfg.num_experts)
           if cfg.moe_aux_weight > 0 else {})
    y = moe_block(xf, top_p, top_i, w["e_wg"], w["e_wu"], w["e_wd"], ctx,
                  cfg)
    if cfg.num_shared_experts:
        y = y + dense_ffn(xf, {"wg": w["s_wg"], "wu": w["s_wu"],
                               "wd": w["s_wd"]}, ctx, cfg.mlp)
    return y.reshape(b, t, d), aux
