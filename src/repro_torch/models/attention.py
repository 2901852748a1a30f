"""GQA attention with RoPE and a dense or paged KV cache, and
cross-attention (counterpart of ``src/repro/models/attention.py``: the
train / prefill / cross branch, the dense single-token decode branch and
the paged branch, each with serve-time tensor parallelism: under a
``sharding`` context the decode branches attend over this rank's
kv-head stripe and all-gather the heads, or, row-parallel, hand the
local heads to a row-sliced ``wo``).

The flash route sends prefill and cross-attention (non-causal, T ≠ S,
also at a decode step's T = 1) to kernel K3 (#5 / #6 / #7 under
autograd), dense decode to kernel K4 and paged steps to kernel #8 (#8q
over an int8 cache) through
``kernels/dispatch.py``; without it
(``KernelConfig(flash=False)``) attention is the plain softmax over the
full score matrix (for the paged cache, #8's plain version).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels import quant as quant_lib
from repro_torch.models.layers import (AdapterCtx, adapted_linear,
                                       apply_rope, serve_rp_linear)
from repro_torch.sharding import (get_serve_rp, serve_tp_gather,
                                  serve_tp_slice)

NEG_INF = -1e30


def _flash_ok(ctx: AdapterCtx) -> bool:
    return (ctx.policy or dispatch.DEFAULT).flash


def _softmax_attend(q, k, v, mask, scale):
    """q (B, T, KV, G, hd), k/v (B, S, KV, hd), mask broadcastable to
    (B, KV, G, T, S) -> (B, T, KV, G, hd); scores and softmax in f32."""
    s = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _causal_mask(t, s, device):
    qi = torch.arange(t, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    return (qi >= ki)[None, None, None]


def attention(x: torch.Tensor, w: dict, ctx: AdapterCtx, cfg: ModelConfig,
              *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              prefix: str = "attn",
              kv_x: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              paged_write=None):
    """Returns (y, new_cache). The projections are the matrix types
    ``<prefix>_q`` .. ``<prefix>_o`` ("xattn" for cross-attention).

    Cross-attention (``kv_x``, the encoder output (B, S, d)): k / v are
    projected from ``kv_x`` without rope (and q too), attention is
    non-causal over all S, and no cache is taken or returned: a decode
    step recomputes the cross k / v from ``kv_x``, as the JAX path does.

    Prefill (``cache is None``): attends the T new tokens and returns their
    k/v as the new cache. Decode (``cache`` given): writes the T new k/v
    into ``cache`` IN PLACE at row b, cells cache_pos[b] + j (cells past
    the cache end are dropped, as the JAX scatter's mode="drop" does);
    query column j attends cells [0, cache_pos[b] + j]; returns the same
    cache dict. Paged (
    ``block_tables`` given): ``cache`` holds flat (N, page, KV, hd) block
    pools and x is a (B, C) chunk of co-batched decode / prefill tokens at
    (B, C) ``positions``, written in place (see ``_paged_attend``;
    ``paged_write`` is the step's precomputed write plan).

    Serve TP (``sharding``): in both decode branches the cache holds this
    rank's contiguous stripe of KV/tp kv-heads; q / k / v are sliced to
    this rank's head group after RoPE (q heads stay aligned with their kv
    head: H/tp = G · KV/tp), attended, and the per-head outputs
    all-gathered before ``wo``, or under row_parallel kept local for the
    row-sliced ``wo`` and its all-reduce. Outside a context every slice
    and gather is the identity.
    """
    hd = cfg.resolved_head_dim
    n_h, n_kv = cfg.num_heads, cfg.num_kv_heads
    g = n_h // n_kv
    scale = hd ** -0.5
    b, t, _ = x.shape

    if kv_x is not None and cache is not None:
        raise ValueError("cross-attention keeps no cache: a decode step "
                         "recomputes its k / v from the encoder output")
    q = adapted_linear(x, w["wq"], ctx, f"{prefix}_q").reshape(
        b, t, n_h, hd)
    kv_in = x if kv_x is None else kv_x
    s_in = kv_in.shape[1]
    k = adapted_linear(kv_in, w["wk"], ctx, f"{prefix}_k").reshape(
        b, s_in, n_kv, hd)
    v = adapted_linear(kv_in, w["wv"], ctx, f"{prefix}_v").reshape(
        b, s_in, n_kv, hd)
    if kv_x is not None:
        out = _prefill_attend(q, k, v, ctx, False, scale)
        y = adapted_linear(out.reshape(b, t, n_h * hd), w["wo"], ctx,
                           f"{prefix}_o")
        return y, None
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if block_tables is not None:
        if cache is None or positions.ndim != 2:
            raise ValueError("paged attention needs a paged cache and "
                             "(B, C) positions")
        out = _paged_attend(serve_tp_slice(q, 2), serve_tp_slice(k, 2),
                            serve_tp_slice(v, 2), ctx, cache, block_tables,
                            positions, paged_write)
        return _tp_out_proj(out, w, ctx, prefix), cache
    if cache is not None:
        q, k, v = (serve_tp_slice(a, 2) for a in (q, k, v))
        n_kv = k.shape[2]           # this rank's kv heads
        # t > 1 is the speculative verifier's pass: column j of row b
        # lands at cache_pos[b] + j, and each column attends [0,
        # cache_pos[b] + j] through exactly the t == 1 code (one K4 launch
        # a column), after every column's k/v is written
        ck, cv = cache["k"], cache["v"]
        s_len = ck.shape[1]
        cp = torch.as_tensor(cache_pos, device=x.device).long()
        cp = cp.expand(b) if cp.ndim == 0 else cp
        rows = torch.arange(b, device=x.device)
        for j in range(t):
            # in-place cache write; a row whose position is past the end
            # keeps its old cell (the JAX scatter drops such writes)
            keep = (cp + j < s_len)[:, None, None]
            cell = (cp + j).clamp(max=s_len - 1)
            ck[rows, cell] = torch.where(keep, k[:, j].to(ck.dtype),
                                         ck[rows, cell])
            cv[rows, cell] = torch.where(keep, v[:, j].to(cv.dtype),
                                         cv[rows, cell])
        cols = []
        for j in range(t):
            if _flash_ok(ctx):
                cols.append(dispatch.decode_attention(
                    q[:, j:j + 1], ck, cv, cp + j, policy=ctx.policy))
            else:
                qh = q[:, j:j + 1].reshape(b, 1, n_kv, g, hd)
                mask = (torch.arange(s_len, device=x.device)[None, :]
                        <= (cp + j)[:, None])[:, None, None, None, :]
                cols.append(_softmax_attend(qh, ck, cv, mask, scale))
        out = torch.cat([c.reshape(b, 1, n_kv * g, hd) for c in cols],
                        dim=1)
        return _tp_out_proj(out, w, ctx, prefix), cache
    else:
        out = _prefill_attend(q, k, v, ctx, causal, scale).reshape(
            b, t, n_h * hd)
        new_cache = {"k": k, "v": v}
    y = adapted_linear(out, w["wo"], ctx, f"{prefix}_o")
    return y, new_cache


def _tp_out_proj(out, w, ctx: AdapterCtx, prefix: str) -> torch.Tensor:
    """The output projection of a decode branch over (B, T, H_local, hd)
    heads: all-gather the heads and run ``wo`` whole, or under
    row_parallel keep the local heads (contiguous heads meet contiguous
    ``wo`` rows) for the row-sliced ``wo`` and its all-reduce."""
    b, t = out.shape[:2]
    if get_serve_rp():
        return serve_rp_linear(out.reshape(b, t, -1), w["wo"], ctx,
                               f"{prefix}_o")
    out = serve_tp_gather(out, 2).reshape(b, t, -1)
    return adapted_linear(out, w["wo"], ctx, f"{prefix}_o")


def _prefill_attend(q, k, v, ctx: AdapterCtx, causal: bool, scale: float
                    ) -> torch.Tensor:
    """The train / prefill / cross branch: q (B, T, H, hd) against k / v
    (B, S, KV, hd). The flash route (K3, or #5 / #6 / #7 under autograd)
    takes it unless it is causal with T != S (as in JAX); else the plain
    softmax over the full score matrix."""
    b, t, n_h, hd = q.shape
    n_kv = k.shape[2]
    if _flash_ok(ctx) and (not causal or t == k.shape[1]):
        return dispatch.flash_attention(q, k, v, causal=causal,
                                        policy=ctx.policy)
    mask = _causal_mask(t, k.shape[1], q.device) if causal else None
    return _softmax_attend(q.reshape(b, t, n_kv, n_h // n_kv, hd), k, v,
                           mask, scale)


def paged_write_plan(block_tables, positions, n_blocks: int, page: int):
    """Where a (B, C) chunk's k/v land in the pools: (rows, blk, off) — the
    flat (b, c) rows whose cells are written, and their physical block and
    cell. Writes through a sentinel page (>= N) or past the table are
    DROPPED, not clamped (the JAX scatter's mode="drop"): clamping would
    overwrite block N-1, a live block of another request. The same plan
    serves every layer of a step (one host sync for the row count)."""
    tables = block_tables.to(device=positions.device, dtype=torch.long)
    p_tab = tables.shape[1]
    pidx = positions // page                                 # (B, C)
    blk = torch.gather(tables, 1, pidx.clamp(0, p_tab - 1))
    keep = (pidx < p_tab) & (blk >= 0) & (blk < n_blocks)
    rows = keep.reshape(-1).nonzero().squeeze(1)
    return (rows, blk.reshape(-1)[rows],
            (positions % page).reshape(-1)[rows])


def _paged_attend(q, k, v, ctx: AdapterCtx, cache: dict, block_tables,
                  positions, write) -> torch.Tensor:
    """Paged-cache step: scatter the chunk's k/v into the flat block pools
    by block table, IN PLACE, then attend with per-slot per-query position
    masks (#8).

    q (B, C, H, hd), k/v (B, C, KV, hd): projected and RoPE'd heads of
    the C co-batched tokens per slot, token c of slot b at absolute
    position positions[b, c]; cache: {"k", "v"} (N, page, KV, hd) pools
    shared by every slot, plus {"k_s", "v_s"} (N, page, KV) f32 scale
    pools when the cells are int8 (k and v are then quantized per cell at
    write time, and the scales go through the same write plan, so a
    dropped write drops its scale too); block_tables: (B, P) int,
    sentinel >= N for unallocated pages; write: the step's
    ``paged_write_plan``.

    Write-then-attend: a token's own k/v lands in its cell before the
    masked attention reads it, so cells holding stale data (pad columns of
    earlier steps) are always overwritten by the step that owns their
    position before any query's mask reaches them.
    """
    ck, cv = cache["k"], cache["v"]
    rows, blk, off = write
    k = k.reshape(-1, *k.shape[2:])[rows]
    v = v.reshape(-1, *v.shape[2:])[rows]
    scales = {}
    if "k_s" in cache:
        k, k_s = quant_lib.quantize_kv(k)
        v, v_s = quant_lib.quantize_kv(v)
        cache["k_s"][blk, off] = k_s
        cache["v_s"][blk, off] = v_s
        scales = dict(k_scale=cache["k_s"], v_scale=cache["v_s"])
    ck[blk, off] = k.to(ck.dtype)
    cv[blk, off] = v.to(cv.dtype)
    pol = ctx.policy if _flash_ok(ctx) else dispatch.REF
    return dispatch.paged_decode_attention(q, ck, cv, block_tables,
                                           positions[:, 0], policy=pol,
                                           **scales)


def _kv_heads(cfg: ModelConfig, shards: int) -> int:
    if cfg.num_kv_heads % shards:
        raise ValueError(f"num_kv_heads={cfg.num_kv_heads} does not split "
                         f"{shards} ways")
    return cfg.num_kv_heads // shards


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype,
               device, shards: int = 1) -> dict:
    """Zero dense k / v (batch, length, KV / shards, hd): ``shards`` > 1
    is one serve-TP rank's kv-head stripe."""
    shape = (batch, length, _kv_heads(cfg, shards), cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, page_size: int,
                     dtype, device, kv_quant: bool = False,
                     shards: int = 1) -> dict:
    """Flat per-layer KV block pool: (num_blocks, page, KV, hd). Which
    request owns which block lives on the host (serving/block_manager.py).
    ``kv_quant`` stores int8 cells plus f32 per-cell scale pools
    (``k_s`` / ``v_s``, (num_blocks, page, KV)) in the same block layout.
    ``shards`` > 1 holds one serve-TP rank's stripe of KV / shards heads.
    """
    shape = (num_blocks, page_size, _kv_heads(cfg, shards),
             cfg.resolved_head_dim)
    if kv_quant:
        z8 = dict(dtype=torch.int8, device=device)
        zs = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, **z8), "v": torch.zeros(shape, **z8),
                "k_s": torch.zeros(shape[:-1], **zs),
                "v_s": torch.zeros(shape[:-1], **zs)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
