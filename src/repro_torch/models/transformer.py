"""Decoder-LM / encoder-decoder assembly (counterpart of
``src/repro/models/transformer.py`` for decoders whose mixers are
attention, mamba, mLSTM or sLSTM, with a dense, a MoE or no FFN, and for
the encoder-decoder with an audio stub frontend: init, the encoder,
forward, dense caches and the decode step, paged block pools and the
co-batched paged step).

Weights keep the JAX package's layout so converted weights drop in: one
dict per pattern position in ``blocks``, each leaf stacked over the
``nb`` super-blocks. ``run_blocks`` is a Python loop over super-blocks and
pattern positions; layer ``l = sb * P + p`` reads adapter slice ``l``.
Caches mirror the blocks: an attention position's
``caches[p]["self"]["k"|"v"]`` is (nb, B, S, KV, hd), a mamba position's
``caches[p]["ssm"]`` holds "h" (nb, B, d_inner, d_state) f32 and "conv"
(nb, B, K - 1, d_inner) (``models/mamba.py``), an mLSTM position's
``caches[p]["mlstm"]`` and an sLSTM position's ``caches[p]["slstm"]``
their recurrent states (``models/xlstm.py``); decode writes into them in
place. An encoder-decoder keeps its encoder in ``enc_blocks`` (pattern
``ENC_PATTERN``, non-causal) and a cross-attention (``xattn``, after
``norm3``) in every decoder block; its adapter's layer axis holds the
encoder's layers first, the decoder's after them. Paged pools are (nb,
N, page, KV, hd), one block table shared by every layer, attention
models only; ``paged_step`` writes into them in place too. The training
forward builds no caches and may checkpoint each super-block
(``remat``), recomputing it in the backward. MoE blocks (``models/moe.py``) add their aux losses,
summed over layers, to ``ModelOutputs.aux`` (empty unless
``moe_aux_weight`` > 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (AdapterCtx, dense_ffn, embed_tokens,
                                       lm_logits, norm)
from repro_torch.sharding import get_serve_tp, serve_tp_gather, serve_tp_slice

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _linear_init(gen, d_in, d_out, nb, dtype, dev):
    """N(0, 1/d_in) in ``dtype``, drawn one super-block at a time: the f32
    draw of a whole stack would be twice the bf16 weights it makes
    (granite-34b's (88, 6144, 24576) up-projection: 53 GB)."""
    w = torch.empty((nb, d_in, d_out), device=dev, dtype=dtype)
    for i in range(nb):
        w[i] = torch.randn((d_in, d_out), generator=gen, device=dev,
                           dtype=torch.float32).div_(d_in ** 0.5)
    return w


def _norm_init(cfg: ModelConfig, nb, dev):
    if cfg.norm_kind == "layernorm":
        return {"w": torch.ones((nb, cfg.d_model), device=dev),
                "b": torch.zeros((nb, cfg.d_model), device=dev)}
    return {"w": torch.zeros((nb, cfg.d_model), device=dev)}


def _attn_init(cfg: ModelConfig, gen, nb, dtype, dev):
    return {
        "wq": _linear_init(gen, cfg.d_model, cfg.q_dim, nb, dtype, dev),
        "wk": _linear_init(gen, cfg.d_model, cfg.kv_dim, nb, dtype, dev),
        "wv": _linear_init(gen, cfg.d_model, cfg.kv_dim, nb, dtype, dev),
        "wo": _linear_init(gen, cfg.q_dim, cfg.d_model, nb, dtype, dev),
    }


def _ffn_init(cfg: ModelConfig, gen, nb, dtype, dev):
    d, ff = cfg.d_model, cfg.d_ff
    w = {}
    if cfg.mlp in ("swiglu", "geglu"):
        w["wg"] = _linear_init(gen, d, ff, nb, dtype, dev)
    w["wu"] = _linear_init(gen, d, ff, nb, dtype, dev)
    w["wd"] = _linear_init(gen, ff, d, nb, dtype, dev)
    return w


def _moe_init(cfg: ModelConfig, gen, nb, dtype, dev):
    """An f32 router, the expert banks (nb, E, d, ff) / (nb, E, ff, d)
    in ``dtype`` (drawn one expert of one super-block at a time: a whole
    f32 bank of kimi-k2's would be 22.5 GB a layer) and the shared
    experts' dense FFN."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def bank(d_in, d_out):
        w = torch.empty((nb, e, d_in, d_out), device=dev, dtype=dtype)
        for i in range(nb):
            for j in range(e):
                w[i, j] = torch.randn((d_in, d_out), generator=gen,
                                      device=dev, dtype=torch.float32
                                      ).div_(d_in ** 0.5)
        return w

    w = {"router": _linear_init(gen, d, e, nb, torch.float32, dev),
         "e_wg": bank(d, ff), "e_wu": bank(d, ff), "e_wd": bank(ff, d)}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        w["s_wg"] = _linear_init(gen, d, sff, nb, dtype, dev)
        w["s_wu"] = _linear_init(gen, d, sff, nb, dtype, dev)
        w["s_wd"] = _linear_init(gen, sff, d, nb, dtype, dev)
    return w


def _mamba_init(cfg: ModelConfig, gen, nb, dtype, dev):
    """The JAX package's mamba leaves: the linears N(0, 1/d_in), conv_w
    N(0, 1/K), zero biases, a_log = log(1..d_state) per channel and d = 1
    (both f32 whatever ``dtype``)."""
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, k = cfg.resolved_dt_rank, cfg.mamba_conv
    w_in = _linear_init(gen, cfg.d_model, 2 * di, nb, dtype, dev)
    conv_w = (torch.randn((nb, k, di), generator=gen, device=dev,
                          dtype=torch.float32) / k ** 0.5).to(dtype)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((nb, di), dtype=dtype, device=dev),
        "w_x": _linear_init(gen, di, dtr + 2 * ds, nb, dtype, dev),
        "w_dt": _linear_init(gen, dtr, di, nb, dtype, dev),
        "dt_bias": torch.zeros((nb, di), dtype=dtype, device=dev),
        "a_log": torch.log(a).expand(nb, di, ds).contiguous(),
        "d": torch.ones((nb, di), dtype=torch.float32, device=dev),
        "w_out": _linear_init(gen, di, cfg.d_model, nb, dtype, dev),
    }


def _mlstm_init(cfg: ModelConfig, gen, nb, dtype, dev):
    d, h = cfg.d_model, cfg.num_heads
    return {"wq": _linear_init(gen, d, d, nb, dtype, dev),
            "wk": _linear_init(gen, d, d, nb, dtype, dev),
            "wv": _linear_init(gen, d, d, nb, dtype, dev),
            "w_i": _linear_init(gen, d, h, nb, dtype, dev),
            "w_f": _linear_init(gen, d, h, nb, dtype, dev),
            "w_og": _linear_init(gen, d, d, nb, dtype, dev),
            "w_out": _linear_init(gen, d, d, nb, dtype, dev)}


def _slstm_init(cfg: ModelConfig, gen, nb, dtype, dev):
    """The JAX package's sLSTM leaves: the linears N(0, 1/d_in), the
    per-head recurrent matrices r_* (nb, H, hd, hd) N(0, 1/hd)."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    out = {n: _linear_init(gen, d, d, nb, dtype, dev)
           for n in ("w_z", "w_i", "w_f", "w_o", "w_out")}
    for n in ("r_z", "r_i", "r_f", "r_o"):
        out[n] = (torch.randn((nb, h, hd, hd), generator=gen, device=dev,
                              dtype=torch.float32) / hd ** 0.5).to(dtype)
    return out


_MIXER_INIT = {"attn": _attn_init, "mamba": _mamba_init,
               "mlstm": _mlstm_init, "slstm": _slstm_init}
#: each mixer's key in a position's decode cache
CACHE_KEY = {"attn": "self", "mamba": "ssm", "mlstm": "mlstm",
             "slstm": "slstm"}
#: the encoder's (fixed) super-block pattern, shared with
#: ``core/merge.py``'s whole-model fold
ENC_PATTERN = (("attn", "dense"),)


def check_supported(cfg: ModelConfig) -> None:
    """The port's model slice: attention, mamba, mLSTM or sLSTM mixers
    with a dense, a MoE or no FFN, decoder-only (with the ``patch_stub``
    prefix of patch embeddings, or none) or encoder-decoder (the audio
    stub frontend)."""
    for mixer, ffn in cfg.block_pattern:
        if mixer not in _MIXER_INIT or ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: block {(mixer, ffn)} is not ported yet "
                "(attention, mamba, mLSTM or sLSTM mixers with a dense, "
                "MoE or no FFN only)")
    if cfg.frontend not in ("none", "audio_stub", "patch_stub"):
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet")


def init_base_params(cfg: ModelConfig, generator: Optional[torch.Generator]
                     = None, *, device=None) -> dict:
    """Random stand-in for the frozen pre-trained weights, with the JAX
    package's distributions: embed N(0, 0.02²), linears N(0, 1/d_in),
    norms zero (rmsnorm scales by 1 + w). Drawn from ``generator`` on the
    target device (the JAX PRNG's numbers are not reproduced: tests carry
    JAX weights across with ``convert.from_jax_numpy``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.param_dtype
    embed = (torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                         device=dev, dtype=torch.float32) * 0.02).to(dtype)
    params = {"embed": {"tok": embed},
              "blocks": _block_init(cfg, cfg.block_pattern, generator,
                                    cfg.num_super_blocks, dtype, dev,
                                    decoder_cross=cfg.is_encdec),
              "final_norm": _norm_init(cfg, 1, dev)}
    if cfg.is_encdec:
        params["enc_blocks"] = _block_init(cfg, ENC_PATTERN, generator,
                                           cfg.encoder_layers, dtype, dev,
                                           decoder_cross=False)
        params["enc_final_norm"] = _norm_init(cfg, 1, dev)
    return params


def _block_init(cfg: ModelConfig, pattern, gen, nb, dtype, dev, *,
                decoder_cross: bool) -> list:
    """One dict per pattern position, leaves stacked over ``nb``; an
    encoder-decoder's decoder blocks add the cross-attention ("norm3",
    "xattn")."""
    blocks = []
    for mixer, ffn in pattern:
        blk: dict = {"norm1": _norm_init(cfg, nb, dev),
                     "mixer": _MIXER_INIT[mixer](cfg, gen, nb, dtype, dev)}
        if decoder_cross:
            blk["norm3"] = _norm_init(cfg, nb, dev)
            blk["xattn"] = _attn_init(cfg, gen, nb, dtype, dev)
        if ffn != "none":
            blk["norm2"] = _norm_init(cfg, nb, dev)
            blk["ffn"] = (_moe_init if ffn == "moe" else _ffn_init)(
                cfg, gen, nb, dtype, dev)
        blocks.append(blk)
    return blocks


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _at(tree, i):
    """Leaf-wise ``[i]`` over a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_at(v, i) for v in tree)
    return tree[i]


def _sublayer(h, blk, mixer, ffn, ctx: AdapterCtx, cfg: ModelConfig, *,
              positions, cache, cache_pos, block_tables=None,
              paged_write=None, causal=True, enc_out=None):
    hn = norm(h, blk["norm1"], cfg.norm_eps)
    if mixer == "mamba":
        y, c = mamba_lib.mamba_mixer(hn, blk["mixer"], ctx, cfg, cache=cache)
    elif mixer == "mlstm":
        y, c = xlstm_lib.mlstm_mixer(hn, blk["mixer"], ctx, cfg, cache=cache)
    elif mixer == "slstm":
        y, c = xlstm_lib.slstm_mixer(hn, blk["mixer"], ctx, cfg, cache=cache)
    else:
        y, c = attn_lib.attention(hn, blk["mixer"], ctx, cfg, causal=causal,
                                  positions=positions, cache=cache,
                                  cache_pos=cache_pos,
                                  block_tables=block_tables,
                                  paged_write=paged_write)
    h = h + y
    if "xattn" in blk and enc_out is not None:
        # cross-attention: k / v from the encoder output, no rope, not
        # causal; with no cross cache (JAX's init_caches has none) a
        # decode step recomputes them from ``enc_out``
        hn = norm(h, blk["norm3"], cfg.norm_eps)
        y, _ = attn_lib.attention(hn, blk["xattn"], ctx, cfg, causal=False,
                                  prefix="xattn", kv_x=enc_out)
        h = h + y
    aux = {}
    if ffn == "moe":
        hn = norm(h, blk["norm2"], cfg.norm_eps)
        y, aux = moe_lib.moe_ffn(hn, blk["ffn"], ctx, cfg)
        h = h + y
    elif ffn != "none":
        hn = norm(h, blk["norm2"], cfg.norm_eps)
        h = h + dense_ffn(hn, blk["ffn"], ctx, cfg.mlp)
    return h, c, aux


def run_blocks(h, blocks, pattern, spec, broadcast, per_layer,
               cfg: ModelConfig, *, causal: bool = True, positions=None,
               caches=None, cache_pos=None, enc_out=None,
               layer_offset: int = 0, task=None, policy=None,
               remat: bool = False, return_caches: bool = True,
               block_tables=None, paged_write=None):
    """Loop over super-blocks and pattern positions; layer ``sb · P + p``
    reads adapter slice ``layer_offset + sb · P + p`` (an enc-dec
    decoder's start after the encoder's), its cross-attention included.
    ``causal`` masks self-attention (False: the encoder); ``enc_out``
    feeds the decoder blocks' cross-attention. With ``caches``
    (decode) they are updated in place and returned; ``block_tables``
    (one (B, P) table shared by every layer) makes them paged pools, and
    ``paged_write`` is the step's precomputed write plan. Without them
    (prefill / training) the new k/v (a mamba position's state) are
    returned stacked like the blocks when ``return_caches``, else None;
    a position whose mixer returns no cache (the xLSTM parallel forms)
    gets ``{}``, as in JAX. ``remat`` checkpoints each
    super-block (``torch.utils.checkpoint``, non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, kernels included. Returns (h, caches, aux): aux holds each
    MoE aux loss summed over the layers (empty without them)."""
    if remat and (caches is not None or return_caches):
        raise ValueError("remat is a training option: no caches in or out")
    p_len = len(pattern)
    nb = blocks[0]["norm1"]["w"].shape[0]
    new = [[] for _ in range(p_len)]
    aux_layers = []

    def super_block(h, sb):
        out, aux = [], []
        for i, (mixer, ffn) in enumerate(pattern):
            layer = layer_offset + sb * p_len + i
            ly = None if per_layer is None else _at(per_layer, layer)
            ctx = AdapterCtx(spec, broadcast, ly, task, policy)
            cache = (None if caches is None
                     else _at(caches[i][CACHE_KEY[mixer]], sb))
            h, c, a = _sublayer(h, _at(blocks[i], sb), mixer, ffn, ctx, cfg,
                                positions=positions, cache=cache,
                                cache_pos=cache_pos,
                                block_tables=block_tables,
                                paged_write=paged_write, causal=causal,
                                enc_out=enc_out)
            out.append(c)
            aux.append(a)
        return h, out, aux

    def remat_block(h, sb):
        h, _, aux = super_block(h, sb)
        return h, aux

    for sb in range(nb):
        if remat:
            h, aux = checkpoint(remat_block, h, sb, use_reentrant=False)
            aux_layers += aux
            continue
        h, cs, aux = super_block(h, sb)
        aux_layers += aux
        if return_caches and caches is None:
            for i, c in enumerate(cs):
                new[i].append(c)
    aux = {k: torch.stack([a[k] for a in aux_layers if a]).sum()
           for k in next((a for a in aux_layers if a), {})}
    if caches is not None:
        return h, caches, aux
    if not return_caches:
        return h, None, aux
    stacked = [{} if cs[0] is None else
               {CACHE_KEY[mixer]: {k: torch.stack([c[k] for c in cs])
                                   for k in cs[0]}}
               for (mixer, _), cs in zip(pattern, new)]
    return h, stacked, aux


@dataclasses.dataclass(frozen=True)
class ModelOutputs:
    logits: torch.Tensor
    aux: dict
    caches: Any = None
    enc_out: Any = None


def _tokens(tokens, base, device) -> torch.Tensor:
    dev = resolve_device(device)
    emb = base["embed"]["tok"]
    if emb.device.type != dev.type:
        raise RuntimeError(f"weights are on {emb.device}, the call asks for "
                           f"{dev}")
    return torch.as_tensor(tokens, device=emb.device).long()


def encode(base, cfg: ModelConfig, enc_embeds, spec, broadcast, per_layer,
           *, policy=None) -> tuple:
    """The encoder over the stub frame embeddings ``enc_embeds`` (B, S,
    d): non-causal self-attention at rope positions 0 .. S - 1, adapter
    slices 0 .. encoder_layers - 1, no task (as in JAX). Returns
    (enc_out (B, S, d), aux)."""
    h = enc_embeds.to(cfg.compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, aux = run_blocks(h, base["enc_blocks"], ENC_PATTERN, spec,
                           broadcast, per_layer, cfg, causal=False,
                           positions=positions, policy=policy,
                           return_caches=False)
    return norm(h, _at(base["enc_final_norm"], 0), cfg.norm_eps), aux


def forward(base, cfg: ModelConfig, spec, broadcast, per_layer, tokens, *,
            embeds=None, enc_embeds=None, task=None, remat: bool = False,
            return_caches: bool = False, policy=None,
            device=None) -> ModelOutputs:
    """Train / prefill forward: tokens (B, T) -> ModelOutputs with
    (B, T, V) logits, and with ``return_caches`` the per-position caches a
    prefill hands to decode (k/v (nb, B, T, KV, hd); a mamba position's
    last state and conv window; ``{}`` for an xLSTM position). An
    encoder-decoder first encodes ``enc_embeds`` (B, S, d) (``encode``;
    ``ModelOutputs.enc_out``, which its decode steps take) and its decoder
    reads adapter slices from ``encoder_layers`` on. ``embeds`` (B, Tp, d),
    a VLM's patch embeddings, is cast to the compute dtype and prepended
    to the token embeddings: positions, logits and caches then cover the
    Tp + T rows, the prefix under the causal mask like any token.
    ``remat`` checkpoints each decoder super-block (training; the encoder
    is not, as in JAX).
    ``device`` is where the call runs (None: the CUDA device, raising
    without one)."""
    check_supported(cfg)
    tokens = _tokens(tokens, base, device)
    aux, enc_out, offset = {}, None, 0
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "enc_embeds")
        enc_out, aux = encode(base, cfg, torch.as_tensor(
            enc_embeds, device=tokens.device), spec, broadcast, per_layer,
            policy=policy)
        offset = cfg.encoder_layers
    h = embed_tokens(tokens, base["embed"]["tok"], cfg.compute_dtype)
    if embeds is not None:
        h = torch.cat([torch.as_tensor(embeds, device=h.device).to(h.dtype),
                       h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches, aux2 = run_blocks(h, base["blocks"], cfg.block_pattern, spec,
                                 broadcast, per_layer, cfg,
                                 positions=positions, enc_out=enc_out,
                                 layer_offset=offset, task=task,
                                 policy=policy, remat=remat,
                                 return_caches=return_caches)
    aux.update(aux2)
    h = norm(h, _at(base["final_norm"], 0), cfg.norm_eps)
    return ModelOutputs(logits=lm_logits(h, base["embed"]["tok"]), aux=aux,
                        caches=caches, enc_out=enc_out)


def init_caches(cfg: ModelConfig, batch: int, length: int, dtype, *,
                device=None, num_super_blocks: Optional[int] = None,
                shards: int = 1) -> list:
    """Zero dense caches, one per pattern position: {"self": {"k", "v"}}
    with leaves (nb, batch, length, KV, hd) for attention, {"ssm": {"h",
    "conv"}} with leaves (nb, batch, d_inner, d_state) f32 and (nb, batch,
    K - 1, d_inner) for mamba, {"mlstm": {"c", "n", "m"}} and {"slstm":
    {"h", "c", "n", "m"}} (f32) for the xLSTM mixers; an enc-dec decoder
    holds no cross-attention cache (its decode steps recompute the cross
    k / v from ``enc_out``, as JAX's do); ``num_super_blocks`` overrides
    nb (the speculative drafter's layer-strided region); ``shards`` > 1
    allocates one serve-TP rank's stripe of KV / shards kv-heads of an
    attention cache."""
    check_supported(cfg)
    nb = num_super_blocks or cfg.num_super_blocks
    dev = resolve_device(device)
    out = []
    for mixer, _ in cfg.block_pattern:
        if mixer == "mamba":
            c = mamba_lib.init_mamba_cache(cfg, nb * batch, dtype, dev)
        elif mixer == "mlstm":
            c = xlstm_lib.init_mlstm_cache(cfg, nb * batch, dev)
        elif mixer == "slstm":
            c = xlstm_lib.init_slstm_cache(cfg, nb * batch, dev)
        else:
            c = attn_lib.init_cache(cfg, nb * batch, length, dtype, dev,
                                    shards=shards)
        out.append({CACHE_KEY[mixer]: {k: v.view(nb, batch, *v.shape[1:])
                                       for k, v in c.items()}})
    return out


def insert_cache_slot(caches, req_caches, slot: int) -> list:
    """Write a batch-1 cache (leaves (nb, 1, T, KV, hd), T <= the slot
    width) into batch row ``slot`` of a decode cache, in place; cells past
    T are zeroed, as the JAX engine's padded prefill cache is."""
    for c, c1 in zip(caches, req_caches):
        for name in ("k", "v"):
            dst, src = c["self"][name], c1["self"][name]
            t = src.shape[2]
            dst[:, slot, :t] = src[:, 0].to(dst.dtype)
            dst[:, slot, t:] = 0
    return caches


def _serve_logits(h, embed) -> torch.Tensor:
    """The tied-embedding readout of the serving steps. Under serve TP
    (``sharding``) each rank computes its contiguous padded-vocab stripe
    (equal to those columns of the whole readout: splitting a GEMM by
    columns changes no element's reduction order) and the logits are
    all-gathered: the one all-gather of the step that is not per layer,
    (B, V) a token."""
    if not get_serve_tp():
        return lm_logits(h, embed)
    return serve_tp_gather(lm_logits(h, serve_tp_slice(embed, 0)),
                           h.ndim - 1)


def decode_step(base, cfg: ModelConfig, spec, broadcast, per_layer, token,
                caches, cache_pos, *, enc_out=None, task=None, policy=None,
                device=None, all_logits: bool = False):
    """One decode step: token (B, T) -> (logits (B, V), caches). cache_pos
    is a scalar or a (B,) vector of per-slot positions; token column j
    lands at cache_pos + j (the caches are updated in place; T > 1 only
    in the speculative verifier's pass, each column attending as a T == 1
    step would). An encoder-decoder takes the encoder output ``enc_out``
    (``forward(...).enc_out``): each decoder layer's cross-attention
    recomputes its k / v from it (as JAX does) and reads adapter slice
    ``encoder_layers`` + its layer. The logits are column 0's, or with
    ``all_logits`` every column's (B, T, V)."""
    check_supported(cfg)
    token = _tokens(token, base, device)
    h = embed_tokens(token, base["embed"]["tok"], cfg.compute_dtype)
    b, t = token.shape
    cp = torch.as_tensor(cache_pos, device=h.device).long()
    positions = (cp.reshape(-1, 1)
                 + torch.arange(t, device=h.device)[None]).expand(b, t)
    if cfg.is_encdec and enc_out is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder decode step needs "
                         "enc_out")
    h, caches, _ = run_blocks(h, base["blocks"], cfg.block_pattern, spec,
                              broadcast, per_layer, cfg, positions=positions,
                              caches=caches, cache_pos=cp, enc_out=enc_out,
                              layer_offset=cfg.encoder_layers, task=task,
                              policy=policy)
    h = norm(h, _at(base["final_norm"], 0), cfg.norm_eps)
    if all_logits:
        return _serve_logits(h, base["embed"]["tok"]), caches
    return _serve_logits(h[:, 0], base["embed"]["tok"]), caches


def init_paged_caches(cfg: ModelConfig, num_blocks: int, page_size: int,
                      dtype, *, kv_quant: bool = False, device=None,
                      num_super_blocks: Optional[int] = None,
                      shards: int = 1) -> list:
    """Zero paged pools, one {"self": {"k", "v"}} per pattern position,
    leaves (nb, num_blocks, page, KV, hd); ``kv_quant`` makes them int8
    and adds "k_s" / "v_s" f32 scale pools (nb, num_blocks, page, KV);
    ``num_super_blocks`` overrides nb (the speculative drafter's region);
    ``shards`` > 1 allocates one serve-TP rank's stripe of KV / shards
    kv-heads. Which request owns which block lives on the host
    (serving/block_manager.py). Attention models only: a mamba or xLSTM
    layer's state is not a paged KV pool."""
    check_supported(cfg)
    for m, _ in cfg.block_pattern:
        if m != "attn":
            raise NotImplementedError(
                f"{cfg.name}: paged pools need attention KV caches; mixer "
                f"{m!r} carries a recurrent state that cannot be paged")
    nb = num_super_blocks or cfg.num_super_blocks
    out = []
    for _ in cfg.block_pattern:
        c = attn_lib.init_paged_cache(cfg, nb * num_blocks, page_size, dtype,
                                      resolve_device(device),
                                      kv_quant=kv_quant, shards=shards)
        out.append({"self": {k: v.view(nb, num_blocks, *v.shape[1:])
                             for k, v in c.items()}})
    return out


def copy_cache_block(caches, src: int, dst: int) -> list:
    """Copy-on-write on the device: duplicate physical block ``src`` into
    ``dst`` across every layer of a paged cache (the int8 leg's scale
    pools too), in place. A ``dst`` >= N drops the copy (the JAX scatter's
    mode="drop")."""
    for c in caches:
        for leaf in c["self"].values():
            if 0 <= dst < leaf.shape[1]:
                leaf[:, dst] = leaf[:, src]
    return caches


def paged_step(base, cfg: ModelConfig, spec, broadcast, per_layer, toks,
               caches, block_tables, pos, sel, *, task=None, policy=None,
               device=None, all_logits: bool = False):
    """One co-batched decode / chunked-prefill step over a paged cache.

    toks: (B, C) — slot b's tokens at absolute positions pos[b] ..
    pos[b] + C - 1 (decode slots carry 1 real token, prefilling slots up
    to C prompt tokens; trailing columns past a slot's real count are pad
    whose cache writes are overwritten by the step that owns those
    positions, or dropped past the slot's allocation); block_tables:
    (B, P) int, sentinel >= N for unallocated pages; pos: (B,); sel: (B,)
    column whose logits to return (the slot's last real token). Returns
    (logits (B, V), caches), the pools updated in place; ``all_logits``
    returns every column's (B, C, V) instead (the speculative verifier;
    ``sel`` is ignored)."""
    check_supported(cfg)
    toks = _tokens(toks, base, device)
    dev = toks.device
    h = embed_tokens(toks, base["embed"]["tok"], cfg.compute_dtype)
    pos = torch.as_tensor(pos, device=dev).long()
    positions = pos[:, None] + torch.arange(toks.shape[1], device=dev)[None]
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    pool = caches[0]["self"]["k"]
    write = attn_lib.paged_write_plan(tables, positions, pool.shape[1],
                                      pool.shape[2])
    h, caches, _ = run_blocks(h, base["blocks"], cfg.block_pattern, spec,
                              broadcast, per_layer, cfg, positions=positions,
                              caches=caches, cache_pos=pos, task=task,
                              policy=policy, block_tables=tables,
                              paged_write=write)
    h = norm(h, _at(base["final_norm"], 0), cfg.norm_eps)
    if all_logits:
        return _serve_logits(h, base["embed"]["tok"]), caches
    sel = torch.as_tensor(sel, device=dev).long()
    h_sel = h[torch.arange(h.shape[0], device=dev), sel]           # (B, d)
    return _serve_logits(h_sel, base["embed"]["tok"]), caches
