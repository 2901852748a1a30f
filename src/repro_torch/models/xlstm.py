"""xLSTM mixers: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, sequential) — Beck et al. 2024 (arXiv:2405.04517); counterpart
of ``src/repro/models/xlstm.py``.

The JAX mixers call no Pallas kernel beyond ``adapted_linear``, and
neither do these: the adapted projections (``mlstm_q`` / ``mlstm_v`` /
``mlstm_o``, ``slstm_z`` / ``slstm_o``) run K1 (K2 under a per-row task
vector) through ``adapted_linear``; every other projection is a plain
matmul and everything between them is torch ops. Hand-written kernels
for the recurrences are later speed work (ROADMAP).

mLSTM train / prefill is the stabilised parallel form: the log-gate
matrix D[t, s] = F[t] - F[s] + i[s] (s <= t, F the cumulative log forget
gate, ``NEG_INF`` above the diagonal), query-chunked as JAX chunks it
(only when ``t % chunk == 0 and t > chunk``), each chunk checkpointed
while autograd records (JAX's ``jax.checkpoint`` inside ``lax.map``).
Decode is the O(1) recurrent form over C (B, H, hd, hd), n (B, H, hd)
and m (B, H), all f32.

sLSTM is sequential: a Python loop over T (JAX's ``lax.scan``; its
``unroll`` changes nothing numerically) with the per-head recurrent
mixing R·h_{t-1} and the exponential-gate stabiliser m_t; the four
x-projections are hoisted out of the loop as batched GEMMs, and the four
recurrent matrices are applied in one product a step. Under autograd the
loop is one Function (``_SLSTMLoop``) whose backward runs the loop in
reverse by hand: autograd would record ~20 nodes a step.

The parallel forms return no cache (as in JAX): an xLSTM model decodes
from ``init_mlstm_cache`` / ``init_slstm_cache`` zeros, one token at a
time; a decode step updates the cache's tensors in place.

Every cast is the JAX mixer's: q and k go to f32 for the parallel form
while v stays in the compute dtype (the scores are cast to v's dtype
before the second product); the gate pre-activations are the
compute-dtype products cast to f32; the output gate ``o`` is a
compute-dtype sigmoid applied after h is cast back to the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import AdapterCtx, adapted_linear

NEG_INF = -1e30


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def _mlstm_block(qc, fc, off: int, k, v, fcum, i_raw):
    """Queries qc (B, c, H, hd) f32 at positions off .. off + c - 1 with
    their cumulative log forget gates fc (B, c, H), against every key:
    k (B, T, H, hd) f32, v (B, T, H, hd), fcum / i_raw (B, T, H) f32."""
    t, hd = k.shape[1], k.shape[-1]
    dmat = (fc[:, :, None, :] - fcum[:, None, :, :]
            + i_raw[:, None, :, :])                      # (B, c, T, H)
    qi = torch.arange(qc.shape[1], device=qc.device)[:, None] + off
    ki = torch.arange(t, device=qc.device)[None, :]
    dmat = torch.where((qi >= ki)[None, :, :, None], dmat,
                       torch.full_like(dmat, NEG_INF))
    m = dmat.amax(dim=2, keepdim=True)                   # (B, c, 1, H)
    s = torch.einsum("bthd,bshd->btsh", qc, k) * hd ** -0.5
    s = s * torch.exp(dmat - m)
    n = torch.maximum(s.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))
    out = torch.einsum("btsh,bshd->bthd", s.to(v.dtype), v)
    return out / n[..., None].to(v.dtype)


def _mlstm_parallel(q, k, v, i_raw, logf, chunk: int) -> torch.Tensor:
    """Stabilised parallel form. q, k (B, T, H, hd) f32, v (B, T, H, hd);
    i_raw / logf (B, T, H) f32 -> (B, T, H, hd) in v's dtype."""
    t = q.shape[1]
    fcum = torch.cumsum(logf, dim=1)                     # (B, T, H)
    if not (chunk and t % chunk == 0 and t > chunk):
        return _mlstm_block(q, fcum, 0, k, v, fcum, i_raw)
    record = torch.is_grad_enabled() and any(
        a.requires_grad for a in (q, k, v, i_raw, logf))
    outs = []
    for off in range(0, t, chunk):
        args = (q[:, off:off + chunk], fcum[:, off:off + chunk], off, k, v,
                fcum, i_raw)
        outs.append(checkpoint(_mlstm_block, *args, use_reentrant=False)
                    if record else _mlstm_block(*args))
    return torch.cat(outs, dim=1)


def _mlstm_step(cache: dict, q, k, v, i_raw, logf) -> torch.Tensor:
    """The recurrent form, one step, the cache updated in place. q, k, v
    (B, H, hd) f32; i_raw / logf (B, H) f32 -> h (B, H, hd) f32."""
    c_prev, n_prev, m_prev = cache["c"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m_prev, i_raw)          # (B, H)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf + m_prev - m_new)
    c_new = (f_s[..., None, None] * c_prev
             + i_s[..., None, None] * v[..., :, None] * k[..., None, :])
    n_new = f_s[..., None] * n_prev + i_s[..., None] * k
    qs = q * q.shape[-1] ** -0.5
    num = torch.einsum("bhde,bhe->bhd", c_new, qs)
    # the state is implicitly scaled by exp(-m): the max-with-1 of the
    # unstabilised form becomes max(|nᵀq|, exp(-m))
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, qs).abs(),
                        torch.exp(-m_new))
    cache["c"].copy_(c_new)
    cache["n"].copy_(n_new)
    cache["m"].copy_(m_new)
    return num / den[..., None]


def mlstm_mixer(x: torch.Tensor, w: dict, ctx: AdapterCtx, cfg: ModelConfig,
                *, cache: Optional[dict] = None, chunk: int = 256) -> tuple:
    """x (B, T, d) -> (y, new_cache): the parallel form without ``cache``
    (new_cache None, as in JAX), one recurrent step (T = 1) with it (the
    cache updated in place and returned)."""
    b, t, d = x.shape
    n_h = cfg.num_heads
    hd = d // n_h
    q = adapted_linear(x, w["wq"], ctx, "mlstm_q").reshape(b, t, n_h, hd)
    k = (x @ w["wk"].to(x.dtype)).reshape(b, t, n_h, hd)
    v = adapted_linear(x, w["wv"], ctx, "mlstm_v").reshape(b, t, n_h, hd)
    i_raw = (x @ w["w_i"].to(x.dtype)).float()           # (B, T, H)
    logf = F.logsigmoid((x @ w["w_f"].to(x.dtype)).float())
    o = torch.sigmoid(x @ w["w_og"].to(x.dtype))
    if cache is None:
        h = _mlstm_parallel(q.float(), k.float(), v, i_raw, logf, chunk)
        new_cache = None
    else:
        h = _mlstm_step(cache, q[:, 0].float(), k[:, 0].float(),
                        v[:, 0].float(), i_raw[:, 0], logf[:, 0])[:, None]
        new_cache = cache
    h = h.reshape(b, t, d).to(x.dtype) * o
    return adapted_linear(h, w["w_out"], ctx, "mlstm_o"), new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero decode state: "c" (batch, H, hd, hd), "n" (batch, H, hd),
    "m" (batch, H) at ``NEG_INF``, all f32."""
    n_h = cfg.num_heads
    hd = cfg.d_model // n_h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, n_h, hd, hd), **f32),
            "n": torch.zeros((batch, n_h, hd), **f32),
            "m": torch.full((batch, n_h), NEG_INF, **f32)}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def _slstm_step(carry: tuple, pre_x: torch.Tensor, r_all: torch.Tensor
                ) -> tuple:
    """One step. carry (h, c, n, m), each (H, B, hd) f32; pre_x (H, B, 4,
    hd) f32, the hoisted z / i / f / o x-projections; r_all (H, hd, 4·hd)
    f32, the recurrent matrices side by side (one batched product a step
    adds R·h to all four). Returns the new carry and what the backward of
    ``_SLSTMLoop`` reads: (z, i_s, f_s, o, f_raw)."""
    h, c, n, m = carry
    n_h, b, hd = h.shape
    pre = torch.baddbmm(pre_x.reshape(n_h, b, 4 * hd), h, r_all).view(
        n_h, b, 4, hd)
    z = torch.tanh(pre[:, :, 0])
    i_raw = pre[:, :, 1]
    logf_m = F.logsigmoid(pre[:, :, 2]) + m
    o = torch.sigmoid(pre[:, :, 3])
    m_new = torch.maximum(logf_m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf_m - m_new)
    c_new = torch.addcmul(f_s * c, i_s, z)
    n_new = torch.addcmul(i_s, f_s, n)
    h_new = c_new / torch.clamp(n_new, min=1e-6) * o
    return (h_new, c_new, n_new, m_new), (z, i_s, f_s, o, pre[:, :, 2])


def _zero_carry(pre_x: torch.Tensor) -> tuple:
    _, n_h, b, _, hd = pre_x.shape
    zeros = pre_x.new_zeros((n_h, b, hd))
    return zeros, zeros, zeros, torch.full_like(zeros, NEG_INF)


class _SLSTMLoop(torch.autograd.Function):
    """h_0 .. h_{T-1} (T, H, B, hd) of the sLSTM loop from zero states,
    given pre_x (T, H, B, 4, hd) and r_all (H, hd, 4·hd), both f32, with
    a backward written by hand: the loop in reverse, so that autograd
    records no node a step. It holds the stabiliser m fixed: h = o·c / n
    does not depend on m (the states are c and n scaled by exp(-m), and
    n >= 1 from the first step on, so the clamp never acts), and the
    gradient through m is exactly zero. Saves c, n and the gates of every
    step (≈ 8 · B · T · d f32); the factors of the backward that do not
    depend on the carried gradients are formed for all steps at once."""

    @staticmethod
    def forward(ctx, pre_x, r_all):
        carry = _zero_carry(pre_x)
        hs, cs, ns, gates = [], [], [], []
        for i in range(pre_x.shape[0]):
            carry, g = _slstm_step(carry, pre_x[i], r_all)
            hs.append(carry[0])
            cs.append(carry[1])
            ns.append(carry[2])
            gates.append(g)
        h = torch.stack(hs)
        ctx.save_for_backward(r_all, h, torch.stack(cs), torch.stack(ns),
                              *(torch.stack(k) for k in zip(*gates)))
        return h

    @staticmethod
    def backward(ctx, g):
        r_all, h, c, n, z, i_s, f_s, o, f_raw = ctx.saved_tensors
        t, n_h, b, hd = h.shape
        inv = 1.0 / torch.clamp(n, min=1e-6)
        c_inv, o_inv = c * inv, o * inv
        neg_oc_inv2 = -(o_inv * c_inv)
        # d pre = d(gate) · d(gate) / d(pre), for z, i, f and o
        slope = torch.stack([1 - z * z, i_s,
                             f_s * torch.sigmoid(-f_raw), o * (1 - o)], 3)
        c_prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
        n_prev = torch.cat([torch.zeros_like(n[:1]), n[:-1]])
        dpre = torch.empty_like(slope)
        r_t = r_all.transpose(1, 2)
        dh_next = dc = dn = torch.zeros_like(h[0])
        for i in reversed(range(t)):
            dh = g[i] + dh_next
            dc = torch.addcmul(dc, dh, o_inv[i])
            dn = torch.addcmul(dn, dh, neg_oc_inv2[i])
            d = dpre[i]
            torch.mul(dc, i_s[i], out=d[:, :, 0])
            torch.addcmul(dn, dc, z[i], out=d[:, :, 1])
            torch.addcmul(dc * c_prev[i], dn, n_prev[i], out=d[:, :, 2])
            torch.mul(dh, c_inv[i], out=d[:, :, 3])
            d.mul_(slope[i])
            dc, dn = dc * f_s[i], dn * f_s[i]
            dh_next = torch.bmm(d.view(n_h, b, 4 * hd), r_t)
        h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
        dr = torch.einsum("thbd,thbe->hde", h_prev,
                          dpre.view(t, n_h, b, 4 * hd))
        return dpre, dr


def slstm_mixer(x: torch.Tensor, w: dict, ctx: AdapterCtx, cfg: ModelConfig,
                *, cache: Optional[dict] = None) -> tuple:
    """x (B, T, d) -> (y, new_cache): the loop over T from zero states
    without ``cache`` (new_cache None, as in JAX; ``_SLSTMLoop`` while
    autograd records), one step (T = 1) with it (the cache updated in
    place and returned). The loop runs heads-first, (T, H, B, ...), so
    that a step's slices are contiguous for its batched product."""
    b, t, d = x.shape
    n_h = cfg.num_heads
    hd = d // n_h
    # the hoisted x-projections (batched GEMMs outside the loop)
    zx = adapted_linear(x, w["w_z"], ctx, "slstm_z").float()
    ix = (x @ w["w_i"].to(x.dtype)).float()
    fx = (x @ w["w_f"].to(x.dtype)).float()
    ox = (x @ w["w_o"].to(x.dtype)).float()
    pre_x = torch.stack([a.reshape(b, t, n_h, hd) for a in (zx, ix, fx, ox)],
                        dim=3).permute(1, 2, 0, 3, 4).contiguous()
    r_all = torch.cat([w[n].float() for n in ("r_z", "r_i", "r_f", "r_o")],
                      dim=-1)                            # (H, hd, 4 hd)
    if cache is None:
        if torch.is_grad_enabled() and (pre_x.requires_grad
                                        or r_all.requires_grad):
            h = _SLSTMLoop.apply(pre_x, r_all)
        else:
            carry, hs = _zero_carry(pre_x), []
            for i in range(t):
                carry, _ = _slstm_step(carry, pre_x[i], r_all)
                hs.append(carry[0])
            h = torch.stack(hs)
        h = h.permute(2, 0, 1, 3).reshape(b, t, d)       # (T, H, B, hd) ->
        new_cache = None
    else:
        names = ("h", "c", "n", "m")
        carry = tuple(cache[k].reshape(b, n_h, hd).transpose(0, 1)
                      for k in names)
        carry, _ = _slstm_step(carry, pre_x[0], r_all)
        for k, v in zip(names, carry):
            cache[k].copy_(v.transpose(0, 1).reshape(b, d))
        h = carry[0].transpose(0, 1).reshape(b, 1, d)
        new_cache = cache
    return adapted_linear(h.to(x.dtype), w["w_out"], ctx, "slstm_o"), \
        new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero decode state: "h", "c", "n" (batch, d) and "m" (batch, d)
    at ``NEG_INF``, all f32."""
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), **f32),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), NEG_INF, **f32)}
