"""Mamba (selective SSM) mixer, jamba's dominant block type (counterpart of
``src/repro/models/mamba.py``).

The mixer: in-projection ``mamba_in`` (K1 through ``adapted_linear``), a
causal depthwise conv and SiLU, the input-dependent coefficients
da = exp(dt ⊙ A) and db = dt ⊙ B ⊙ x, the linear recurrence
h_t = da_t ⊙ h_{t-1} + db_t over (d_inner, d_state), y = h·C + D ⊙ x,
the SiLU(z) gate and the out-projection ``mamba_out`` (K1). The JAX
mixer calls no Pallas kernel, and neither does this one: everything
between the two projections is torch ops. A hand-written scan kernel is
later speed work (ROADMAP).

Train / prefill keeps JAX's two branches: the chunked scan when
``t % chunk == 0 and t > chunk``, else one scan over the whole sequence.
Each chunk is one body: its coefficients, its scan (the carry folded
into the first step's additive term, as JAX does) and the contraction
with C, so a body returns only (B, chunk, d_inner) and the last state.
With autograd recording, each body is checkpointed: no (B, T, d_inner,
d_state) tensor is saved for the backward, and only one chunk's
(B, chunk, d_inner, d_state) tensors live during its recompute (JAX
checkpoints each chunk too). The scan is a log-depth (Hillis–Steele)
scan run without autograd; its backward (``_LinearScan``) is the reverse
recurrence λ_t = g_t + da_{t+1} ⊙ λ_{t+1}, scanned the same way, with
d(db) = λ and d(da) = λ ⊙ h_{t-1}: it saves da and the states, not every
level of the scan.

Decode is the O(1) recurrent step over the cache {"h": (B, d_inner,
d_state) f32, "conv": (B, K - 1, d_inner)}, updated in place. The
prefill's "conv" holds the last K - 1 in-projection rows (zero-padded on
the left), the window the decode step's conv reads, so prefill then
decode equals the parallel forward. (The JAX prefill stores the rows
after the conv and SiLU there, which its decode step then convolves
again: its prefill-then-decode does not equal its own parallel forward.
``tests/test_torch_mamba.py`` shows both.)
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import AdapterCtx, _silu, adapted_linear


def _ssm_coeffs(x: torch.Tensor, w: dict, cfg: ModelConfig) -> tuple:
    """x (B, T, di) after the conv and SiLU -> (da, db) of the recurrence,
    (B, T, di, ds) f32, and C (B, T, ds)."""
    dt_rank, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    xdbc = x @ w["w_x"].to(x.dtype)                      # (B, T, dtr + 2ds)
    dt, b, c = xdbc.split([dt_rank, ds, ds], dim=-1)
    dt = F.softplus(dt @ w["w_dt"].to(x.dtype) + w["dt_bias"].to(x.dtype))
    a = -torch.exp(w["a_log"].float())                   # (di, ds)
    da = torch.exp(dt.float()[..., None] * a)
    db = (dt[..., None] * b[:, :, None, :] * x[..., None]).float()
    return da, db, c


@torch.no_grad()
def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of h_t = a_t ⊙ h_{t-1} + b_t (h_{-1} = 0) along
    dim 1, in log2(T) Hillis–Steele steps on copies of a and b; returns
    h. Each step combines position t with t - off, (a, b) ∘ (a', b') =
    (a·a', a·b' + b), as JAX's ``_assoc_combine``."""
    a, b = a.clone(), b.clone()
    t, off = a.shape[1], 1
    while off < t:
        b[:, off:] += a[:, off:] * b[:, :-off]
        if 2 * off < t:
            a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """h = ``_scan(da, db)`` with a backward that is itself a scan: the
    reverse recurrence λ_t = g_t + da_{t+1} ⊙ λ_{t+1}, then d(db) = λ and
    d(da) = λ ⊙ h_{t-1}. Saves da and h."""

    @staticmethod
    def forward(ctx, da, db):
        h = _scan(da, db)
        ctx.save_for_backward(da, h)
        return h

    @staticmethod
    def backward(ctx, g):
        da, h = ctx.saved_tensors
        a_next = torch.cat([da[:, 1:], torch.zeros_like(da[:, :1])], 1)
        lam = _scan(a_next.flip(1), g.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        return lam * h_prev, lam


def _ssm_chunk(x: torch.Tensor, h0: torch.Tensor, w: dict,
               cfg: ModelConfig) -> tuple:
    """One chunk: x (B, c, di) after the conv and SiLU, h0 (B, di, ds) f32
    -> (h·C (B, c, di) f32, the last state (B, di, ds))."""
    da, db, c = _ssm_coeffs(x, w, cfg)
    # the carry folded into the first step's additive term
    db = torch.cat([db[:, :1] + da[:, :1] * h0[:, None], db[:, 1:]], 1)
    hs = _LinearScan.apply(da, db)
    y = torch.einsum("btds,bts->btd", hs, c.float())
    return y, hs[:, -1]


def _causal_conv(x: torch.Tensor, w_conv: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x (B, T, di), w_conv (K, di)."""
    k, t = w_conv.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                                   # K is 4: unrolled
        out = out + pad[:, i:i + t] * w_conv[i].to(x.dtype)
    return out + bias.to(x.dtype)


def _scan_sequence(xc: torch.Tensor, w: dict, cfg: ModelConfig,
                   chunk: int) -> tuple:
    """JAX's two prefill branches over x (B, T, di): chunks of ``chunk``
    when ``t % chunk == 0 and t > chunk``, else the whole sequence as one
    body; each body checkpointed while autograd records. Returns
    (h·C (B, T, di) f32, the last state)."""
    b, t, di = xc.shape
    h = torch.zeros((b, di, cfg.mamba_d_state), dtype=torch.float32,
                    device=xc.device)
    size = chunk if (t % chunk == 0 and t > chunk) else t
    record = torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for v in (xc, *w.values()))
    ys = []
    for i in range(0, t, size):
        part = xc[:, i:i + size]
        if record:
            y, h = checkpoint(_ssm_chunk, part, h, w, cfg,
                              use_reentrant=False)
        else:
            y, h = _ssm_chunk(part, h, w, cfg)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_mixer(x: torch.Tensor, w: dict, ctx: AdapterCtx, cfg: ModelConfig,
                *, cache: Optional[dict] = None, chunk: int = 256) -> tuple:
    """x (B, T, d_model) -> (y, new_cache). Without ``cache`` (train /
    prefill) new_cache is {"h", "conv"} for a decode to start from; with
    it (decode, T = 1) the cache's tensors are updated in place and
    returned."""
    b, t, _ = x.shape
    di = cfg.mamba_d_inner
    xz = adapted_linear(x, w["w_in"], ctx, "mamba_in")   # (B, T, 2 di)
    xi, z = xz.split(di, dim=-1)
    k = w["conv_w"].shape[0]
    if cache is None:
        xc = _silu(_causal_conv(xi, w["conv_w"], w["conv_b"]))
        y, h_last = _scan_sequence(xc, w, cfg, chunk)
        tail = xi[:, -(k - 1):]
        new_cache = {"h": h_last,
                     "conv": F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))}
    else:
        win = torch.cat([cache["conv"].to(xi.dtype), xi], 1)   # (B, K, di)
        xc = (torch.einsum("bkd,kd->bd", win, w["conv_w"].to(xi.dtype))
              [:, None] + w["conv_b"].to(xi.dtype))
        xc = _silu(xc)
        da, db, c = _ssm_coeffs(xc, w, cfg)
        h = da[:, 0] * cache["h"] + db[:, 0]              # (B, di, ds)
        y = torch.einsum("bds,bts->btd", h, c.float())
        cache["h"].copy_(h)
        cache["conv"].copy_(win[:, 1:])
        new_cache = cache
    y = y + w["d"].float() * xc.float()
    y = y.to(x.dtype) * _silu(z)
    return adapted_linear(y, w["w_out"], ctx, "mamba_out"), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """A zero decode cache: "h" (batch, d_inner, d_state) f32, "conv"
    (batch, K - 1, d_inner) in ``dtype``."""
    di = cfg.mamba_d_inner
    return {"h": torch.zeros((batch, di, cfg.mamba_d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba_conv - 1, di), dtype=dtype,
                                device=device)}
