"""Shape contract between model code and the kernels (counterpart of
``src/repro/kernels/ops.py``).

Leading dims flatten to rows; attention keeps q in (B, T, H, d) and k/v in
(B, S, KV, d) at these functions. The CUDA kernels mask ragged edges and
index KV head h // G themselves, so — unlike the TPU path — nothing pads
to a tile multiple and no head-repeated copy of k/v is made.

``backend``: "kernel" calls the kernel wrappers (a CUDA tensor launches
the kernel, a CPU tensor runs the plain version); "ref" calls the plain
versions directly, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tt_linear as _tl

BACKENDS = ("kernel", "ref")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; want one of {BACKENDS}")


def tt_linear(x, w, a, b, *, alpha: float = 1.0, backend: str = "kernel"):
    """y = x·W + α·(x·A)·B; x (..., K), w (K, N), a (K, r), b (r, N)."""
    _check(backend)
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k)
    fn = _ref.tt_linear_ref if backend == "ref" else _tl.tt_linear
    return fn(xf, w, a, b, alpha).reshape(*lead, w.shape[1])


def _split_rows(call, x, a):
    """``call(x_rows, a_rows)`` over row chunks of at most
    ``BATCHED_A_ROWS`` (one K2 / #10 launch each), concatenated. Rows are
    independent — no sum crosses them — so this equals one call over all
    rows, as the JAX package's grid over M does."""
    n = _tl.BATCHED_A_ROWS
    if x.shape[0] <= n:
        return call(x, a)
    return torch.cat([call(x[i:i + n], a[i:i + n])
                      for i in range(0, x.shape[0], n)])


def tt_linear_batched_a(x, w, a, b, *, alpha: float = 1.0,
                        backend: str = "kernel"):
    """y[s] = x[s]·W + α·(x[s]·A[s])·B; x (S, K) or (S, 1, K), a (S, K, r).
    The S axis is the engine's slot axis: A[s] was gathered by slot s's
    task id, so a mixed-task decode batch of up to 64 slots is one kernel
    call; on the kernel backend larger S is split into ⌈S / 64⌉ calls."""
    _check(backend)
    squeeze = x.ndim == 3
    if squeeze:
        if x.shape[1] != 1:
            raise ValueError("batched-A fusion is decode-shaped (one token "
                             f"per slot); got {tuple(x.shape)}")
        x = x[:, 0]
    if backend == "ref":
        y = _ref.tt_linear_batched_a_ref(x, w, a, b, alpha)
    else:
        y = _split_rows(
            lambda xs, as_: _tl.tt_linear_batched_a(xs, w, as_, b, alpha),
            x, a)
    return y[:, None] if squeeze else y


def tt_linear_q(x, wq, scale, a, b, *, alpha: float = 1.0,
                backend: str = "kernel"):
    """w8a16 adapted linear (#9): x (..., K), int8 wq (K, N), f32 scale
    (G, N), a (K, r), b (r, N)."""
    _check(backend)
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k)
    fn = _ref.tt_linear_q_ref if backend == "ref" else _tl.tt_linear_w8
    return fn(xf, wq, scale, a, b, alpha).reshape(*lead, wq.shape[1])


def tt_linear_batched_a_q(x, wq, scale, a, b, *, alpha: float = 1.0,
                          backend: str = "kernel"):
    """w8a16 per-row-A adapted linear (#10): x (S, K) or (S, 1, K),
    a (S, K, r); on the kernel backend ⌈S / 64⌉ calls, as
    ``tt_linear_batched_a``."""
    _check(backend)
    squeeze = x.ndim == 3
    if squeeze:
        if x.shape[1] != 1:
            raise ValueError("batched-A fusion is decode-shaped (one token "
                             f"per slot); got {tuple(x.shape)}")
        x = x[:, 0]
    if backend == "ref":
        y = _ref.tt_linear_batched_a_q_ref(x, wq, scale, a, b, alpha)
    else:
        y = _split_rows(
            lambda xs, as_: _tl.tt_linear_batched_a_w8(xs, wq, scale, as_, b,
                                                       alpha), x, a)
    return y[:, None] if squeeze else y


def flash_attention(q, k, v, *, causal: bool = True,
                    backend: str = "kernel"):
    """GQA attention. q (B, T, H, d); k, v (B, S, KV, d) -> (B, T, H, d)."""
    _check(backend)
    if backend == "ref":
        return _fa.flash_attention_plain(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        backend: str = "kernel"):
    """Stats-emitting GQA forward for training. q (B, T, H, d); k, v
    (B, S, KV, d) -> (out (B, T, H, d), lse (B, H, T) f32)."""
    _check(backend)
    fn = (_fa.flash_attention_fwd_plain if backend == "ref"
          else _fa.flash_attention_fwd)
    return fn(q, k, v, causal)


def flash_attention_bwd(q, k, v, o, lse, g, *, causal: bool = True,
                        backend: str = "kernel"):
    """GQA flash backward from the forward's residuals. q, o, g
    (B, T, H, d); k, v (B, S, KV, d); lse (B, H, T) f32 -> (dq, dk, dv),
    dk/dv in the KV-head layout. The JAX package repeats KV heads and sums
    each group after the kernels; here the kernels read KV head h // G in
    place and sum the group in f32."""
    _check(backend)
    fn = (_fa.flash_attention_bwd_plain if backend == "ref"
          else _fa.flash_attention_bwd)
    return fn(q, k, v, o, lse, g, causal)


def decode_attention(q, k, v, pos, *, backend: str = "kernel"):
    """Cached single-token decode. q (B, 1, H, d); k, v (B, S, KV, d);
    pos scalar or (B,) — row b attends cells [0, pos[b]] -> (B, 1, H, d)."""
    _check(backend)
    b, t = q.shape[:2]
    if t != 1:
        raise ValueError("decode attention expects a single query token")
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32)
    pos = pos.expand(b) if pos.ndim == 0 else pos
    fn = (_fa.decode_attention_plain if backend == "ref"
          else _fa.decode_attention)
    return fn(q[:, 0], k, v, pos)[:, None]


def paged_decode_attention(q, k_cache, v_cache, tables, pos, *,
                           k_scale=None, v_scale=None,
                           backend: str = "kernel"):
    """Block-table attention over a paged KV cache (the engine's decode and
    in-loop chunked prefill). q (B, C, H, d) — query c of slot b at
    position pos[b] + c; k_cache, v_cache (N, page, KV, d) flat block
    pools; tables (B, P) int (sentinel >= N marks unallocated pages); pos
    scalar or (B,) -> (B, C, H, d): query c attends cells [0, pos[b] + c].
    ``k_scale`` / ``v_scale``: (N, page, KV) f32 per-cell scale pools of
    int8 pools (#8q; the output is in q's dtype)."""
    _check(backend)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("the int8 leg takes both k_scale and v_scale")
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32)
    pos = pos.expand(q.shape[0]) if pos.ndim == 0 else pos
    if k_scale is not None:
        fn = (_pa.paged_decode_attention_int8_plain if backend == "ref"
              else _pa.paged_decode_attention_int8)
        return fn(q, k_cache, v_cache, k_scale, v_scale, tables, pos)
    fn = (_pa.paged_decode_attention_plain if backend == "ref"
          else _pa.paged_decode_attention)
    return fn(q, k_cache, v_cache, tables, pos)
