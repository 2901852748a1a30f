"""Attention kernels K3 and K4 (``csrc/flash_attention.cu``), forward only.

K3 ``flash_attention``: online-softmax attention, q (B, T, H, d) against
k/v (B, S, KV, d), read in place through strides with KV head h // G —
replaces ``src/repro/kernels/flash_attention.py::flash_attention``.
K4 ``decode_attention``: one query per (slot, head) against the dense
(B, S, KV, d) cache, cells 0..pos[b] — replaces
``src/repro/kernels/flash_attention.py::decode_attention``.

A CPU tensor runs the plain version (``kernels/ref.py``, through the
layout shims below). A CUDA tensor launches the kernel (bf16, head_dim
64 or 128; decode group size G in {1, 2, 4, 8}) or raises. ``LAUNCHES``
counts the launches, and nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"flash_attention": 0, "decode_attention": 0}

HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


def flash_attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """(B, T, H, d) x (B, S, KV, d) layout shim over ``flash_attention_ref``
    (repeat KV heads, move heads forward, as ``ops.py`` does in JAX)."""
    g = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(g, dim=2) if g > 1 else k
    vv = v.repeat_interleave(g, dim=2) if g > 1 else v
    out = _ref.flash_attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                                   vv.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def decode_attention_plain(q, k, v, pos) -> torch.Tensor:
    """q (B, H, d), cache (B, S, KV, d), pos (B,) -> (B, H, d) through
    ``decode_attention_ref`` on head-repeated (B·H, S, d) rows."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, d)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, d)
    out = _ref.decode_attention_ref(q.reshape(b * h, d), kh, vh,
                                    pos.repeat_interleave(h))
    return out.reshape(b, h, d)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(_build.library("flash_attention"), name)
    if name == "flash_attention_bf16":
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p, ctypes.c_void_p]
    else:
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_cuda(ts, d: int, what: str) -> None:
    _build.check_device(ts[0])
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bf16; got "
                            f"{t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{ts[0].device}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands need a contiguous last dim, "
                             "strides in multiples of 8 elements and "
                             "16-byte aligned data")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: CUDA kernel built for head_dim in {HEAD_DIMS}; got {d}")


def _strides(*ts) -> ctypes.Array:
    vals = [st for t in ts for st in t.stride()[:-1]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, T, H, d); k, v (B, S, KV, d) -> (B, T, H, d)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or h % kv:
        raise ValueError(f"flash_attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    _check_cuda((q, k, v), d, "flash_attention")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides(q, k, v, o)
    rc = _fn("flash_attention_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, s, h,
        kv, d, s, int(causal), ctypes.cast(st, ctypes.c_void_p),
        _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """q (B, H, d); k, v (B, S, KV, d) cache; pos (B,) -> (B, H, d)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or h % kv \
            or pos.shape != (b,):
        raise ValueError(f"decode_attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} pos{tuple(pos.shape)}")
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, pos)
    _check_cuda((q, k, v), d, "decode_attention")
    if h // kv not in DECODE_GROUPS:
        raise NotImplementedError(
            f"decode_attention: CUDA kernel built for GQA groups "
            f"{DECODE_GROUPS}; got {h // kv}")
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, o)
    rc = _fn("decode_attention_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), b, s, h, kv, d, ctypes.cast(st, ctypes.c_void_p),
        _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
