"""Paged attention kernel (``csrc/paged_attention.cu``).

#8 ``paged_decode_attention``: C query tokens per slot against flat
(N, page, KV, d) K/V block pools through a (B, P) block table; query c of
slot b sits at position pos[b] + c and attends cells [0, pos[b] + c].
Table entries >= N are sentinels, clamped to N - 1 and hidden by the mask
wherever it reaches them; pages past pos[b] + C - 1 are never read.
Replaces the fp leg of
``src/repro/kernels/paged_attention.py::paged_decode_attention``.
#8q ``paged_decode_attention_int8``: its int8 leg — int8 (N, page, KV, d)
pools with (N, page, KV) f32 per-cell scale pools, dequantized in
registers; p stays f32 through P·V, the output is bf16.

A CPU tensor runs the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel (bf16 q, bf16 or int8 pools, head_dim 64 or 128, GQA
group in {1, 2, 4, 8}, page a multiple of 8 up to 64) or raises.
``LAUNCHES`` counts the launches, and nothing else adds to it. The kernel is serving-only: an
input that requires grad while autograd records raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

LAUNCHES = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}

PAGES = tuple(range(8, 65, 8))


def paged_decode_attention_plain(q, k_cache, v_cache, tables, pos
                                 ) -> torch.Tensor:
    """#8's plain twin: gather by the clamped table, then a masked softmax
    (``ref.paged_decode_attention_ref``)."""
    return _ref.paged_decode_attention_ref(q, k_cache, v_cache, tables, pos)


def paged_decode_attention_int8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      tables, pos) -> torch.Tensor:
    """#8q's plain twin: dequantize the pools to f32, then #8's plain
    version with p in f32; output in q's dtype."""
    return _ref.paged_decode_attention_ref(q, k_cache, v_cache, tables, pos,
                                           k_scale, v_scale)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(_build.library("paged_attention"), name)
    # q k v [k_scale v_scale] tables pos o, B C H KV d N page P, strides,
    # stream
    n_ptr = 8 if name == "paged_attention_int8" else 6
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_shapes(q, k_cache, v_cache, tables, pos, what: str) -> tuple:
    b, c, h, d = q.shape
    n, page, kv = k_cache.shape[:3]
    if (k_cache.shape != (n, page, kv, d) or v_cache.shape != k_cache.shape
            or h % kv or tables.ndim != 2 or tables.shape[0] != b
            or pos.shape != (b,)):
        raise ValueError(
            f"{what} shapes q{tuple(q.shape)} "
            f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)} "
            f"tables{tuple(tables.shape)} pos{tuple(pos.shape)}")
    return b, c, h, d, n, page, kv


def _check_kernel_dims(h, kv, page, what: str) -> None:
    if h // kv not in _fa.GROUPS:
        raise NotImplementedError(
            f"{what}: CUDA kernel built for GQA groups {_fa.GROUPS}; got "
            f"{h // kv}")
    if page not in PAGES:
        raise NotImplementedError(
            f"{what}: CUDA kernel built for pages of {PAGES} cells; got "
            f"{page}")


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """#8. q (B, C, H, d); k_cache, v_cache (N, page, KV, d); tables (B, P)
    int; pos (B,) int -> (B, C, H, d)."""
    what = "paged_decode_attention"
    b, c, h, d, n, page, kv = _check_shapes(q, k_cache, v_cache, tables, pos,
                                            what)
    _build.check_no_grad((q, k_cache, v_cache), what)
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, tables, pos)
    _fa._check_cuda((q, k_cache, v_cache), d, what)
    _check_kernel_dims(h, kv, page, what)
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    st = _fa._strides(q, k_cache, v_cache, o)
    st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
    rc = _fn("paged_attention_bf16")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), o.data_ptr(), b, c, h, kv, d, n,
        page, tables.shape[1], ctypes.cast(st, ctypes.c_void_p),
        _build.stream_ptr(q))
    _build.check(rc, what)
    LAUNCHES[what] += 1
    return o


def paged_decode_attention_int8(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, tables: torch.Tensor,
                                pos: torch.Tensor) -> torch.Tensor:
    """#8q. q (B, C, H, d); k_cache, v_cache int8 (N, page, KV, d);
    k_scale, v_scale f32 (N, page, KV); tables (B, P) int; pos (B,) int
    -> (B, C, H, d) in q's dtype."""
    what = "paged_decode_attention_int8"
    b, c, h, d, n, page, kv = _check_shapes(q, k_cache, v_cache, tables, pos,
                                            what)
    if k_scale.shape != (n, page, kv) or v_scale.shape != k_scale.shape:
        raise ValueError(f"{what}: scale pools {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)}, want {(n, page, kv)}")
    _build.check_no_grad((q, k_scale, v_scale), what)
    if not q.is_cuda:
        return paged_decode_attention_int8_plain(q, k_cache, v_cache, k_scale,
                                                 v_scale, tables, pos)
    _fa._check_cuda((q,), d, what)
    for t, nm, dt in ((k_cache, "k", torch.int8), (v_cache, "v", torch.int8),
                      (k_scale, "k_scale", torch.float32),
                      (v_scale, "v_scale", torch.float32)):
        if t.dtype != dt or t.device != q.device or t.stride(-1) != 1:
            raise TypeError(f"{what}: {nm} must be {dt} on {q.device} with "
                            f"a contiguous last dim; got {t.dtype} on "
                            f"{t.device}")
    for t in (k_cache, v_cache):
        if any(st % 16 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{what}: int8 pools need strides in multiples "
                             "of 16 elements and 16-byte aligned data")
    _check_kernel_dims(h, kv, page, what)
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    st = (ctypes.c_longlong * 19)(
        *_fa._strides(q, k_cache, v_cache, o), tables.stride(0),
        *k_scale.stride(), *v_scale.stride())
    rc = _fn("paged_attention_int8")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), o.data_ptr(), b, c, h, kv, d, n, page,
        tables.shape[1], ctypes.cast(st, ctypes.c_void_p),
        _build.stream_ptr(q))
    _build.check(rc, what)
    LAUNCHES[what] += 1
    return o
