"""Paged attention kernel (``csrc/paged_attention.cu``).

#8 ``paged_decode_attention``: C query tokens per slot against flat
(N, page, KV, d) K/V block pools through a (B, P) block table; query c of
slot b sits at position pos[b] + c and attends cells [0, pos[b] + c].
Table entries >= N are sentinels, clamped to N - 1 and hidden by the mask
wherever it reaches them; pages past pos[b] + C - 1 are never read.
Replaces the fp leg of
``src/repro/kernels/paged_attention.py::paged_decode_attention``; the
int8 leg (per-cell scale pools) belongs to the quantized slice.

A CPU tensor runs the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel (bf16, head_dim 64 or 128, GQA group in {1, 2, 4, 8},
page a multiple of 8 up to 64) or raises. ``LAUNCHES`` counts the
launches, and nothing else adds to it. The kernel is serving-only: an
input that requires grad while autograd records raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

LAUNCHES = {"paged_decode_attention": 0}

PAGES = tuple(range(8, 65, 8))


def paged_decode_attention_plain(q, k_cache, v_cache, tables, pos
                                 ) -> torch.Tensor:
    """The kernel's plain twin: gather by the clamped table, then a masked
    softmax (``ref.paged_decode_attention_ref``)."""
    return _ref.paged_decode_attention_ref(q, k_cache, v_cache, tables, pos)


@functools.lru_cache(maxsize=None)
def _fn():
    f = _build.library("paged_attention").paged_attention_bf16
    # q k v tables pos o, B C H KV d N page P, strides, stream
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """#8. q (B, C, H, d); k_cache, v_cache (N, page, KV, d); tables (B, P)
    int; pos (B,) int -> (B, C, H, d)."""
    b, c, h, d = q.shape
    n, page, kv = k_cache.shape[:3]
    if (k_cache.shape != (n, page, kv, d) or v_cache.shape != k_cache.shape
            or h % kv or tables.ndim != 2 or tables.shape[0] != b
            or pos.shape != (b,)):
        raise ValueError(
            f"paged_decode_attention shapes q{tuple(q.shape)} "
            f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)} "
            f"tables{tuple(tables.shape)} pos{tuple(pos.shape)}")
    _build.check_no_grad((q, k_cache, v_cache), "paged_decode_attention")
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, tables, pos)
    _fa._check_cuda((q, k_cache, v_cache), d, "paged_decode_attention")
    if h // kv not in _fa.GROUPS:
        raise NotImplementedError(
            f"paged_decode_attention: CUDA kernel built for GQA groups "
            f"{_fa.GROUPS}; got {h // kv}")
    if page not in PAGES:
        raise NotImplementedError(
            f"paged_decode_attention: CUDA kernel built for pages of "
            f"{PAGES} cells; got {page}")
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    st = _fa._strides(q, k_cache, v_cache, o)
    st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
    rc = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               tables.data_ptr(), pos.data_ptr(), o.data_ptr(), b, c, h, kv,
               d, n, page, tables.shape[1], ctypes.cast(st, ctypes.c_void_p),
               _build.stream_ptr(q))
    _build.check(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return o
