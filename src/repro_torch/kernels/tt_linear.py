"""Fused adapted-linear kernels K1 and K2 (``csrc/tt_linear.cu``).

K1 ``tt_linear``: y = x·W + α·(x·A)·B, x (M, K), W (K, N), A (K, r),
B (r, N) — replaces ``src/repro/kernels/tt_linear.py::tt_linear``.
K2 ``tt_linear_batched_a``: the same with a per-row A[m] (M, K, r), the
decode-slot form whose A rows were gathered by each slot's task id —
replaces ``src/repro/kernels/tt_linear.py::tt_linear_batched_a``.

A CPU tensor runs the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel (bf16 only) or raises; ``LAUNCHES`` counts the
launches, and nothing else adds to it. The training backward runs K1
again on transposed operands (``dispatch._FusedTTLinear``). These
wrappers make plain outputs with no ``grad_fn``: an input that requires
grad while autograd records raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"tt_linear": 0, "tt_linear_batched_a": 0}

tt_linear_plain = _ref.tt_linear_ref
tt_linear_batched_a_plain = _ref.tt_linear_batched_a_ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(_build.library("tt_linear"), name)
    f.argtypes = _ARGTYPES
    f.restype = ctypes.c_int
    return f


def _check_cuda(x, w, a, b, what: str) -> None:
    _build.check_device(x)
    for t, n in ((x, "x"), (w, "w"), (a, "a"), (b, "b")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bf16 operands; "
                            f"{n} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {n} is on {t.device}, x on {x.device}")


def _vec_flags(x, w, a, k: int, n: int, r: int) -> int:
    """Which operands may take the kernel's 16-byte cp.async loads: x / W
    need K, N multiples of 8 and aligned bases (bit 1), A needs r a
    multiple of 8 and an aligned base (bit 2)."""
    xw = (k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
          and w.data_ptr() % 16 == 0)
    av = r % 8 == 0 and a.data_ptr() % 16 == 0
    return int(xw) | (2 * int(av))


def tt_linear(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x (M, K), w (K, N), a (K, r), b (r, N) -> y (M, N)."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or b.shape != (r, n):
        raise ValueError(f"tt_linear shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    _build.check_no_grad((x, w, a, b), "tt_linear")
    if not x.is_cuda:
        return tt_linear_plain(x, w, a, b, alpha)
    _check_cuda(x, w, a, b, "tt_linear")
    if not 1 <= r <= 256:
        raise ValueError(f"tt_linear: rank {r} outside 1..256")
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = _fn("tt_linear_bf16")(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), m, n, k, r, float(alpha), _vec_flags(x, w, a, k, n, r),
        _build.stream_ptr(x))
    _build.check(rc, "tt_linear")
    LAUNCHES["tt_linear"] += 1
    return y


def tt_linear_batched_a(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x (M, K), w (K, N), a (M, K, r), b (r, N) -> y (M, N); M <= 64."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    if w.shape[0] != k or a.shape[:2] != (m, k) or b.shape != (r, n):
        raise ValueError(f"tt_linear_batched_a shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    _build.check_no_grad((x, w, a, b), "tt_linear_batched_a")
    if not x.is_cuda:
        return tt_linear_batched_a_plain(x, w, a, b, alpha)
    _check_cuda(x, w, a, b, "tt_linear_batched_a")
    if not 1 <= m <= 64 or not 1 <= r <= 256:
        raise ValueError(f"tt_linear_batched_a: M={m} outside 1..64 or "
                         f"rank {r} outside 1..256")
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _fn("tt_linear_batched_a_bf16")(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), m, n, k, r, float(alpha), _vec_flags(x, w, a, k, n, r),
        _build.stream_ptr(x))
    _build.check(rc, "tt_linear_batched_a")
    LAUNCHES["tt_linear_batched_a"] += 1
    return y
