"""Fused adapted-linear kernels K1, K2, #9 and #10 (``csrc/tt_linear.cu``).

K1 ``tt_linear``: y = x·W + α·(x·A)·B, x (M, K), W (K, N), A (K, r),
B (r, N) — replaces ``src/repro/kernels/tt_linear.py::tt_linear``.
K2 ``tt_linear_batched_a``: the same with a per-row A[m] (M, K, r), the
decode-slot form whose A rows were gathered by each slot's task id —
replaces ``src/repro/kernels/tt_linear.py::tt_linear_batched_a``.
#9 ``tt_linear_w8`` and #10 ``tt_linear_batched_a_w8``: K1 and K2 over an
int8 W with f32 scales (G, N) — G = 1 per output channel, G > 1 per group
of K / G rows (a multiple of 128) — replacing ``tt_linear_w8`` and
``tt_linear_batched_a_w8`` of the same file. Inference only, as in the
JAX package (no backward).

A CPU tensor runs the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel (bf16 only) or raises; ``LAUNCHES`` counts the
launches, and nothing else adds to it. The training backward runs K1
again on transposed operands (``dispatch._FusedTTLinear``): K1 reads W,
A and B through their strides, so those views are never copied. These
wrappers make plain outputs with no ``grad_fn``: an input that requires
grad while autograd records raises.

K1 runs one `wgmma` kernel in two variants (``k1_variant``): ranks up to
``RANK_WGMMA`` keep P = x·A in registers; above it, up to ``K1_MAX_RANK``
(VeRA's rank 1024 in the paper's Table 1), a pre-pass writes α·P as a
bf16 hi + lo pair into a (M, 2·rp) workspace and the main kernel sums
[hi | lo]·[B; B] on the tensor cores after its base K loop. Both read W,
A and B through their strides; only the pre-pass variant copies a B
whose columns are strided (r·N elements) into rows. K2, #9 and #10
share a split-K `wgmma` kernel for ranks up to ``RANK_WGMMA`` on
operands that take 16-byte copies, over ``w8_splits`` slices of K (#9:
``w8_path``; K2 and #10, whose per-row adapter term P[m] = x[m]·A[m] a
pre-pass kernel sums first: ``ba_path`` and ``bw8_path``); else the
template kernel. K2 and #10 take at most 64 rows a launch; ``ops.py``
splits larger M.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"tt_linear": 0, "tt_linear_batched_a": 0, "tt_linear_w8": 0,
            "tt_linear_batched_a_w8": 0}

tt_linear_plain = _ref.tt_linear_ref
tt_linear_batched_a_plain = _ref.tt_linear_batched_a_ref
tt_linear_w8_plain = _ref.tt_linear_q_ref
tt_linear_batched_a_w8_plain = _ref.tt_linear_batched_a_q_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # x w a b y, M N K r, alpha, strides (w, a, b), variant, ws, stream
    "tt_linear_bf16": [_P] * 5 + [_I] * 4 + [_F, _P, _I, _P, _P],
    # x w a b y, M N K r, alpha, vec, variant, splits, ws, stream
    "tt_linear_batched_a_bf16": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P,
                                                       _P],
    # x w scale a b y, M N K r G, alpha, strides (a, b), variant, splits,
    # stream
    "tt_linear_w8_bf16": [_P] * 6 + [_I] * 5 + [_F, _P, _I, _I, _P],
    # x w scale a b y, M N K r G, alpha, vec, variant, splits, ws, stream
    "tt_linear_batched_a_w8_bf16": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _I,
                                                          _P, _P],
}
#: K1's variants (``csrc/tt_linear.cu``): the `wgmma` kernel with P in
#: registers, which takes ranks up to RANK_WGMMA, and the pre-pass for P
#: followed by the `wgmma` kernel over K + 2·rp, which takes every rank up
#: to K1_MAX_RANK
K1_VARIANTS = {"wgmma": 1, "pre_pass": 2}
RANK_WGMMA = 64
#: the largest rank K1 takes on the card (the JAX kernel keeps any r
#: whole in a (bm, r) f32 scratch; the paper's largest is VeRA's 1024)
K1_MAX_RANK = 1024
#: K2's, #9's and #10's rank limit on the card: their template kernel
#: keeps a (BM, r) f32 P in shared memory. K2 / #10's per-row A comes from
#: a MetaTT 4+1d adapter, whose ranks stay far below it; #9 serves any
#: kind over an int8 base (VeRA at 1024 raises: ROADMAP Queue 3)
SHARED_P_MAX_RANK = 256
#: rows a K2 / #10 launch takes
BATCHED_A_ROWS = 64
#: K2's, #9's and #10's CUDA kernels: the split-K `wgmma` kernel and the
#: template kernel
W8_VARIANTS = {"wgmma": 1, "template": 2}
#: the split-K kernel's output tile, K tile, and most slices of K (the
#: slices of a tile are one thread-block cluster of at most 8)
W8_TILE, W8_BK, W8_MAX_SPLITS = 64, 64, 8
#: K rows a partial sum of K2's and #10's pre-pass (P[m] = x[m]·A[m])
#: covers
PRE_K = 256


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(_build.library("tt_linear"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


def k1_variant(r: int) -> str:
    """Which variant K1 launches at rank r: ``"wgmma"`` (ranks up to
    ``RANK_WGMMA``, every M) or ``"pre_pass"`` (larger ranks)."""
    return "wgmma" if r <= RANK_WGMMA else "pre_pass"


def k1_workspace_elems(m: int, r: int) -> int:
    """bf16 elements of the pre-pass variant's P workspace: (M, 2·rp),
    rp = r rounded up to 64."""
    return m * 2 * (-(-r // 64) * 64)


def w8_splits(m: int, n: int, k: int, sms: int) -> int:
    """Slices of K for #9's `wgmma` kernel: the fewest (a power of two, at
    most ``W8_MAX_SPLITS``) that put at least one block on each of
    ``sms`` SMs, with every slice at least two K tiles long. M = 64,
    N = K = 2048 on 132 SMs: 32 output tiles x 8 slices of 256 rows."""
    tiles = -(-n // W8_TILE) * -(-m // W8_TILE)
    nk = -(-k // W8_BK)
    s = 1
    while tiles * s < sms and 2 * s * 2 <= nk and s < W8_MAX_SPLITS:
        s *= 2
    return s


def w8_path(x, wq, scale, r: int) -> tuple:
    """Which CUDA kernel #9 launches, and over how many slices of K:
    ``("wgmma", S)`` for ranks up to ``RANK_WGMMA`` when x and the int8 W
    take 16-byte copies (K % 8 == 0, N % 16 == 0, aligned bases) and the
    scales 8-byte ones; else ``("template", 1)``."""
    m, k = x.shape
    n = wq.shape[1]
    if (r <= RANK_WGMMA and k % 8 == 0 and n % 16 == 0
            and x.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
            and scale.data_ptr() % 8 == 0):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        return "wgmma", w8_splits(m, n, k, sms)
    return "template", 1


def ba_plan(m: int, n: int, k: int, r: int, vec: bool, sms: int) -> tuple:
    """K2's (and #10's) CUDA kernel and slices of K for operands of these
    sizes: ``("wgmma", w8_splits(...))`` (the split-K kernel after a
    pre-pass that sums P[m] = x[m]·A[m]) for ranks up to ``RANK_WGMMA`` on
    operands that take 16-byte copies (``vec``), else ``("template",
    1)``."""
    if not vec or r > RANK_WGMMA:
        return "template", 1
    return "wgmma", w8_splits(m, n, k, sms)


def ba_path(x, w, a, r: int) -> tuple:
    """``ba_plan`` on K2's operands: the `wgmma` kernel needs K % 8 == 0,
    N % 8 == 0 and 16-byte aligned x, W and A."""
    m, k = x.shape
    n = w.shape[1]
    vec = (k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return ba_plan(m, n, k, r, vec, sms)


def bw8_path(x, wq, scale, a, r: int) -> tuple:
    """``ba_plan`` on #10's operands: the `wgmma` kernel needs K % 8 == 0,
    N % 16 == 0, 16-byte aligned x, W and A and 8-byte aligned scales."""
    m, k = x.shape
    n = wq.shape[1]
    vec = (k % 8 == 0 and n % 16 == 0 and x.data_ptr() % 16 == 0
           and wq.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0
           and scale.data_ptr() % 8 == 0)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return ba_plan(m, n, k, r, vec, sms)


def _check_cuda(x, w, a, b, what: str, w_dtype=torch.bfloat16) -> None:
    _build.check_device(x)
    for t, n, dt in ((x, "x", torch.bfloat16), (w, "w", w_dtype),
                     (a, "a", torch.bfloat16), (b, "b", torch.bfloat16)):
        if t.dtype != dt:
            raise TypeError(f"{what}: the CUDA kernel takes {dt} for {n}; "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {n} is on {t.device}, x on {x.device}")


def _vec_flags(x, w, a, k: int, n: int, r: int) -> int:
    """Which operands may take the kernel's 16-byte cp.async loads: x / W
    need K, N multiples of 8 (int8 W: N a multiple of 16) and aligned
    bases (bit 1), A needs r a multiple of 8 and an aligned base (bit 2)."""
    n_mult = 16 if w.dtype == torch.int8 else 8
    xw = (k % 8 == 0 and n % n_mult == 0 and x.data_ptr() % 16 == 0
          and w.data_ptr() % 16 == 0)
    av = r % 8 == 0 and a.data_ptr() % 16 == 0
    return int(xw) | (2 * int(av))


def _check_scale(wq, scale, what: str) -> int:
    """(G, N) f32 scales of an int8 (K, N) W; returns G. On the card a
    grouped scale (G > 1) needs a group K / G that is a multiple of 128."""
    k, n = wq.shape
    g = scale.shape[0] if scale.ndim == 2 else 0
    if wq.dtype != torch.int8 or scale.shape != (g, n) or g < 1 or k % g:
        raise ValueError(f"{what}: want int8 W (K, N) and f32 scales (G, N) "
                         f"with G dividing K; got W {tuple(wq.shape)} "
                         f"{wq.dtype}, scale {tuple(scale.shape)}")
    return g


def _launch_w8(name, x, wq, scale, a, b, alpha, r, batched: bool):
    """#9 / #10 on checked shapes: CUDA operands, or the plain version."""
    m, k = x.shape
    n = wq.shape[1]
    g = _check_scale(wq, scale, name)
    _build.check_no_grad((x, scale, a, b), name)
    if not x.is_cuda:
        plain = (tt_linear_batched_a_w8_plain if batched
                 else tt_linear_w8_plain)
        return plain(x, wq, scale, a, b, alpha)
    _check_cuda(x, wq, a, b, name, w_dtype=torch.int8)
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise TypeError(f"{name}: scales must be f32 on {x.device}")
    if g > 1 and (k // g) % 128:
        raise NotImplementedError(
            f"{name}: CUDA kernel built for scale groups of a multiple of "
            f"128 rows; got {k // g}")
    if (not 1 <= r <= SHARED_P_MAX_RANK
            or (batched and not 1 <= m <= BATCHED_A_ROWS)):
        raise ValueError(f"{name}: rank {r} outside 1..{SHARED_P_MAX_RANK} "
                         f"or M={m} outside 1..{BATCHED_A_ROWS} (batched A)")
    x, wq, scale = (t.contiguous() for t in (x, wq, scale))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if batched:
        a, b = a.contiguous(), b.contiguous()
        rc = _launch_w8_batched_a(x, wq, scale, a, b, y, g, alpha,
                                  *bw8_path(x, wq, scale, a, r))
    else:
        rc = _launch_w8_shared_a(x, wq, scale, a, b, y, g, alpha,
                                 *w8_path(x, wq, scale, r))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return y


def _launch_w8_shared_a(x, wq, scale, a, b, y, g: int, alpha,
                        variant: str, splits: int) -> int:
    """#9 through the named kernel (see ``w8_path``); returns the
    launch's cudaError. A and B are read through their strides by the
    `wgmma` kernel and copied contiguous for the template one."""
    m, k = x.shape
    n, r = wq.shape[1], a.shape[1]
    if variant == "template":
        a, b = a.contiguous(), b.contiguous()
    st = (ctypes.c_longlong * 6)(0, 0, *a.stride(), *b.stride())
    return _fn("tt_linear_w8_bf16")(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), m, n, k, r, g, float(alpha),
        ctypes.cast(st, ctypes.c_void_p), W8_VARIANTS[variant], splits,
        _build.stream_ptr(x))


def _pre_pass_ws(x, r: int, variant: str):
    """The f32 workspace of the pre-pass's partial P sums (`wgmma` path
    of K2 and #10), or None."""
    if variant != "wgmma":
        return None
    m, k = x.shape
    return torch.empty(m * -(-k // PRE_K) * r, dtype=torch.float32,
                       device=x.device)


def _launch_w8_batched_a(x, wq, scale, a, b, y, g: int, alpha,
                         variant: str, splits: int) -> int:
    """#10 on contiguous CUDA operands through the named kernel (see
    ``bw8_path``); returns the launch's cudaError."""
    m, k = x.shape
    n, r = wq.shape[1], a.shape[2]
    ws = _pre_pass_ws(x, r, variant)
    return _fn("tt_linear_batched_a_w8_bf16")(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), a.data_ptr(),
        b.data_ptr(), y.data_ptr(), m, n, k, r, g, float(alpha),
        _vec_flags(x, wq, a, k, n, r), W8_VARIANTS[variant], splits,
        None if ws is None else ws.data_ptr(), _build.stream_ptr(x))


def _launch_batched_a(x, w, a, b, y, alpha, variant: str,
                      splits: int) -> int:
    """K2 on contiguous CUDA operands through the named kernel (see
    ``ba_plan``); returns the launch's cudaError."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    ws = _pre_pass_ws(x, r, variant)
    return _fn("tt_linear_batched_a_bf16")(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), m, n, k, r, float(alpha), _vec_flags(x, w, a, k, n, r),
        W8_VARIANTS[variant], splits, None if ws is None else ws.data_ptr(),
        _build.stream_ptr(x))


def _launch_k1(x, w, a, b, alpha, variant: str) -> torch.Tensor:
    """K1 on checked CUDA operands through the named variant (see
    ``k1_variant``); W, A and B are read through their strides."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    x = x.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    ws = None
    if variant == "pre_pass":
        ws = torch.empty(k1_workspace_elems(m, r), dtype=x.dtype,
                         device=x.device)
        if b.stride(1) != 1:
            # the extension streams B's rows as the W tiles of its K loop:
            # a B with strided columns (dx's Aᵀ of a row-major A) is copied
            # to rows, r·N elements, against the element loads it would
            # take otherwise
            b = b.contiguous()
    st = (ctypes.c_longlong * 6)(*w.stride(), *a.stride(), *b.stride())
    rc = _fn("tt_linear_bf16")(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), m, n, k, r, float(alpha),
        ctypes.cast(st, ctypes.c_void_p), K1_VARIANTS[variant],
        None if ws is None else ws.data_ptr(), _build.stream_ptr(x))
    _build.check(rc, "tt_linear")
    LAUNCHES["tt_linear"] += 1
    return y


def tt_linear(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x (M, K), w (K, N), a (K, r), b (r, N) -> y (M, N). W, A and B may
    be transposed views: the kernel reads them through their strides."""
    k = x.shape[1]
    n, r = w.shape[1], a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or b.shape != (r, n):
        raise ValueError(f"tt_linear shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    _build.check_no_grad((x, w, a, b), "tt_linear")
    if not x.is_cuda:
        return tt_linear_plain(x, w, a, b, alpha)
    _check_cuda(x, w, a, b, "tt_linear")
    if not 1 <= r <= K1_MAX_RANK:
        raise ValueError(
            f"tt_linear: rank {r} outside 1..{K1_MAX_RANK}; the JAX kernel "
            "keeps r whole in a (bm, r) f32 scratch, and the card's K1 "
            f"takes every rank of the paper's adapters (VeRA's "
            f"{K1_MAX_RANK} the largest)")
    return _launch_k1(x, w, a, b, alpha, k1_variant(r))


def tt_linear_batched_a(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x (M, K), w (K, N), a (M, K, r), b (r, N) -> y (M, N); on the card
    M <= 64 (one launch; ``ops.tt_linear_batched_a`` splits larger M)."""
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
    if not 1 <= m <= BATCHED_A_ROWS or not 1 <= r <= SHARED_P_MAX_RANK:
        raise ValueError(f"tt_linear_batched_a: M={m} outside "
                         f"1..{BATCHED_A_ROWS} or rank {r} outside "
                         f"1..{SHARED_P_MAX_RANK}")
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _launch_batched_a(x, w, a, b, y, alpha, *ba_path(x, w, a, r))
    _build.check(rc, "tt_linear_batched_a")
    LAUNCHES["tt_linear_batched_a"] += 1
    return y


def tt_linear_w8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor,
                 alpha: float = 1.0) -> torch.Tensor:
    """#9. x (M, K), wq int8 (K, N), scale f32 (G, N), a (K, r), b (r, N)
    -> y (M, N) = x·(q·s) + α·(x·A)·B."""
    m, k = x.shape
    n, r = wq.shape[1], a.shape[1]
    if wq.shape[0] != k or a.shape[0] != k or b.shape != (r, n):
        raise ValueError(f"tt_linear_w8 shapes x{tuple(x.shape)} "
                         f"w{tuple(wq.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    return _launch_w8("tt_linear_w8", x, wq, scale, a, b, alpha, r, False)


def tt_linear_batched_a_w8(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, alpha: float = 1.0
                           ) -> torch.Tensor:
    """#10. x (M, K), wq int8 (K, N), scale f32 (G, N), a (M, K, r),
    b (r, N) -> y (M, N); on the card M <= 64 (one launch;
    ``ops.tt_linear_batched_a_q`` splits larger M)."""
    m, k = x.shape
    n, r = wq.shape[1], a.shape[2]
    if wq.shape[0] != k or a.shape[:2] != (m, k) or b.shape != (r, n):
        raise ValueError(f"tt_linear_batched_a_w8 shapes x{tuple(x.shape)} "
                         f"w{tuple(wq.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    return _launch_w8("tt_linear_batched_a_w8", x, wq, scale, a, b, alpha,
                      r, True)
