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
launches the kernel or raises: bf16 operands launch the kernels below; f32
operands launch the f32 instances of K1 (``LAUNCHES["tt_linear_f32"]``:
FFMA tiles, P = α·x·A kept in f32 — RoBERTa trains in f32), K2
(``LAUNCHES["tt_linear_batched_a_f32"]``: a pre-pass for P[m] = x[m]·A[m],
then an FFMA pass over [x | α·P]·[W; B] in slices of K merged in a fixed
order — RoBERTa decodes in f32), #9 (``LAUNCHES["tt_linear_w8_f32"]``:
K1f's two launches with the int8 W widened to f32 as it is loaded) and
#10 (``LAUNCHES["tt_linear_batched_a_w8_f32"]``: K2f's, the same) —
RoBERTa served over int8 weights; the scales as the TPU kernels apply
them, per channel on the base sum before the adapter term is added, per
group on each widened K tile. Mixed dtypes raise.
``LAUNCHES`` counts the launches, and nothing else adds to it. The
training backward runs K1 again on transposed operands
(``dispatch._FusedTTLinear``): K1 reads W,
A and B through their strides, so those views are never copied. These
wrappers make plain outputs with no ``grad_fn``: an input that requires
grad while autograd records raises.

K1 runs one `wgmma` kernel in two variants (``k1_variant``): ranks up to
``RANK_WGMMA`` keep P = x·A in registers; every larger rank runs a
pre-pass that writes α·P as a bf16 hi + lo pair into a (M, 2·rp)
workspace, and the main kernel sums [hi | lo]·[B; B] on the tensor cores
after its base K loop. Both read W, A and B through their strides; only
the pre-pass variant copies a B whose columns are strided (r·N elements)
into rows. K2, #9 and #10 share a split-K `wgmma` kernel over
``w8_splits`` slices of K (``splitk_path``), with
the same two forms of the rank term by ``k1_variant`` (#9's pre-pass is
K1's; K2's and #10's sums the per-row P[m] = x[m]·A[m]); above
``RANK_WGMMA`` the slices also split the 2·rp extension rows. No rank is
refused: the workspace, not a constant, bounds it. The split-K kernel
takes only operands that allow 16-byte copies: ``vec_operands`` pads
ragged K / N with zeros and copies unaligned operands first (the model's
shapes need no copy). K2 and #10 take at most 64 rows a launch;
``ops.py`` splits larger M (f32 rows too). K2's f32 instance takes any
M, N, K and r in one launch, W, A and B through their strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"tt_linear": 0, "tt_linear_batched_a": 0, "tt_linear_w8": 0,
            "tt_linear_batched_a_w8": 0, "tt_linear_f32": 0,
            "tt_linear_batched_a_f32": 0, "tt_linear_w8_f32": 0,
            "tt_linear_batched_a_w8_f32": 0}

tt_linear_plain = _ref.tt_linear_ref
tt_linear_batched_a_plain = _ref.tt_linear_batched_a_ref
tt_linear_w8_plain = _ref.tt_linear_q_ref
tt_linear_batched_a_w8_plain = _ref.tt_linear_batched_a_q_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # x w a b y, M N K r, alpha, strides (w, a, b), variant, ws, stream
    "tt_linear_bf16": [_P] * 5 + [_I] * 4 + [_F, _P, _I, _P, _P],
    # x w a b y, M N K r, alpha, strides (w, a, b), ws, stream
    "tt_linear_f32": [_P] * 5 + [_I] * 4 + [_F, _P, _P, _P],
    # x w a b y, M N K r, alpha, splits, ws, stream
    "tt_linear_batched_a_bf16": [_P] * 5 + [_I] * 4 + [_F, _I, _P, _P],
    # x w a b y, M N K r, alpha, strides (w, a, b), splits, ws, cnt, stream
    "tt_linear_batched_a_f32": [_P] * 5 + [_I] * 4 + [_F, _P, _I, _P, _P,
                                                      _P],
    # x w scale a b y, M N K r G, alpha, strides (a, b), splits, ws, stream
    "tt_linear_w8_bf16": [_P] * 6 + [_I] * 5 + [_F, _P, _I, _P, _P],
    # x w scale a b y, M N K r G, alpha, splits, ws, stream
    "tt_linear_batched_a_w8_bf16": [_P] * 6 + [_I] * 5 + [_F, _I, _P, _P],
    # x w scale a b y, M N K r G, alpha, strides (w, a, b), ws, stream
    "tt_linear_w8_f32": [_P] * 6 + [_I] * 5 + [_F, _P, _P, _P],
    # x w scale a b y, M N K r G, alpha, strides (w, a, b), splits, ws,
    # cnt, stream
    "tt_linear_batched_a_w8_f32": [_P] * 6 + [_I] * 5 + [_F, _P, _I, _P,
                                                         _P, _P],
}
#: K1's variants (``csrc/tt_linear.cu``): the `wgmma` kernel with P in
#: registers, which takes ranks up to RANK_WGMMA, and the pre-pass for P
#: followed by the `wgmma` kernel over K + 2·rp, which takes every rank.
#: The split-K kernel of K2, #9 and #10 forms its rank term the same way
K1_VARIANTS = {"wgmma": 1, "pre_pass": 2}
RANK_WGMMA = 64
#: rows a K2 / #10 launch takes
BATCHED_A_ROWS = 64
#: the split-K kernel's output tile, K tile, and most slices of K (the
#: slices of a tile are one thread-block cluster of at most 8)
W8_TILE, W8_BK, W8_MAX_SPLITS = 64, 64, 8
#: K rows a partial sum of K2's and #10's pre-pass (P[m] = x[m]·A[m])
#: covers, at ranks up to RANK_WGMMA (and at every rank in f32)
PRE_K = 256
#: K2's f32 instance: output channels and rows a block, and most rows of
#: K + r a slice (``csrc/tt_linear.cu``, ``BA32_*``)
BA32_TILE_N, BA32_TILE_M, BA32_MAX_ROWS = 128, 8, 1024


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(_build.library("tt_linear"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


def k1_variant(r: int) -> str:
    """How a kernel forms the rank term at rank r: ``"wgmma"`` (P in
    registers, ranks up to ``RANK_WGMMA``) or ``"pre_pass"`` (α·P as a
    bf16 hi + lo pair in a workspace, every larger rank)."""
    return "wgmma" if r <= RANK_WGMMA else "pre_pass"


def _rank_pad(r: int) -> int:
    return -(-r // 64) * 64


def k1_workspace_elems(m: int, r: int) -> int:
    """bf16 elements of the pre-pass variant's P workspace: (M, 2·rp),
    rp = r rounded up to 64."""
    return m * 2 * _rank_pad(r)


def splitk_rows(k: int, r: int) -> int:
    """K rows the split-K kernel's loop covers: K, and above
    ``RANK_WGMMA`` the 2·rp extension rows of [hi | lo]·[B; B]."""
    return k if r <= RANK_WGMMA else k + 2 * _rank_pad(r)


def w8_splits(m: int, n: int, k: int, sms: int) -> int:
    """Slices of K for the split-K `wgmma` kernel: the fewest (a power of
    two, at most ``W8_MAX_SPLITS``) that put at least one block on each of
    ``sms`` SMs, with every slice at least two K tiles long. M = 64,
    N = K = 2048 on 132 SMs: 32 output tiles x 8 slices of 256 rows."""
    tiles = -(-n // W8_TILE) * -(-m // W8_TILE)
    nk = -(-k // W8_BK)
    s = 1
    while tiles * s < sms and 2 * s * 2 <= nk and s < W8_MAX_SPLITS:
        s *= 2
    return s


def ba_f32_splits(m: int, n: int, k: int, r: int, sms: int) -> int:
    """Slices of the K + r rows for K2's f32 instance: the fewest (a power
    of two) that put about two blocks on each of ``sms`` SMs with every
    slice at least 32 rows long, and never a slice above
    ``BA32_MAX_ROWS``. M = 4, N = K = 1024, r = 8 on 132 SMs: 8 tiles x 16
    slices of 65 rows."""
    rows = k + r
    tiles = -(-n // BA32_TILE_N) * -(-m // BA32_TILE_M)
    s = 1
    while tiles * s < 2 * sms and rows >= 2 * s * 32:
        s *= 2
    return max(s, -(-rows // BA32_MAX_ROWS))


def ba_f32_workspace_elems(m: int, n: int, k: int, r: int,
                           splits: int) -> int:
    """f32 elements of K2's f32 workspace: the pre-pass's partials of P
    (M, ceil(K / 256), r), then the slices' partial tiles."""
    tiles = -(-n // BA32_TILE_N) * -(-m // BA32_TILE_M)
    part = tiles * BA32_TILE_M * BA32_TILE_N * splits if splits > 1 else 0
    return m * -(-k // PRE_K) * r + part


def _padded(k: int, n: int, w_dtype) -> tuple:
    """(K, N) as the split-K kernel takes them: rows of x (bf16) and of W
    a multiple of 16 bytes — K a multiple of 8, N of 16 bytes' worth of
    W's dtype (8 bf16, 16 int8)."""
    nm = 16 // w_dtype.itemsize
    return -(-k // 8) * 8, -(-n // nm) * nm


def ba_plan(m: int, n: int, k: int, r: int, sms: int) -> tuple:
    """K2's (and #10's, and #9's) kernel form and slices of K for
    operands of these (padded) sizes: ``(k1_variant(r), w8_splits(...))``
    over ``splitk_rows(k, r)``. Every rank takes the split-K `wgmma`
    kernel; above ``RANK_WGMMA`` after the hi + lo pre-pass."""
    return k1_variant(r), w8_splits(m, n, splitk_rows(k, r), sms)


def _sms(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def splitk_path(x, w, r: int) -> tuple:
    """``ba_plan`` on the operands of K2 (bf16 W), #9 or #10 (int8 W):
    x (M, K), W (K, N), at the padded sizes ``vec_operands`` gives."""
    kp, np_ = _padded(x.shape[1], w.shape[1], w.dtype)
    return ba_plan(x.shape[0], np_, kp, r, _sms(x))


def _fit(t, shape: tuple, align: int = 16):
    """t if it already has this shape, is contiguous and sits on an
    ``align``-byte boundary; else a zero-padded aligned copy."""
    if (tuple(t.shape) == shape and t.is_contiguous()
            and t.data_ptr() % align == 0):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, d) for d in t.shape)] = t
    return out


def vec_operands(x, w, scale, a, b, batched: bool) -> tuple:
    """The split-K kernel's operands: K and N padded (``_padded``) with
    zero rows / columns, x, W, B (and the per-row A) contiguous on 16-byte
    boundaries, scales on 8-byte ones. Returns (x, w, scale, a, b,
    copied); operands that already qualify pass through uncopied. #9's
    shared A is read through its strides and is copied only to pad K."""
    m, k = x.shape
    n = w.shape[1]
    kp, np_ = _padded(k, n, w.dtype)
    r = a.shape[-1]
    new = (_fit(x, (m, kp)), _fit(w, (kp, np_)),
           None if scale is None else _fit(scale, (scale.shape[0], np_), 8),
           _fit(a, (m, kp, r)) if batched
           else (a if kp == k else _fit(a, (kp, r))),
           _fit(b, (r, np_)))
    copied = any(p is not q for p, q in zip(new, (x, w, scale, a, b)))
    return (*new, copied)


def _workspace(x, r: int):
    """The pre-pass's workspace: f32 partial P sums (K2 / #10 up to
    ``RANK_WGMMA``), the bf16 hi + lo pair (every larger rank), or None
    (#9 up to ``RANK_WGMMA``: P in registers)."""
    m, k = x.shape
    if r > RANK_WGMMA:
        return torch.empty(k1_workspace_elems(m, r), dtype=torch.bfloat16,
                           device=x.device)
    return torch.empty(m * -(-k // PRE_K) * r, dtype=torch.float32,
                       device=x.device)


def _check_cuda(x, w, a, b, what: str, w_dtype=None,
                dtype=torch.bfloat16) -> None:
    """Device and dtypes: every operand in ``dtype`` (W in ``w_dtype``,
    default ``dtype``); anything else — f32 where only bf16 is built,
    mixed dtypes — raises ``TypeError``."""
    _build.check_device(x)
    for t, n, dt in ((x, "x", dtype), (w, "w", w_dtype or dtype),
                     (a, "a", dtype), (b, "b", dtype)):
        if t.dtype != dt:
            raise TypeError(f"{what}: the CUDA kernel takes {dt} for {n}; "
                            f"got {t.dtype} (f32 instances exist for K1, "
                            "K2, #9, #10, K3 / #5, #6, #7, K4, #8 and #8q "
                            "only)")
        if t.device != x.device:
            raise ValueError(f"{what}: {n} is on {t.device}, x on {x.device}")


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


def _launch_splitk(name: str, x, w, scale, a, b, alpha,
                   splits: int = 0) -> torch.Tensor:
    """K2 (``scale`` None), #9 or #10 on checked CUDA operands: padded
    and aligned by ``vec_operands``, then the pre-pass (where the rank
    term needs one) and the split-K kernel over ``splits`` slices of K
    (0: ``ba_plan``'s); N's padding is cut off y."""
    batched = name != "tt_linear_w8"
    m, n, r = x.shape[0], w.shape[1], a.shape[-1]
    x, w, scale, a, b, _ = vec_operands(x, w, scale, a, b, batched)
    kp, np_ = x.shape[1], w.shape[1]
    y = torch.empty((m, np_), dtype=x.dtype, device=x.device)
    if m == 0:
        return y[:, :n]
    splits = splits or ba_plan(m, np_, kp, r, _sms(x))[1]
    ws = _workspace(x, r) if batched or r > RANK_WGMMA else None
    common = (m, np_, kp, r)
    tail = (splits, None if ws is None else ws.data_ptr(),
            _build.stream_ptr(x))
    if name == "tt_linear_batched_a":
        rc = _fn("tt_linear_batched_a_bf16")(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), *common, float(alpha), *tail)
    elif name == "tt_linear_w8":
        st = (ctypes.c_longlong * 6)(0, 0, *a.stride(), *b.stride())
        rc = _fn("tt_linear_w8_bf16")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), a.data_ptr(),
            b.data_ptr(), y.data_ptr(), *common, scale.shape[0],
            float(alpha), ctypes.cast(st, ctypes.c_void_p), *tail)
    else:
        rc = _fn("tt_linear_batched_a_w8_bf16")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), a.data_ptr(),
            b.data_ptr(), y.data_ptr(), *common, scale.shape[0],
            float(alpha), *tail)
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return y if np_ == n else y[:, :n].contiguous()


def _launch_w8(name, x, wq, scale, a, b, alpha, batched: bool):
    """#9 / #10 on checked shapes: CUDA operands, or the plain version."""
    m, k = x.shape
    g = _check_scale(wq, scale, name)
    _build.check_no_grad((x, scale, a, b), name)
    if not x.is_cuda:
        plain = (tt_linear_batched_a_w8_plain if batched
                 else tt_linear_w8_plain)
        return plain(x, wq, scale, a, b, alpha)
    f32 = x.dtype == torch.float32
    _check_cuda(x, wq, a, b, name, w_dtype=torch.int8,
                dtype=torch.float32 if f32 else torch.bfloat16)
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise TypeError(f"{name}: scales must be f32 on {x.device}")
    if g > 1 and (k // g) % 128:
        raise NotImplementedError(
            f"{name}: CUDA kernel built for scale groups of a multiple of "
            f"128 rows; got {k // g}")
    if batched and not 1 <= m <= BATCHED_A_ROWS:
        raise ValueError(f"{name}: M={m} outside 1..{BATCHED_A_ROWS} "
                         "(batched A)")
    if f32:
        launch = _launch_ba_f32 if batched else _launch_k1_f32
        return launch(x, wq, a, b, alpha, scale=scale.contiguous())
    return _launch_splitk(name, x, wq, scale, a, b, alpha)


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


def _launch_k1_f32(x, w, a, b, alpha, scale=None) -> torch.Tensor:
    """K1's f32 instance on checked CUDA operands — or, given the f32
    ``scale`` (G, N) of an int8 W, #9's: the pre-pass writes P = α·x·A
    (M, r) in f32, then y = x·W + P·B (W = q·s); W, A and B are read
    through their strides."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    x = x.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    ws = torch.empty(m * r, dtype=torch.float32, device=x.device)
    st = ctypes.cast((ctypes.c_longlong * 6)(*w.stride(), *a.stride(),
                                             *b.stride()), ctypes.c_void_p)
    if scale is None:
        name = "tt_linear_f32"
        rc = _fn(name)(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                       b.data_ptr(), y.data_ptr(), m, n, k, r, float(alpha),
                       st, ws.data_ptr(), _build.stream_ptr(x))
    else:
        name = "tt_linear_w8_f32"
        rc = _fn(name)(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                       a.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, r,
                       scale.shape[0], float(alpha), st, ws.data_ptr(),
                       _build.stream_ptr(x))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return y


def _launch_ba_f32(x, w, a, b, alpha, splits: int = 0,
                   scale=None) -> torch.Tensor:
    """K2's f32 instance on checked CUDA operands, any M — or, given the
    f32 ``scale`` (G, N) of an int8 W, #10's: the pre-pass, then the
    slices of K + r rows (``splits``, 0: ``ba_f32_splits``'s); W, A and B
    are read through their strides."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    x = x.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    splits = splits or ba_f32_splits(m, n, k, r, _sms(x))
    ws = torch.empty(ba_f32_workspace_elems(m, n, k, r, splits),
                     dtype=torch.float32, device=x.device)
    tiles = -(-n // BA32_TILE_N) * -(-m // BA32_TILE_M)
    cnt = _build.counters(x.device, tiles) if splits > 1 else None
    st = ctypes.cast((ctypes.c_longlong * 7)(*w.stride(), *a.stride(),
                                             *b.stride()), ctypes.c_void_p)
    tail = (splits, ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
            _build.stream_ptr(x))
    if scale is None:
        name = "tt_linear_batched_a_f32"
        rc = _fn(name)(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                       b.data_ptr(), y.data_ptr(), m, n, k, r, float(alpha),
                       st, *tail)
    else:
        name = "tt_linear_batched_a_w8_f32"
        rc = _fn(name)(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                       a.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, r,
                       scale.shape[0], float(alpha), st, *tail)
    _build.check(rc, name)
    LAUNCHES[name] += 1
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
    if x.dtype == torch.float32:
        _check_cuda(x, w, a, b, "tt_linear", dtype=torch.float32)
        return _launch_k1_f32(x, w, a, b, alpha)
    _check_cuda(x, w, a, b, "tt_linear")
    return _launch_k1(x, w, a, b, alpha, k1_variant(r))


def tt_linear_batched_a(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x (M, K), w (K, N), a (M, K, r), b (r, N) -> y (M, N); on the card
    bf16 takes M <= 64 (one launch; ``ops.tt_linear_batched_a`` splits
    larger M in either dtype), f32 any M in one launch."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[2]
    if w.shape[0] != k or a.shape[:2] != (m, k) or b.shape != (r, n):
        raise ValueError(f"tt_linear_batched_a shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    _build.check_no_grad((x, w, a, b), "tt_linear_batched_a")
    if not x.is_cuda:
        return tt_linear_batched_a_plain(x, w, a, b, alpha)
    if x.dtype == torch.float32:
        _check_cuda(x, w, a, b, "tt_linear_batched_a", dtype=torch.float32)
        return _launch_ba_f32(x, w, a, b, alpha)
    _check_cuda(x, w, a, b, "tt_linear_batched_a")
    if not 1 <= m <= BATCHED_A_ROWS:
        raise ValueError(f"tt_linear_batched_a: M={m} outside "
                         f"1..{BATCHED_A_ROWS}")
    return _launch_splitk("tt_linear_batched_a", x, w, None, a, b, alpha)


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
    return _launch_w8("tt_linear_w8", x, wq, scale, a, b, alpha, False)


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
                      True)
