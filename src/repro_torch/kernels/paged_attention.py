"""Paged attention kernel (``csrc/paged_attention.cu``), which also runs
K4, the dense-cache decode attention of ``flash_attention.py``.

#8 ``paged_decode_attention``: C query tokens per slot against flat
(N, page, KV, d) K/V block pools through a (B, P) block table; query c of
slot b sits at position pos[b] + c and attends cells [0, pos[b] + c].
Table entries >= N are sentinels, clamped to N - 1 and hidden by the mask
wherever it reaches them; pages past pos[b] + C - 1 are never read.
Replaces the fp leg of
``src/repro/kernels/paged_attention.py::paged_decode_attention``.
#8q ``paged_decode_attention_int8``: its int8 leg — int8 (N, page, KV, d)
pools with (N, page, KV) f32 per-cell scale pools; the scales are applied
in f32 and p is kept above bf16 precision through P·V (the TPU kernel's
f32), the output is in q's dtype.

A CPU tensor runs the plain version (``kernels/ref.py``). A CUDA tensor
launches the kernel (bf16 q, bf16 or int8 pools, head_dim 64, 128 or 256
— gemma-7b's, counted under the kernel's name + ``_d256``: ``mma.sync``
in slabs of at most 64 rows, a two-stage ring of 32 KB tiles — or 112,
kimi-k2's, counted under + ``_d112``: the d = 128 kernels on tiles padded
in shared memory, the pools 112 wide (an int8 row 112 bytes); f32
q, f32 or int8 pools, head_dim 64; any GQA group in bf16 — a slab may
start mid-column, as granite-34b's G = 48 has it — and G in {1, 2, 4, 8}
in f32 (``flash_attention.GROUPS_F32``); page a multiple of 8 up to
64; a contiguous last dim, strides of whole 16 bytes, 16-byte aligned
data) or raises; mixed fp dtypes raise. f32 operands
(RoBERTa serves in f32) launch the f32 instances, counted under the
kernel's name + ``_f32``: FFMA tiles (``csrc/attention_f32.cuh``), all
C·G rows of a (slot, kv head) up to 64 in a block, a two-stage cp.async
ring of f32 K / V tiles (#8q: int8 tiles widened exactly to f32, both
scales applied in f32), the same chunk rule and fixed-order merge. The
bf16 legs run one tensor-core kernel with all C·G rows of a (slot, kv
head) in one block: #8 ``mma.sync`` below 64 rows, ``wgmma`` from 64; #8q
``mma.sync`` in slabs of at most 64 rows, its int8 tiles widened exactly
to bf16 in shared memory and p·s_v fed as a bf16 hi + lo pair; where the
blocks leave the card under-filled each window is split into chunks
merged in a fixed order (``paged_path``). K4
(``flash_attention.decode_attention``) runs the fp leg at C = 1 over the
dense (B, S, KV, d) cache, with no table (``decode_path``,
``launch_dense``), in f32 on the f32 kernel.
``LAUNCHES`` counts the launches, and nothing else adds to it. The
kernel is serving-only: an input that requires grad while autograd
records raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

LAUNCHES = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            "paged_decode_attention_f32": 0,
            "paged_decode_attention_int8_f32": 0,
            "paged_decode_attention_d256": 0,
            "paged_decode_attention_int8_d256": 0,
            "paged_decode_attention_d112": 0,
            "paged_decode_attention_int8_d112": 0}

PAGES = tuple(range(8, 65, 8))
#: cells a streamed tile of #8's kernel, and the most rows a block takes
#: (#8q and every bf16 block at head_dim 256: one ``mma.sync``
#: warpgroup's; the f32 instances: 64)
TILE_CELLS, SLAB_ROWS, SLAB_ROWS_Q8, SLAB_ROWS_F32 = 64, 256, 64, 64
#: threads a block of the f32 instances
THREADS_F32 = 256


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
    p, i = ctypes.c_void_p, ctypes.c_int
    if name.startswith("paged_attention_int8"):
        # q k v k_scale v_scale tables pos o, B C H KV d N page P, strides,
        # split, ws, cnt, stream
        f.argtypes = [p] * 8 + [i] * 8 + [p, i, p, p, p]
    elif name.startswith("dense_decode_attention"):
        # q k v pos o, B S H KV d, strides, split, ws, cnt, stream
        f.argtypes = [p] * 5 + [i] * 5 + [p, i, p, p, p]
    else:
        # q k v tables pos o, B C H KV d N page P, strides, split, ws, cnt,
        # stream
        f.argtypes = [p] * 6 + [i] * 8 + [p, i, p, p, p]
    f.restype = ctypes.c_int
    return f


def slab_rows(c: int, g: int, quantized: bool = False,
              f32: bool = False, d: int = 64) -> int:
    """Rows (column, head pairs) a block of #8 / #8q takes: all C·G of a
    (slot, kv head) up to ``SLAB_ROWS`` (#8q and head_dim 256:
    ``SLAB_ROWS_Q8``, one ``mma.sync`` warpgroup; the f32 instances
    ``SLAB_ROWS_F32``); above that, slabs of that many rows."""
    cap = (SLAB_ROWS_F32 if f32 else SLAB_ROWS_Q8 if quantized or d == 256
           else SLAB_ROWS)
    return min(c * g, cap)


def f32_row_tile(brows: int) -> int:
    """Query rows the f32 kernel pads a block's ``brows`` rows to: 16,
    32 or 64 (RA = 1, 2 or 4 rows a thread row)."""
    return 16 if brows <= 16 else 32 if brows <= 32 else 64


def f32_workspace_elems(blocks: int, chunks: int, brows: int,
                        d: int) -> int:
    """f32 elements of the f32 kernel's split workspace: each chunk of
    each block keeps (m, l, O) a thread: RA · (d / 16 + 2) floats."""
    ra = f32_row_tile(brows) // 16
    return blocks * chunks * THREADS_F32 * ra * (d // 16 + 2)


def paged_path(b: int, c: int, h: int, kv: int, p_tab: int, page: int,
               sms: int, quantized: bool = False, f32: bool = False,
               d: int = 64) -> tuple:
    """How #8's kernel runs: ``("mma", split)`` below 64 rows a block
    (C·G < 64), else ``("wgmma", split)``; #8q (``quantized``) and every
    block at head_dim ``d`` = 256 always ``"mma"``, in slabs of at most
    64 rows. ``split`` is the tiles of 64
    cells a chunk of each window when the blocks (B·KV·slabs) would leave
    the card under-filled (fewer than two on each of ``sms`` SMs), so
    that about four blocks an SM run, and 0 (one block a window)
    otherwise. ``f32``: the f32 instances' FFMA kernel (``"ffma"``), in
    slabs of at most 64 rows, by the same chunk rule."""
    rows = c * (h // kv)
    mode = ("ffma" if f32 else "mma" if quantized or rows < 64 or d == 256
            else "wgmma")
    blocks = b * kv * -(-rows // slab_rows(c, h // kv, quantized, f32, d))
    return mode, _chunk_tiles(blocks, -(-p_tab * page // TILE_CELLS), sms)


def dense_slabs(h: int, kv: int) -> int:
    """Blocks K4 gives a (slot, kv head): its G = H / KV query rows in
    slabs of at most ``SLAB_ROWS_Q8`` (one ``mma.sync`` warpgroup)."""
    return -(-(h // kv) // SLAB_ROWS_Q8)


def decode_path(b: int, h: int, kv: int, s: int, sms: int) -> tuple:
    """How K4 runs on #8's kernel: ``("mma", split)`` — a block of a (slot,
    kv head) holds its G = H / KV query rows on ``mma.sync`` (slabs of 64
    above G = 64: ``dense_slabs``), and windows of the S-cell dense cache
    split into chunks of ``split`` 64-cell tiles by ``paged_path``'s rule
    (0: one block a window)."""
    return "mma", _chunk_tiles(b * kv * dense_slabs(h, kv),
                               -(-s // TILE_CELLS), sms)


def _chunk_tiles(blocks: int, tiles: int, sms: int) -> int:
    """Tiles of 64 cells a chunk when ``blocks`` blocks of windows of up
    to ``tiles`` tiles would leave the card under-filled (fewer than two
    on each of ``sms`` SMs): about four blocks an SM; else 0."""
    if blocks >= 2 * sms or tiles < 2:
        return 0
    split = -(-tiles // -(-4 * sms // blocks))
    return split if split < tiles else 0


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


def _check_kernel_dims(q, h, kv, page, what: str) -> None:
    _fa.check_group_f32(q, h // kv, what)
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
    sfx = _fa._check_cuda((q, k_cache, v_cache), d, what)
    _check_kernel_dims(q, h, kv, page, what)
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    st = _fa._strides(q, k_cache, v_cache, o)
    st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, split = paged_path(b, c, h, kv, tables.shape[1], page, sms,
                          f32=q.dtype == torch.float32, d=d)
    rc = _launch_tc(q, k_cache, v_cache, tables, pos, o, n, page, st, split)
    _build.check(rc, what)
    LAUNCHES[what + sfx] += 1
    return o


def _launch_tc(q, k_cache, v_cache, tables, pos, o, n: int, page: int, st,
               split: int, scales=None) -> int:
    """#8's kernel (#8q's with ``scales`` = (k_scale, v_scale)) over
    checked CUDA operands with ``split`` tiles a chunk (0: one block a
    window); returns the launch's cudaError. A split run takes an f32
    workspace for the chunks' partial states and the shared zeroed
    counters (``_build.counters``)."""
    b, c, h, d = q.shape
    kv, p_tab = k_cache.shape[2], tables.shape[1]
    f32 = q.dtype == torch.float32
    ws = cnt = None
    if split:
        rows = c * (h // kv)
        brows = slab_rows(c, h // kv, scales is not None, f32, d)
        slabs = -(-rows // brows)
        chunks = -(-p_tab * page // (TILE_CELLS * split))
        if f32:
            elems = f32_workspace_elems(b * kv * slabs, chunks, brows, d)
        else:
            threads = 128 * (1 if brows <= 64 else 2 if brows <= 128 else 4)
            elems = (b * kv * slabs * chunks * threads
                     * (_fa.tile_dim(d) // 2 + 4))
        ws = torch.empty(elems, dtype=torch.float32, device=q.device)
        cnt = _build.counters(q.device, b * kv * slabs)
    head = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
    if scales is not None:
        head += [t.data_ptr() for t in scales]
    return _fn(("paged_attention_bf16" if scales is None
                else "paged_attention_int8") if not f32 else
               ("paged_attention_f32" if scales is None
                else "paged_attention_int8_f32"))(
        *head, tables.data_ptr(), pos.data_ptr(), o.data_ptr(), b, c, h, kv,
        d, n, page, p_tab, ctypes.cast(st, ctypes.c_void_p), split,
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), _build.stream_ptr(q))


def launch_dense(q, k, v, pos, o, split: int) -> int:
    """K4 on checked CUDA operands (q, o (B, H, d); k, v (B, S, KV, d)
    read through their strides; pos (B,) int32) with ``split`` tiles a
    chunk (0: one block a window); returns the launch's cudaError. A split
    run takes the workspace and counters as ``_launch_tc``'s, for the
    ``dense_slabs`` blocks of each (slot, kv head) (f32: one)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    f32 = q.dtype == torch.float32
    ws = cnt = None
    if split:
        chunks = -(-s // (TILE_CELLS * split))
        blocks = b * kv * (1 if f32 else dense_slabs(h, kv))
        elems = (f32_workspace_elems(blocks, chunks, h // kv, d) if f32
                 else blocks * chunks * 128 * (_fa.tile_dim(d) // 2 + 4))
        ws = torch.empty(elems, dtype=torch.float32, device=q.device)
        cnt = _build.counters(q.device, blocks)
    st = _fa._strides(q, k, v, o)
    return _fn("dense_decode_attention_f32" if f32
               else "dense_decode_attention_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), b, s, h, kv, d, ctypes.cast(st, ctypes.c_void_p), split,
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), _build.stream_ptr(q))


def int8_strides(q, k_cache, v_cache, k_scale, v_scale, tables, o):
    """The 19 element strides #8q's kernel reads: q, k, v, o, the table
    row, then the two scale pools."""
    return (ctypes.c_longlong * 19)(
        *_fa._strides(q, k_cache, v_cache, o), tables.stride(0),
        *k_scale.stride(), *v_scale.stride())


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
    sfx = _fa._check_cuda((q,), d, what)
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
    _check_kernel_dims(q, h, kv, page, what)
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    st = int8_strides(q, k_cache, v_cache, k_scale, v_scale, tables, o)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, split = paged_path(b, c, h, kv, tables.shape[1], page, sms,
                          quantized=True, f32=q.dtype == torch.float32,
                          d=d)
    rc = _launch_tc(q, k_cache, v_cache, tables, pos, o, n, page, st, split,
                    (k_scale, v_scale))
    _build.check(rc, what)
    LAUNCHES[what + sfx] += 1
    return o
