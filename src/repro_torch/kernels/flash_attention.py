"""Attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

K3 ``flash_attention``: online-softmax attention, q (B, T, H, d) against
k/v (B, S, KV, d), read in place through strides with KV head h // G —
replaces ``src/repro/kernels/flash_attention.py::flash_attention``.
#5 ``flash_attention_fwd``: the same kernel also writing the per-row
log-sum-exp (B, H, T) f32 — replaces ``flash_attention_fwd``.
#6 / #7 ``flash_attention_bwd``: the dq pass, then the dk/dv pass, each
rebuilding p = exp(s − lse) tile by tile; dk/dv come back in the KV-head
layout, the GQA group summed in f32 inside the kernel — replaces the two
``pallas_call``s of ``flash_attention_bwd``.
K4 ``decode_attention``: one query per (slot, head) against the dense
(B, S, KV, d) cache, cells 0..min(pos[b], S - 1) — replaces
``src/repro/kernels/flash_attention.py::decode_attention``. It runs #8's
tensor-core kernel over the dense cache (``csrc/paged_attention.cu``,
``paged_attention.decode_path`` / ``launch_dense``).

A CPU tensor runs the plain version (``kernels/ref.py``, through the
layout shims below). A CUDA tensor launches the kernel or raises: bf16
operands at head_dim 64, 128 and 256 (gemma-7b; the d = 256 instances of
K3 / #5, #6, #7 and K4 are counted under the kernel's name + ``_d256``;
#7's at d = 256 runs two warpgroups a block, one owning dk and one dv),
and at 112 for K3 / #5, #6, #7 and K4 (kimi-k2: the d = 128 kernels on
tiles padded in shared memory, ``tile_dim``; counted under + ``_d112``);
f32 operands (RoBERTa trains and
serves in f32) launch the f32 instances of K3 / #5, #6, #7 and K4 at
head_dim 64 (FFMA, ``csrc/attention_f32.cuh``; counted under the
kernel's name + ``_f32``; K4's is #8's f32 kernel over the dense cache);
mixed dtypes raise. Any GQA group G for the bf16 kernels: the forward
(K3 / #5), the backward (#6; #7 in slabs of heads of each group where
the unsplit grid would leave the SMs short, ``dkv_slab_heads``, merged
in a fixed order) and decode (K4: groups above 64 in slabs of 64 rows, a
block each); G in {1, 2, 4, 8} for the f32 instances (``GROUPS_F32``),
which raise ``NotImplementedError`` outside it.
Operands need a contiguous last dim, strides of whole 16 bytes (8 bf16
or 4 f32 elements) and 16-byte aligned data. ``LAUNCHES`` counts the
launches, and nothing else adds to it.
These wrappers make plain outputs with no ``grad_fn``: an input that
requires grad while autograd records raises, so the only way to
differentiate through them is ``dispatch.py``'s ``autograd.Function``s.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"flash_attention": 0, "decode_attention": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_f32": 0,
            "flash_attention_fwd_f32": 0, "flash_attention_bwd_dq_f32": 0,
            "flash_attention_bwd_dkv_f32": 0, "decode_attention_f32": 0,
            "flash_attention_d256": 0, "flash_attention_fwd_d256": 0,
            "flash_attention_bwd_dq_d256": 0,
            "flash_attention_bwd_dkv_d256": 0, "decode_attention_d256": 0,
            "flash_attention_d112": 0, "flash_attention_fwd_d112": 0,
            "flash_attention_bwd_dq_d112": 0,
            "flash_attention_bwd_dkv_d112": 0, "decode_attention_d112": 0}

#: head dims of the bf16 forward and decode kernels (K3 / #5, K4, #8, #8q);
#: 112 runs on tiles of 128 (``tile_dim``)
HEAD_DIMS = (64, 112, 128, 256)
#: head dims of the bf16 backward (#6 / #7; 112 on tiles of 128 too)
HEAD_DIMS_BWD = (64, 112, 128, 256)
#: head dims of the f32 instances (RoBERTa's heads of 64)
HEAD_DIMS_F32 = (64,)
#: GQA groups of the f32 instances of K4, #8, #8q, #6 and #7 (RoBERTa's
#: G = 1); the bf16 kernels take any group
GROUPS_F32 = (1, 2, 4, 8)
#: the dtypes the attention kernels are built for (f32 at HEAD_DIMS_F32)
DTYPES = (torch.bfloat16, torch.float32)


def _repeat_kv(q, k, v):
    """(B, T, H, d) x (B, S, KV, d) -> the three in (B, H, ·, d) with KV
    heads repeated to H (as ``ops.py`` does in JAX)."""
    g = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(g, dim=2) if g > 1 else k
    vv = v.repeat_interleave(g, dim=2) if g > 1 else v
    return q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)


def flash_attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """(B, T, H, d) x (B, S, KV, d) layout shim over
    ``flash_attention_ref``."""
    out = _ref.flash_attention_ref(*_repeat_kv(q, k, v), causal=causal)
    return out.transpose(1, 2)


def flash_attention_fwd_plain(q, k, v, causal: bool = True):
    """Layout shim over ``flash_attention_fwd_ref``: (out (B, T, H, d),
    lse (B, H, T) f32)."""
    out, lse = _ref.flash_attention_fwd_ref(*_repeat_kv(q, k, v),
                                            causal=causal)
    return out.transpose(1, 2), lse


def flash_attention_bwd_plain(q, k, v, o, lse, g, causal: bool = True):
    """Layout shim over ``flash_attention_bwd_ref``: (dq (B, T, H, d),
    dk, dv (B, S, KV, d)); each GQA group of query heads summed in f32 onto
    its KV head, then rounded once to the operand dtype."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qh, kh, vh = _repeat_kv(q, k, v)
    dq, dk, dv = _ref.flash_attention_bwd_ref(
        qh, kh, vh, o.transpose(1, 2), lse, g.transpose(1, 2), causal)

    def group_sum(x, dtype):
        return x.reshape(b, kv, h // kv, s, d).sum(2).transpose(1, 2) \
            .to(dtype)
    return (dq.transpose(1, 2).to(q.dtype), group_sum(dk, k.dtype),
            group_sum(dv, v.dtype))


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


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # q k v o lse, B T S H KV d causal variant, strides, stream
    "flash_attention_bf16": [_P] * 5 + [_I] * 8 + [_P, _P],
    # q k v o g lse delta dq, B T S H KV d causal, strides, stream
    "flash_attention_bwd_dq_bf16": [_P] * 8 + [_I] * 7 + [_P, _P],
    # q k v g lse delta dk dv, B T S H KV d causal, strides, heads a
    # slab, ws, cnt, stream
    "flash_attention_bwd_dkv_bf16": [_P] * 8 + [_I] * 7 + [_P, _I] + [_P] * 3,
    # q k v o lse, B T S H KV d causal, strides, stream
    "flash_attention_f32": [_P] * 5 + [_I] * 7 + [_P, _P],
    "flash_attention_bwd_dq_f32": [_P] * 8 + [_I] * 7 + [_P, _P],
    "flash_attention_bwd_dkv_f32": [_P] * 8 + [_I] * 7 + [_P, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    lib = "flash_attention_bwd" if "bwd" in name else "flash_attention"
    f = getattr(_build.library(lib), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


def tile_dim(d: int) -> int:
    """The width of the shared-memory tiles a bf16 head_dim ``d`` runs on:
    ``d`` padded to the next multiple of 64 (kimi-k2's 112 -> 128; the
    padding columns are zero-filled in shared memory and never stored).
    The split workspaces of K4 / #8 / #8q and #7's slab workspace are
    sized by it."""
    return -(-d // 64) * 64


def _instance(t) -> str:
    """The suffix of the C function an operand launches: "_f32" or ""
    (bf16, after "_bf16")."""
    return "_f32" if t.dtype == torch.float32 else ""


def _suffix(t) -> str:
    """The ``LAUNCHES`` suffix of the instance an operand launches: "_f32",
    "_d256" / "_d112" (bf16 at head_dim 256 / 112) or "" (bf16 at 64 /
    128)."""
    return _instance(t) or {256: "_d256", 112: "_d112"}.get(t.shape[-1], "")


def _check_cuda(ts, d: int, what: str, dtypes=DTYPES,
                dims=HEAD_DIMS) -> str:
    """Device, dtype, layout and head_dim of the operands ``ts`` (bf16 in
    ``dims``, f32 in ``HEAD_DIMS_F32``); returns the instance's
    ``LAUNCHES`` suffix (``_suffix``). Every operand in one of ``dtypes``
    and all in the same one, else ``TypeError``."""
    _build.check_device(ts[0])
    dt = ts[0].dtype
    if dt not in dtypes:
        raise TypeError(f"{what}: the CUDA kernel takes "
                        f"{' or '.join(map(str, dtypes))}; got {dt}")
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"{what}: mixed operand dtypes {dt} and "
                            f"{t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{ts[0].device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{what}: operands need a contiguous last dim, "
                             "strides of whole 16 bytes and 16-byte "
                             "aligned data")
    dims = HEAD_DIMS_F32 if dt == torch.float32 else dims
    if d not in dims:
        raise NotImplementedError(
            f"{what}: CUDA kernel built for head_dim in {dims} ({dt}); "
            f"got {d}")
    return _suffix(ts[0])


def check_group_f32(q, g: int, what: str) -> None:
    """The f32 instances of K4, #8, #8q, #6 and #7 take G in
    ``GROUPS_F32``; raise ``NotImplementedError`` before the launch
    otherwise (the bf16 instances take any group)."""
    if q.dtype == torch.float32 and g not in GROUPS_F32:
        raise NotImplementedError(
            f"{what}: f32 CUDA kernel built for GQA groups {GROUPS_F32}; "
            f"got {g}")


def _strides(*ts) -> ctypes.Array:
    vals = [st for t in ts for st in t.stride()[:-1]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_attn(q, k, v, what: str) -> tuple:
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or h % kv:
        raise ValueError(f"{what} shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    return b, t, s, h, kv, d


def _dims(q, k) -> tuple:
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3])


#: the forward kernel's variants (``csrc/flash_attention.cu``): one
#: warpgroup of 64 query rows a block, or two (128 rows sharing each K/V
#: tile)
FWD_VARIANTS = {"wg1": 1, "wg2": 2}
#: queries from which two warpgroups a block run faster (measured on an
#: H100 at d = 64: one is faster at T = 16..256, two at T = 1000, 1024)
WG2_FROM_T = 512


def fwd_variant(t: int, d: int = 64) -> str:
    """Which variant K3 / #5 launch for T queries at head_dim ``d``; at
    d = 256 one warpgroup always (two would not fit in shared memory)."""
    return "wg2" if t >= WG2_FROM_T and d != 256 else "wg1"


def _launch_fwd(q, k, v, causal: bool, lse, variant=None) -> torch.Tensor:
    """K3 (lse None) or #5 (lse a (B, H, T) f32 buffer): one kernel, on
    checked CUDA operands; ``variant`` defaults to ``fwd_variant``'s. f32
    operands run the f32 instance (one variant)."""
    b, t, s, h, kv, d = _dims(q, k)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = ctypes.cast(_strides(q, k, v, o), ctypes.c_void_p)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, t, s, h, kv, d,
            int(causal))
    if _instance(q):
        rc = _fn("flash_attention_f32")(*ptrs, st, _build.stream_ptr(q))
    else:
        variant = variant or fwd_variant(t, d)
        rc = _fn("flash_attention_bf16")(*ptrs, FWD_VARIANTS[variant], st,
                                         _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """K3. q (B, T, H, d); k, v (B, S, KV, d) -> (B, T, H, d)."""
    _check_attn(q, k, v, "flash_attention")
    _build.check_no_grad((q, k, v), "flash_attention")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    sfx = _check_cuda((q, k, v), q.shape[-1], "flash_attention")
    o = _launch_fwd(q, k, v, causal, None)
    LAUNCHES["flash_attention" + sfx] += 1
    return o


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """#5. q (B, T, H, d); k, v (B, S, KV, d) -> (out (B, T, H, d),
    lse (B, H, T) f32)."""
    b, t, _, h, _, d = _check_attn(q, k, v, "flash_attention_fwd")
    _build.check_no_grad((q, k, v), "flash_attention_fwd")
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, causal)
    sfx = _check_cuda((q, k, v), d, "flash_attention_fwd")
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    o = _launch_fwd(q, k, v, causal, lse)
    LAUNCHES["flash_attention_fwd" + sfx] += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        causal: bool = True):
    """#6 then #7. q, o, g (B, T, H, d); k, v (B, S, KV, d); lse (B, H, T)
    f32 from ``flash_attention_fwd`` -> (dq (B, T, H, d), dk, dv
    (B, S, KV, d))."""
    b, t, s, h, kv, d = _check_attn(q, k, v, "flash_attention_bwd")
    if o.shape != q.shape or g.shape != q.shape or lse.shape != (b, h, t):
        raise ValueError(f"flash_attention_bwd shapes o{tuple(o.shape)} "
                         f"g{tuple(g.shape)} lse{tuple(lse.shape)}")
    _build.check_no_grad((q, k, v, o, lse, g), "flash_attention_bwd")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    _check_cuda((q, k, v, o, g), d, "flash_attention_bwd",
                dims=HEAD_DIMS_BWD)
    check_group_f32(q, h // kv, "flash_attention_bwd")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError("flash_attention_bwd: lse must be f32 on "
                        f"{q.device}; got {lse.dtype} on {lse.device}")
    lse = lse.contiguous()
    dq, delta = _launch_bwd_dq(q, k, v, o, lse, g, causal)
    dk, dv = _launch_bwd_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


def _launch_bwd_dq(q, k, v, o, lse, g, causal: bool):
    """#6 on checked CUDA operands: (dq, delta = rowsum(g ⊙ o) (B, H, T)
    f32, written by the kernel's prologue for #7)."""
    b, t, s, h, kv, d = _dims(q, k)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides(q, k, v, o, g, dq)
    rc = _fn("flash_attention_bwd_dq" + (_instance(q) or "_bf16"))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, s, h, kv, d,
        int(causal), ctypes.cast(st, ctypes.c_void_p), _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd (dq)")
    LAUNCHES["flash_attention_bwd_dq" + _suffix(q)] += 1
    return dq, delta


#: rows of a block of #7 (its key tile)
DKV_ROWS = 64


def dkv_slab_heads(b: int, s: int, kv: int, g: int, d: int,
                   sms: int) -> int:
    """Query heads a bf16 #7 block sums: the whole group G while the
    (kv head, batch, key tile) blocks fill every SM's resident slots (two
    blocks at d = 64 / 128, one at 256, where a block is two warpgroups);
    else the largest divisor of G that cuts it into at least
    ⌊2 · slots / blocks⌋ slabs, two waves of blocks for the causal tail
    to even out. granite-34b at B = 4, S = 1024 has 64 blocks for 264
    slots: slabs of 6 heads, 512 blocks (measured on an H100 at that
    shape: 6 heads 0.3124 ms, 8 0.3655, 4 0.3294, unsplit 1.5530). The
    slabs' f32 sums merge in slab order."""
    slots = (1 if d == 256 else 2) * sms
    blocks = b * kv * -(-s // DKV_ROWS)
    if blocks >= slots:
        return g
    want = min(g, 2 * slots // blocks)   # slabs
    return max(x for x in range(1, g + 1) if g % x == 0 and x * want <= g)


def _launch_bwd_dkv(q, k, v, g, lse, delta, causal: bool, heads=None):
    """#7 on checked CUDA operands: (dk, dv) in the KV-head layout.
    ``heads``: query heads a block sums (bf16; default
    ``dkv_slab_heads``'s); below the group, an f32 workspace holds each
    slab's sums and the shared zeroed counters (``_build.counters``) its
    tickets."""
    b, t, s, h, kv, d = _dims(q, k)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    st = ctypes.cast(_strides(q, k, v, g, dk, dv), ctypes.c_void_p)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, s, h, kv, d, int(causal), st)
    if _instance(q):
        rc = _fn("flash_attention_bwd_dkv_f32")(*head, _build.stream_ptr(q))
    else:
        grp = h // kv
        if heads is None:
            sms = torch.cuda.get_device_properties(
                q.device).multi_processor_count
            heads = dkv_slab_heads(b, s, kv, grp, d, sms)
        heads = min(max(heads, 1), grp)
        slabs = -(-grp // heads)
        ws = cnt = None
        if slabs > 1:
            tiles = b * kv * -(-s // DKV_ROWS)
            ws = torch.empty(tiles * slabs * 2 * DKV_ROWS * tile_dim(d),
                             dtype=torch.float32, device=q.device)
            cnt = _build.counters(q.device, tiles)
        rc = _fn("flash_attention_bwd_dkv_bf16")(
            *head, heads, None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(), _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd (dk/dv)")
    LAUNCHES["flash_attention_bwd_dkv" + _suffix(q)] += 1
    return dk, dv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """K4. q (B, H, d); k, v (B, S, KV, d) cache; pos (B,) -> (B, H, d)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or h % kv \
            or pos.shape != (b,):
        raise ValueError(f"decode_attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} pos{tuple(pos.shape)}")
    _build.check_no_grad((q, k, v), "decode_attention")
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, pos)
    sfx = _check_cuda((q, k, v), d, "decode_attention")
    check_group_f32(q, h // kv, "decode_attention")
    # paged_attention imports this module: import it at call time
    from repro_torch.kernels import paged_attention as _pa
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, split = _pa.decode_path(b, h, kv, s, sms)
    _build.check(_pa.launch_dense(q, k, v, pos, o, split), "decode_attention")
    LAUNCHES["decode_attention" + sfx] += 1
    return o
