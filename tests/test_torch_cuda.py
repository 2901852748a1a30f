"""The CUDA kernels against their plain versions, on the card.

Odd shapes the main paths do not hit — ragged M/N/K, ranks that are
not multiples of 8 or 16, large ranks, every GQA group size, head dims
64 and 128 (and 256, gemma-7b's, and 112, kimi-k2's, for every bf16
attention kernel), non-causal and S != T attention — so each kernel's
masking and load
paths are exercised, forward and backward. Marked ``cuda``: skipped
without a CUDA device of compute capability >= 9.0. Run on the card with

    python -m pytest -q --noconftest tests/test_torch_cuda.py

The f32 instances (K1, K3 / #5, #6, #7: RoBERTa's f32 training; K2, K4,
#8, #8q: its f32 serving; #9, #10: its serving over int8 weights) are
held to 1e-4 of the largest plain value (f32 sums in another order; a
TF32 pass would miss it), lse to 1e-5 absolute, and K2, K4, #8, #8q, #9
and #10 in f32 are bit-identical from call to call; mixed dtypes raise
``TypeError``. The head_dim 256 instances of #6 / #7 (gemma-7b's
training) are held as the bf16 backward is, bit-identical twice.

This file imports no JAX (``--noconftest`` skips the JAX fixture file),
so it runs where only PyTorch is installed. Tolerances: bf16 linears, fp
and w8a16, 1e-2 (one bf16 ulp from another f32 summation order);
attention, dense and paged (fp and int8), 2e-2 (fp: p rounded to bf16
unnormalised by the kernel, normalised by the plain version; int8: the
bf16 output's ulp, p kept above bf16 precision); lse 1e-3 absolute (f32,
another summation order); backward 2e-2 of the largest plain gradient
(the JAX package's bf16 gradient limit, tests/test_grads.py).
"""
import ctypes

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import tt_linear as ttl

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA device of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return (torch.randn(*shape, generator=g, device=dev) * scale
            ).to(torch.bfloat16)


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,r", [(37, 72, 48, 4), (37, 69, 45, 8),
                                     (1, 2048, 2048, 13), (130, 256, 96, 200),
                                     (64, 2048, 2048, 16)])
def test_tt_linear(dev, m, k, n, r):
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    _close(ttl.tt_linear(x, w, a, b, 4.0),
           ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)


@pytest.mark.parametrize("m,k,n,r", [(1, 2048, 2048, 8), (4, 69, 45, 4),
                                     (17, 512, 96, 8), (64, 256, 130, 8),
                                     (5, 128, 64, 100)])
def test_tt_linear_batched_a(dev, m, k, n, r):
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    _close(ttl.tt_linear_batched_a(x, w, a, b, 2.0),
           ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), 1e-2)


def _ba_case(dev, m, k, n, r):
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    return x, w, a, b


def _ba_launch(x, w, a, b, splits):
    return ttl._launch_splitk("tt_linear_batched_a", x, w, None, a, b, 2.0,
                              splits)


@pytest.mark.parametrize("r", [1, 8, 16, 64])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 33, 64])
def test_tt_linear_batched_a_wgmma(dev, m, r):
    """K2 on the split-K `wgmma` kernel (the pre-pass summing P[m] =
    x[m]·A[m], then the kernel with a bf16 W) at every M a launch takes
    and ranks up to ``RANK_WGMMA``: within 1e-2 of the plain version, two
    calls bit-identical."""
    x, w, a, b = _ba_case(dev, m, 512, 192, r)
    assert ttl.splitk_path(x, w, r)[0] == "wgmma"
    got = ttl.tt_linear_batched_a(x, w, a, b, 2.0)
    assert got.shape == (m, 192) and got.dtype == torch.bfloat16
    _close(got, ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), 1e-2)
    assert torch.equal(ttl.tt_linear_batched_a(x, w, a, b, 2.0), got)


@pytest.mark.parametrize("m,k,n,r", [(4, 200, 136, 8), (5, 72, 40, 3),
                                     (33, 1000, 520, 16), (64, 136, 72, 64),
                                     (2, 8, 8, 1)])
def test_tt_linear_batched_a_every_variant(dev, m, k, n, r):
    """K and N ragged against the 64-wide tiles (multiples of 8, so the
    split-K kernel takes them uncopied): the launcher's slices of K and
    one slice on the same inputs, each within 1e-2 of the plain
    version."""
    x, w, a, b = _ba_case(dev, m, k, n, r)
    assert ttl.splitk_path(x, w, r)[0] == "wgmma"
    assert not ttl.vec_operands(x, w, None, a, b, True)[-1]
    want = ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for sp in (ttl.w8_splits(m, n, k, sms), 1):
        _close(_ba_launch(x, w, a, b, sp), want, 1e-2)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m,r", [(4, 8), (16, 16), (64, 8), (33, 3)])
def test_tt_linear_batched_a_slices_of_k(dev, m, r, splits):
    """K2's `wgmma` kernel over 1 to 8 slices of K at K = N = 2048:
    within 1e-2 of the plain version, two calls bit-identical
    (fixed-order sums over the cluster, no float atomics)."""
    x, w, a, b = _ba_case(dev, m, 2048, 2048, r)
    ys = [_ba_launch(x, w, a, b, splits) for _ in range(2)]
    _close(ys[0], ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), 1e-2)
    assert torch.equal(ys[0], ys[1])


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", [
    (2, 70, 70, 8, 2, 64, True), (1, 33, 100, 4, 4, 128, False),
    (3, 5, 5, 4, 1, 64, True), (1, 300, 300, 2, 2, 64, True)])
def test_flash_attention(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rn(dev, b, t, h, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    _close(tfa.flash_attention(q, k, v, causal),
           tfa.flash_attention_plain(q, k, v, causal), 2e-2)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention(dev, g, d):
    b, s, kv = 5, 300, 2
    q, k, v = _rn(dev, b, kv * g, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    pos = torch.tensor([0, 1, 150, 298, 299], dtype=torch.int32, device=dev)
    _close(tfa.decode_attention(q, k, v, pos),
           tfa.decode_attention_plain(q, k, v, pos), 2e-2)


def _dense_launch(q, k, v, pos, split):
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tpa._build.check(tpa.launch_dense(q, k, v, pos, o, split),
                     "decode_attention")
    return o


@pytest.mark.parametrize("split", [0, 1, 2, 3])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_edges_and_splits(dev, d, g, split):
    """K4 on #8's kernel over a 300-cell cache (not a multiple of 64):
    windows of one cell (pos 0, exactly v[0]), of the whole cache (S - 1)
    and past it (pos >= S: clamped to S - 1), split into chunks of
    ``split`` tiles or not; within 2e-2 of the plain version, two calls
    bit-identical."""
    b, s, kv = 5, 300, 2
    q, k, v = (_rn(dev, b, kv * g, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([0, 63, s - 1, s, 5 * s], dtype=torch.int32,
                       device=dev)
    got = _dense_launch(q, k, v, pos, split)
    _close(got, tfa.decode_attention_plain(q, k, v, pos), 2e-2)
    assert torch.equal(got[0], v[0, 0].repeat_interleave(g, 0))
    assert torch.equal(_dense_launch(q, k, v, pos, split), got)


@pytest.mark.parametrize("kv", [32, 8])
def test_decode_attention_long_cache(dev, kv):
    """K4 over a 4096-cell cache at the launcher's split (``decode_path``)
    and unsplit: both within 2e-2 of the plain version and bit-identical
    from call to call."""
    b, s, h, d = 4, 4096, 32, 64
    q, k, v = (_rn(dev, b, h, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([511, 1500, 3000, 4095], dtype=torch.int32,
                       device=dev)
    want = tfa.decode_attention_plain(q, k, v, pos)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, split = tpa.decode_path(b, h, kv, s, sms)
    assert split > 0
    for sp in (0, split):
        got = _dense_launch(q, k, v, pos, sp)
        _close(got, want, 2e-2)
        assert torch.equal(_dense_launch(q, k, v, pos, sp), got)
    kernels.reset_launch_counts()
    _close(tfa.decode_attention(q, k, v, pos), want, 2e-2)
    assert kernels.launch_counts()["decode_attention"] == 1


def test_decode_attention_reads_views(dev):
    """q as a view into a wider projection output and k / v as views of a
    longer stacked cache (the engine passes cache views): read through
    their strides, no copy; the same result as on contiguous copies."""
    b, s, kv, g, d = 4, 200, 4, 2, 64
    wide = _rn(dev, b, kv * g + 6, d, seed=3)
    q = wide[:, 3:3 + kv * g]
    stack = _rn(dev, 2, b, s + 40, kv, d, seed=4)
    k, v = stack[0, :, :s], stack[1, :, :s]
    pos = torch.tensor([0, 37, 130, 199], dtype=torch.int32, device=dev)
    got = tfa.decode_attention(q, k, v, pos)
    want = tfa.decode_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), pos)
    assert torch.equal(got, want)
    _close(got, tfa.decode_attention_plain(q, k, v, pos), 2e-2)


ATTN_SHAPES = [(2, 70, 70, 8, 2, 64, True), (1, 33, 100, 4, 4, 128, False),
               (3, 5, 5, 4, 1, 64, True), (1, 300, 300, 8, 1, 128, True),
               (2, 130, 91, 4, 2, 64, False)]


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", ATTN_SHAPES)
def test_flash_attention_fwd(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rn(dev, b, t, h, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    # the same kernel without stats is K3
    _close(tfa.flash_attention(q, k, v, causal), o, 0)


def _rel_max(got, want) -> float:
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _bwd_inputs(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rn(dev, b, t, h, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    g = _rn(dev, b, t, h, d, seed=1)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, g


def _check_bwd(got, want):
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.isfinite(x.float()).all(), name
        assert _rel_max(x, y) <= 2e-2, (name, _rel_max(x, y))


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", ATTN_SHAPES)
def test_flash_attention_bwd(dev, b, t, s, h, kv, d, causal):
    args = _bwd_inputs(dev, b, t, s, h, kv, d, causal)
    _check_bwd(tfa.flash_attention_bwd(*args, causal),
               tfa.flash_attention_bwd_plain(*args, causal))


# the backward's tile edges: a block owns 64 rows and streams tiles of 64
# keys (dq pass) or 128 queries (dk/dv pass; 32 at d = 128) — causal T = S
# one below, at and one past 128, two tiles and a row; fewer rows than a
# block; S != T both ways, causal and not; GQA groups 4 and 8; d = 128
BWD_SHAPES = [(1, 127, 127, 4, 4, 64, True), (2, 128, 128, 4, 2, 64, True),
              (1, 129, 129, 8, 1, 64, True), (1, 257, 257, 2, 2, 64, True),
              (2, 40, 40, 4, 4, 64, True), (1, 70, 200, 4, 1, 64, False),
              (1, 200, 70, 4, 4, 64, False), (1, 200, 70, 8, 1, 64, True),
              (1, 257, 257, 16, 2, 64, True), (2, 129, 129, 4, 4, 128, True),
              (1, 257, 100, 8, 2, 128, False), (1, 40, 40, 2, 1, 128, True)]


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", BWD_SHAPES)
def test_flash_attention_bwd_tile_edges(dev, b, t, s, h, kv, d, causal):
    args = _bwd_inputs(dev, b, t, s, h, kv, d, causal)
    _check_bwd(tfa.flash_attention_bwd(*args, causal),
               tfa.flash_attention_bwd_plain(*args, causal))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_reads_packed_qkv_views(dev, d):
    """q, k and v as strided views of one packed (B, T, 3·H, d) tensor: the
    kernels read them in place and give what they give on contiguous
    copies, bit for bit."""
    b, t, h = 2, 129, 4
    qkv = _rn(dev, b, t, 3 * h, d)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    g = _rn(dev, b, t, h, d, seed=1)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, True)
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, True))
    dense = tfa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, lse, g, True)
    for name, x, y in zip(("dq", "dk", "dv"), got, dense):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", [
    (2, 300, 300, 8, 2, 64, True), (1, 200, 70, 8, 1, 128, False)])
def test_flash_attention_bwd_is_repeatable(dev, b, t, s, h, kv, d, causal):
    """No atomics: two calls give the same dq, dk and dv bit for bit."""
    args = _bwd_inputs(dev, b, t, s, h, kv, d, causal)
    one = tfa.flash_attention_bwd(*args, causal)
    two = tfa.flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), one, two):
        assert torch.equal(x, y), name


def test_flash_attention_bwd_rejects_what_the_kernels_do_not_take(dev):
    q, k, v, o, lse, g = _bwd_inputs(dev, 1, 64, 64, 4, 2, 64, True)
    with pytest.raises(NotImplementedError):   # head_dim 96
        a = _bwd_inputs(dev, 1, 64, 64, 4, 2, 96, True)
        tfa.flash_attention_bwd(*a, True)
    with pytest.raises(NotImplementedError):   # GQA group 3 in f32
        a = [t.float() for t in _bwd_inputs(dev, 1, 64, 64, 6, 2, 64, True)]
        tfa.flash_attention_bwd(*a, True)
    with pytest.raises(TypeError):             # mixed bf16 / f32 operands
        tfa.flash_attention_bwd(q.float(), k, v, o, lse, g, True)
    with pytest.raises(TypeError):             # lse in bf16
        tfa.flash_attention_bwd(q, k, v, o, lse.bfloat16(), g, True)
    wide = _rn(dev, 1, 64, 4, 68)              # rows of 68: stride % 8 != 0
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(wide[..., 4:], k, v, o, lse, g, True)
    with pytest.raises(ValueError):            # k and v of different shapes
        tfa.flash_attention_bwd(q, k, v[:, :32], o, lse, g, True)


@pytest.mark.parametrize("m,k,n,r", [(37, 72, 48, 10), (130, 256, 96, 8),
                                     (64, 2048, 2048, 10)])
def test_fused_tt_linear_backward(dev, m, k, n, r):
    """dx through K1 on transposed operands (a rank that is not a multiple
    of 8 loses A's 16-byte loads and must stay right), dA and dB in f32,
    against autograd through the plain version."""
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    g = _rn(dev, m, n, seed=2)
    outs = []
    for fn in (lambda *t: dispatch.tt_linear(*t, alpha=4.0),
               lambda *t: ttl.tt_linear_plain(*t, 4.0)):
        leaves = [x.clone().requires_grad_(True), w,
                  a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        fn(*leaves).backward(g)
        outs.append([leaves[i].grad for i in (0, 2, 3)])
    for name, got, want in zip(("dx", "da", "db"), *outs):
        assert _rel_max(got, want) <= 2e-2, (name, _rel_max(got, want))


def test_dispatch_routes_training_and_inference(dev):
    """With autograd recording, flash attention runs #5 forward and #6 /
    #7 backward; without, K3; K1 runs in both directions."""
    q, k, v = _rn(dev, 1, 64, 4, 64), _rn(dev, 1, 64, 2, 64), \
        _rn(dev, 1, 64, 2, 64)
    kernels.reset_launch_counts()
    with torch.no_grad():
        dispatch.flash_attention(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dispatch.flash_attention(*leaves).float().sum().backward()
    x = _rn(dev, 8, 64).requires_grad_(True)
    w, a, b = _rn(dev, 64, 32), _rn(dev, 64, 8), _rn(dev, 8, 32)
    dispatch.tt_linear(x, w, a, b).float().sum().backward()
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    assert n["flash_attention"] == 1 and n["flash_attention_fwd"] == 1
    assert n["flash_attention_bwd_dq"] == n["flash_attention_bwd_dkv"] == 1
    assert n["tt_linear"] == 2
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.flash_attention(*leaves)


def test_launch_counts_and_cpu_leg(dev):
    kernels.reset_launch_counts()
    x, w = _rn(dev, 4, 64), _rn(dev, 64, 32)
    a, b = _rn(dev, 64, 8), _rn(dev, 8, 32)
    ttl.tt_linear(x, w, a, b)
    ttl.tt_linear(x.cpu(), w.cpu(), a.cpu(), b.cpu())   # plain: not counted
    assert kernels.launch_counts()["tt_linear"] == 1
    ttl.tt_linear(x.float(), w.float(), a.float(), b.float())   # f32 K1
    n = kernels.launch_counts()
    assert n["tt_linear"] == 1 and n["tt_linear_f32"] == 1
    with pytest.raises(TypeError):                      # mixed dtypes
        ttl.tt_linear(x.float(), w, a, b)


def _paged_case(dev, c, g, d, page, seed=0, edge=False, f32=False):
    """4 slots over a 40-block pool, 6-page tables: slot 0 at position 0,
    slot 1 with its last in-window page a sentinel (read clamped, masked
    past its position), slot 2 with its first query on the last cell of
    the table, slot 3 mid-table. Every entry past a slot's window is a
    sentinel (N or larger). ``edge``: a fifth slot whose window ends
    exactly on a page edge (its last query on a page's last cell).
    ``f32``: q and the pools in f32."""
    b, kv, n, p_tab = 4 + int(edge), 2, 40, 6
    h = kv * g
    gen = torch.Generator().manual_seed(seed + c * 131 + g * 17 + page)
    rn = _rf if f32 else _rn
    q = rn(dev, b, c, h, d, seed=seed)
    kc, vc = rn(dev, n, page, kv, d, seed=1), rn(dev, n, page, kv, d,
                                                  seed=2)
    pos = [0, 2 * page + 3, p_tab * page - 1, page + 1]
    if edge:
        pos.append((-(-c // page) + 1) * page - c)
    tables = torch.full((b, p_tab), n, dtype=torch.int32)
    perm = torch.randperm(n, generator=gen)
    used = 0
    for row, p0 in enumerate(pos):
        last = min((p0 + c - 1) // page, p_tab - 1)
        tables[row, :last + 1] = perm[used:used + last + 1].int()
        tables[row, last + 1:] = n + row          # sentinels of any size
        used += last + 1
    last1 = min((pos[1] + c - 1) // page, p_tab - 1)
    if last1 > pos[1] // page:
        tables[1, last1] = n
    return (q, kc, vc, tables.to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [1, 3, 8, 32])
def test_paged_decode_attention(dev, c, g, d, page):
    """C·G from 1 to 256 rows a block: ``mma.sync`` below 64, ``wgmma``
    from 64 (C·G in {64, 256} at C = 32, G = 2 / 8 and C = 8, G = 8); a
    window ending exactly on a page edge; sentinels inside and past the
    window; split windows wherever the table spans two or more tiles."""
    args = _paged_case(dev, c, g, d, page, edge=True)
    got = tpa.paged_decode_attention(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention(*args), got)


@pytest.mark.parametrize("split", [0, 1, 3, 5])
@pytest.mark.parametrize("c,g", [(1, 1), (32, 1), (32, 8)])
def test_paged_decode_attention_split_windows(dev, c, g, split):
    """#8 with its windows in chunks of ``split`` 64-cell tiles (0: one
    block a window; 1, 3, 5: 9, 3 and 2 chunks of the 34-page table) at
    the engine's page and table width: each within 2e-2 of the plain
    version, and two calls bit-identical (the chunks merge in a fixed
    order, no float atomics)."""
    b, kv, d, page, n, p_tab = 8, 4, 64, 16, 256, 34
    h = kv * g
    pos = [0, 37, 100, 161, 230, 299, 407, 479]
    gen = torch.Generator().manual_seed(c + g)
    tables = torch.full((b, p_tab), n, dtype=torch.int32)
    perm, used = torch.randperm(n, generator=gen), 0
    for row, p0 in enumerate(pos):
        last = min((p0 + c - 1) // page, p_tab - 1)
        tables[row, :last + 1] = perm[used:used + last + 1].int()
        used += last + 1
    q, kc, vc = (_rn(dev, b, c, h, d, seed=3), _rn(dev, n, page, kv, d, seed=4),
                 _rn(dev, n, page, kv, d, seed=5))
    tables, pos = tables.to(dev), torch.tensor(pos, dtype=torch.int32,
                                               device=dev)
    o = [torch.empty_like(q) for _ in range(2)]
    st = tfa._strides(q, kc, vc, o[0])
    st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
    for t in o:
        tpa._build.check(tpa._launch_tc(q, kc, vc, tables, pos, t, n, page,
                                        st, split), "split")
    _close(o[0], tpa.paged_decode_attention_plain(q, kc, vc, tables, pos),
           2e-2)
    assert torch.equal(o[0], o[1])


def test_paged_decode_attention_reads_q_through_strides(dev):
    """q as a view into a wider projection output (no copy) and a pool
    view of one layer of a stacked (nb, N, page, KV, d) pool."""
    q, kc, vc, tables, pos = _paged_case(dev, 8, 4, 64, 16)
    wide = _rn(dev, 4, 8, 16, 64, seed=5)
    wide[:, :, 4:12] = q
    qv = wide[:, :, 4:12]
    pools = torch.stack([vc, kc, vc])
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention(qv, pools[1], pools[2], tables, pos)
    want = tpa.paged_decode_attention_plain(q, kc, vc, tables, pos)
    _close(got, want, 2e-2)
    tpa.paged_decode_attention(q.cpu(), kc.cpu(), vc.cpu(), tables.cpu(),
                               pos.cpu())                # plain: not counted
    assert kernels.launch_counts()["paged_decode_attention"] == 1


def test_paged_decode_attention_rejects_what_the_kernel_does_not_take(dev):
    q, kc, vc, tables, pos = _paged_case(dev, 4, 2, 64, 8)
    with pytest.raises(NotImplementedError):            # page 72
        tpa.paged_decode_attention(q, kc.repeat(1, 9, 1, 1),
                                   vc.repeat(1, 9, 1, 1), tables, pos)
    with pytest.raises(NotImplementedError):            # head_dim 32
        tpa.paged_decode_attention(q[..., :32].contiguous(),
                                   kc[..., :32].contiguous(),
                                   vc[..., :32].contiguous(), tables, pos)
    kernels.reset_launch_counts()                       # f32: its instance
    got = tpa.paged_decode_attention(q.float(), kc.float(), vc.float(),
                                     tables, pos)
    assert got.dtype == torch.float32
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_f32"] == 1
    assert n_["paged_decode_attention"] == 0
    with pytest.raises(TypeError):                      # mixed dtypes
        tpa.paged_decode_attention(q.float(), kc, vc, tables, pos)
    with pytest.raises(NotImplementedError):            # f32 head_dim 128
        tpa.paged_decode_attention(*(_rf(dev, *t.shape[:-1], 128)
                                     for t in (q, kc, vc)), tables, pos)
    with pytest.raises(RuntimeError, match="requires grad"):
        tpa.paged_decode_attention(q.clone().requires_grad_(True), kc, vc,
                                   tables, pos)


def _w8(dev, k, n, group, seed=0):
    """An int8 W (K, N) with f32 scales (G, N), quantized on the card."""
    return tquant.quantize_int8(_rn(dev, k, n, scale=k ** -0.5, seed=seed),
                                group)


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("m,k,n,r", [(1, 2048, 2048, 8), (3, 384, 130, 5),
                                     (4, 256, 48, 8), (8, 512, 96, 13),
                                     (64, 2048, 2048, 8),
                                     (100, 256, 200, 100),
                                     (16, 2048, 2048, 1), (63, 512, 256, 64),
                                     (65, 384, 192, 8), (256, 2048, 2048, 8),
                                     (64, 256, 112, 65), (16, 384, 48, 256),
                                     (64, 2048, 2048, 64)])
def test_tt_linear_w8(dev, m, k, n, r, group):
    """#9, per output channel and grouped (K = 2048: 16 groups); ragged M
    / N, ranks that are not multiples of 8, N not a multiple of 16 (W,
    B and the scales copied into zero-padded aligned buffers), ranks on
    both sides of RANK_WGMMA (64: P in registers, 65 and up: K1's
    pre-pass and the extension tiles); A both K-contiguous (the model's
    layout) and row-major. Two calls are bit-identical."""
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    at, b = _rn(dev, r, k, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    want = None
    for a in (at.T, at.T.contiguous()):
        got = ttl.tt_linear_w8(x, wq, s, a, b, 4.0)
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        if want is None:
            want = ttl.tt_linear_w8_plain(x, wq, s, a, b, 4.0)
        _close(got, want, 1e-2)
        assert torch.equal(ttl.tt_linear_w8(x, wq, s, a, b, 4.0), got)


@pytest.mark.parametrize("group", [0, 128, 1024])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_tt_linear_w8_slices_of_k(dev, splits, group):
    """#9's `wgmma` kernel at M = 64, K = N = 2048 over 1 to 8 slices of
    K, one thread-block cluster a tile (3: slices of 11 and 10 tiles;
    group 1024 spans several slices): within 1e-2 of the plain version,
    two calls bit-identical (the slices are summed in a fixed order, no
    float atomics)."""
    m, k, n, r = 64, 2048, 2048, 8
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    a = _rn(dev, r, k, scale=k ** -0.5).T
    b = _rn(dev, r, n, scale=r ** -0.5)
    ys = [ttl._launch_splitk("tt_linear_w8", x, wq, s, a, b, 4.0, splits)
          for _ in range(2)]
    _close(ys[0], ttl.tt_linear_w8_plain(x, wq, s, a, b, 4.0), 1e-2)
    assert torch.equal(ys[0], ys[1])
    assert ttl.splitk_path(x, wq, r)[0] == "wgmma"


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("r", [1, 8, 16, 64, 65])
@pytest.mark.parametrize("m", [1, 3, 4, 16, 17, 64])
def test_tt_linear_batched_a_w8(dev, m, r, group):
    """#10 at M in {1, 3, 4, 16, 17, 64} (M > 64 is refused, as K2's) and
    ranks up to RANK_WGMMA (P summed by the pre-pass in f32) and past it
    (65: α·P as hi + lo and the extension tiles), per output channel and
    grouped; two calls bit-identical."""
    k, n = 512, 192
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    got = ttl.tt_linear_batched_a_w8(x, wq, s, a, b, 2.0)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 2.0), 1e-2)
    assert torch.equal(ttl.tt_linear_batched_a_w8(x, wq, s, a, b, 2.0), got)
    want = "pre_pass" if r > ttl.RANK_WGMMA else "wgmma"
    assert ttl.splitk_path(x, wq, r)[0] == want


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("m,k,n,r", [(1, 2048, 2048, 8), (3, 384, 130, 5),
                                     (4, 256, 48, 8), (17, 256, 40, 100),
                                     (64, 512, 200, 16)])
def test_tt_linear_batched_a_w8_template_shapes(dev, m, k, n, r, group):
    """#10 on operands the split-K kernel takes only after a padded copy
    (N % 16 != 0), at ranks above 64 (the pre-pass), and on the engine's
    shape."""
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    got = ttl.tt_linear_batched_a_w8(x, wq, s, a, b, 2.0)
    _close(got, ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 2.0), 1e-2)
    path = ttl.splitk_path(x, wq, r)[0]
    assert (path == "pre_pass") == (r > ttl.RANK_WGMMA)
    assert ttl.vec_operands(x, wq, s, a, b, True)[-1] == (n % 16 != 0)


@pytest.mark.parametrize("group", [0, 128, 1024])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("m,r", [(4, 8), (16, 16), (64, 8), (33, 3),
                                 (64, 64), (17, 13)])
def test_tt_linear_batched_a_w8_slices_of_k(dev, m, r, splits, group):
    """#10's `wgmma` kernel (the pre-pass summing P[m] = x[m]·A[m], then
    #9's kernel as its programmatic dependent) over 1 to 8 slices of K at
    K = N = 2048: within 1e-2 of the plain version, two calls
    bit-identical (fixed-order sums, no float atomics)."""
    k = n = 2048
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    ys = [ttl._launch_splitk("tt_linear_batched_a_w8", x, wq, s, a, b, 2.0,
                             splits) for _ in range(2)]
    _close(ys[0], ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 2.0), 1e-2)
    assert torch.equal(ys[0], ys[1])
    assert ttl.splitk_path(x, wq, r)[0] == "wgmma"


def test_w8_linears_reject_what_the_kernels_do_not_take(dev):
    x = _rn(dev, 4, 256)
    wq, s = _w8(dev, 256, 64, 0)
    a, b = _rn(dev, 256, 8), _rn(dev, 8, 64)
    wg, sg = tquant.quantize_int8(_rn(dev, 256, 64), 64)   # group 64
    with pytest.raises(NotImplementedError):
        ttl.tt_linear_w8(x, wg, sg, a, b)
    with pytest.raises(TypeError):                          # f32 x
        ttl.tt_linear_w8(x.float(), wq, s, a, b)
    with pytest.raises(ValueError):                         # M > 64
        ttl.tt_linear_batched_a_w8(_rn(dev, 65, 256), wq, s,
                                   _rn(dev, 65, 256, 8), b)
    kernels.reset_launch_counts()
    ttl.tt_linear_w8(x, wq, s, a, b)
    ttl.tt_linear_w8(x.cpu(), wq.cpu(), s.cpu(), a.cpu(), b.cpu())
    assert kernels.launch_counts()["tt_linear_w8"] == 1


def _paged_case_int8(dev, c, g, d, page, seed=0):
    q, kc, vc, tables, pos = _paged_case(dev, c, g, d, page, seed, edge=True)
    k8, ks = tquant.quantize_kv(kc.float() * 3)
    v8, vs = tquant.quantize_kv(vc.float() * 3)
    return q, k8, v8, ks, vs, tables, pos


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [1, 4, 32])
def test_paged_decode_attention_int8(dev, c, g, d, page):
    """#8q from 1 to 256 rows a (slot, kv head) (slabs of 64 above 64), a
    window ending on a page edge, sentinels inside and past the window;
    two calls bit-identical."""
    args = _paged_case_int8(dev, c, g, d, page)
    got = tpa.paged_decode_attention_int8(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_int8_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention_int8(*args), got)


@pytest.mark.parametrize("split", [0, 1, 3, 5])
@pytest.mark.parametrize("c,g", [(1, 1), (4, 2), (32, 1), (32, 8)])
def test_paged_decode_attention_int8_split_windows(dev, c, g, split):
    """#8q with its windows in chunks of ``split`` 64-cell tiles at the
    engine's page and table width (C = 32, G = 8: four slabs of 64 rows):
    within 2e-2 of the plain version, two calls bit-identical."""
    b, kv, d, page, n, p_tab = 8, 4, 64, 16, 256, 34
    h = kv * g
    pos = [0, 37, 100, 161, 230, 299, 407, 479]
    gen = torch.Generator().manual_seed(c + g)
    tables = torch.full((b, p_tab), n, dtype=torch.int32)
    perm, used = torch.randperm(n, generator=gen), 0
    for row, p0 in enumerate(pos):
        last = min((p0 + c - 1) // page, p_tab - 1)
        tables[row, :last + 1] = perm[used:used + last + 1].int()
        used += last + 1
    q = _rn(dev, b, c, h, d, seed=3)
    k8, ks = tquant.quantize_kv(_rn(dev, n, page, kv, d, seed=4).float())
    v8, vs = tquant.quantize_kv(_rn(dev, n, page, kv, d, seed=5).float())
    tables, pos = tables.to(dev), torch.tensor(pos, dtype=torch.int32,
                                               device=dev)
    o = [torch.empty_like(q) for _ in range(2)]
    st = tpa.int8_strides(q, k8, v8, ks, vs, tables, o[0])
    for t in o:
        tpa._build.check(tpa._launch_tc(q, k8, v8, tables, pos, t, n, page,
                                        st, split, (ks, vs)), "split")
    _close(o[0], tpa.paged_decode_attention_int8_plain(q, k8, v8, ks, vs,
                                                       tables, pos), 2e-2)
    assert torch.equal(o[0], o[1])


def test_paged_decode_attention_int8_reads_pool_views(dev):
    """One layer of stacked (nb, N, page, KV, d) int8 pools and their
    (nb, N, page, KV) scale pools, as the engine passes them; the plain
    leg on the CPU is not counted."""
    q, k8, v8, ks, vs, tables, pos = _paged_case_int8(dev, 8, 4, 64, 16)
    pk, pv = torch.stack([v8, k8]), torch.stack([k8, v8])
    sk, sv = torch.stack([vs, ks]), torch.stack([ks, vs])
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention_int8(q, pk[1], pv[1], sk[1], sv[1],
                                          tables, pos)
    want = tpa.paged_decode_attention_int8_plain(q, k8, v8, ks, vs, tables,
                                                 pos)
    _close(got, want, 2e-2)
    tpa.paged_decode_attention_int8(*(t.cpu() for t in (
        q, k8, v8, ks, vs, tables, pos)))
    n = kernels.launch_counts()
    assert n["paged_decode_attention_int8"] == 1
    assert n["paged_decode_attention"] == 0
    with pytest.raises(TypeError):                      # bf16 pools
        tpa.paged_decode_attention_int8(q, k8.bfloat16(), v8.bfloat16(),
                                        ks, vs, tables, pos)


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_decode_attention_reads_tp_head_stripes(dev, tp, kind):
    """Serve-time tensor parallelism hands rank r's K4 / #8 / #8q a
    contiguous stripe of the heads taken with ``narrow``: q heads
    r·H/tp.. of the projection output, kv heads r·KV/tp.. of the cache or
    pool (and of the int8 scale pools). Each stripe is read through its
    strides, within 2e-2 of the plain version on contiguous copies, and
    the stripes concatenated in rank order are within 2e-2 of the plain
    version over all heads; one launch a stripe."""
    b, kv, g, d = 4, 4, 2, 128
    h = kv * g
    if kind == "dense":
        q = _rn(dev, b, h, d, seed=7)
        pools = (_rn(dev, b, 300, kv, d, seed=8),
                 _rn(dev, b, 300, kv, d, seed=9))
        pos = torch.tensor([0, 63, 150, 299], dtype=torch.int32, device=dev)
        kernel, plain, rest, name = (tfa.decode_attention,
                                     tfa.decode_attention_plain, (pos,),
                                     "decode_attention")
    else:
        _, _, _, tables, pos = _paged_case(dev, 1, g, d, 16)
        q = _rn(dev, b, 1, h, d, seed=7)
        kc, vc = _rn(dev, 40, 16, kv, d, seed=8), _rn(dev, 40, 16, kv, d,
                                                       seed=9)
        if kind == "paged":
            pools = (kc, vc)
            kernel, plain, name = (tpa.paged_decode_attention,
                                   tpa.paged_decode_attention_plain,
                                   "paged_decode_attention")
        else:
            k8, ks = tquant.quantize_kv(kc.float() * 3)
            v8, vs = tquant.quantize_kv(vc.float() * 3)
            pools = (k8, v8, ks, vs)
            kernel, plain, name = (tpa.paged_decode_attention_int8,
                                   tpa.paged_decode_attention_int8_plain,
                                   "paged_decode_attention_int8")
        rest = (tables, pos)
    hq = q.ndim - 2                       # q's head axis; pools' is 2
    kernels.reset_launch_counts()
    stripes = []
    for r in range(tp):
        qs = q.narrow(hq, r * h // tp, h // tp)
        ps = [t.narrow(2, r * kv // tp, kv // tp) for t in pools]
        got = kernel(qs, *ps, *rest)
        _close(got, plain(qs.contiguous(), *(t.contiguous() for t in ps),
                          *rest), 2e-2)
        stripes.append(got)
    assert kernels.launch_counts()[name] == tp
    _close(torch.cat(stripes, hq), plain(q, *pools, *rest), 2e-2)


# --------------------------------------------------------------- K1 `wgmma`

@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("r", [1, 8, 10, 100, 256])
@pytest.mark.parametrize("k,n", [(69, 130), (130, 69), (256, 2048)])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 4096])
def test_tt_linear_tile_edges_and_views(dev, m, k, n, r, view):
    """K1 at row, column and K tile edges, every rank kind (P in
    registers up to rank 64, the pre-pass variant above), with W, A and B
    contiguous or as transposed views (the backward's dx call: the
    `wgmma` kernel reads them through their strides)."""
    x = _rn(dev, m, k)
    w, a, b = (_rn(dev, k, n, scale=k ** -0.5),
               _rn(dev, k, r, scale=k ** -0.5),
               _rn(dev, r, n, scale=r ** -0.5))
    if view:
        w, a, b = (t.T.contiguous().T for t in (w, a, b))
        assert not w.is_contiguous()
    got = ttl.tt_linear(x, w, a, b, 4.0)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)


@pytest.mark.parametrize("variant", sorted(ttl.K1_VARIANTS))
@pytest.mark.parametrize("m", [16, 64, 96, 4096])
def test_tt_linear_every_kernel_variant(dev, m, variant):
    """Every K1 kernel agrees with the plain version at the serving
    prefill's row counts and the training's (the launcher picks one)."""
    k = n = 2048
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, 8, scale=k ** -0.5), _rn(dev, 8, n, scale=8 ** -0.5)
    _close(ttl._launch_k1(x, w, a, b, 4.0, variant),
           ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)


def test_tt_linear_dx_makes_no_copy_of_w(dev, monkeypatch):
    """The backward's dx hands K1 Wᵀ as a view; the wrapper passes it on
    without ``.contiguous()`` copying it."""
    m, k, n, r = 256, 512, 384, 10
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    copied = []
    real = torch.Tensor.contiguous

    def spy(t, *args, **kw):
        if not t.is_contiguous():
            copied.append(tuple(t.shape))
        return real(t, *args, **kw)
    g = _rn(dev, m, n, seed=3)
    monkeypatch.setattr(torch.Tensor, "contiguous", spy)
    got = ttl.tt_linear(g, w.T, b.T, a.T, 4.0)
    monkeypatch.undo()
    assert copied == []
    _close(got, ttl.tt_linear_plain(g, w.T, b.T, a.T, 4.0), 1e-2)


# ------------------------------------------------ #5 / K3 on `wgmma`

FWD_EDGES = [(t, t) for t in (1, 63, 64, 65, 127, 128, 129, 1000)] + [
    (1, 1000), (63, 129), (129, 63), (1000, 65), (65, 127)]


def _packed_q(dev, b, t, h, d, seed=0):
    """q as a strided view into a packed (B, T, H + 8, d) projection."""
    return _rn(dev, b, t, h + 8, d, seed=seed)[:, :, 4:4 + h]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,s", FWD_EDGES)
def test_flash_attention_fwd_tile_edges(dev, t, s, d, g, causal):
    """#5 (and K3, the same kernel without lse) at query and key tile
    edges, both head dims, every GQA group size, causal or not, q read
    from a packed-projection view; out within 2e-2, lse within 1e-3."""
    kv = 2
    q = _packed_q(dev, 1, t, kv * g, d)
    k, v = _rn(dev, 1, s, kv, d, seed=1), _rn(dev, 1, s, kv, d, seed=2)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    _close(tfa.flash_attention(q, k, v, causal), o, 0)


@pytest.mark.parametrize("variant", sorted(tfa.FWD_VARIANTS))
@pytest.mark.parametrize("t,s,d,g,causal", [
    (1000, 1000, 64, 1, True), (129, 63, 128, 4, False),
    (65, 127, 64, 8, True), (1, 1, 128, 2, True), (200, 200, 64, 2, True)])
def test_flash_attention_fwd_variants(dev, variant, t, s, d, g, causal):
    """Every variant of the forward kernel against the plain version."""
    kv = 2
    q = _packed_q(dev, 2, t, kv * g, d)
    k, v = _rn(dev, 2, s, kv, d, seed=1), _rn(dev, 2, s, kv, d, seed=2)
    lse = torch.empty((2, kv * g, t), dtype=torch.float32, device=dev)
    o = tfa._launch_fwd(q, k, v, causal, lse, variant)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


# ------------------------------- whisper-large-v3's cross-attention

#: whisper's encoder length and heads: 20 heads of 64 over 20 (G = 1)
WHISPER_S, WHISPER_H = 1536, 20


@pytest.mark.parametrize("t", [1, 256], ids=["decode-T1", "prefill-T256"])
def test_flash_attention_cross_at_whisper_shapes(dev, t):
    """K3 as whisper-large-v3's cross-attention: T query rows (1: a decode
    step, 256: a prefill) over S = 1536 encoder keys, not causal, B = 4,
    20 heads of 64: within 2e-2 of the plain version, two calls
    bit-identical."""
    b, d = 4, 64
    q = _rn(dev, b, t, WHISPER_H, d)
    k = _rn(dev, b, WHISPER_S, WHISPER_H, d, seed=1)
    v = _rn(dev, b, WHISPER_S, WHISPER_H, d, seed=2)
    out = tfa.flash_attention(q, k, v, False)
    _close(out, tfa.flash_attention_plain(q, k, v, False), 2e-2)
    assert torch.equal(out, tfa.flash_attention(q, k, v, False))


def test_flash_attention_train_cross_at_whisper_shape(dev):
    """#5, #6 and #7 as whisper's cross-attention in training: T = 256
    decoder rows over S = 1536 encoder keys, not causal, 20 heads of 64:
    out within 2e-2 and lse within 1e-3 of the plain forward, dq / dk / dv
    within 2e-2 of the largest plain gradient, two backward calls
    bit-identical."""
    b, t, d = 2, 256, 64
    q = _rn(dev, b, t, WHISPER_H, d)
    k = _rn(dev, b, WHISPER_S, WHISPER_H, d, seed=1)
    v = _rn(dev, b, WHISPER_S, WHISPER_H, d, seed=2)
    g = _rn(dev, b, t, WHISPER_H, d, seed=3)
    o, lse = tfa.flash_attention_fwd(q, k, v, False)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, False)
    _close(o, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, False)
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, False))
    again = tfa.flash_attention_bwd(q, k, v, o, lse, g, False)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)


# ------------------------------- K2 / #10 beyond 64 rows, through ops.py

@pytest.mark.parametrize("m", [72, 130])
def test_batched_a_linears_split_rows(dev, m):
    """``ops`` splits M > 64 into ⌈M / 64⌉ launches of K2 and of #10; the
    raw wrappers still refuse M > 64 (test_w8_linears_reject_...)."""
    from repro_torch.kernels import ops as tops
    k, n, r = 2048, 2048, 8
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    wq, s = _w8(dev, k, n, 0)
    kernels.reset_launch_counts()
    got = tops.tt_linear_batched_a(x[:, None], w, a, b, alpha=2.0)
    got8 = tops.tt_linear_batched_a_q(x, wq, s, a, b, alpha=2.0)
    n_launch = kernels.launch_counts()
    assert n_launch["tt_linear_batched_a"] == (m + 63) // 64
    assert n_launch["tt_linear_batched_a_w8"] == (m + 63) // 64
    assert got.shape == (m, 1, n)
    _close(got[:, 0], ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), 1e-2)
    _close(got8, ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 2.0), 1e-2)
    with pytest.raises(ValueError):
        ttl.tt_linear_batched_a(x, w, a, b)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_dense_engine_serves_72_slots(dev, weights):
    """A 4+1d dense engine with max_batch=72 (decode rows of 72 slots: two
    K2 or #10 launches a linear) serves what the plain leg serves; a small
    bf16 model with head_dim 64, so every kernel takes it.

    Greedy bf16 decoding is chaotic at argmax near-ties, so each of the
    kernel leg's tokens is held against the plain leg's teacher-forced
    logits on the same token history: the chosen token's logit within 5%
    of the largest |logit| of the plain leg's maximum (the smoke script's
    logits limit). How many tokens equal the plain leg's own greedy run
    is printed."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.config.base import (KernelConfig, QuantConfig,
                                         RunConfig, ServeConfig)
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRuntime, Engine, Request
    cfg = dataclasses.replace(configs.get_config("stablelm-1.6b"),
                              num_layers=2, d_model=256, num_heads=4,
                              num_kv_heads=4, d_ff=512,
                              vocab_size=512).validate()
    spec = M.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, spec, generator=gen, device=dev)
    params["adapter"] = {"cores": ttlib.random_tt(
        gen, spec.cfg.mode_sizes, 4, scale=0.3, device=dev)}
    rt = AdapterRuntime.build("live", params["base"], spec,
                              params["adapter"], params["frozen"])
    quant = QuantConfig(weights="int8" if weights == "int8" else "none")
    serve = ServeConfig(cache_mode="dense", max_batch=72, cache_len=64,
                        out_cap=8)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (int(n),),
                                  generator=rng).numpy(), 8, task=i % 3)
            for i, n in enumerate(torch.randint(4, 17, (72,),
                                                generator=rng))]
    name = ("tt_linear_batched_a_w8" if weights == "int8"
            else "tt_linear_batched_a")
    outs, engines = {}, {}
    for leg in ("auto", "ref"):
        eng = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
            backend=leg, quant=quant), device=dev)
        kernels.reset_launch_counts()
        outs[leg] = [o.tolist() for o in eng.generate(reqs)]
        n_launch = kernels.launch_counts()
        assert (n_launch[name] > 0) == (leg == "auto"), n_launch
        engines[leg] = eng
    assert all(len(o) == 8 for o in outs["auto"])
    base = engines["ref"].base_weights
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs["auto"]):
            seq = torch.as_tensor([*req.prompt, *toks], device=dev)[None]
            lg = T.forward(base, cfg, spec, rt.broadcast, rt.per_layer, seq,
                           task=req.task, policy=dispatch.REF,
                           device=dev).logits[0].float()
            lg = lg[len(req.prompt) - 1:-1]          # the 8 predictions
            top = lg.max(-1).values
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (top - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    same = sum(x == y for o, r in zip(outs["auto"], outs["ref"])
               for x, y in zip(o, r))
    print(f"{weights}: {same}/{72 * 8} tokens equal the plain leg's greedy "
          f"run; largest teacher-forced gap {worst:.3e}")
    assert worst <= 5e-2


# ------------------------------------------- K1 above rank 256 (pre-pass)

@pytest.mark.parametrize("r", [384, 1024])
@pytest.mark.parametrize("m", [4, 64, 4096])
def test_tt_linear_high_rank_forward_and_dx(dev, m, r):
    """K1 at ranks the TPU kernel keeps whole in its f32 scratch (VeRA's
    1024, the paper's largest): the forward, and through ``_FusedTTLinear``
    the backward's dx on the (g, Wᵀ, Bᵀ, Aᵀ) views with dA and dB, each
    against the plain leg on the same inputs."""
    k = n = 2048
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a = _rn(dev, k, r, scale=k ** -0.5)
    b = _rn(dev, r, n, scale=r ** -0.5)
    assert ttl.k1_variant(r) == "pre_pass"
    _close(ttl.tt_linear(x, w, a, b, 4.0),
           ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)
    g = _rn(dev, m, n, seed=5)
    got, want = [], []
    for pol, out in ((dispatch.DEFAULT, got), (dispatch.REF, want)):
        xx, aa, bb = (t.clone().requires_grad_(True) for t in (x, a, b))
        y = dispatch.tt_linear(xx, w, aa, bb, alpha=4.0, policy=pol)
        out.extend(torch.autograd.grad(y, (xx, aa, bb), g))
    for gt, wt in zip(got, want):
        torch.cuda.synchronize()
        err = (gt.float() - wt.float()).abs().max()
        assert err <= 2e-2 * wt.float().abs().max(), err


@pytest.mark.parametrize("m", [64, 4096])
def test_tt_linear_rank_2048(dev, m):
    """K1 above VeRA's 1024: the workspace, not a constant, bounds the
    rank (r = 2048 at K = N = 2048)."""
    k = n = 2048
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, 2048, scale=k ** -0.5), _rn(dev, 2048, n,
                                                   scale=2048 ** -0.5)
    _close(ttl.tt_linear(x, w, a, b, 4.0),
           ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("r", [384, 1024])
@pytest.mark.parametrize("m", [4, 64, 256])
def test_tt_linear_w8_high_rank(dev, m, r, group):
    """#9 above rank 64 (VeRA's 1024 over an int8 base): K1's pre-pass
    writes α·P as hi + lo, the split-K kernel sums the extension tiles
    after the scaled base; within 1e-2 of the plain version, two calls
    bit-identical."""
    k = n = 2048
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, group)
    a = _rn(dev, r, k, scale=k ** -0.5).T
    b = _rn(dev, r, n, scale=r ** -0.5)
    assert ttl.splitk_path(x, wq, r)[0] == "pre_pass"
    got = ttl.tt_linear_w8(x, wq, s, a, b, 4.0)
    _close(got, ttl.tt_linear_w8_plain(x, wq, s, a, b, 4.0), 1e-2)
    assert torch.equal(ttl.tt_linear_w8(x, wq, s, a, b, 4.0), got)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("r", [100, 384])
@pytest.mark.parametrize("m", [1, 4, 64])
def test_batched_a_high_rank(dev, m, r, w8):
    """K2 and #10 above rank 64: the per-row pre-pass writes α·P[m] as
    hi + lo, the split-K kernel extends its K loop over them; within 1e-2
    of the plain version, two calls bit-identical."""
    k = n = 2048
    x = _rn(dev, m, k)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    if w8:
        wq, s = _w8(dev, k, n, 0)
        fn = lambda: ttl.tt_linear_batched_a_w8(x, wq, s, a, b, 2.0)
        want = ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 2.0)
    else:
        w = _rn(dev, k, n, scale=k ** -0.5)
        fn = lambda: ttl.tt_linear_batched_a(x, w, a, b, 2.0)
        want = ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0)
    got = fn()
    _close(got, want, 1e-2)
    assert torch.equal(fn(), got)


def test_vera_1024_training_step_full_width(dev):
    """One VeRA r = 1024 step on a 2-layer full-width stablelm-1.6b: K1
    takes the pre-pass variant forward and as dx, the loss is finite and
    g moves off its zero init (d's gradient is 0 while g is, so d keeps
    d_init for this first step)."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.config.base import RunConfig, TrainConfig
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(configs.get_config("stablelm-1.6b"),
                              num_layers=2).validate()
    run = RunConfig(model=cfg, adapter_kind="vera", adapter_rank=1024,
                    train=TrainConfig(remat="block"))

    class Batch:
        def __next__(self):
            rng = np.random.default_rng(0)
            return {"tokens": rng.integers(0, cfg.vocab_size, (2, 256)),
                    "mask": np.ones((2, 256), np.float32)}
    tr = Trainer(run=run, data=Batch(), total_steps=1, device=dev)
    d0 = tr.state.adapter["d"].clone()
    kernels.reset_launch_counts()
    tr.train()
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    assert n["tt_linear"] == 6 * cfg.num_layers - 2
    assert np.isfinite(tr.losses()).all()
    assert torch.equal(tr.state.adapter["d"], d0)
    assert float(tr.state.adapter["g"].abs().max()) > 0


def test_w8_engine_snapshot_roundtrip_same_tokens(dev, tmp_path):
    """A dense int8-weight engine's base snapshot, loaded by a second
    engine over other weights, gives the same greedy tokens."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.config.base import (QuantConfig, RunConfig,
                                         ServeConfig)
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime, Engine, Request
    cfg = dataclasses.replace(configs.get_config("stablelm-1.6b"),
                              num_layers=2, d_model=256, num_heads=4,
                              num_kv_heads=4, d_ff=512,
                              vocab_size=512).validate()
    spec = M.build_adapter_spec(RunConfig(model=cfg, adapter_rank=4))
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=64,
                        out_cap=8, quant=QuantConfig(weights="int8"))

    def engine(seed):
        p = M.init_params(cfg, spec, torch.Generator(device=dev)
                          .manual_seed(seed), device=dev)
        rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                                  p["frozen"])
        return Engine(cfg, rt, serve=serve, device=dev)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (5 + i,),
                                  generator=rng).numpy(), 8)
            for i in range(4)]
    e1 = engine(0)
    out1 = [o.tolist() for o in e1.generate(reqs)]
    path = e1.save_base_snapshot(str(tmp_path / "w8"))
    e2 = engine(1)
    e2.load_base_snapshot(path)
    assert all(t.is_cuda for t in M.tensors(e2.base_weights))
    assert any(t.dtype == torch.int8 for t in M.tensors(e2.base_weights))
    assert [o.tolist() for o in e2.generate(reqs)] == out1


# ------------------------------- VeRA r = 1024 over int8; speculation


def _small_cfg():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config("stablelm-1.6b"),
                               num_layers=2, d_model=256, num_heads=4,
                               num_kv_heads=4, d_ff=512,
                               vocab_size=512).validate()


def test_vera_1024_w8_dense_engine(dev):
    """A dense engine over an int8 base serving VeRA at rank 1024: #9
    runs above rank 64 (prefill and decode), and every token is the
    plain leg's choice within 5% of its largest teacher-forced logit."""
    from repro_torch.config.base import QuantConfig, RunConfig, ServeConfig
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRuntime, Engine, Request
    cfg = _small_cfg()
    spec = M.build_adapter_spec(RunConfig(model=cfg, adapter_kind="vera",
                                          adapter_rank=1024))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = M.init_params(cfg, spec, generator=gen, device=dev)
    p["adapter"]["g"] = 0.02 * torch.randn(p["adapter"]["g"].shape,
                                           generator=gen, device=dev)
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=64,
                        out_cap=8, quant=QuantConfig(weights="int8"))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (int(n),),
                                  generator=rng).numpy(), 8)
            for n in torch.randint(4, 17, (6,), generator=rng)]
    eng = Engine(cfg, rt, serve=serve, device=dev)
    kernels.reset_launch_counts()
    outs = [o.tolist() for o in eng.generate(reqs)]
    n = kernels.launch_counts()
    assert n["tt_linear_w8"] > 0 and n["tt_linear"] == 0, n
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs):
            seq = torch.as_tensor([*req.prompt, *toks], device=dev)[None]
            lg = T.forward(eng.base_weights, cfg, spec, rt.broadcast,
                           rt.per_layer, seq, policy=dispatch.REF,
                           device=dev).logits[0].float()
            lg = lg[len(req.prompt) - 1:-1]
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    assert worst <= 5e-2


def test_spec_dense_engine_token_identical_under_the_kernels(dev):
    """A speculative dense engine on the card (spec_k 3, draft rank 2,
    stride 2, a 4+1d adapter): K4 launches once per verified column and
    drafter step, every request finishes, and its tokens are the plain
    leg's teacher-forced choices within 5% of the largest logit."""
    from repro_torch.config.base import RunConfig, ServeConfig, SpecConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRuntime, Engine, Request
    cfg = _small_cfg()
    spec = M.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = M.init_params(cfg, spec, generator=gen, device=dev)
    p["adapter"] = {"cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 4,
                                             scale=0.3, device=dev)}
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    k = 3
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=64,
                        out_cap=8, spec=SpecConfig(spec_k=k, draft_rank=2,
                                                   draft_layer_stride=2))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (int(n),),
                                  generator=rng).numpy(), 8, task=i % 3)
            for i, n in enumerate(torch.randint(4, 17, (6,), generator=rng))]
    eng = Engine(cfg, rt, serve=serve, device=dev)
    kernels.reset_launch_counts()
    outs = [o.tolist() for o in eng.generate(reqs)]
    n = kernels.launch_counts()
    st = eng.last_stats
    assert all(r.status == "FINISHED" for r in eng.last_results)
    assert st.draft_tokens > 0 and 0 <= st.acceptance_rate <= 1
    nb = cfg.num_super_blocks
    assert n["decode_attention"] == (k + 1) * (nb + -(-nb // 2)) \
        * len(cfg.block_pattern) * st.decode_steps, n
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs):
            seq = torch.as_tensor([*req.prompt, *toks], device=dev)[None]
            lg = T.forward(p["base"], cfg, spec, rt.broadcast, rt.per_layer,
                           seq, task=req.task, policy=dispatch.REF,
                           device=dev).logits[0].float()
            lg = lg[len(req.prompt) - 1:-1]
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    assert worst <= 5e-2



# ------------------------------------- the adapter registry and chaos

def _registry_setup(dev, num_tasks=6):
    from repro_torch.config.base import RunConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime
    cfg = _small_cfg()
    spec = M.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=num_tasks, adapter_rank=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = M.init_params(cfg, spec, generator=gen, device=dev)
    p["adapter"] = {"cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 4,
                                             scale=0.3, device=dev)}
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    return cfg, spec, p, rt


def _teacher_forced_gap(cfg, spec, rt, base, reqs, outs, dev):
    """The largest gap, over every generated token, between the plain
    leg's best teacher-forced logit and the chosen token's, over the
    largest |logit| (full task axis, task ids)."""
    from repro_torch.models import transformer as T
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs):
            toks = list(toks)
            if not toks:
                continue
            seq = torch.as_tensor([*req.prompt, *toks], device=dev)[None]
            lg = T.forward(base, cfg, spec, rt.broadcast, rt.per_layer, seq,
                           task=req.task, policy=dispatch.REF,
                           device=dev).logits[0].float()
            lg = lg[len(req.prompt) - 1:len(req.prompt) - 1 + len(toks)]
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    return worst


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_registry_engine_kernel_leg_vs_plain_leg(dev, cache_mode):
    """A registry engine (2 pool slots, 6 tasks) in bf16 on the card: the
    kernel leg reads the per-row A gathered from the pool (K2 on dense
    decode, #8 on the paged step), the plain leg (``backend="ref"``) the
    same pool; both finish every request with no pin or block left, and
    the kernel leg's tokens are the plain leg's teacher-forced choices
    within 5% of the largest logit (the count equal to the plain leg's
    own greedy run is printed)."""
    from repro_torch.config.base import (KernelConfig, RegistryConfig,
                                         ServeConfig)
    from repro_torch.serving import Engine, Request
    cfg, spec, p, rt = _registry_setup(dev)
    serve = ServeConfig(cache_mode=cache_mode, max_batch=4, cache_len=64,
                        out_cap=8, page_size=16, prefill_chunk=8,
                        registry=RegistryConfig(max_resident_tasks=2))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (int(n),),
                                  generator=rng).numpy(), 8, task=i % 6)
            for i, n in enumerate(torch.randint(4, 33, (12,),
                                                generator=rng))]
    outs = {}
    for leg in ("auto", "ref"):
        eng = Engine(cfg, rt, serve=serve,
                     kernels=KernelConfig(backend=leg), device=dev)
        kernels.reset_launch_counts()
        outs[leg] = [o.tolist() for o in eng.generate(reqs)]
        n = kernels.launch_counts()
        name = ("tt_linear_batched_a" if cache_mode == "dense"
                else "paged_decode_attention")
        assert (n[name] > 0) == (leg == "auto"), n
        st = eng.last_stats
        assert all(r.status == "FINISHED" for r in eng.last_results)
        assert st.adapter_faults + st.adapter_hits == st.admitted
        assert st.adapter_evictions > 0 and st.adapter_waits > 0
        assert eng.registry.pinned_slots == 0
        if eng.paged:
            assert eng.leaked_blocks() == 0
    gap = _teacher_forced_gap(cfg, spec, rt, p["base"], reqs, outs["auto"],
                              dev)
    same = sum(x == y for o, r in zip(outs["auto"], outs["ref"])
               for x, y in zip(o, r))
    print(f"{cache_mode}: {same}/{12 * 8} tokens equal the plain leg's; "
          f"largest teacher-forced gap {gap:.3e}")
    assert gap <= 5e-2


def test_chaos_run_audit_holds_every_step(dev):
    """A paged registry engine on the card under a seeded chaos schedule
    (forced allocation failures, two failed fault-ins, a cancel, a NaN
    row): the audit runs after every host-loop iteration and holds, the
    statuses are one CANCELLED, one FAILED with 3 tokens and the rest
    FINISHED, and the survivors are the plain leg's teacher-forced
    choices within 5%."""
    from repro_torch.config.base import RegistryConfig, ServeConfig
    from repro_torch.serving import ChaosInjector, Engine, Request, audit
    cfg, spec, p, rt = _registry_setup(dev)
    serve = ServeConfig(max_batch=4, cache_len=64, out_cap=8, page_size=16,
                        prefill_chunk=8,
                        registry=RegistryConfig(max_resident_tasks=2))
    rng = torch.Generator().manual_seed(2)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (int(n),),
                                  generator=rng).numpy(), 8, task=i % 6,
                    request_id=f"r{i}")
            for i, n in enumerate(torch.randint(4, 33, (10,),
                                                generator=rng))]
    eng = Engine(cfg, rt, serve=serve, device=dev)
    chaos = ChaosInjector(seed=7, alloc_fail_steps=(0, 1),
                          alloc_fail_rate=0.2, scatter_failures=2,
                          cancel_at={2: ["r8"]}, nan_after={"r1": 3})
    outs = [o.tolist() for o in eng.generate(reqs, chaos=chaos)]
    status = [r.status for r in eng.last_results]
    assert status.count("CANCELLED") == 1 and status[8] == "CANCELLED"
    assert status[1] == "FAILED" and len(outs[1]) == 3
    assert status.count("FINISHED") == len(reqs) - 2
    st = eng.last_stats
    assert st.numerics_faults == 1
    assert chaos.alloc_faults > 0 and chaos.scatter_faults == 2
    assert chaos.audits > 0 and chaos.audits + chaos.stalls == \
        chaos.steps
    audit(eng)
    survivors = [(r, o) for r, o, s in zip(reqs, outs, status)
                 if s == "FINISHED"]
    assert _teacher_forced_gap(cfg, spec, rt, p["base"],
                               [r for r, _ in survivors],
                               [o for _, o in survivors], dev) <= 5e-2


# ---------------------------------------------------------------------------
# the f32 instances (RoBERTa trains in f32)
# ---------------------------------------------------------------------------


def _rf(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return torch.randn(*shape, generator=g, device=dev) * scale


def _close_f32(got, want, tol=1e-4):
    """Within ``tol`` of the largest plain value, elementwise."""
    assert got.dtype == want.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel_max(got, want) <= tol, _rel_max(got, want)


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("m,k,n,r", [(37, 72, 48, 4), (130, 69, 45, 13),
                                     (4096, 1024, 1024, 8), (64, 768, 768,
                                                             1024),
                                     (257, 768, 768, 1024), (3, 5, 7, 1)])
def test_tt_linear_f32(dev, m, k, n, r, view):
    """K1's f32 instance: forward (A K-contiguous, as the model folds it)
    and dx on the (g, Wᵀ, Bᵀ, Aᵀ) views the backward passes (view)."""
    x, w = _rf(dev, m, k), _rf(dev, k, n, scale=k ** -0.5)
    a, b = _rf(dev, r, k, scale=k ** -0.5).T, _rf(dev, r, n, scale=r ** -0.5)
    if view:
        ops_ = (_rf(dev, m, n, seed=1), w.T, b.T, a.T)
    else:
        ops_ = (x, w, a, b)
    kernels.reset_launch_counts()
    _close_f32(ttl.tt_linear(*ops_, 4.0), ttl.tt_linear_plain(*ops_, 4.0))
    n_ = kernels.launch_counts()
    assert n_["tt_linear_f32"] == 1 and n_["tt_linear"] == 0


F32_ATTN_SHAPES = [(2, 70, 70, 8, 2, 64, True), (3, 5, 5, 4, 1, 64, True),
                   (1, 33, 100, 4, 4, 64, False), (2, 130, 91, 4, 2, 64,
                                                   False),
                   (4, 1000, 1000, 16, 16, 64, True)]


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", F32_ATTN_SHAPES)
def test_flash_attention_f32(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rf(dev, b, t, h, d), _rf(dev, b, s, kv, d), _rf(dev, b, s, kv,
                                                                d, seed=2)
    kernels.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close_f32(o, po)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)
    _close_f32(tfa.flash_attention(q, k, v, causal), po)   # K3
    n_ = kernels.launch_counts()
    assert n_["flash_attention_fwd_f32"] == n_["flash_attention_f32"] == 1
    assert n_["flash_attention_fwd"] == n_["flash_attention"] == 0


@pytest.mark.parametrize("b,t,s,h,kv,d,causal",
                         [x for x in BWD_SHAPES if x[5] == 64]
                         + [(4, 1000, 1000, 16, 16, 64, True)])
def test_flash_attention_bwd_f32(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rf(dev, b, t, h, d), _rf(dev, b, s, kv, d), _rf(dev, b, s, kv,
                                                                d, seed=2)
    g = _rf(dev, b, t, h, d, seed=1)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    for x, y in zip(got, want):
        _close_f32(x, y)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, g, causal)
    torch.cuda.synchronize()
    for x, y in zip(got, again):       # no atomics: the same bits
        assert torch.equal(x, y)


def test_f32_fused_linear_and_flash_backward(dev):
    """The autograd Functions over the f32 instances against plain
    autograd in f32: dx, dA, dB and dq, dk, dv within 1e-4."""
    x, w = _rf(dev, 130, 256), _rf(dev, 256, 96, scale=256 ** -0.5)
    a, b = _rf(dev, 256, 8, scale=0.0625), _rf(dev, 8, 96, scale=0.3)
    g = _rf(dev, 130, 96, seed=3)
    legs = []
    for fn in (lambda *t: dispatch.tt_linear(*t, alpha=2.0),
               lambda *t: ttl.tt_linear_plain(*t, 2.0)):
        leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
        y = fn(leaves[0], w, leaves[1], leaves[2])
        legs.append(torch.autograd.grad(y, leaves, g))
    for u, v_ in zip(*legs):
        _close_f32(u, v_)
    q, k, v = (_rf(dev, 2, 70, 4, 64, seed=i) for i in range(3))
    go = _rf(dev, 2, 70, 4, 64, seed=4)
    outs = []
    for pol in (dispatch.DEFAULT, dispatch.REF):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = dispatch.flash_attention(*leaves, causal=True, policy=pol)
        outs.append(torch.autograd.grad(out, leaves, go))
    for u, v_ in zip(*outs):
        _close_f32(u, v_)


def test_f32_mixed_and_missing_instances_raise(dev):
    """Mixed bf16 / f32 operands raise: no plain fallback. f32 operands of
    K2, K4, #8, #8q, #9 and #10 launch their f32 instances, counted under
    the name + ``_f32``, and no bf16 instance."""
    xb, wb = _rn(dev, 4, 64), _rn(dev, 64, 32)
    ab, bb = _rn(dev, 64, 8), _rn(dev, 8, 32)
    with pytest.raises(TypeError):
        ttl.tt_linear(xb.float(), wb, ab, bb)
    with pytest.raises(TypeError):
        ttl.tt_linear(xb, wb.float(), ab.float(), bb.float())
    q = _rf(dev, 1, 8, 4, 64)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, q.bfloat16(), q.bfloat16(), True)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError):                      # mixed K2
        ttl.tt_linear_batched_a(xb.float(), wb, _rf(dev, 4, 64, 8),
                                bb.float())
    cache = _rf(dev, 2, 16, 4, 64)
    with pytest.raises(TypeError):                      # mixed K4
        tfa.decode_attention(_rf(dev, 2, 4, 64), cache, cache.bfloat16(),
                             torch.tensor([3, 7], device=dev))
    wq, sc = tquant.quantize_int8(_rf(dev, 64, 32))
    with pytest.raises(TypeError):                      # mixed #9
        ttl.tt_linear_w8(xb.float(), wq, sc, ab, bb.float())
    with pytest.raises(TypeError):                      # mixed #10
        ttl.tt_linear_batched_a_w8(xb, wq, sc, _rf(dev, 4, 64, 8),
                                   bb.float())
    assert not any(kernels.launch_counts().values())
    ttl.tt_linear_w8(xb.float(), wq, sc, ab.float(), bb.float())
    ttl.tt_linear_batched_a_w8(xb.float(), wq, sc, _rf(dev, 4, 64, 8),
                               bb.float())
    ttl.tt_linear_batched_a(xb.float(), wb.float(), _rf(dev, 4, 64, 8),
                            bb.float())
    tfa.decode_attention(_rf(dev, 2, 4, 64), cache, cache,
                         torch.tensor([3, 7], device=dev))
    tables = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    pool = _rf(dev, 8, 16, 4, 64)
    tpa.paged_decode_attention(_rf(dev, 2, 1, 4, 64), pool, pool, tables,
                               pos)
    k8, ks = tquant.quantize_kv(pool)
    tpa.paged_decode_attention_int8(_rf(dev, 2, 1, 4, 64), k8, k8, ks, ks,
                                    tables, pos)
    n_ = kernels.launch_counts()
    assert {k: v for k, v in n_.items() if v} == {
        "tt_linear_w8_f32": 1, "tt_linear_batched_a_w8_f32": 1,
        "tt_linear_batched_a_f32": 1, "decode_attention_f32": 1,
        "paged_decode_attention_f32": 1,
        "paged_decode_attention_int8_f32": 1}


# K2, K4, #8 and #8q in f32 (RoBERTa serves in f32)

def _ba_f32_case(dev, m, k, n, r, view):
    """x (M, K); W, A, B contiguous, or (``view``) W and B as transposed
    views of (N, K) / (N, r) tensors and A as a (M, r, K) tensor seen as
    (M, K, r): every one read through its strides, no copy."""
    x = _rf(dev, m, k)
    if view:
        w = _rf(dev, n, k, scale=k ** -0.5).T
        a = _rf(dev, m, r, k, scale=k ** -0.5).transpose(1, 2)
        b = _rf(dev, n, r, scale=r ** -0.5).T
    else:
        w = _rf(dev, k, n, scale=k ** -0.5)
        a = _rf(dev, m, k, r, scale=k ** -0.5)
        b = _rf(dev, r, n, scale=r ** -0.5)
    return x, w, a, b


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("r", [1, 8, 64, 1024])
@pytest.mark.parametrize("k,n", [(768, 768), (1024, 1024), (69, 45)])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 130])
def test_tt_linear_batched_a_f32(dev, m, k, n, r, view):
    """K2's f32 instance at any M (one launch: 65 and 130 rows too), the
    model's K = N of roberta-base / -large and a ragged pair, ranks 1 to
    1024, contiguous and strided operands: within 1e-4 of the largest
    plain value, two calls bit-identical, one f32 launch each."""
    x, w, a, b = _ba_f32_case(dev, m, k, n, r, view)
    kernels.reset_launch_counts()
    got = ttl.tt_linear_batched_a(x, w, a, b, 2.0)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close_f32(got, ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0))
    assert torch.equal(ttl.tt_linear_batched_a(x, w, a, b, 2.0), got)
    n_ = kernels.launch_counts()
    assert n_["tt_linear_batched_a_f32"] == 2
    assert n_["tt_linear_batched_a"] == 0


@pytest.mark.parametrize("splits", [0, 2, 3, 16, 64])
def test_tt_linear_batched_a_f32_slices(dev, splits):
    """K2 f32 over 2 to 64 slices of K + r at roberta-large's decode shape
    (0: the launcher's; one slice would exceed the 1024 rows a slice
    takes): the slices merge in a fixed order."""
    x, w, a, b = _ba_f32_case(dev, 4, 1024, 1024, 8, False)
    want = ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0)
    ys = [ttl._launch_ba_f32(x, w, a, b, 2.0, splits) for _ in range(2)]
    _close_f32(ys[0], want)
    assert torch.equal(ys[0], ys[1])


def _dense_launch_f32(q, k, v, pos, split):
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tpa._build.check(tpa.launch_dense(q, k, v, pos, o, split),
                     "decode_attention (f32)")
    return o


@pytest.mark.parametrize("split", [0, 1, 2, 3])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_attention_f32(dev, g, split):
    """K4's f32 instance over a 300-cell cache (not a multiple of the
    64-cell tile): ragged positions 0 (exactly v[0]), 63, S - 1 and past
    the cache (clamped), windows whole or in chunks of ``split`` tiles;
    within 1e-4 of the largest plain value, two calls bit-identical."""
    b, s, kv, d = 5, 300, 2, 64
    q, k, v = (_rf(dev, b, kv * g, d), _rf(dev, b, s, kv, d, seed=1),
               _rf(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([0, 63, s - 1, s, 5 * s], dtype=torch.int32,
                       device=dev)
    got = _dense_launch_f32(q, k, v, pos, split)
    _close_f32(got, tfa.decode_attention_plain(q, k, v, pos))
    torch.testing.assert_close(got[0], v[0, 0].repeat_interleave(g, 0),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(_dense_launch_f32(q, k, v, pos, split), got)


def test_decode_attention_f32_engine_shape_and_views(dev):
    """K4 f32 at roberta-large's dense decode (4 slots x 256 cells, 16
    heads) through the launcher, on cache views of a stacked cache and q
    a view of a wider projection: one f32 launch, no bf16 one."""
    b, s, h, d = 4, 256, 16, 64
    wide = _rf(dev, b, h + 4, d, seed=3)
    q = wide[:, 2:2 + h]
    stack = _rf(dev, 2, b, s + 40, h, d, seed=4)
    k, v = stack[0, :, :s], stack[1, :, :s]
    pos = torch.tensor([17, 100, 200, 255], dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    got = tfa.decode_attention(q, k, v, pos)
    _close_f32(got, tfa.decode_attention_plain(q, k, v, pos))
    assert torch.equal(tfa.decode_attention(q, k, v, pos), got)
    n_ = kernels.launch_counts()
    assert n_["decode_attention_f32"] == 2 and n_["decode_attention"] == 0


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [1, 7, 32])
def test_paged_decode_attention_f32(dev, c, g, page):
    """#8 and #8q in f32 (d = 64) from 1 to 256 rows a (slot, kv head)
    (slabs of 64 above 64): sentinels inside and past the window, a window
    crossing pages and one ending on a page edge; within 1e-4 of the
    largest plain value, two calls bit-identical."""
    args = _paged_case(dev, c, g, 64, page, edge=True, f32=True)
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention(*args)
    assert got.shape == args[0].shape and got.dtype == torch.float32
    _close_f32(got, tpa.paged_decode_attention_plain(*args))
    assert torch.equal(tpa.paged_decode_attention(*args), got)
    q, kc, vc, tables, pos = args
    k8, ks = tquant.quantize_kv(kc * 3)
    v8, vs = tquant.quantize_kv(vc * 3)
    qargs = (q, k8, v8, ks, vs, tables, pos)
    got8 = tpa.paged_decode_attention_int8(*qargs)
    assert got8.dtype == torch.float32
    _close_f32(got8, tpa.paged_decode_attention_int8_plain(*qargs))
    assert torch.equal(tpa.paged_decode_attention_int8(*qargs), got8)
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_f32"] == 2
    assert n_["paged_decode_attention_int8_f32"] == 2
    assert n_["paged_decode_attention"] == n_["paged_decode_attention_int8"] \
        == 0


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("split", [0, 1, 3, 5])
@pytest.mark.parametrize("b,c,g", [(8, 1, 1), (8, 32, 1), (8, 7, 8),
                                   (1, 1, 1), (1, 32, 2)])
def test_paged_decode_attention_f32_split_windows(dev, b, c, g, split,
                                                  quantized):
    """#8 / #8q f32 with windows in chunks of ``split`` 64-cell tiles at
    the engine's page and table width, B = 8 and B = 1 (one slot: the
    launcher splits its window too): within 1e-4 of the largest plain
    value, two calls bit-identical (a fixed-order merge)."""
    kv, d, page, n, p_tab = 4, 64, 16, 256, 34
    h = kv * g
    pos = [0, 37, 100, 161, 230, 299, 407, 479][-b:]
    gen = torch.Generator().manual_seed(b + c + g)
    tables = torch.full((b, p_tab), n, dtype=torch.int32)
    perm, used = torch.randperm(n, generator=gen), 0
    for row, p0 in enumerate(pos):
        last = min((p0 + c - 1) // page, p_tab - 1)
        tables[row, :last + 1] = perm[used:used + last + 1].int()
        used += last + 1
    q = _rf(dev, b, c, h, d, seed=3)
    kc, vc = _rf(dev, n, page, kv, d, seed=4), _rf(dev, n, page, kv, d,
                                                    seed=5)
    tables, pos = tables.to(dev), torch.tensor(pos, dtype=torch.int32,
                                               device=dev)
    o = [torch.empty_like(q) for _ in range(2)]
    if quantized:
        k8, ks = tquant.quantize_kv(kc)
        v8, vs = tquant.quantize_kv(vc)
        st = tpa.int8_strides(q, k8, v8, ks, vs, tables, o[0])
        for t in o:
            tpa._build.check(tpa._launch_tc(q, k8, v8, tables, pos, t, n,
                                            page, st, split, (ks, vs)),
                             "split")
        want = tpa.paged_decode_attention_int8_plain(q, k8, v8, ks, vs,
                                                     tables, pos)
        got = tpa.paged_decode_attention_int8(q, k8, v8, ks, vs, tables,
                                              pos)
    else:
        st = tfa._strides(q, kc, vc, o[0])
        st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
        for t in o:
            tpa._build.check(tpa._launch_tc(q, kc, vc, tables, pos, t, n,
                                            page, st, split), "split")
        want = tpa.paged_decode_attention_plain(q, kc, vc, tables, pos)
        got = tpa.paged_decode_attention(q, kc, vc, tables, pos)
    _close_f32(o[0], want)
    assert torch.equal(o[0], o[1])
    _close_f32(got, want)       # the launcher's own split
    if b == 1:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tpa.paged_path(b, c, h, kv, p_tab, page, sms,
                              quantized, True)[1] > 0


# ---------------------------------------------------------------------------
# head_dim 256 (gemma-7b): the d = 256 instances of K3 / #5, K4, #8 and #8q,
# and the linears at gemma's q / v projection (K = 3072, N = 4096)
# ---------------------------------------------------------------------------

D256_ATTN = [(1, 64, 64, 16, 16, 256, True), (2, 70, 70, 4, 2, 256, True),
             (1, 33, 100, 4, 4, 256, False), (1, 300, 300, 2, 2, 256, True),
             (3, 5, 5, 4, 1, 256, True)]


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", D256_ATTN)
def test_flash_attention_d256(dev, b, t, s, h, kv, d, causal):
    """K3 and #5 at d = 256 (one warpgroup a block, whatever T): within
    2e-2 of the plain version, lse within 1e-3, K3 equal to #5's output,
    two calls bit-identical, counted under the ``_d256`` keys."""
    q, k, v = (_rn(dev, b, t, h, d), _rn(dev, b, s, kv, d),
               _rn(dev, b, s, kv, d))
    assert tfa.fwd_variant(t, d) == "wg1"
    kernels.reset_launch_counts()
    o3 = tfa.flash_attention(q, k, v, causal)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    n_ = kernels.launch_counts()
    assert n_["flash_attention_d256"] == 1
    assert n_["flash_attention_fwd_d256"] == 1
    assert n_["flash_attention"] == n_["flash_attention_fwd"] == 0
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o3, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    assert torch.equal(o3, o)
    assert torch.equal(tfa.flash_attention(q, k, v, causal), o3)


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_decode_attention_d256(dev, g, split):
    """K4 at d = 256 over a 300-cell cache: windows of one cell, of the
    whole cache and past it, split into chunks or not; within 2e-2 of the
    plain version, pos 0 exactly v[0], two calls bit-identical."""
    b, s, kv, d = 5, 300, 2, 256
    q, k, v = (_rn(dev, b, kv * g, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([0, 63, s - 1, s, 5 * s], dtype=torch.int32,
                       device=dev)
    want = tfa.decode_attention_plain(q, k, v, pos)
    got = _dense_launch(q, k, v, pos, split)
    _close(got, want, 2e-2)
    assert torch.equal(got[0], v[0, 0].repeat_interleave(g, 0))
    assert torch.equal(_dense_launch(q, k, v, pos, split), got)
    kernels.reset_launch_counts()
    got = tfa.decode_attention(q, k, v, pos)
    _close(got, want, 2e-2)
    assert torch.equal(tfa.decode_attention(q, k, v, pos), got)
    n_ = kernels.launch_counts()
    assert n_["decode_attention_d256"] == 2 and n_["decode_attention"] == 0


@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("c", [1, 3, 32])
def test_paged_decode_attention_d256(dev, c, g, page):
    """#8 at d = 256: ``mma.sync`` in slabs of at most 64 rows (C·G up to
    256), a window ending on a page edge, sentinels inside and past the
    window; within 2e-2 of the plain version, two calls bit-identical."""
    args = _paged_case(dev, c, g, 256, page, edge=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tpa.paged_path(5, c, 2 * g, 2, 6, page, sms, d=256)[0] == "mma"
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention(*args), got)
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_d256"] == 2
    assert n_["paged_decode_attention"] == 0


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("c", [1, 4, 32])
def test_paged_decode_attention_int8_d256(dev, c, g, page):
    """#8q at d = 256 (the two-stage ring of int8 tiles, widened in
    shared memory); within 2e-2 of the plain version, two calls
    bit-identical."""
    args = _paged_case_int8(dev, c, g, 256, page)
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention_int8(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_int8_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention_int8(*args), got)
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_int8_d256"] == 2
    assert n_["paged_decode_attention_int8"] == 0


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("c,g", [(1, 1), (32, 1), (32, 4)])
def test_paged_d256_split_windows(dev, c, g, split, quantized):
    """#8 / #8q at d = 256 with every window split into chunks of
    ``split`` tiles (0: one block a window), merged in chunk order: within
    2e-2 of the plain version and bit-identical from call to call."""
    q, kc, vc, tables, pos = _paged_case(dev, c, g, 256, 16, edge=True)
    n, page = kc.shape[0], kc.shape[1]
    o = [torch.empty_like(q) for _ in range(2)]
    if quantized:
        k8, ks = tquant.quantize_kv(kc.float() * 3)
        v8, vs = tquant.quantize_kv(vc.float() * 3)
        st = tpa.int8_strides(q, k8, v8, ks, vs, tables, o[0])
        for t in o:
            tpa._build.check(tpa._launch_tc(q, k8, v8, tables, pos, t, n,
                                            page, st, split, (ks, vs)),
                             "split")
        want = tpa.paged_decode_attention_int8_plain(q, k8, v8, ks, vs,
                                                     tables, pos)
    else:
        st = tfa._strides(q, kc, vc, o[0])
        st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
        for t in o:
            tpa._build.check(tpa._launch_tc(q, kc, vc, tables, pos, t, n,
                                            page, st, split), "split")
        want = tpa.paged_decode_attention_plain(q, kc, vc, tables, pos)
    _close(o[0], want, 2e-2)
    assert torch.equal(o[0], o[1])


def test_d256_rejects_what_the_kernels_do_not_take(dev):
    """Head dims outside {64, 128, 256} still raise, f32 at 256 raises (no
    f32 instance), the backward at 256 in f32 raises, and the forward
    refuses two warpgroups at 256; nothing falls back."""
    q, k, v = (_rn(dev, 1, 64, 4, 256), _rn(dev, 1, 64, 4, 256, seed=1),
               _rn(dev, 1, 64, 4, 256, seed=2))
    for d in (96, 192):
        qd, kd, vd = (t[..., :d].contiguous() for t in (q, k, v))
        with pytest.raises(NotImplementedError):
            tfa.flash_attention(qd, kd, vd, True)
        with pytest.raises(NotImplementedError):
            tfa.decode_attention(qd[:, 0], kd, vd,
                                 torch.zeros(1, dtype=torch.int32,
                                             device=dev))
    with pytest.raises(NotImplementedError):        # f32 at 256
        tfa.flash_attention(q.float(), k.float(), v.float(), True)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_fwd(q.float(), k.float(), v.float(), True)
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    with pytest.raises(NotImplementedError):        # f32 backward at 256
        tfa.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                lse, q.float(), True)
    with pytest.raises(RuntimeError):               # two warpgroups at 256
        tfa._launch_fwd(q, k, v, True, None, "wg2")
    args = _paged_case(dev, 4, 2, 256, 16)
    with pytest.raises(NotImplementedError):        # f32 paged at 256
        tpa.paged_decode_attention(args[0].float(), args[1].float(),
                                   args[2].float(), *args[3:])
    a8 = _paged_case_int8(dev, 4, 2, 256, 16)
    with pytest.raises(NotImplementedError):        # f32 q over int8 at 256
        tpa.paged_decode_attention_int8(a8[0].float(), *a8[1:])
    a96 = _paged_case(dev, 4, 2, 96, 16)
    with pytest.raises(NotImplementedError):        # head_dim 96, paged
        tpa.paged_decode_attention(*a96)
    with pytest.raises(NotImplementedError):
        tpa.paged_decode_attention_int8(*_paged_case_int8(dev, 4, 2, 96,
                                                          16))
    torch.cuda.synchronize()


GEMMA_QV = (3072, 4096, 8)      # K = d_model, N = q_dim, r


@pytest.mark.parametrize("m", [64, 96])
def test_tt_linear_gemma_qv(dev, m):
    """K1 at gemma-7b's prefill q projection (K 3072 -> N 4096, r 8)."""
    k, n, r = GEMMA_QV
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a = _rn(dev, r, k, scale=k ** -0.5).T
    b = _rn(dev, r, n, scale=r ** -0.5)
    got = ttl.tt_linear(x, w, a, b, 4.0)
    _close(got, ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)
    assert torch.equal(ttl.tt_linear(x, w, a, b, 4.0), got)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_batched_a_linears_gemma_qv(dev, m, w8):
    """K2 / #10 at gemma-7b's decode q projection (M slots, K 3072 -> N
    4096, r 8): within 1e-2 of the plain version, bit-identical."""
    k, n, r = GEMMA_QV
    x = _rn(dev, m, k)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    if w8:
        wq, s = _w8(dev, k, n, 0)
        fn = lambda: ttl.tt_linear_batched_a_w8(x, wq, s, a, b, 4.0)  # noqa
        want = ttl.tt_linear_batched_a_w8_plain(x, wq, s, a, b, 4.0)
    else:
        w = _rn(dev, k, n, scale=k ** -0.5)
        fn = lambda: ttl.tt_linear_batched_a(x, w, a, b, 4.0)  # noqa
        want = ttl.tt_linear_batched_a_plain(x, w, a, b, 4.0)
    got = fn()
    _close(got, want, 1e-2)
    assert torch.equal(fn(), got)


@pytest.mark.parametrize("m", [64, 96])
def test_tt_linear_w8_gemma_qv(dev, m):
    """#9 at gemma-7b's prefill q projection over int8 W."""
    k, n, r = GEMMA_QV
    x = _rn(dev, m, k)
    wq, s = _w8(dev, k, n, 0)
    a = _rn(dev, r, k, scale=k ** -0.5).T
    b = _rn(dev, r, n, scale=r ** -0.5)
    got = ttl.tt_linear_w8(x, wq, s, a, b, 4.0)
    _close(got, ttl.tt_linear_w8_plain(x, wq, s, a, b, 4.0), 1e-2)
    assert torch.equal(ttl.tt_linear_w8(x, wq, s, a, b, 4.0), got)


# ---------------------------------------------------------------------------
# #9 and #10 in f32 (RoBERTa served over int8 weights), and #6 / #7 at
# head_dim 256 (gemma-7b trained)
# ---------------------------------------------------------------------------


def _w8_f32_case(dev, m, k, n, r, group, batched, view=False):
    """x (M, K) f32, an int8 W (K, N) with per-channel (group 0) or
    grouped scales, A (K, r) — K-contiguous, as the model folds it — or
    per-row (M, K, r), B (r, N); ``view``: W and B as transposed views."""
    wq, sc = tquant.quantize_int8(_rf(dev, k, n, scale=k ** -0.5), group)
    if view:
        wq = wq.T.contiguous().T
    a = (_rf(dev, m, k, r, scale=k ** -0.5) if batched
         else _rf(dev, r, k, scale=k ** -0.5).T)
    b = _rf(dev, n, r, scale=r ** -0.5).T if view \
        else _rf(dev, r, n, scale=r ** -0.5)
    return _rf(dev, m, k, seed=3), wq, sc, a, b


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("r", [1, 8, 64, 100, 1024])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 1024), (300, 768, 768),
                                   (37, 256, 130), (1, 384, 45)])
def test_tt_linear_w8_f32(dev, m, k, n, r, group):
    """#9's f32 instance: within 1e-4 of the plain version (which
    dequantizes W first), per channel and per group of 128 rows, at every
    rank K1f takes; two calls bit-identical; counted under
    ``tt_linear_w8_f32`` and nothing else."""
    args = _w8_f32_case(dev, m, k, n, r, group, False, view=m == 37)
    kernels.reset_launch_counts()
    got = ttl.tt_linear_w8(*args, 4.0)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close_f32(got, ttl.tt_linear_w8_plain(*args, 4.0))
    assert torch.equal(ttl.tt_linear_w8(*args, 4.0), got)
    n_ = kernels.launch_counts()
    assert {k_: v for k_, v in n_.items() if v} == {"tt_linear_w8_f32": 2}


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("r", [1, 8, 64, 1024])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 33, 64])
def test_tt_linear_batched_a_w8_f32(dev, m, r, group):
    """#10's f32 instance at roberta-large's decode q / v (K = N = 1024)
    for every M in the launch's range: within 1e-4 of the plain version,
    two calls bit-identical, counted under ``tt_linear_batched_a_w8_f32``;
    the slices of K + r straddle the W / B boundary."""
    args = _w8_f32_case(dev, m, 1024, 1024, r, group, True)
    kernels.reset_launch_counts()
    got = ttl.tt_linear_batched_a_w8(*args, 2.0)
    _close_f32(got, ttl.tt_linear_batched_a_w8_plain(*args, 2.0))
    assert torch.equal(ttl.tt_linear_batched_a_w8(*args, 2.0), got)
    n_ = kernels.launch_counts()
    assert {k_: v for k_, v in n_.items() if v} == {
        "tt_linear_batched_a_w8_f32": 2}


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("splits", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("m,k,n,r", [(4, 768, 768, 8), (5, 256, 69, 13)])
def test_tt_linear_batched_a_w8_f32_slices(dev, m, k, n, r, splits, group):
    """#10f over every split of K + r (a slice ending inside W's rows, on
    the boundary, inside B's), strided W and B: within 1e-4 of the plain
    version and bit-identical from call to call."""
    x, wq, sc, a, b = _w8_f32_case(dev, m, k, n, r, group, True, view=True)
    want = ttl.tt_linear_batched_a_w8_plain(x, wq, sc, a, b, 2.0)
    one = ttl._launch_ba_f32(x, wq, a, b, 2.0, splits, scale=sc)
    two = ttl._launch_ba_f32(x, wq, a, b, 2.0, splits, scale=sc)
    _close_f32(one, want)
    assert torch.equal(one, two)


D256_BWD = [(1, 64, 64, 16, 16, 256, True), (2, 70, 70, 4, 2, 256, True),
            (1, 33, 100, 4, 4, 256, False), (1, 300, 300, 2, 2, 256, True),
            (3, 5, 5, 4, 1, 256, True), (1, 129, 129, 8, 1, 256, True),
            (1, 200, 70, 8, 2, 256, False), (1, 1000, 1000, 2, 2, 256, True),
            (1, 97, 97, 4, 4, 256, True)]


def _bwd_inputs_d256(dev, b, t, s, h, kv, d, causal):
    """``_bwd_inputs`` with q, k and v drawn apart. ``_rn`` seeds by shape,
    so at H = KV the shared helper gives k = q = v; at d = 256 that makes
    s_ii = |q_i|² / 16 ≈ 16 and p one-hot on the diagonal, and dk a
    cancellation of dP − D at f32 noise level (the plain f32 version is
    itself 1e-2 of max |dk| from an f64 one there, 2.6e-3 on distinct
    inputs)."""
    q, k, v = (_rn(dev, b, t, h, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    g = _rn(dev, b, t, h, d, seed=3)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, g


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", D256_BWD)
def test_flash_attention_bwd_d256(dev, b, t, s, h, kv, d, causal):
    """#6 / #7 at d = 256 (dq in key tiles of 32; dk / dv on two
    warpgroups that exchange P): every GQA group, causal and not, S != T,
    tile edges; each gradient within 2e-2 of the largest plain one, two
    calls bit-identical, counted under the ``_d256`` keys."""
    args = _bwd_inputs_d256(dev, b, t, s, h, kv, d, causal)
    kernels.reset_launch_counts()
    got = tfa.flash_attention_bwd(*args, causal)
    _check_bwd(got, tfa.flash_attention_bwd_plain(*args, causal))
    again = tfa.flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(x, y), name
    n_ = kernels.launch_counts()
    assert {k_: v for k_, v in n_.items() if v} == {
        "flash_attention_bwd_dq_d256": 2, "flash_attention_bwd_dkv_d256": 2}


def test_flash_attention_bwd_d256_reads_packed_qkv_views(dev):
    """q, k, v as views of one packed (B, T, 3·H, 256) tensor: the same
    bits as on contiguous copies."""
    b, t, h, d = 1, 129, 2, 256
    qkv = _rn(dev, b, t, 3 * h, d)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    g = _rn(dev, b, t, h, d, seed=1)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, True)
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, True))
    dense = tfa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, lse, g, True)
    for name, x, y in zip(("dq", "dk", "dv"), got, dense):
        assert torch.equal(x, y), name


def test_flash_d256_training_function(dev):
    """The autograd Function over #5 / #6 / #7 at d = 256 against plain
    autograd in bf16: dq, dk, dv within 2e-2 of the largest plain one."""
    q, k, v = (_rn(dev, 2, 70, 4, 256, seed=i) for i in range(3))
    go = _rn(dev, 2, 70, 4, 256, seed=4)
    outs = []
    for pol in (dispatch.DEFAULT, dispatch.REF):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = dispatch.flash_attention(*leaves, causal=True, policy=pol)
        outs.append(torch.autograd.grad(out, leaves, go))
    _check_bwd(outs[0], outs[1])


# ---------------------------------------------------------------------------
# any GQA group: K4, #8 and #8q in bf16 at G = 3, 12 (mistral-large), 48
# (granite-34b's MQA) and 96; #6 / #7 and the f32 instances keep
# {1, 2, 4, 8}
# ---------------------------------------------------------------------------

ANY_GROUPS = [3, 12, 48, 96]


def _any_heads(g):
    """(slots, query heads, kv heads) at group ``g``: MQA (one kv head, 8
    slots) from G = 48, else 4 slots over 4 or 2 kv heads."""
    kv = 4 if g < 12 else 2 if g < 48 else 1
    return (8 if kv == 1 else 4), kv * g, kv


def _any_paged_case(dev, c, g, d, page=16, p_tab=34, quant=False):
    """Slots over a pool of ``p_tab`` pages each, 34-page tables of 16 as
    the engine's: slot 0 at position 0, slot 1 with its window ending on
    a page edge, slot 2 with its last query on the table's last cell, the
    rest mid-table; sentinels past each window. ``quant``: int8 pools and
    their f32 scales."""
    b, h, kv = _any_heads(g)
    n = b * p_tab
    gen = torch.Generator().manual_seed(c * 131 + g * 17 + d)
    pos = [0, 3 * page - c, p_tab * page - c, 161, 230, 299, 407, 479][:b]
    tables = torch.full((b, p_tab), n, dtype=torch.int32)
    perm, used = torch.randperm(n, generator=gen), 0
    for row, p0 in enumerate(pos):
        last = min((p0 + c - 1) // page, p_tab - 1)
        tables[row, :last + 1] = perm[used:used + last + 1].int()
        tables[row, last + 1:] = n + row
        used += last + 1
    q = _rn(dev, b, c, h, d, seed=g)
    kc = _rn(dev, n, page, kv, d, seed=1)
    vc = _rn(dev, n, page, kv, d, seed=2)
    tail = (tables.to(dev), torch.tensor(pos, dtype=torch.int32, device=dev))
    if not quant:
        return (q, kc, vc) + tail
    k8, ks = tquant.quantize_kv(kc.float() * 3)
    v8, vs = tquant.quantize_kv(vc.float() * 3)
    return (q, k8, v8, ks, vs) + tail


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", ANY_GROUPS)
def test_decode_attention_any_group(dev, g, d):
    """K4 at G outside {1, 2, 4, 8}, MQA with 8 slots from G = 48, G = 96
    in two slabs of 64 rows: through the wrapper (one launch) and at
    splits 0, 1 and 3 over a 300-cell cache (windows of one cell, of the
    whole cache and past it); within 2e-2 of the plain version, two calls
    bit-identical."""
    b, h, kv = _any_heads(g)
    s = 300
    q, k, v = (_rn(dev, b, h, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([0, 63, s - 1, s, 5 * s, 100, 200, 250][:b],
                       dtype=torch.int32, device=dev)
    want = tfa.decode_attention_plain(q, k, v, pos)
    kernels.reset_launch_counts()
    got = tfa.decode_attention(q, k, v, pos)
    sfx = "_d256" if d == 256 else ""
    assert kernels.launch_counts()["decode_attention" + sfx] == 1
    _close(got, want, 2e-2)
    assert torch.equal(got[0], v[0, 0].repeat_interleave(g, 0))
    for split in (0, 1, 3):
        one = _dense_launch(q, k, v, pos, split)
        _close(one, want, 2e-2)
        assert torch.equal(_dense_launch(q, k, v, pos, split), one)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("c", [1, 5, 32])
@pytest.mark.parametrize("g", ANY_GROUPS)
def test_paged_decode_attention_any_group(dev, g, c, d):
    """#8 at G outside {1, 2, 4, 8}: C·G from 3 to 3072 rows a (slot, kv
    head), slabs that start mid-column (256 % 12, 256 % 48, 256 % 96 and
    64 % 12 ... are not 0), several slabs x several chunks (splits 1 and
    3 of a 34-page table) and one block a window (split 0); within 2e-2 of
    the plain version, two calls bit-identical."""
    args = _any_paged_case(dev, c, g, d)
    q, kc, vc, tables, pos = args
    want = tpa.paged_decode_attention_plain(*args)
    got = tpa.paged_decode_attention(*args)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _close(got, want, 2e-2)
    assert torch.equal(tpa.paged_decode_attention(*args), got)
    st = tfa._strides(q, kc, vc, got)
    st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
    for split in (0, 1, 3):
        outs = [torch.empty_like(q) for _ in range(2)]
        for o in outs:
            tpa._build.check(tpa._launch_tc(q, kc, vc, tables, pos, o,
                                            kc.shape[0], 16, st, split),
                             "split")
        _close(outs[0], want, 2e-2)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("c", [1, 5, 32])
@pytest.mark.parametrize("g", ANY_GROUPS)
def test_paged_decode_attention_int8_any_group(dev, g, c, d):
    """#8q at G outside {1, 2, 4, 8}: slabs of 64 rows, most starting
    mid-column, several slabs x several chunks (splits 1 and 3) and
    unsplit; within 2e-2 of the plain version, two calls bit-identical."""
    args = _any_paged_case(dev, c, g, d, quant=True)
    q, k8, v8, ks, vs, tables, pos = args
    want = tpa.paged_decode_attention_int8_plain(*args)
    got = tpa.paged_decode_attention_int8(*args)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _close(got, want, 2e-2)
    assert torch.equal(tpa.paged_decode_attention_int8(*args), got)
    st = tpa.int8_strides(q, k8, v8, ks, vs, tables, got)
    for split in (0, 1, 3):
        outs = [torch.empty_like(q) for _ in range(2)]
        for o in outs:
            tpa._build.check(tpa._launch_tc(q, k8, v8, tables, pos, o,
                                            k8.shape[0], 16, st, split,
                                            (ks, vs)), "split")
        _close(outs[0], want, 2e-2)
        assert torch.equal(outs[0], outs[1])


def test_groups_outside_1248_stay_refused_in_f32(dev):
    """The f32 instances of K4, #8, #8q and of the backward (#6 / #7) keep
    G in {1, 2, 4, 8}: at G = 12 they raise ``NotImplementedError`` before
    any launch, and nothing falls back (the bf16 backward takes any
    group: ``test_flash_bwd_any_group``)."""
    q, kc, vc, tables, pos = _any_paged_case(dev, 5, 12, 64)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="GQA"):
        tpa.paged_decode_attention(q.float(), kc.float(), vc.float(),
                                   tables, pos)
    k8, ks = tquant.quantize_kv(kc.float())
    v8, vs = tquant.quantize_kv(vc.float())
    with pytest.raises(NotImplementedError, match="GQA"):
        tpa.paged_decode_attention_int8(q.float(), k8, v8, ks, vs, tables,
                                        pos)
    k, v = _rf(dev, 4, 64, 2, 64, seed=1), _rf(dev, 4, 64, 2, 64, seed=2)
    with pytest.raises(NotImplementedError, match="GQA"):
        tfa.decode_attention(_rf(dev, 4, 24, 64), k, v, pos[:4])
    a = [t.float() for t in _bwd_inputs(dev, 1, 64, 64, 24, 2, 64, True)]
    with pytest.raises(NotImplementedError, match="GQA"):
        tfa.flash_attention_bwd(*a, True)
    assert not any(kernels.launch_counts().values())


def _slab_heads(g):
    """#7's heads a block for the any-group test: the whole group
    (unsplit), a quarter of it and one past half (an uneven last slab)."""
    return sorted({g, max(1, g // 4), g // 2 + 1})


@pytest.mark.parametrize("t,s", [(200, 200), (1000, 700)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", ANY_GROUPS)
def test_flash_bwd_any_group(dev, g, d, causal, t, s):
    """#6 / #7 in bf16 at G outside {1, 2, 4, 8} (MQA from G = 48), T = S
    and T = 1000 against S = 700: through the wrapper (one launch each,
    #7 in the slabs ``dkv_slab_heads`` picks at this small grid), then #7
    unsplit and in slabs of a quarter and of one past half of the group
    (its f32 sums merged in slab order through the ticket counters);
    dq, dk and dv within 2e-2 of the plain version's largest, two calls
    bit-identical."""
    _, h, kv = _any_heads(g)
    args = _bwd_inputs(dev, 2, t, s, h, kv, d, causal)
    q, k, v, o, lse, gr = args
    want = tfa.flash_attention_bwd_plain(*args, causal)
    kernels.reset_launch_counts()
    got = tfa.flash_attention_bwd(*args, causal)
    sfx = "_d256" if d == 256 else ""
    n = kernels.launch_counts()
    assert n["flash_attention_bwd_dq" + sfx] == 1
    assert n["flash_attention_bwd_dkv" + sfx] == 1
    _check_bwd(got, want)
    again = tfa.flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(x, y), name
    _, delta = tfa._launch_bwd_dq(q, k, v, o, lse, gr, causal)
    for heads in _slab_heads(g):
        one = tfa._launch_bwd_dkv(q, k, v, gr, lse, delta, causal, heads)
        _check_bwd((got[0],) + one, want)
        two = tfa._launch_bwd_dkv(q, k, v, gr, lse, delta, causal, heads)
        torch.cuda.synchronize()
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1]), \
            heads


# ---------------------------------------------------------------------------
# the MoE FFN (models/moe.py) on the card: plain PyTorch around the
# expert products, held to the CPU result on the same inputs
# ---------------------------------------------------------------------------


def _moe_case(dtype, tie=False, n=256):
    """granite-moe-1b's widths (d 1024, 32 experts of d_ff 512, top-8,
    capacity factor 2.0) on ``n`` tokens, made on the CPU from a seed;
    with ``tie`` the router's columns repeat in pairs (exact ties between
    experts 2j and 2j + 1)."""
    from repro_torch.config.base import ModelConfig
    cfg = ModelConfig(name="moe-case", family="moe", num_layers=1,
                      d_model=1024, num_heads=16, num_kv_heads=8, d_ff=512,
                      vocab_size=128, block_pattern=(("attn", "moe"),),
                      num_experts=32, experts_per_token=8,
                      param_dtype=dtype, compute_dtype=dtype).validate()
    g = torch.Generator().manual_seed(11)
    e, d, ff = 32, 1024, 512
    router = torch.randn(d, e, generator=g) / d ** 0.5
    if tie:
        router[:, 1::2] = router[:, 0::2]
    w = {"router": router,
         "e_wg": (torch.randn(e, d, ff, generator=g) / d ** 0.5).to(dtype),
         "e_wu": (torch.randn(e, d, ff, generator=g) / d ** 0.5).to(dtype),
         "e_wd": (torch.randn(e, ff, d, generator=g) / ff ** 0.5).to(dtype)}
    x = torch.randn(1, n, d, generator=g).to(dtype)
    return cfg, w, x


def _moe(cfg, w, x, device):
    from repro_torch.models import moe
    from repro_torch.models.layers import NO_ADAPTER
    w = {k: v.to(device) for k, v in w.items()}
    x = x.to(device)
    xf = x.reshape(-1, x.shape[-1])
    _, probs, _, top_i = moe.router(xf, w["router"], cfg.experts_per_token)
    cap = moe.capacity(cfg, top_i.numel())
    _, _, dest = moe.dispatch_plan(top_i, cfg.num_experts, cap)
    y, _ = moe.moe_ffn(x, w, NO_ADAPTER, cfg)
    torch.cuda.synchronize()
    return y.cpu(), probs.cpu(), top_i.cpu(), dest.cpu()


def test_moe_ffn_on_the_card_matches_the_cpu_in_f32(dev):
    """Exact routing and dispatch (the same top-8 sets, the same slots and
    dropped pairs), outputs within 1e-4 of the largest CPU value."""
    cfg, w, x = _moe_case(torch.float32, n=512)
    y, _, top_i, dest = _moe(cfg, w, x, dev)
    y0, _, top_i0, dest0 = _moe(cfg, w, x, "cpu")
    assert torch.equal(top_i, top_i0) and torch.equal(dest, dest0)
    assert float((y - y0).abs().max() / y0.abs().max()) <= 1e-4


def test_moe_ffn_on_the_card_is_deterministic_in_bf16(dev):
    cfg, w, x = _moe_case(torch.bfloat16)
    a, b = _moe(cfg, w, x, dev), _moe(cfg, w, x, dev)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_moe_router_ties_on_the_card_keep_the_lower_expert(dev):
    """bf16 logits with exact ties (duplicated router columns): the
    card's top-k keeps the lower expert index first, as a stable sort of
    the same probabilities on the CPU does (and ``jax.lax.top_k``)."""
    cfg, w, x = _moe_case(torch.bfloat16, tie=True)
    _, probs, top_i, _ = _moe(cfg, w, x, dev)
    assert torch.equal(probs[:, 0::2], probs[:, 1::2])
    want = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    assert torch.equal(top_i, want[:, :cfg.experts_per_token])
    assert bool((top_i[:, 0] % 2 == 0).all())


# ---------------------------------------------------------------------------
# head_dim 112 (kimi-k2, 7168 / 64): the d = 128 kernels of K3 / #5, K4, #8
# and #8q on tiles padded in shared memory; operands stay 112 wide
# ---------------------------------------------------------------------------

D112_ATTN = [(1, 64, 64, 64, 8, True, 1.0), (2, 70, 70, 8, 1, True, 1.0),
             (1, 33, 100, 48, 1, False, 1.0), (1, 300, 300, 8, 8, True, 1.0),
             (2, 600, 600, 16, 2, True, 1.0), (1, 64, 64, 8, 1, True, 4.0)]


@pytest.mark.parametrize("b,t,s,h,kv,causal,qscale", D112_ATTN)
def test_flash_attention_d112(dev, b, t, s, h, kv, causal, qscale):
    """K3 and #5 at d = 112 (G = 1, 8, 48; T = 600 takes two warpgroups a
    block): within 2e-2 of the plain version, lse within 1e-3, K3 equal
    to #5's output, both variants bit-identical from call to call,
    counted under the ``_d112`` keys. ``qscale`` 4: scores large enough
    that a softmax scaled by 128^-0.5 instead of 112^-0.5 misses 2e-2."""
    d = 112
    q = (_rn(dev, b, t, h, d).float() * qscale).to(torch.bfloat16)
    k, v = _rn(dev, b, s, kv, d, seed=1), _rn(dev, b, s, kv, d, seed=2)
    kernels.reset_launch_counts()
    o3 = tfa.flash_attention(q, k, v, causal)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    n_ = kernels.launch_counts()
    assert n_["flash_attention_d112"] == 1
    assert n_["flash_attention_fwd_d112"] == 1
    assert n_["flash_attention"] == n_["flash_attention_fwd"] == 0
    assert o.shape == q.shape and o.stride() == q.stride()
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o3, po, 2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    assert torch.equal(o3, o)
    for variant in tfa.FWD_VARIANTS:
        got = tfa._launch_fwd(q, k, v, causal, None, variant)
        _close(got, po, 2e-2)
        assert torch.equal(tfa._launch_fwd(q, k, v, causal, None, variant),
                           got)


def test_d112_kernels_write_only_their_columns(dev):
    """K3, K4 and #8 at d = 112 writing into o viewed inside a buffer of
    128 columns a head, the 16 past each head's 112 holding a sentinel:
    the sentinels survive (a 128-column store would overwrite them, or
    the next head's first columns in a packed (B, T, 64, 112) output), and
    the 112 written columns match the plain version."""
    b, t, h, kv, d = 1, 64, 64, 8, 112

    def sentinel_o(*shape):
        buf = torch.full((*shape, 128), 7.0, dtype=torch.bfloat16,
                         device=dev)
        return buf, buf[..., :d]
    q, k, v = (_rn(dev, b, t, h, d), _rn(dev, b, t, kv, d, seed=1),
               _rn(dev, b, t, kv, d, seed=2))
    buf, o = sentinel_o(b, t, h)
    st = ctypes.cast(tfa._strides(q, k, v, o), ctypes.c_void_p)
    tfa._build.check(tfa._fn("flash_attention_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, t,
        t, h, kv, d, 1, 1, st, tfa._build.stream_ptr(q)), "flash_attention")
    _close(o, tfa.flash_attention_plain(q, k, v, True), 2e-2)
    assert bool((buf[..., d:] == 7.0).all())
    pos = torch.tensor([t - 1], dtype=torch.int32, device=dev)
    for split in (0, 1):
        buf, o = sentinel_o(b, h)
        tpa._build.check(tpa.launch_dense(q[:, -1], k, v, pos, o, split),
                         "decode_attention")
        _close(o, tfa.decode_attention_plain(q[:, -1], k, v, pos), 2e-2)
        assert bool((buf[..., d:] == 7.0).all())
    args = _paged_case(dev, 32, 8, d, 16, edge=True)
    qp, kc, vc, tables, ppos = args
    for split in (0, 1):
        buf, o = sentinel_o(*qp.shape[:3])
        st = tfa._strides(qp, kc, vc, o)
        st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
        tpa._build.check(tpa._launch_tc(qp, kc, vc, tables, ppos, o,
                                        kc.shape[0], 16, st, split), "paged")
        _close(o, tpa.paged_decode_attention_plain(*args), 2e-2)
        assert bool((buf[..., d:] == 7.0).all())


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("g", [1, 8, 48])
def test_decode_attention_d112(dev, g, split):
    """K4 at d = 112 over a 300-cell cache: windows of one cell, of the
    whole cache and past it, split into chunks or not (the workspace
    sized by the 128-wide tile); within 2e-2 of the plain version, pos 0
    exactly v[0], two calls bit-identical."""
    b, s, kv, d = 5, 300, 1 if g == 48 else 2, 112
    q, k, v = (_rn(dev, b, kv * g, d), _rn(dev, b, s, kv, d, seed=1),
               _rn(dev, b, s, kv, d, seed=2))
    pos = torch.tensor([0, 63, s - 1, s, 5 * s], dtype=torch.int32,
                       device=dev)
    want = tfa.decode_attention_plain(q, k, v, pos)
    got = _dense_launch(q, k, v, pos, split)
    _close(got, want, 2e-2)
    assert torch.equal(got[0], v[0, 0].repeat_interleave(g, 0))
    assert torch.equal(_dense_launch(q, k, v, pos, split), got)
    kernels.reset_launch_counts()
    got = tfa.decode_attention(q, k, v, pos)
    _close(got, want, 2e-2)
    assert torch.equal(tfa.decode_attention(q, k, v, pos), got)
    n_ = kernels.launch_counts()
    assert n_["decode_attention_d112"] == 2 and n_["decode_attention"] == 0


@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("g", [1, 8, 48])
@pytest.mark.parametrize("c", [1, 3, 32])
def test_paged_decode_attention_d112(dev, c, g, page):
    """#8 at d = 112: ``mma.sync`` below 64 rows, ``wgmma`` from 64 (C·G
    up to 1536 in slabs of 256), a window ending on a page edge,
    sentinels inside and past the window; within 2e-2 of the plain
    version, two calls bit-identical, counted under ``_d112``."""
    args = _paged_case(dev, c, g, 112, page, edge=True)
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention(*args), got)
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_d112"] == 2
    assert n_["paged_decode_attention"] == 0


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("g", [1, 8, 48])
@pytest.mark.parametrize("c", [1, 4, 32])
def test_paged_decode_attention_int8_d112(dev, c, g, page):
    """#8q at d = 112: int8 rows of 112 bytes (7 chunks of 16, the eighth
    of the 128-byte tile row zero-filled and widened to zeros); within
    2e-2 of the plain version, two calls bit-identical."""
    args = _paged_case_int8(dev, c, g, 112, page)
    assert args[1].shape[-1] == 112 and args[1].stride(-2) == 112
    kernels.reset_launch_counts()
    got = tpa.paged_decode_attention_int8(*args)
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16
    _close(got, tpa.paged_decode_attention_int8_plain(*args), 2e-2)
    assert torch.equal(tpa.paged_decode_attention_int8(*args), got)
    n_ = kernels.launch_counts()
    assert n_["paged_decode_attention_int8_d112"] == 2
    assert n_["paged_decode_attention_int8"] == 0


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("c,g", [(1, 1), (1, 8), (32, 8), (32, 48)])
def test_paged_d112_split_windows(dev, c, g, split, quantized):
    """#8 / #8q at d = 112 with every window split into chunks of
    ``split`` tiles (0: one block a window), merged in chunk order through
    the workspace sized by the 128-wide tile: within 2e-2 of the plain
    version and bit-identical from call to call."""
    q, kc, vc, tables, pos = _paged_case(dev, c, g, 112, 16, edge=True)
    n, page = kc.shape[0], kc.shape[1]
    o = [torch.empty_like(q) for _ in range(2)]
    if quantized:
        k8, ks = tquant.quantize_kv(kc.float() * 3)
        v8, vs = tquant.quantize_kv(vc.float() * 3)
        st = tpa.int8_strides(q, k8, v8, ks, vs, tables, o[0])
        for t in o:
            tpa._build.check(tpa._launch_tc(q, k8, v8, tables, pos, t, n,
                                            page, st, split, (ks, vs)),
                             "split")
        want = tpa.paged_decode_attention_int8_plain(q, k8, v8, ks, vs,
                                                     tables, pos)
    else:
        st = tfa._strides(q, kc, vc, o[0])
        st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
        for t in o:
            tpa._build.check(tpa._launch_tc(q, kc, vc, tables, pos, t, n,
                                            page, st, split), "split")
        want = tpa.paged_decode_attention_plain(q, kc, vc, tables, pos)
    _close(o[0], want, 2e-2)
    assert torch.equal(o[0], o[1])


def test_int8_pool_of_112_bytes_a_row(dev):
    """The int8 paged pools of a head_dim 112 model hold 112 bytes a row
    (no padded copy in device memory), and #8q reads them as they are."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get_smoke_config("kimi-k2-1t-a32b"),
                              d_model=896, num_heads=8, num_kv_heads=1,
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    assert cfg.resolved_head_dim == 112
    caches = T.init_paged_caches(cfg, 6, 16, torch.bfloat16, kv_quant=True,
                                 device=dev)
    pools = [t for c in caches for t in c["self"].values()
             if t.dtype == torch.int8]
    assert len(pools) == 2 * len(caches)
    for t in pools:
        assert t.shape[-1] == 112 and t.stride(-2) == 112
        assert t.element_size() == 1
    args = _paged_case_int8(dev, 1, 8, 112, 16)
    got = tpa.paged_decode_attention_int8(*args)
    _close(got, tpa.paged_decode_attention_int8_plain(*args), 2e-2)


def test_d112_rejects_what_the_kernels_do_not_take(dev):
    """The flash backward (#6 / #7) takes bf16 at d = 112 (one launch of
    each, under the ``_d112`` keys); f32 at 112 raises for the forward and
    the backward, and head_dim 96 still raises everywhere, the backward
    included; nothing falls back."""
    q, k, v = (_rn(dev, 1, 64, 8, 112), _rn(dev, 1, 64, 1, 112, seed=1),
               _rn(dev, 1, 64, 1, 112, seed=2))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    kernels.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, q, True)
    n_ = kernels.launch_counts()
    assert n_["flash_attention_bwd_dq_d112"] == 1
    assert n_["flash_attention_bwd_dkv_d112"] == 1
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, q, True))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q.float(), k.float(), v.float(), True)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                lse, q.float(), True)
    qd, kd, vd = (t[..., :96].contiguous() for t in (q, k, v))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(qd, kd, vd, True)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_bwd(qd, kd, vd, qd, lse, qd, True)
    with pytest.raises(NotImplementedError):
        tfa.decode_attention(qd[:, 0], kd, vd,
                             torch.zeros(1, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError):
        tpa.paged_decode_attention(*_paged_case(dev, 4, 2, 96, 16))
    torch.cuda.synchronize()


# #6 / #7 at d = 112 (kimi-k2's training): the d = 128 passes on tiles
# padded in shared memory; T = S and T = 1000 != S, causal and not, G = 1,
# 8 (kimi's), 48, and a q x 4 case that a 128^-0.5 scale misses
D112_BWD = [(2, 200, 200, 64, 8, True, 1.0), (2, 200, 200, 64, 8, False, 1.0),
            (1, 1000, 700, 16, 2, True, 1.0),
            (1, 1000, 700, 16, 2, False, 1.0),
            (1, 129, 129, 8, 1, True, 1.0), (2, 70, 70, 48, 1, True, 1.0),
            (1, 64, 64, 8, 8, True, 1.0), (1, 128, 128, 16, 2, True, 4.0)]


def _bwd_inputs_d112(dev, b, t, s, h, kv, causal, qscale=1.0):
    q, k, v, o, lse, g = _bwd_inputs_d256(dev, b, t, s, h, kv, 112, causal)
    if qscale != 1.0:
        q = (q.float() * qscale).to(torch.bfloat16)
        o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, g


@pytest.mark.parametrize("b,t,s,h,kv,causal,qscale", D112_BWD)
def test_flash_attention_bwd_d112(dev, b, t, s, h, kv, causal, qscale):
    """#6 / #7 at d = 112 through the wrapper (one launch each, under the
    ``_d112`` keys; #7 in the slabs ``dkv_slab_heads`` picks at this
    grid), then #7 unsplit and in slabs of a quarter and of one past half
    of the group: each gradient within 2e-2 of the largest plain one, two
    calls bit-identical."""
    args = _bwd_inputs_d112(dev, b, t, s, h, kv, causal, qscale)
    q, k, v, o, lse, gr = args
    want = tfa.flash_attention_bwd_plain(*args, causal)
    kernels.reset_launch_counts()
    got = tfa.flash_attention_bwd(*args, causal)
    n_ = kernels.launch_counts()
    assert {k_: x for k_, x in n_.items() if x} == {
        "flash_attention_bwd_dq_d112": 1, "flash_attention_bwd_dkv_d112": 1}
    _check_bwd(got, want)
    again = tfa.flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(x, y), name
    _, delta = tfa._launch_bwd_dq(q, k, v, o, lse, gr, causal)
    for heads in _slab_heads(h // kv):
        one = tfa._launch_bwd_dkv(q, k, v, gr, lse, delta, causal, heads)
        _check_bwd((got[0],) + one, want)
        two = tfa._launch_bwd_dkv(q, k, v, gr, lse, delta, causal, heads)
        torch.cuda.synchronize()
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1]), \
            heads


def test_flash_bwd_d112_slab_rule_at_kimi_shapes(dev):
    """kimi-k2's training shapes: at B = 1, T = 1024 the 128 (kv head,
    batch, key tile) blocks leave the SMs short, so #7 runs slabs (of 2
    heads on 132 SMs); at B = 4 its 512 blocks run unsplit. Both against
    the plain version at B = 1 (the slab instance) and B = 2, T = 512
    (unsplit: 256 blocks on 132 SMs)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tfa.dkv_slab_heads(1, 1024, 8, 8, 112, sms) < 8
    assert tfa.dkv_slab_heads(4, 1024, 8, 8, 112, sms) == 8
    for b, t in ((1, 1024), (2, 512)):
        args = _bwd_inputs_d112(dev, b, t, t, 64, 8, True)
        _check_bwd(tfa.flash_attention_bwd(*args, True),
                   tfa.flash_attention_bwd_plain(*args, True))


def _in_wide(x, fill):
    """x (..., 112) copied into the first 112 columns of a (..., 128)
    buffer whose last 16 columns hold ``fill``; returns (buffer, view)."""
    buf = torch.full((*x.shape[:-1], 128), fill, dtype=x.dtype,
                     device=x.device)
    buf[..., :112] = x
    return buf, buf[..., :112]


@pytest.mark.parametrize("heads", [8, 2])
def test_flash_bwd_d112_reads_and_writes_only_112_columns(dev, heads):
    """#6 / #7 at d = 112 on operands viewed inside buffers of 128 columns
    a head whose 16 padding columns hold 7.0: δ equals the plain rowsum of
    dO ⊙ O over the 112 real columns (a 128-column read would add the
    sentinels' 16 · 49 a row), dq / dk / dv match the plain version, and
    the sentinels past each head's 112 in dq, dk and dv survive, unsplit
    (8 heads a block) and in slabs of 2."""
    b, t, h, kv, causal = 2, 200, 64, 8, True
    q, k, v, o, lse, g = _bwd_inputs_d112(dev, b, t, t, h, kv, causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    (_, qw), (_, kw), (_, vw), (_, ow), (_, gw) = (
        _in_wide(x, 7.0) for x in (q, k, v, o, g))
    dqb, dq = _in_wide(torch.zeros_like(q), 7.0)
    dkb, dk = _in_wide(torch.zeros_like(k), 7.0)
    dvb, dv = _in_wide(torch.zeros_like(v), 7.0)
    delta = torch.empty_like(lse)
    st = ctypes.cast(tfa._strides(qw, kw, vw, ow, gw, dq), ctypes.c_void_p)
    tfa._build.check(tfa._fn("flash_attention_bwd_dq_bf16")(
        qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), ow.data_ptr(),
        gw.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t,
        t, h, kv, 112, int(causal), st, tfa._build.stream_ptr(q)), "dq")
    plain_delta = (g.float() * o.float()).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, plain_delta, rtol=1e-5, atol=1e-4)
    slabs = -(-(h // kv) // heads)
    ws = cnt = None
    if slabs > 1:
        tiles = b * kv * -(-t // tfa.DKV_ROWS)
        ws = torch.empty(tiles * slabs * 2 * tfa.DKV_ROWS * 128,
                         dtype=torch.float32, device=dev)
        cnt = tfa._build.counters(dev, tiles)
    st = ctypes.cast(tfa._strides(qw, kw, vw, gw, dk, dv), ctypes.c_void_p)
    tfa._build.check(tfa._fn("flash_attention_bwd_dkv_bf16")(
        qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), gw.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t,
        t, h, kv, 112, int(causal), st, heads,
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), tfa._build.stream_ptr(q)),
        "dkv")
    _check_bwd((dq, dk, dv), want)
    for buf in (dqb, dkb, dvb):
        assert bool((buf[..., 112:] == 7.0).all())


# ---------------------------------------------------------------------------
# the mamba mixer (models/mamba.py, jamba-v0.1-52b): torch ops between two
# K1 projections, held to the CPU in f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,chunk", [(8, 256), (24, 8)])
def test_mamba_mixer_on_the_card_matches_the_cpu_in_f32(dev, t, chunk):
    """jamba's smoke mixer (d_inner 128, d_state 16) with a MetaTT-4d
    adapter on mamba in / out (the f32 K1 on the card), on the
    whole-sequence and the chunked scan: the output, the last state and
    the conv window, the input and adapter gradients and one decode step
    in place, within 1e-4 of the largest CPU value (f32 sums in another
    order; TF32 off)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.config.base import RunConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import mamba as tmamba
    from repro_torch.models import model as TM
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import AdapterCtx
    from repro_torch.peft import api as tpeft
    cfg = configs.get_smoke_config("jamba-v0.1-52b")
    spec = TM.build_adapter_spec(RunConfig(model=cfg, adapter_rank=4))
    gen = torch.Generator().manual_seed(19)
    params = TM.init_params(cfg, spec, gen, device="cpu")
    cores = ttlib.random_tt(gen, spec.cfg.mode_sizes, 4, scale=0.3,
                            device="cpu")
    x = torch.randn((2, t, cfg.d_model), generator=gen)
    cot = torch.randn((2, t, cfg.d_model), generator=gen)

    def run(device):
        w = TT._at(params["base"]["blocks"][0]["mixer"], 0)
        w = {k: v.to(device) for k, v in w.items()}
        cs = [c.to(device).requires_grad_(True) for c in cores]
        bc, pl = tpeft.adapter_factors(spec, {"cores": cs}, {})
        ctx = AdapterCtx(spec, bc, TT._at(pl, 0))
        xs = x.to(device).requires_grad_(True)
        y, cache = tmamba.mamba_mixer(xs, w, ctx, cfg, chunk=chunk)
        grads = torch.autograd.grad(y, [xs] + cs, cot.to(device))
        with torch.no_grad():
            cache = {k: v.detach().clone() for k, v in cache.items()}
            step, _ = tmamba.mamba_mixer(xs[:, -1:].detach(), w, ctx, cfg,
                                         cache=cache)
        return [v.detach().cpu() for v in
                (y, *cache.values(), step, *grads)]
    kernels.reset_launch_counts()
    got = run(dev)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tt_linear_f32"] > 0
    for g, w in zip(got, run("cpu")):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
