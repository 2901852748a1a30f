"""Host-side choices of the kernels' launchers, on the CPU.

- ``tt_linear.ba_plan``: how K2's, #9's and #10's split-K `wgmma` kernel
  forms the rank term (``"wgmma"``: P in registers or summed by the
  per-row pre-pass in f32, up to ``RANK_WGMMA``; ``"pre_pass"``: α·P as
  a bf16 hi + lo pair and extension tiles, every larger rank) and over
  how many slices of K; ``splitk_path`` on the operands themselves, and
  ``vec_operands``, which pads and copies the operands the kernel cannot
  take with 16-byte copies.
- ``paged_attention.decode_path``: K4 on #8's kernel over the dense
  cache, with windows split into chunks where the blocks leave the card
  under-filled.
- ``paged_attention.paged_path`` with ``quantized=True``: #8q runs
  ``mma.sync`` in slabs of at most 64 rows, and splits windows into
  chunks where the blocks leave the card under-filled; at head_dim 256
  #8 does too, and the forward (K3 / #5) takes one warpgroup a block.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import tt_linear as ttl


@pytest.mark.parametrize("m,k,n,r,offset,want", [
    (4, 2048, 2048, 8, 0, ("wgmma", False)),
    (4, 2048, 2048, 64, 0, ("wgmma", False)),
    (4, 2048, 2048, 65, 0, ("pre_pass", False)),    # above RANK_WGMMA
    (4, 2048, 136, 8, 0, ("wgmma", False)),         # N % 8 == 0 (bf16 W)
    (4, 2048, 130, 8, 0, ("wgmma", True)),          # N % 8 != 0: padded
    (4, 2044, 2048, 8, 0, ("wgmma", True)),         # K % 8 != 0: padded
    (4, 2048, 2048, 8, 1, ("wgmma", True)),         # x not 16-byte aligned
])
def test_ba_path_reads_the_operands(monkeypatch, m, k, n, r, offset, want):
    """``splitk_path`` on real tensors names the rank term's form; K % 8,
    N % 8 and 16-byte aligned x, W and A decide whether
    ``vec_operands`` copies them (the card's SM count is stubbed). The
    copies hold the operands zero-padded, so the plain version on them
    gives the same y."""
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: type("Props", (), {"multi_processor_count": 132}))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m * k + offset, generator=g).bfloat16()[offset:]
    x = x.view(m, k)
    w = torch.randn(k, n, generator=g).bfloat16()
    a = torch.randn(m, k, r, generator=g).bfloat16()
    b = torch.randn(r, n, generator=g).bfloat16()
    ops_ = ttl.vec_operands(x, w, None, a, b, True)
    assert (ttl.splitk_path(x, w, r)[0], ops_[-1]) == want
    xp, wp, _, ap, bp, _ = ops_
    assert xp.shape[1] % 8 == 0 and wp.shape[1] % 8 == 0
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (xp, wp, ap, bp))
    y = ttl.tt_linear_batched_a_plain(xp, wp, ap, bp, 2.0)[:, :n]
    torch.testing.assert_close(
        y, ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), rtol=0, atol=0)


@pytest.mark.parametrize("b,h,kv,s,want", [
    (4, 32, 32, 256, ("mma", 1)),      # the dense engine: 4 one-tile chunks
    (4, 32, 32, 4096, ("mma", 13)),    # a long cache: 5 chunks a window
    (4, 32, 8, 256, ("mma", 1)),       # G = 4: 32 blocks
    (1, 8, 1, 4096, ("mma", 1)),       # one block, 64 tiles: 1 a chunk
    (72, 32, 32, 256, ("mma", 0)),     # 2304 blocks fill the card
    (4, 32, 32, 64, ("mma", 0)),       # a one-tile cache
    (4, 32, 32, 40, ("mma", 0)),       # shorter than a tile
])
def test_decode_path_splits_where_the_card_is_under_filled(b, h, kv, s,
                                                           want):
    """K4 on 132 SMs: ``mma.sync`` with the G query rows of a (slot, kv
    head) a block; windows split into chunks of ``split`` 64-cell tiles
    (about four blocks an SM) only where B·KV blocks leave the card with
    fewer than two an SM, and never on a one-tile cache."""
    assert tpa.decode_path(b, h, kv, s, sms=132) == want


@pytest.mark.parametrize("m,n,k,r,want", [
    (4, 2048, 2048, 8, ("wgmma", 8)),       # the w8 dense decode
    (1, 2048, 2048, 1, ("wgmma", 8)),
    (16, 2048, 2048, 16, ("wgmma", 8)),
    (64, 2048, 2048, 8, ("wgmma", 8)),      # a full launch of ops'
    (8, 2048, 2048, 64, ("wgmma", 8)),      # RANK_WGMMA
    (8, 2048, 2048, 65, ("pre_pass", 8)),   # above it: K + 2·128 rows
    (4, 144, 2048, 8, ("wgmma", 8)),        # N padded to 16
    (4, 2048, 2048, 384, ("pre_pass", 8)),  # K + 2·384 rows
    (4, 2048, 2048, 1024, ("pre_pass", 8)),  # VeRA's rank
    (64, 2048, 2048, 1024, ("pre_pass", 8)),
    (4, 2048, 256, 8, ("wgmma", 2)),        # 4 K tiles: 2 a slice
    (4, 2048, 256, 1024, ("pre_pass", 8)),  # 4 + 32 tiles
    (4, 64, 64, 8, ("wgmma", 1)),           # one K tile
    (4, 64, 64, 100, ("pre_pass", 2)),      # 1 + 4 tiles: 3 + 2
    (64, 8192, 2048, 8, ("wgmma", 2)),      # 128 channel tiles
    (64, 16384, 2048, 8, ("wgmma", 1)),     # 256: no split
    (64, 4096, 2048, 8, ("wgmma", 4)),      # 64 channel tiles
])
def test_bw8_plan_picks_the_kernel_and_the_slices(m, n, k, r, want):
    """#10, K2 and #9 on 132 SMs (``ba_plan``): every rank takes the
    split-K `wgmma` kernel — P in registers (or the per-row pre-pass's f32
    sums) up to ``RANK_WGMMA``, the hi + lo pre-pass above it; the slices
    of K are ``w8_splits`` over the K loop's rows, extension included (a
    block on every SM, each slice at least two K tiles, at most eight)."""
    assert ttl.ba_plan(m, n, k, r, sms=132) == want


@pytest.mark.parametrize("r", [65, 384, 1024, 2048, 5000])
def test_split_k_linears_take_every_rank(monkeypatch, r):
    """No rank is refused: ``splitk_path`` names the pre-pass form above
    ``RANK_WGMMA`` on K2's bf16 and #9 / #10's int8 operands at any rank,
    and the extension rows join the K loop the slices split."""
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: type("Props", (), {"multi_processor_count": 132}))
    m, k, n = 4, 2048, 2048
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    wq = torch.zeros(k, n, dtype=torch.int8)
    want = ("pre_pass", ttl.w8_splits(m, n, k + 2 * (-(-r // 64) * 64),
                                      132))
    assert ttl.splitk_path(x, wq, r) == want
    assert ttl.splitk_path(x, w, r) == want
    assert ttl.splitk_rows(k, r) == k + 2 * (-(-r // 64) * 64)
    assert ttl.k1_workspace_elems(m, r) == m * 2 * (-(-r // 64) * 64)
    assert not hasattr(ttl, "SHARED_P_MAX_RANK")
    assert not hasattr(ttl, "K1_MAX_RANK")


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (64, 2048, 2048),
                                   (3, 384, 130), (17, 512, 200)])
def test_bw8_plan_slices_equal_w8_splits(m, k, n):
    """K2's and #10's `wgmma` path slices K as #9's does at the same
    shape."""
    assert ttl.ba_plan(m, n, k, 8, sms=132)[1] == ttl.w8_splits(
        m, n, k, sms=132)


@pytest.mark.parametrize("b,c,h,kv,p_tab,page,want", [
    (8, 32, 32, 32, 34, 16, ("mma", 3)),    # the int8 engine's step
    (8, 1, 32, 32, 34, 16, ("mma", 3)),     # pure decode: one row
    (8, 32, 32, 16, 34, 16, ("mma", 2)),    # G = 2: one 64-row slab
    (8, 32, 64, 8, 34, 16, ("mma", 3)),     # G = 8: four slabs of 64 rows
    (8, 32, 128, 16, 34, 16, ("mma", 0)),   # 8 x 16 x 4 blocks: no split
    (64, 1, 32, 32, 34, 16, ("mma", 0)),    # 2048 blocks fill the card
    (8, 1, 32, 32, 4, 16, ("mma", 0)),      # a one-tile table: no split
    (1, 1, 8, 8, 64, 64, ("mma", 1)),       # 8 blocks, 64 tiles: 1 a chunk
])
def test_paged_path_int8_takes_mma_slabs_and_splits(b, c, h, kv, p_tab,
                                                    page, want):
    """#8q on 132 SMs: always ``mma.sync``, one block a (slot, kv head,
    slab of 64 rows); windows split into chunks of ``split`` 64-cell tiles
    (about four blocks an SM) only where the blocks leave the card with
    fewer than two an SM."""
    assert tpa.paged_path(b, c, h, kv, p_tab, page, sms=132,
                          quantized=True) == want


@pytest.mark.parametrize("c,g,quantized,want", [
    (1, 1, False, 1), (32, 8, False, 256), (64, 8, False, 256),
    (1, 1, True, 1), (32, 2, True, 64), (32, 8, True, 64)])
def test_slab_rows_caps_a_block(c, g, quantized, want):
    assert tpa.slab_rows(c, g, quantized) == want


@pytest.mark.parametrize("b,c,h,kv,quantized,want", [
    (8, 32, 16, 16, False, ("mma", 2)),   # gemma-7b's paged step
    (8, 1, 16, 16, False, ("mma", 2)),    # gemma-7b's decode column
    (8, 32, 16, 16, True, ("mma", 2)),    # the int8 leg
    (8, 32, 16, 2, False, ("mma", 1)),    # G = 8: 256 rows, 4 slabs
    (8, 8, 16, 2, False, ("mma", 1)),     # G = 8: 64 rows, one slab
    (64, 32, 16, 16, False, ("mma", 0)),  # 1024 blocks fill the card
])
def test_paged_path_at_head_dim_256_is_mma_in_64_row_slabs(
        b, c, h, kv, quantized, want):
    """At d = 256 every #8 / #8q block runs ``mma.sync`` with at most 64
    rows (a `wgmma` block of 128 / 256 rows does not fit beside the
    ring), with the d = 64 chunk rule; 34-page tables of 16 cells."""
    assert tpa.paged_path(b, c, h, kv, 34, 16, sms=132, quantized=quantized,
                          d=256) == want
    assert tpa.slab_rows(c, h // kv, quantized, d=256) == min(c * h // kv,
                                                               64)


@pytest.mark.parametrize("t,d,want", [
    (64, 64, "wg1"), (1024, 64, "wg2"), (64, 256, "wg1"), (1024, 256, "wg1")])
def test_fwd_variant_takes_one_warpgroup_at_head_dim_256(t, d, want):
    """K3 / #5 at d = 256 run one warpgroup a block at any T: two would
    need 256 KB of shared memory."""
    assert tfa.fwd_variant(t, d) == want


@pytest.mark.parametrize("b,c,h,kv,quantized,want,slabs", [
    (8, 32, 48, 1, False, ("wgmma", 1), 6),   # granite's paged step
    (8, 1, 48, 1, False, ("mma", 1), 1),      # granite's decode column
    (8, 32, 48, 1, True, ("mma", 3), 24),     # the int8 leg: slabs of 64
    (8, 32, 96, 8, False, ("wgmma", 2), 2),   # mistral-large's step
    (8, 1, 96, 8, False, ("mma", 1), 1),      # G = 12, one row a column
    (8, 32, 96, 8, True, ("mma", 0), 6),      # 384 blocks fill the card
    (8, 32, 36, 12, False, ("wgmma", 2), 1),  # G = 3: 96 of 128 rows
])
def test_paged_path_at_any_group(b, c, h, kv, quantized, want, slabs):
    """#8 / #8q at GQA groups outside {1, 2, 4, 8} (granite-34b's 48,
    mistral-large's 12; 34-page tables of 16 cells, 132 SMs): the C·G rows
    of a (slot, kv head) in slabs of 256 (fp) or 64 (int8), each slab
    starting where the last ended — mid-column when 256 or 64 is not a
    multiple of G — and the chunk rule counts every slab's block."""
    assert tpa.paged_path(b, c, h, kv, 34, 16, sms=132,
                          quantized=quantized) == want
    rows = tpa.slab_rows(c, h // kv, quantized)
    assert -(-c * (h // kv) // rows) == slabs


@pytest.mark.parametrize("b,h,kv,s,want,slabs", [
    (4, 48, 1, 256, ("mma", 1), 1),      # granite-34b's dense decode
    (4, 96, 8, 256, ("mma", 1), 1),      # mistral-large's
    (4, 96, 1, 256, ("mma", 1), 2),      # G = 96: two slabs of 64 rows
    (4, 200, 1, 4096, ("mma", 2), 4),    # G = 200: four, the last of 8
    (288, 48, 1, 256, ("mma", 0), 1),    # 288 blocks fill the card
])
def test_decode_path_takes_slabs_above_64_rows(b, h, kv, s, want, slabs):
    """K4 at any group: the G query rows of a (slot, kv head) in slabs of
    at most 64 (one ``mma.sync`` warpgroup), a block each; the chunk rule
    counts B·KV·slabs blocks."""
    assert tpa.dense_slabs(h, kv) == slabs
    assert tpa.decode_path(b, h, kv, s, sms=132) == want
