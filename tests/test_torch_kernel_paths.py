"""Host-side choices of the kernels' launchers, on the CPU.

- ``tt_linear.ba_plan``: K2's and #10's kernel (the split-K `wgmma`
  kernel after a pre-pass that sums the adapter term P[m] = x[m]·A[m],
  or the template kernel where the operands cannot take 16-byte copies or
  the rank passes ``RANK_WGMMA``) and over how many slices of K;
  ``ba_path`` on K2's operands themselves.
- ``paged_attention.decode_path``: K4 on #8's kernel over the dense
  cache, with windows split into chunks where the blocks leave the card
  under-filled.
- ``paged_attention.paged_path`` with ``quantized=True``: #8q runs
  ``mma.sync`` in slabs of at most 64 rows, and splits windows into
  chunks where the blocks leave the card under-filled.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import tt_linear as ttl


@pytest.mark.parametrize("m,k,n,r,offset,want", [
    (4, 2048, 2048, 8, 0, "wgmma"),
    (4, 2048, 2048, 64, 0, "wgmma"),
    (4, 2048, 2048, 65, 0, "template"),    # rank above RANK_WGMMA
    (4, 2048, 136, 8, 0, "wgmma"),         # N % 8 == 0 (bf16 W)
    (4, 2048, 130, 8, 0, "template"),      # N % 8 != 0
    (4, 2044, 2048, 8, 0, "template"),     # K % 8 != 0
    (4, 2048, 2048, 8, 1, "template"),     # x not 16-byte aligned
])
def test_ba_path_reads_the_operands(monkeypatch, m, k, n, r, offset, want):
    """``ba_path`` on real tensors: K % 8, N % 8 and 16-byte aligned x, W
    and A decide the vector path (the card's SM count is stubbed)."""
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: type("Props", (), {"multi_processor_count": 132}))
    x = torch.zeros(m * k + offset, dtype=torch.bfloat16)[offset:]
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    a = torch.zeros(m, k, r, dtype=torch.bfloat16)
    assert ttl.ba_path(x.view(m, k), w, a, r)[0] == want


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


@pytest.mark.parametrize("m,n,k,r,vec,want", [
    (4, 2048, 2048, 8, True, ("wgmma", 8)),       # the w8 dense decode
    (1, 2048, 2048, 1, True, ("wgmma", 8)),
    (16, 2048, 2048, 16, True, ("wgmma", 8)),
    (64, 2048, 2048, 8, True, ("wgmma", 8)),      # a full launch of ops'
    (8, 2048, 2048, 64, True, ("wgmma", 8)),      # RANK_WGMMA
    (8, 2048, 2048, 65, True, ("template", 1)),   # above it
    (4, 130, 2048, 8, False, ("template", 1)),    # N % 16 != 0
    (4, 2048, 2048, 8, False, ("template", 1)),   # an unaligned operand
    (4, 2048, 256, 8, True, ("wgmma", 2)),        # 4 K tiles: 2 a slice
    (4, 64, 64, 8, True, ("wgmma", 1)),           # one K tile
    (64, 8192, 2048, 8, True, ("wgmma", 2)),      # 128 channel tiles
    (64, 16384, 2048, 8, True, ("wgmma", 1)),     # 256: no split
    (64, 4096, 2048, 8, True, ("wgmma", 4)),      # 64 channel tiles
])
def test_bw8_plan_picks_the_kernel_and_the_slices(m, n, k, r, vec, want):
    """#10 and K2 on 132 SMs (``ba_plan``): the template kernel only
    where the `wgmma` kernel cannot take the operands (rank above
    ``RANK_WGMMA``, N % 16 != 0 for an int8 W, an operand that cannot take
    16-byte copies); the slices of K are #9's (``w8_splits``: a block on
    every SM, each slice at least two K tiles, at most eight)."""
    assert ttl.ba_plan(m, n, k, r, vec, sms=132) == want


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (64, 2048, 2048),
                                   (3, 384, 130), (17, 512, 200)])
def test_bw8_plan_slices_equal_w8_splits(m, k, n):
    """K2's and #10's `wgmma` path slices K as #9's does at the same
    shape."""
    assert ttl.ba_plan(m, n, k, 8, True, sms=132)[1] == ttl.w8_splits(
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
