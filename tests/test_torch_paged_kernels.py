"""The port's paged attention (#8) against the JAX package's.

``ops.paged_decode_attention`` of the port (its plain version: on the CPU
the kernel wrapper runs it too) is held, on the same inputs made with
numpy from a seed, against the JAX Pallas kernel in interpret mode and
the JAX reference, at the shapes of tests/test_paged_engine.py (C in
{1, 4, 8}, GQA, sentinel table entries, ragged positions) and at a few
more (a slot whose last query sits on the last cell of its table, pages
of 16 and 32, C past one page, C·G = 64 and 256 query rows a (slot, kv
head): the row counts at which the card's kernel takes `wgmma`).

Tolerances: f32 2e-5 (the same algorithm, f32 sums in another order);
bf16 2e-2 (the Pallas kernel rounds unnormalised probabilities to bf16
before P·V, the plain version the normalised softmax).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}


def _pair(rng, shape, dt):
    a = rng.standard_normal(shape).astype(np.float32).astype(DTYPES[dt][0])
    if dt == "bf16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, b, c, h, kv, d, n, page, tables, pos, dt):
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng, (b, c, h, d), dt)
    jk, tk = _pair(rng, (n, page, kv, d), dt)
    jv, tv = _pair(rng, (n, page, kv, d), dt)
    tables = np.asarray(tables, np.int32)
    pos = np.asarray(pos, np.int32)
    return ((jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos)),
            (tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(pos)))


def _engine_tables(n, p_tab):
    """tests/test_paged_engine.py's tables: sentinel everywhere but a
    ragged prefix of each row."""
    tables = np.full((3, p_tab), n, np.int32)
    tables[0, :3] = [2, 7, 1]
    tables[1, :2] = [4, 9]
    tables[2, :1] = [11]
    return tables


@pytest.mark.parametrize("c,heads", [(1, (4, 4)), (4, (4, 2)),
                                     (8, (8, 2))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_and_ref_at_engine_test_shapes(c, heads, dt,
                                                            d=16):
    h, kv = heads
    b, n, page, p_tab = 3, 12, 8, 4
    j, t = _inputs(c, b, c, h, kv, d, n, page, _engine_tables(n, p_tab),
                   [17, 9, 3], dt)
    got = tops.paged_decode_attention(*t, backend="ref")
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, c, h, d)
    for want in (jops.paged_decode_attention(*j, backend="ref"),
                 jops.paged_decode_attention(*j, backend="pallas",
                                             interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt],
                                   rtol=TOL[dt])


@pytest.mark.parametrize("c,h,kv,d,page,p_tab,pos", [
    (3, 8, 1, 32, 16, 3, [47, 0, 20]),      # last query past the table
    (16, 4, 2, 64, 32, 2, [63, 10, 40]),    # C past half a page, pos at end
    (1, 2, 2, 16, 8, 5, [39, 0, 7]),        # pos at the table's last cell
    (8, 16, 2, 16, 8, 6, [8, 0, 23]),       # C·G = 64, a window on a page edge
    (32, 16, 2, 16, 16, 4, [0, 31, 12]),    # C·G = 256
])
def test_plain_matches_pallas_at_odd_shapes(c, h, kv, d, page, p_tab, pos):
    n = 9
    rng = np.random.default_rng(c)
    tables = np.full((3, p_tab), n, np.int32)
    for row in range(3):         # distinct blocks for the first pages
        k = min(p_tab, pos[row] // page + 1)
        tables[row, :k] = rng.choice(n, size=k, replace=False)
    j, t = _inputs(7, 3, c, h, kv, d, n, page, tables, pos, "f32")
    got = tops.paged_decode_attention(*t, backend="ref")
    want = jops.paged_decode_attention(*j, backend="pallas", interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("c,heads", [(1, (2, 2)), (5, (4, 2))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_and_ref_at_head_dim_256(c, heads, dt):
    """gemma-7b's heads of 256 at the engine tests' tables (decode and a
    5-column chunk, MHA and GQA)."""
    test_plain_matches_pallas_and_ref_at_engine_test_shapes(c, heads, dt,
                                                            d=256)


@pytest.mark.parametrize("c,heads", [(1, (24, 2)), (5, (24, 2)),
                                     (1, (48, 1)), (5, (48, 1))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_and_ref_at_any_group(c, heads, dt):
    """GQA groups outside {1, 2, 4, 8}: G = 12 (mistral-large's) and
    G = 48 (granite-34b's MQA), at the engine tests' tables, a decode
    column and a 5-column chunk (C·G = 60 and 240 rows a kv head)."""
    test_plain_matches_pallas_and_ref_at_engine_test_shapes(c, heads, dt)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    j, t = _inputs(0, 3, 4, 4, 2, 16, 12, 8, _engine_tables(12, 4),
                   [17, 9, 3], "f32")
    plain = tpa.paged_decode_attention_plain(*t)
    assert torch.equal(tpa.paged_decode_attention(*t), plain)
    assert torch.equal(tops.paged_decode_attention(*t), plain)
    assert torch.equal(tdispatch.paged_decode_attention(*t), plain)
    # a scalar position broadcasts over the slots
    one = tops.paged_decode_attention(*t[:4], torch.tensor(9),
                                      backend="ref")
    assert torch.equal(one, tops.paged_decode_attention(
        *t[:4], torch.full((3,), 9), backend="ref"))
    assert tpa.LAUNCHES["paged_decode_attention"] == 0


def test_sentinel_pages_past_the_window_do_not_change_the_result():
    """Entries past pos + C - 1 are never attended: rewriting them (and
    what their blocks hold) leaves the output bit-identical."""
    _, t = _inputs(1, 3, 4, 4, 2, 16, 12, 8, _engine_tables(12, 4),
                   [10, 5, 2], "f32")
    q, kc, vc, tables, pos = t
    want = tops.paged_decode_attention(q, kc, vc, tables, pos,
                                       backend="ref")
    t2 = tables.clone()
    t2[0, 2:] = 3                 # slot 0 sees cells 0..13: pages 0, 1
    t2[1, 2:] = 5                 # slot 1 sees cells 0..8: pages 0, 1
    got = tops.paged_decode_attention(q, kc, vc, t2, pos, backend="ref")
    assert torch.equal(got, want)


def test_raw_wrapper_and_unported_leg_raise():
    _, t = _inputs(2, 3, 1, 4, 4, 16, 12, 8, _engine_tables(12, 4),
                   [17, 9, 3], "f32")
    q = t[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError):
        tpa.paged_decode_attention(q, *t[1:])
    with torch.no_grad():
        tpa.paged_decode_attention(q, *t[1:])     # serving: no recording
    # the int8 leg is ported (tests/test_torch_quant.py): it takes both
    # scale pools, and over int8 cells with unit scales it is the f32 leg
    with pytest.raises(ValueError):
        tops.paged_decode_attention(*t, k_scale=torch.ones(12, 8, 4))
    k8, v8 = ((x * 40).round().clamp(-127, 127).to(torch.int8)
              for x in t[1:3])
    ones = torch.ones(12, 8, 4)
    torch.testing.assert_close(
        tops.paged_decode_attention(t[0], k8, v8, *t[3:], k_scale=ones,
                                    v_scale=ones),
        tops.paged_decode_attention(t[0], k8.float(), v8.float(), *t[3:]),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.paged_decode_attention(*t, backend="pallas")
    with pytest.raises(ValueError):          # a pool of the wrong width
        tpa.paged_decode_attention(t[0], t[1][..., :8], t[2][..., :8],
                                   *t[3:])


@pytest.mark.parametrize("b,c,h,kv,p_tab,page,want", [
    (8, 32, 32, 32, 34, 16, ("mma", 3)),    # the engine's step: 32 rows
    (8, 1, 32, 32, 34, 16, ("mma", 3)),     # pure decode: one row
    (8, 32, 32, 16, 34, 16, ("wgmma", 2)),  # G = 2: 64 rows, 128 blocks
    (8, 32, 64, 8, 34, 16, ("wgmma", 1)),   # G = 8: 256 rows, 64 blocks
    (64, 1, 32, 32, 34, 16, ("mma", 0)),    # 2048 blocks fill the card
    (8, 1, 32, 32, 4, 16, ("mma", 0)),      # a one-tile table: no split
])
def test_paged_path_picks_the_product_and_the_split(b, c, h, kv, p_tab,
                                                    page, want):
    """#8 on 132 SMs: ``mma.sync`` below 64 rows a (slot, kv head) block,
    ``wgmma`` from 64; windows split into chunks of ``split`` 64-cell
    tiles (about four blocks an SM) only where B·KV blocks leave the card
    with fewer than two an SM."""
    assert tpa.paged_path(b, c, h, kv, p_tab, page, sms=132) == want
