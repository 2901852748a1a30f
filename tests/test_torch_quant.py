"""The port's int8 quantization and its three w8 / int8 kernels' plain
versions against the JAX package.

* ``kernels/quant.py``: ``quantize_int8``, ``quantize_kv`` and
  ``quantize_base`` of both packages on the same f32 / bf16 arrays (made
  with numpy from a seed) give BIT-identical int8 values and scales.
* #9 ``tt_linear_w8`` and #10 ``tt_linear_batched_a_w8`` (their plain
  versions: on the CPU the kernel wrappers run them) against the JAX
  Pallas kernels in interpret mode and the JAX reference, on the same int8
  numbers, at the shapes of tests/test_quant.py (odd shapes, grouped
  scales, the (S, 1, K) decode layout, a zero adapter). f32, 1e-4 — the
  JAX package's own w8 tolerance; and at 1e-5 of the largest value on
  RoBERTa-like f32 shapes, per channel and in groups of 128 rows, as the
  f32 instances of #9 / #10 serve RoBERTa over int8 weights on the card.
* #8q, the int8 leg of paged attention, against the JAX Pallas kernel in
  interpret mode and the JAX reference at tests/test_quant.py's shapes
  (sentinel tables, GQA, C in {1, 4}): f32 2e-5; bf16 q 2e-2 (one bf16
  rounding of the output from f32 sums in another order, as #8's bf16
  tolerance). int8 attention tracks fp attention within 0.1.
* The raw wrappers refuse an input that requires grad; the config
  validation raises where the JAX package's does.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import KernelConfig as JKernelConfig
from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import ServeConfig as JServeConfig
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import transformer as JT

from repro_torch.config.base import KernelConfig, QuantConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import tt_linear as ttl

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dt="f32", scale=1.0):
    """The same values as a JAX array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    a = a.astype(DTYPES[dt][0])
    if dt == "bf16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _t(x) -> torch.Tensor:
    """A JAX array (int8, f32) as a torch tensor with the same bits."""
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _same_bits(t, j):
    j = np.asarray(j)
    assert t.dtype == {np.dtype("int8"): torch.int8,
                       np.dtype("float32"): torch.float32}[j.dtype]
    assert tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                  j.view(np.uint8))


# ---------------------------------------------------------------------------
# quantization: bit-identical to the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_int8_bit_identical_to_jax(dt, group):
    rng = np.random.default_rng(3)
    # (nb, K, N) as quantize_base sees it; a spread of magnitudes, an odd
    # N and one all-zero column
    jw, tw = _pair(rng, (2, 256, 131), dt, scale=2.5)
    jw, tw = jw.at[:, :, 7].set(0), tw.clone()
    tw[:, :, 7] = 0
    jq, js = jquant.quantize_int8(jw, group_size=group)
    tq, ts = tquant.quantize_int8(tw, group_size=group)
    _same_bits(tq, jq)
    _same_bits(ts, js)
    assert ts.shape == (2, 1 if group == 0 else 2, 131)
    _same_bits(tquant.dequantize_int8(tq, ts),
               jquant.dequantize_int8(jq, js))
    # symmetric rounding: at most half a scale step per element, plus the
    # f32 rounding of q·scale (2^-22 of |w|)
    g = ts.shape[1]
    bound = (ts.repeat_interleave(256 // g, dim=1) * 0.5
             + 2.0 ** -22 * tw.float().abs())
    assert bool(((tquant.dequantize_int8(tq, ts) - tw.float()).abs()
                 <= bound).all())
    # the zero column comes back as exact zeros
    assert not tquant.dequantize(tquant.quantize_linear(tw, group)
                                 )[:, :, 7].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_bit_identical_to_jax(dt):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (6, 8, 4, 64), dt, scale=3.0)
    jq, js = jquant.quantize_kv(jx)
    tq, ts = tquant.quantize_kv(tx)
    _same_bits(tq, jq)
    _same_bits(ts, js)


def test_quantize_kv_zero_rows_roundtrip_to_zero():
    q, s = tquant.quantize_kv(torch.zeros((3, 4, 8)))
    assert not q.any() and bool((s > 0).all())
    assert not (q.float() * s[..., None]).any()


def test_quantize_rejects_indivisible_group():
    with pytest.raises(ValueError):
        tquant.quantize_int8(torch.ones((100, 8)), group_size=64)


@pytest.mark.parametrize("group", [0, 128, 1024])
def test_quantize_base_bit_identical_and_hot_leaves_only(group):
    """The smoke stablelm-1.6b base made by the JAX package: the port's
    ``quantize_base`` of the carried-over base equals the JAX package's
    packed base carried over (int8 q8, f32 scale), leaf for leaf. Only the
    seven matmul leaves are packed; a group that does not divide K falls
    back to per channel; the input tree is not mutated."""
    jcfg = jconfigs.get_smoke_config("stablelm-1.6b")
    jbase = JT.init_base_params(jcfg, jax.random.PRNGKey(0))
    tbase = from_jax_numpy(jax.device_get(jbase), device="cpu")
    want = from_jax_numpy(jax.device_get(
        jquant.quantize_base(jbase, group_size=group)), device="cpu")
    got = tquant.quantize_base(tbase, group_size=group)
    for blk_g, blk_w, blk_in in zip(got["blocks"], want["blocks"],
                                    tbase["blocks"]):
        for part in ("mixer", "ffn"):
            for key, leaf in blk_g[part].items():
                assert tquant.is_quantized(leaf) == (key in (
                    "wq", "wk", "wv", "wo", "wu", "wd", "wg"))
                if not tquant.is_quantized(leaf):
                    continue
                w = blk_w[part][key]
                _same_bits(leaf["q8"], w["q8"].numpy())
                _same_bits(leaf["scale"], w["scale"].numpy())
                k = leaf["q8"].shape[-2]
                assert leaf["scale"].shape[-2] == (
                    k // group if group and k % group == 0 else 1)
                assert not tquant.is_quantized(blk_in[part][key])
        assert blk_g["norm1"] is blk_in["norm1"]
    assert got["embed"] is tbase["embed"]
    assert got["final_norm"] is tbase["final_norm"]


# ---------------------------------------------------------------------------
# #9 / #10: the w8a16 linears
# ---------------------------------------------------------------------------


def _w8_operands(seed, m, k, n, r, group, batched=False):
    """x, int8 W + scales (quantized by the JAX package), a, b — as JAX
    arrays and as torch tensors with the same bits."""
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng, (m, k))
    jw, _ = _pair(rng, (k, n), scale=k ** -0.5)
    ja, ta = _pair(rng, (m, k, r) if batched else (k, r), scale=k ** -0.5)
    jb, tb = _pair(rng, (r, n), scale=r ** -0.5)
    jq, js = jquant.quantize_int8(jw, group_size=group)
    return (jx, jq, js, ja, jb), (tx, _t(jq), _t(js), ta, tb), jw


@pytest.mark.parametrize("m,k,n,r,group", [
    (128, 256, 256, 8, 0),
    (12, 200, 391, 9, 0),       # odd everything
    (8, 256, 384, 16, 128),     # grouped: one scale row per 128 K rows
    (3, 384, 130, 5, 128),      # grouped, odd M / N / r
    (16, 256, 128, 65, 0),      # rank 65: past the card's `wgmma` path
    (64, 256, 128, 65, 128),    # ... grouped
])
def test_w8_plain_matches_pallas_and_ref(m, k, n, r, group):
    j, t, jw = _w8_operands(m + k, m, k, n, r, group)
    got = tops.tt_linear_q(*t, alpha=1.3)            # the wrapper (CPU)
    torch.testing.assert_close(got, tops.tt_linear_q(*t, alpha=1.3,
                                                     backend="ref"),
                               rtol=0, atol=0)
    for want in (jops.tt_linear_q(*j, alpha=1.3, backend="pallas",
                                  interpret=True),
                 jref.tt_linear_q_ref(*j, alpha=1.3)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
    # the quantized result tracks the fp one at int8 resolution
    fp = jref.tt_linear_ref(j[0], jw, j[3], j[4], alpha=1.3)
    assert float(np.abs(_np(got) - _np(fp)).max()) < 0.1


@pytest.mark.parametrize("group", [0, 128])
def test_w8_batched_a_plain_matches_pallas_and_ref(group):
    s, k, n, r = 5, 256, 130, 6
    j, t, _ = _w8_operands(group + 1, s, k, n, r, group, batched=True)
    got = tops.tt_linear_batched_a_q(*t, alpha=0.7)
    for want in (jops.tt_linear_batched_a_q(*j, alpha=0.7, backend="pallas",
                                            interpret=True),
                 jref.tt_linear_batched_a_q_ref(*j, alpha=0.7)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
    # the decode layout (S, 1, K) round-trips
    got3 = tops.tt_linear_batched_a_q(t[0][:, None], *t[1:], alpha=0.7)
    assert got3.shape == (s, 1, n)
    torch.testing.assert_close(got3[:, 0], got, rtol=0, atol=0)


@pytest.mark.parametrize("group", [0, 128])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["w8", "batched_a_w8"])
def test_w8_f32_plain_matches_pallas_and_ref_at_1e5(batched, group):
    """#9 / #10 in f32 (RoBERTa served over int8 weights): the plain
    versions, which the f32 CUDA instances are held to on the card, within
    1e-5 of the largest value of the Pallas kernels (interpret mode) and
    of the JAX refs, per channel and per group of 128 rows."""
    m = 4 if batched else 24
    j, t, _ = _w8_operands(17 + group + m, m, 256, 384, 8, group,
                           batched=batched)
    if batched:
        fn, jfn = tops.tt_linear_batched_a_q, jops.tt_linear_batched_a_q
        jr = jref.tt_linear_batched_a_q_ref
    else:
        fn, jfn, jr = tops.tt_linear_q, jops.tt_linear_q, jref.tt_linear_q_ref
    got = fn(*t, alpha=2.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 384)
    for want in (jfn(*j, alpha=2.0, backend="pallas", interpret=True),
                 jr(*j, alpha=2.0)):
        w = _np(want)
        assert np.abs(_np(got) - w).max() <= 1e-5 * np.abs(w).max()


def test_w8_zero_adapter_equals_quantized_base_matmul():
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng, (128, 256))
    jw, _ = _pair(rng, (256, 128), scale=1 / 16)
    jq, js = jquant.quantize_int8(jw)
    jb, tb = _pair(rng, (16, 128))
    got = tops.tt_linear_q(tx, _t(jq), _t(js), torch.zeros((256, 16)), tb,
                           alpha=4.0)
    want = jx @ jquant.dequantize_int8(jq, js)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


@pytest.mark.parametrize("group", [0, 128])
def test_dispatch_w8_batched_a_chunk_block_matches_jax(group):
    """The paged step's (B, C > 1, K) adapted q/v over an int8 base: W
    dequantized to x's dtype and the batched einsum, in both packages."""
    b_, c, k, n, r = 3, 4, 256, 96, 4
    rng = np.random.default_rng(group + 7)
    jx, tx = _pair(rng, (b_, c, k))
    jw, _ = _pair(rng, (k, n), scale=k ** -0.5)
    ja, ta = _pair(rng, (b_, k, r), scale=k ** -0.5)
    jb, tb = _pair(rng, (r, n), scale=r ** -0.5)
    jq, js = jquant.quantize_int8(jw, group_size=group)
    jw8, tw8 = {"q8": jq, "scale": js}, {"q8": _t(jq), "scale": _t(js)}
    got = tdispatch.tt_linear_batched_a_q(tx, tw8, ta, tb, alpha=2.0)
    for pol in (None, jdispatch.PALLAS_INTERPRET):
        want = jdispatch.tt_linear_batched_a_q(jx, jw8, ja, jb, alpha=2.0,
                                               policy=pol)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# #8q: the int8 leg of paged attention
# ---------------------------------------------------------------------------


def _engine_tables(n, p_tab):
    """tests/test_quant.py's tables: sentinel everywhere but a ragged
    prefix of each row."""
    tables = np.full((3, p_tab), n, np.int32)
    tables[0, :3] = [2, 7, 1]
    tables[1, :2] = [4, 9]
    tables[2, :1] = [11]
    return tables


@pytest.mark.parametrize("c,heads", [(1, (4, 4)), (4, (4, 2))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_paged_attention_plain_matches_pallas_and_ref(c, heads, dt,
                                                           d=16):
    h, kv = heads
    b, n, page, p_tab = 3, 12, 8, 4
    rng = np.random.default_rng(c)
    jq, tq = _pair(rng, (b, c, h, d), dt)
    jk, tk = _pair(rng, (n, page, kv, d))
    jv, tv = _pair(rng, (n, page, kv, d))
    jk8, jks = jquant.quantize_kv(jk)
    jv8, jvs = jquant.quantize_kv(jv)
    tables = _engine_tables(n, p_tab)
    pos = np.array([17, 9, 3], np.int32)
    jt, tt_ = jnp.asarray(tables), torch.from_numpy(tables)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    tk8, tks, tv8, tvs = (_t(a) for a in (jk8, jks, jv8, jvs))
    got = tops.paged_decode_attention(tq, tk8, tv8, tt_, tp, k_scale=tks,
                                      v_scale=tvs)
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, c, h, d)
    torch.testing.assert_close(
        got, tpa.paged_decode_attention_int8_plain(tq, tk8, tv8, tks, tvs,
                                                   tt_, tp), rtol=0, atol=0)
    tol = 2e-5 if dt == "f32" else 2e-2
    for want in (jops.paged_decode_attention(jq, jk8, jv8, jt, jp,
                                             k_scale=jks, v_scale=jvs,
                                             backend="ref"),
                 jops.paged_decode_attention(jq, jk8, jv8, jt, jp,
                                             k_scale=jks, v_scale=jvs,
                                             backend="pallas",
                                             interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # int8 attention tracks fp attention at quantization resolution
    fp = tops.paged_decode_attention(tq.float(), tk, tv, tt_, tp)
    assert float((got.float() - fp).abs().max()) < 0.1


@pytest.mark.parametrize("c,heads", [(1, (2, 2)), (5, (4, 2))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_paged_attention_at_head_dim_256(c, heads, dt):
    """#8q at gemma-7b's heads of 256: the same checks as above."""
    test_int8_paged_attention_plain_matches_pallas_and_ref(c, heads, dt,
                                                           d=256)


@pytest.mark.parametrize("c,heads", [(1, (24, 2)), (5, (48, 1))])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_paged_attention_at_any_group(c, heads, dt):
    """#8q at GQA groups 12 (mistral-large's) and 48 (granite-34b's
    MQA): the same checks as above."""
    test_int8_paged_attention_plain_matches_pallas_and_ref(c, heads, dt)


def test_int8_paged_attention_needs_both_scale_pools():
    q = torch.zeros((1, 1, 2, 16))
    pool = torch.zeros((2, 8, 2, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        tops.paged_decode_attention(q, pool, pool, torch.zeros((1, 1)),
                                    torch.zeros((1,)),
                                    k_scale=torch.ones((2, 8, 2)))


# ---------------------------------------------------------------------------
# no autograd through the raw wrappers; config validation
# ---------------------------------------------------------------------------


def _raw_calls():
    rng = np.random.default_rng(0)
    _, t, _ = _w8_operands(1, 3, 128, 32, 4, 0)
    _, tb, _ = _w8_operands(2, 3, 128, 32, 4, 128, batched=True)
    k8, ks = tquant.quantize_kv(torch.from_numpy(
        rng.standard_normal((4, 8, 2, 16)).astype(np.float32)))
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 16)).astype(
        np.float32))
    tables = torch.tensor([[0, 1], [2, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    return {
        "tt_linear_w8": (ttl.tt_linear_w8, t),
        "tt_linear_batched_a_w8": (ttl.tt_linear_batched_a_w8, tb),
        "paged_decode_attention_int8": (
            tpa.paged_decode_attention_int8,
            (q, k8, k8.clone(), ks, ks.clone(), tables, pos)),
    }


@pytest.mark.parametrize("name", ["tt_linear_w8", "tt_linear_batched_a_w8",
                                  "paged_decode_attention_int8"])
def test_raw_wrapper_raises_on_an_input_that_requires_grad(name):
    """The int8 kernels are inference only (the JAX package defines no VJP
    for them): with recording off they run, with an input that requires
    grad while autograd records they refuse."""
    fn, args = _raw_calls()[name]
    fn(*args)
    grad = [t.clone().requires_grad_(t.is_floating_point()) for t in args]
    with torch.no_grad():
        fn(*grad)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*grad)


CONFIGS = [
    dict(quant=dict(weights="int4")),
    dict(quant=dict(kv="fp8")),
    dict(quant=dict(group_size=100)),
    dict(quant=dict(group_size=256)),
    dict(quant=dict(weights="int8", kv="int8", group_size=128)),
    dict(quant=dict(kv="int8")),
    dict(quant=dict(kv="int8"), cache_mode="dense"),
    dict(quant=dict(weights="int8"), cache_mode="dense"),
]


def _raises(make) -> bool:
    try:
        make()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("case", CONFIGS, ids=str)
def test_config_validation_matches_jax(case):
    q = case["quant"]
    extra = {k: v for k, v in case.items() if k != "quant"}
    checks = (
        (lambda: JQuantConfig(**q).validate(),
         lambda: QuantConfig(**q).validate()),
        (lambda: JKernelConfig(quant=JQuantConfig(**q)).validate(),
         lambda: KernelConfig(quant=QuantConfig(**q)).validate()),
        (lambda: JServeConfig(quant=JQuantConfig(**q), **extra).validate(),
         lambda: ServeConfig(quant=QuantConfig(**q), **extra).validate()),
    )
    for jmake, tmake in checks:
        assert _raises(tmake) == _raises(jmake)
