"""The adapted linears beyond one launch's rows, and through strided views.

- ``ops.tt_linear_batched_a`` / ``ops.tt_linear_batched_a_q`` (K2 / #10,
  the 4+1d decode linears) split M into calls of at most 64 rows on every
  device, since a CUDA launch takes at most 64; at M in {65, 72, 130} the
  split result is held against the JAX package's Pallas kernel (interpret
  mode) and reference, which grid over M with no cap.
- K1 (``tt_linear.tt_linear``) reads W, A and B through their strides on
  the card, so the training backward hands it transposed views with no
  copy; given views it equals the contiguous call, and
  ``_FusedTTLinear``'s gradients match the JAX ``_fused_tt_linear`` VJP
  at ranks 1, 10 and 100.

On the CPU the kernel wrappers run their plain versions; the CUDA kernels
are held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Tolerances: f32 1e-5 (the same algorithm, f32 sums in
another order); bf16 rtol 8e-3, one bf16 ulp of the output.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref

from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tt_linear as ttl

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
LIN_TOL = {"f32": 1e-5, "bf16": 8e-3}


def _pair(rng, shape, dt="f32", scale=1.0):
    """The same values as a JAX array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    a = a.astype(DTYPES[dt][0])
    if dt == "bf16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.fixture
def launches(monkeypatch):
    """Records the row count of every raw K2 / #10 wrapper call."""
    rows = {"tt_linear_batched_a": [], "tt_linear_batched_a_w8": []}
    for name, seen in rows.items():
        fn = getattr(ttl, name)

        def counted(x, *rest, _fn=fn, _seen=seen):
            _seen.append(x.shape[0])
            return _fn(x, *rest)
        monkeypatch.setattr(ttl, name, counted)
    return rows


def _chunks(m):
    return [min(64, m - i) for i in range(0, m, 64)]


@pytest.mark.parametrize("m", [65, 72, 130])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batched_a_splits_rows_and_matches_jax(m, dt, launches):
    k, n, r = 72, 40, 8
    rng = np.random.default_rng(m)
    jx, tx = _pair(rng, (m, 1, k), dt)
    jw, tw = _pair(rng, (k, n), dt, k ** -0.5)
    ja, ta = _pair(rng, (m, k, r), dt, k ** -0.5)
    jb, tb = _pair(rng, (r, n), dt, r ** -0.5)
    got = tops.tt_linear_batched_a(tx, tw, ta, tb, alpha=4.0)
    assert got.shape == (m, 1, n) and got.dtype == tx.dtype
    assert launches["tt_linear_batched_a"] == _chunks(m)
    _close(got, jops.tt_linear_batched_a(jx, jw, ja, jb, alpha=4.0,
                                         backend="pallas", interpret=True),
           LIN_TOL[dt])
    _close(got, jops.tt_linear_batched_a(jx, jw, ja, jb, alpha=4.0,
                                         backend="ref"), LIN_TOL[dt])
    # the plain leg takes all rows in one call
    _close(got, tops.tt_linear_batched_a(tx, tw, ta, tb, alpha=4.0,
                                         backend="ref"), LIN_TOL[dt])


@pytest.mark.parametrize("m", [65, 72, 130])
@pytest.mark.parametrize("group", [0, 128])
def test_w8_batched_a_splits_rows_and_matches_jax(m, group, launches):
    k, n, r = 256, 48, 6
    rng = np.random.default_rng(m + group)
    jx, tx = _pair(rng, (m, k))
    jw, _ = _pair(rng, (k, n), scale=k ** -0.5)
    ja, ta = _pair(rng, (m, k, r), scale=k ** -0.5)
    jb, tb = _pair(rng, (r, n), scale=r ** -0.5)
    jq, js = jquant.quantize_int8(jw, group_size=group)
    got = tops.tt_linear_batched_a_q(tx, _to_torch(jq), _to_torch(js), ta,
                                     tb, alpha=0.7)
    assert got.shape == (m, n)
    assert launches["tt_linear_batched_a_w8"] == _chunks(m)
    for want in (jops.tt_linear_batched_a_q(jx, jq, js, ja, jb, alpha=0.7,
                                            backend="pallas",
                                            interpret=True),
                 jref.tt_linear_batched_a_q_ref(jx, jq, js, ja, jb,
                                                alpha=0.7)):
        _close(got, want, LIN_TOL["f32"])


def test_batched_a_up_to_64_rows_is_one_call(launches):
    x, w = torch.randn(64, 32), torch.randn(32, 16)
    a, b = torch.randn(64, 32, 4), torch.randn(4, 16)
    tops.tt_linear_batched_a(x, w, a, b)
    assert launches["tt_linear_batched_a"] == [64]


@pytest.mark.parametrize("r", [1, 10, 100])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tt_linear_reads_transposed_views(r, dt):
    """W, A and B handed over as transposed views (the backward's dx call)
    give the contiguous call's result."""
    rng = np.random.default_rng(r)
    m, k, n = 33, 72, 45
    _, x = _pair(rng, (m, k), dt)
    _, w = _pair(rng, (k, n), dt, k ** -0.5)
    _, a = _pair(rng, (k, r), dt, k ** -0.5)
    _, b = _pair(rng, (r, n), dt, r ** -0.5)
    wt, at, bt = (t.T.contiguous() for t in (w, a, b))
    views = (wt.T, at.T, bt.T)
    assert not views[0].is_contiguous()
    got = ttl.tt_linear(x, *views, 4.0)
    torch.testing.assert_close(got, ttl.tt_linear(x, w, a, b, 4.0), rtol=0,
                               atol=0)


def test_k1_variant_names_the_kernel_by_rank():
    assert ttl.k1_variant(8) == "wgmma"
    assert ttl.k1_variant(ttl.RANK_WGMMA) == "wgmma"
    assert ttl.k1_variant(ttl.RANK_WGMMA + 1) == "pre_pass"
    assert ttl.k1_variant(1024) == "pre_pass"
    assert ttl.k1_variant(2048) == "pre_pass"


@pytest.mark.parametrize("m,k,n,want", [
    (16, 2048, 2048, 8), (64, 2048, 2048, 8),    # 32 output tiles
    (128, 2048, 2048, 4), (256, 2048, 2048, 2),  # 64 and 128 tiles
    (1024, 2048, 2048, 1),                       # 512 tiles: no split
    (64, 256, 2048, 2),                          # 4 K tiles: 2 a slice
    (64, 64, 48, 1),                             # one K tile
    (1, 8192, 64, 8),                            # at most 8: one cluster
])
def test_w8_splits_fill_the_card_with_whole_slices(m, k, n, want):
    """#9's slices of K on 132 SMs: the fewest (a power of two) that put
    a block on every SM, each slice at least two 64-row K tiles, at most
    eight (the slices of a tile are one thread-block cluster)."""
    assert ttl.w8_splits(m, k=k, n=n, sms=132) == want


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("r", [1, 10, 100])
def test_fused_tt_linear_grads_match_jax_vjp_at_rank(r):
    """dx = g·Wᵀ + α·(g·Bᵀ)·Aᵀ goes through K1 on transposed views; every
    gradient against jax.vjp of the JAX ``_fused_tt_linear`` (f32)."""
    rng = np.random.default_rng(r + 7)
    m, k, n = 12, 40, 24
    (jx, tx), (jw, tw) = _pair(rng, (m, k)), _pair(rng, (k, n),
                                                   scale=k ** -0.5)
    (ja, ta), (jb, tb) = _pair(rng, (k, r), scale=0.3), _pair(rng, (r, n))
    cot = rng.standard_normal((m, n)).astype(np.float32)
    jout, vjp = jax.vjp(
        lambda x, w, a, b: jdispatch.tt_linear(
            x, w, a, b, alpha=4.0, policy=jdispatch.PALLAS_INTERPRET),
        jx, jw, ja, jb)
    jgrads = vjp(jnp.asarray(cot))
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, ta, tb)]
    tout = tdispatch.tt_linear(*leaves, alpha=4.0)
    assert _rel(tout, jout) <= 1e-5
    tout.backward(torch.from_numpy(cot))
    for i, (t, jg) in enumerate(zip(leaves, jgrads)):
        assert _rel(t.grad, jg) <= 1e-5, (i, _rel(t.grad, jg))
