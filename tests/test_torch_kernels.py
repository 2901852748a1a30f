"""The port's plain kernel versions against the JAX package's kernels.

Each of the four kernels of the dense serving path is held, on the same
inputs (made with numpy from a seed), against both the JAX Pallas kernel
in interpret mode and the JAX reference, through the public shape
contract (``ops.py``) of each package. On the CPU the port's kernel
wrappers run their plain versions; the CUDA kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 — the same algorithm, f32 sums in another order.
bf16 linears: rtol 8e-3, one bf16 ulp of the output, because f32 sums in
another order can round to the neighbouring bf16 value. bf16 attention:
2e-2, the JAX package's own bf16 flash tolerance (tests/test_kernels.py):
the Pallas kernel rounds unnormalised probabilities to bf16 before P·V,
the plain version the normalised softmax.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tt_linear as ttl

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dt, scale=1.0):
    """The same values as a JAX array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    a = a.astype(DTYPES[dt][0])
    if dt == "bf16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


LIN_TOL = {"f32": 1e-5, "bf16": 8e-3}
ATT_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("m,k,n,r", [(33, 70, 45, 4), (5, 129, 200, 8),
                                     (9, 72, 40, 1024)])   # VeRA's rank
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tt_linear_plain_matches_pallas_and_ref(m, k, n, r, dt):
    rng = np.random.default_rng(m * 1000 + k)
    jx, tx = _pair(rng, (m, k), dt)
    jw, tw = _pair(rng, (k, n), dt, k ** -0.5)
    ja, ta = _pair(rng, (k, r), dt, k ** -0.5)
    jb, tb = _pair(rng, (r, n), dt, r ** -0.5)
    got = tops.tt_linear(tx, tw, ta, tb, alpha=4.0)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    _close(got, jops.tt_linear(jx, jw, ja, jb, alpha=4.0, backend="pallas",
                               interpret=True), LIN_TOL[dt])
    _close(got, jops.tt_linear(jx, jw, ja, jb, alpha=4.0, backend="ref"),
           LIN_TOL[dt])
    # the wrapper's CPU leg is exactly the plain version
    assert torch.equal(ttl.tt_linear(tx, tw, ta, tb, 4.0),
                       ttl.tt_linear_plain(tx, tw, ta, tb, 4.0))


def test_tt_linear_flattens_leading_dims():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (3, 5, 40), "f32")
    jw, tw = _pair(rng, (40, 24), "f32")
    ja, ta = _pair(rng, (40, 4), "f32")
    jb, tb = _pair(rng, (4, 24), "f32")
    got = tops.tt_linear(tx, tw, ta, tb, alpha=1.3)
    assert got.shape == (3, 5, 24)
    _close(got, jops.tt_linear(jx, jw, ja, jb, alpha=1.3, backend="ref"),
           1e-5)


@pytest.mark.parametrize("s,k,n,r,slot_axis", [(3, 70, 45, 4, False),
                                               (4, 96, 130, 8, True)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batched_a_plain_matches_pallas_and_ref(s, k, n, r, slot_axis, dt):
    rng = np.random.default_rng(s * 100 + n)
    shape = (s, 1, k) if slot_axis else (s, k)
    jx, tx = _pair(rng, shape, dt)
    jw, tw = _pair(rng, (k, n), dt, k ** -0.5)
    ja, ta = _pair(rng, (s, k, r), dt, k ** -0.5)
    jb, tb = _pair(rng, (r, n), dt, r ** -0.5)
    got = tops.tt_linear_batched_a(tx, tw, ta, tb, alpha=4.0)
    assert got.shape == shape[:-1] + (n,)
    _close(got, jops.tt_linear_batched_a(jx, jw, ja, jb, alpha=4.0,
                                         backend="pallas", interpret=True),
           LIN_TOL[dt])
    _close(got, jops.tt_linear_batched_a(jx, jw, ja, jb, alpha=4.0,
                                         backend="ref"), LIN_TOL[dt])


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", [
    (2, 37, 37, 4, 2, 16, True),      # odd T == S, causal, GQA G = 2
    (2, 20, 45, 4, 2, 32, False),     # S != T, non-causal
    (1, 19, 30, 2, 2, 64, True),      # S != T, causal
    (1, 21, 21, 2, 2, 256, True),     # head_dim 256 (gemma-7b), causal
    (1, 9, 40, 2, 1, 256, False),     # head_dim 256, S != T, GQA G = 2
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_plain_matches_pallas_and_ref(b, t, s, h, kv, d,
                                                      causal, dt):
    rng = np.random.default_rng(t * 10 + s)
    jq, tq = _pair(rng, (b, t, h, d), dt)
    jk, tk = _pair(rng, (b, s, kv, d), dt)
    jv, tv = _pair(rng, (b, s, kv, d), dt)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, t, h, d) and got.dtype == tq.dtype
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     backend="pallas", interpret=True),
           ATT_TOL[dt])
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     backend="ref"), ATT_TOL[dt])
    assert torch.equal(tfa.flash_attention(tq, tk, tv, causal),
                       tfa.flash_attention_plain(tq, tk, tv, causal))


@pytest.mark.parametrize("b,s,h,kv,d", [(4, 40, 8, 4, 16),
                                         (4, 40, 2, 2, 256),
                                         (4, 40, 24, 2, 16),    # G = 12
                                         (4, 40, 48, 1, 16)])   # G = 48
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain_matches_pallas_and_ref(b, s, h, kv, d, dt):
    rng = np.random.default_rng(b * 10 + s)
    jq, tq = _pair(rng, (b, 1, h, d), dt)
    jk, tk = _pair(rng, (b, s, kv, d), dt)
    jv, tv = _pair(rng, (b, s, kv, d), dt)
    pos = np.array([0, s - 1, 7, 20][:b], np.int32)     # includes pos 0
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.shape == (b, 1, h, d)
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                      backend="pallas", interpret=True),
           ATT_TOL[dt])
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                      backend="ref"), ATT_TOL[dt])
    # row 0 (pos 0) sees only cell 0: its output is v[0] for every head
    g = h // kv
    want0 = tv[0, 0].repeat_interleave(g, dim=0)
    np.testing.assert_allclose(_np(got[0, 0]), _np(want0), rtol=1e-6,
                               atol=1e-6)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """Shape checks run before any device work, so they hold on the CPU."""
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        ttl.tt_linear(x, torch.zeros(15, 8), torch.zeros(16, 4),
                      torch.zeros(4, 8))
    with pytest.raises(ValueError):
        ttl.tt_linear_batched_a(x, torch.zeros(16, 8),
                                torch.zeros(3, 16, 4), torch.zeros(4, 8))
    with pytest.raises(ValueError):
        tfa.decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 8, 3, 16),
                             torch.zeros(2, 8, 3, 16),
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.tt_linear(x, torch.zeros(16, 8), torch.zeros(16, 4),
                       torch.zeros(4, 8), backend="pallas")
