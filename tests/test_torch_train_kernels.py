"""The training path's kernels: the plain flash forward-with-stats and
backward, and the three ``autograd.Function``s of ``kernels/dispatch.py``,
against the JAX package.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
and the JAX references on one side, and through the port (whose wrappers
run their plain versions on the CPU) on the other. The CUDA kernels
themselves are held against those plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances: f32 1e-5 (the same algorithm, f32 sums in another order);
bf16 2e-2 of the largest magnitude (the JAX package's bf16 flash
tolerance: p and ds are rounded to bf16 at the same points on both sides,
but the two forwards' outputs differ by a bf16 ulp, and the port sums
each GQA group in f32 before rounding where JAX rounds each head first).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops

from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tt_linear as ttl

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}
PALLAS = jdispatch.PALLAS_INTERPRET


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


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1.0))


# the odd GQA shapes of tests/test_grads.py: T=70 queries, S=91 keys,
# 4 query heads over 2 KV heads, head_dim 32
Q_SHAPE, KV_SHAPE = (2, 70, 4, 32), (2, 91, 2, 32)


# a tile edge of the CUDA backward: 129 = one row past its 128-row blocks
# and two past its 64-row tiles; 8 query heads on one KV head (group 8)
EDGE_Q_SHAPE, EDGE_KV_SHAPE = (1, 129, 8, 64), (1, 129, 1, 64)
# head_dim 256 (gemma-7b): the d = 256 backward takes keys in tiles of 32
# (dq) and queries in tiles of 64 (dk / dv); 33 rows is one past a key
# tile. GQA group 1, and 2 with T != S
D256_SHAPES = ((1, 33, 2, 256), (1, 33, 2, 256))
D256_GQA_SHAPES = ((1, 33, 4, 256), (1, 70, 2, 256))
# GQA groups outside {1, 2, 4, 8}: mistral-large's 12 (24 query heads over
# 2, T = 70 against S = 91) and granite-34b's MQA 48 (over one KV head)
G12_SHAPES = ((1, 70, 24, 32), (1, 91, 2, 32))
G48_SHAPES = ((1, 33, 48, 32), (1, 33, 1, 32))


def _qkvg(dt, seed=0, shapes=(Q_SHAPE, KV_SHAPE)):
    rng = np.random.default_rng(seed)
    qs, kvs = shapes
    return (_pair(rng, qs, dt), _pair(rng, kvs, dt), _pair(rng, kvs, dt),
            _pair(rng, qs, dt))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_fwd_plain_matches_jax(dt, causal):
    (jq, tq), (jk, tk), (jv, tv), _ = _qkvg(dt)
    out, lse = tops.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 4, 70)
    for backend in ("pallas", "ref"):
        kw = {"interpret": True} if backend == "pallas" else {}
        jo, jl = jops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          backend=backend, **kw)
        assert _rel(out, jo) <= TOL[dt], backend
        assert _rel(lse, jl) <= 1e-5, backend
    # the raw wrapper's CPU leg is the plain version
    o2, l2 = tfa.flash_attention_fwd(tq, tk, tv, causal)
    assert torch.equal(o2, out) and torch.equal(l2, lse)


@pytest.mark.parametrize("dt,causal,shapes", [
    pytest.param(dt, causal, shapes, id=f"{dt}-{causal}{tag}")
    for tag, shapes in (("", (Q_SHAPE, KV_SHAPE)),
                        ("-tile_edge", (EDGE_Q_SHAPE, EDGE_KV_SHAPE)),
                        ("-d256", D256_SHAPES),
                        ("-d256_gqa2", D256_GQA_SHAPES),
                        ("-g12", G12_SHAPES), ("-g48", G48_SHAPES))
    for dt in ("f32", "bf16") for causal in (True, False)])
def test_flash_bwd_plain_matches_jax(dt, causal, shapes):
    """The same residuals (JAX's o and lse) into both backwards. The plain
    version is what the card holds the CUDA kernels to, so it is held to
    the Pallas kernel here at a tile edge of those kernels too, and at
    groups of 12 and 48 (the JAX backward sums each group with
    ``_group_sum_kv``)."""
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _qkvg(dt, seed=1, shapes=shapes)
    jo, jl = jops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                      backend="pallas", interpret=True)
    to, tl = _to_torch(jo), _to_torch(jl)
    got = tops.flash_attention_bwd(tq, tk, tv, to, tl, tg, causal=causal)
    for t, ref in zip(got, (tq, tk, tv)):
        assert t.dtype == ref.dtype and t.shape == ref.shape
    for backend in ("pallas", "ref"):
        kw = {"interpret": True} if backend == "pallas" else {}
        want = jops.flash_attention_bwd(jq, jk, jv, jo, jl, jg,
                                        causal=causal, backend=backend, **kw)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert _rel(x, y) <= TOL[dt], (backend, name, _rel(x, y))


def _vjp_check(jfn, tfn, jargs, targs, cot_shape, seed):
    """jax.vjp of ``jfn`` and torch autograd of ``tfn`` with one numpy
    cotangent; every input's gradient within 1e-5 (f32)."""
    cot = np.random.default_rng(seed).standard_normal(cot_shape).astype(
        np.float32)
    jout, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(cot))
    leaves = [t.clone().requires_grad_(True) for t in targs]
    tout = tfn(*leaves)
    assert _rel(tout, jout) <= 1e-5
    tout.backward(torch.from_numpy(cot))
    for i, (t, jg) in enumerate(zip(leaves, jgrads)):
        assert t.grad is not None, i
        assert _rel(t.grad, jg) <= 1e-5, (i, _rel(t.grad, jg))


def test_fused_tt_linear_grads_match_jax_vjp():
    rng = np.random.default_rng(2)
    (jx, tx), (jw, tw) = _pair(rng, (3, 5, 40)), _pair(rng, (40, 24), "f32",
                                                       40 ** -0.5)
    (ja, ta), (jb, tb) = _pair(rng, (40, 4), "f32", 0.3), _pair(rng, (4, 24))
    _vjp_check(
        lambda x, w, a, b: jdispatch.tt_linear(x, w, a, b, alpha=4.0,
                                               policy=PALLAS),
        lambda x, w, a, b: tdispatch.tt_linear(x, w, a, b, alpha=4.0),
        (jx, jw, ja, jb), (tx, tw, ta, tb), (3, 5, 24), 3)


@pytest.mark.parametrize("squeeze", [True, False])
def test_fused_tt_linear_batched_a_grads_match_jax_vjp(squeeze):
    rng = np.random.default_rng(4)
    xs = (5, 1, 40) if squeeze else (5, 40)
    (jx, tx), (jw, tw) = _pair(rng, xs), _pair(rng, (40, 24), "f32",
                                               40 ** -0.5)
    (ja, ta), (jb, tb) = _pair(rng, (5, 40, 4), "f32", 0.3), \
        _pair(rng, (4, 24))
    _vjp_check(
        lambda x, w, a, b: jdispatch.tt_linear_batched_a(
            x, w, a, b, alpha=2.0, policy=PALLAS),
        lambda x, w, a, b: tdispatch.tt_linear_batched_a(x, w, a, b,
                                                         alpha=2.0),
        (jx, jw, ja, jb), (tx, tw, ta, tb), xs[:-1] + (24,), 5)


@pytest.mark.parametrize("causal", [True, False])
def test_fused_flash_grads_match_jax_vjp(causal):
    (jq, tq), (jk, tk), (jv, tv), _ = _qkvg("f32", seed=6)
    _vjp_check(
        lambda q, k, v: jdispatch.flash_attention(q, k, v, causal=causal,
                                                  policy=PALLAS),
        lambda q, k, v: tdispatch.flash_attention(q, k, v, causal=causal),
        (jq, jk, jv), (tq, tk, tv), Q_SHAPE, 7)


def test_fused_flash_ref_backend_grads_match_autograd_of_softmax():
    """``backend="ref"`` runs the same Function on the plain versions; its
    gradients equal plain autograd through the materialized softmax."""
    rng = np.random.default_rng(8)
    _, q = _pair(rng, (1, 33, 4, 16))
    _, k = _pair(rng, (1, 33, 1, 16))
    _, v = _pair(rng, (1, 33, 1, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tdispatch.flash_attention(*leaves, policy=tdispatch.REF)
    (out.sin().sum()).backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qh = ref[0].transpose(1, 2)
    kh = ref[1].repeat_interleave(4, 2).transpose(1, 2)
    vh = ref[2].repeat_interleave(4, 2).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * 16 ** -0.5
    s = s.masked_fill(~torch.ones(33, 33, dtype=torch.bool).tril(), -1e30)
    want = (s.softmax(-1) @ vh).transpose(1, 2)
    (want.sin().sum()).backward()
    assert _rel(out, want) <= 1e-5
    for a, b in zip(leaves, ref):
        assert _rel(a.grad, b.grad) <= 1e-5


def test_fused_flash_saves_nothing_of_size_t_by_s():
    """CPU analogue of the JAX package's flash-backward memory check: at
    T = S = 2048 the Function keeps q, k, v, out and lse for its backward
    and no tensor with T·S elements."""
    t, s = 2048, 2048
    rng = np.random.default_rng(9)
    _, q = _pair(rng, (1, t, 2, 16))
    _, k = _pair(rng, (1, s, 1, 16))
    _, v = _pair(rng, (1, s, 1, 16))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = tdispatch.flash_attention(*leaves, causal=True)
    assert saved and max(saved) < t * s, saved
    assert sorted(saved) == sorted([q.numel(), k.numel(), v.numel(),
                                    out.numel(), 2 * t])
    out.sum().backward()
    assert all(x.grad is not None for x in leaves)


def _raw_calls():
    gen = torch.Generator().manual_seed(10)

    def rn(*shape):
        return torch.randn(*shape, generator=gen)

    x, w = rn(4, 16), rn(16, 8)
    a, b, a3 = rn(16, 2), rn(2, 8), rn(4, 16, 2)
    q, k = rn(1, 5, 2, 16), rn(1, 5, 1, 16)
    lse = torch.zeros(1, 2, 5)
    qd, pos = rn(1, 2, 16), torch.tensor([3])
    return {
        "tt_linear": (ttl.tt_linear, (x, w, a, b)),
        "tt_linear_batched_a": (ttl.tt_linear_batched_a, (x, w, a3, b)),
        "flash_attention": (tfa.flash_attention, (q, k, k)),
        "flash_attention_fwd": (tfa.flash_attention_fwd, (q, k, k)),
        "flash_attention_bwd": (tfa.flash_attention_bwd,
                                (q, k, k, q, lse, q)),
        "decode_attention": (tfa.decode_attention, (qd, k, k, pos)),
    }


@pytest.mark.parametrize("name", sorted(_raw_calls()))
def test_raw_wrapper_raises_on_an_input_that_requires_grad(name):
    """A raw kernel wrapper would cut the graph (its output has no
    grad_fn), so it refuses an input that requires grad while autograd
    records; with recording off, or inside a Function, it runs."""
    fn, args = _raw_calls()[name]
    fn(*args)
    with torch.no_grad():
        fn(*(t.clone().requires_grad_(t.is_floating_point()) for t in args))
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*(t.clone().requires_grad_(t.is_floating_point()) for t in args))
