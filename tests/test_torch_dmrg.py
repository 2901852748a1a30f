"""The port's TT algebra and DMRG sweep against the JAX package
(``src/repro/core/tt.py``, ``core/dmrg.py``) on the same numpy cores.

SVD factors are unique only up to a sign per singular vector, and the two
backends pick signs differently. So the tests compare what does not
depend on the signs — materialized tensors, ranks, spectra, truncation
errors, and the second moments (transported through squared transfer
coefficients) — and compare cores and first moments only after aligning
each bond's sign to the JAX cores. Tolerance 1e-5 (f32 SVDs of two
libraries).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dmrg as jdmrg
from repro.core import tt as jtt

from repro_torch.core import dmrg as tdmrg
from repro_torch.core import tt as ttt

TOL = 1e-5
MODES = (12, 3, 2, 10)


def _cores(seed, ranks=(5, 5, 5), modes=MODES, scale=0.5):
    rng = np.random.default_rng(seed)
    bonds = (1,) + tuple(ranks) + (1,)
    vals = [(rng.standard_normal((bonds[k], n, bonds[k + 1])) * scale)
            .astype(np.float32) for k, n in enumerate(modes)]
    return ([jnp.asarray(v) for v in vals],
            [torch.from_numpy(v.copy()) for v in vals])


def _close(got, want, tol=TOL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(
        float(np.abs(w).max()), 1e-12))


def _bond_signs(tcores, jcores):
    """Per-bond sign vectors that map the port's factors onto JAX's, left
    to right: core k is first flipped by bond k-1's signs, then bond k's
    signs are read off its correlation with the JAX core."""
    signs = []
    for tc, jc in zip(tcores[:-1], jcores[:-1]):
        c = tc.numpy()
        if signs:
            c = c * signs[-1][:, None, None]
        dot = (c * np.asarray(jc)).reshape(-1, c.shape[-1]).sum(0)
        signs.append(np.where(dot < 0, -1.0, 1.0).astype(np.float32))
    return signs


def _align(cores, signs):
    out = []
    for k, c in enumerate(cores):
        c = c.numpy()
        if k > 0:
            c = c * signs[k - 1][:, None, None]
        if k < len(cores) - 1:
            c = c * signs[k][None, None, :]
        out.append(torch.from_numpy(c))
    return out


def test_tt_basics_match_jax():
    jc, tc = _cores(0, ranks=(4, 6, 3))
    assert ttt.ranks(tc) == jtt.ranks(jc) == (4, 6, 3)
    assert ttt.mode_sizes(tc) == jtt.mode_sizes(jc) == MODES
    assert ttt.num_params(tc) == jtt.num_params(jc)
    _close(ttt.materialize(tc), jtt.materialize(jc))
    _close(ttt.tt_norm(tc), jtt.tt_norm(jc))
    _close(ttt.merge_pair(tc[1], tc[2]), jtt.merge_pair(jc[1], jc[2]))
    merged_j = jtt.merge_pair(jc[1], jc[2])
    merged_t = ttt.merge_pair(tc[1], tc[2])
    for r in (1, 3, 6):
        _close(ttt.truncation_error(merged_t, r),
               jtt.truncation_error(merged_j, r))


@pytest.mark.parametrize("kw", [{"rank": 3}, {"rank": 50},
                                {"rtol": 0.3}, {"rtol": 1e-3, "max_rank": 4}])
@pytest.mark.parametrize("left", [True, False])
def test_split_merged_matches_jax(kw, left):
    jc, tc = _cores(1, ranks=(6, 6, 6))
    mj, mt = jtt.merge_pair(jc[1], jc[2]), ttt.merge_pair(tc[1], tc[2])
    kw = dict(kw)
    rank = kw.pop("rank", None)
    ja, jb, js = jtt.split_merged(mj, rank, left_orthogonal=left, **kw)
    ta, tb, ts = ttt.split_merged(mt, rank, left_orthogonal=left, **kw)
    assert ta.shape == ja.shape and tb.shape == jb.shape
    _close(ts, js)
    _close(ttt.merge_pair(ta, tb), jtt.merge_pair(ja, jb))
    # singular vectors of the (numerically) zero singular values are
    # arbitrary: compare the factor columns of the nonzero ones
    live = int((ts > 1e-4 * ts[0]).sum())
    sign = _bond_signs([ta[..., :live], tb], [ja[..., :live], jb])[0]
    _close(ta[..., :live] * torch.from_numpy(sign), ja[..., :live])
    # the isometry: U's columns (left) or Vᵀ's rows (right) orthonormal
    iso = (ta.reshape(-1, ta.shape[-1]) if left
           else tb.reshape(tb.shape[0], -1).T)
    _close(iso.T @ iso, np.eye(ta.shape[-1], dtype=np.float32))


def test_left_canonicalize_matches_jax():
    jc, tc = _cores(2)
    tl, jl = ttt.left_canonicalize(tc), jtt.left_canonicalize(jc)
    _close(ttt.materialize(tl), jtt.materialize(jl))
    for c in tl[:-1]:
        m = c.reshape(-1, c.shape[-1])
        _close(m.T @ m, np.eye(c.shape[-1], dtype=np.float32))


@pytest.mark.parametrize("target,kw", [(3, {}), ((4, 2, 3), {}),
                                       (5, {"canonicalize": True}),
                                       (None, {"rtol": 0.25}),
                                       (None, {"rtol": 0.05, "max_rank": 4})])
def test_dmrg_sweep_matches_jax(target, kw):
    jc, tc = _cores(3, ranks=(6, 6, 6))
    jres = jdmrg.dmrg_sweep({"cores": jc}, target, **kw)
    tres = tdmrg.dmrg_sweep({"cores": tc}, target, **kw)
    assert tres.ranks == jres.ranks
    assert tres.moments is None
    _close(ttt.materialize(tres.params["cores"]),
           jtt.materialize(jres.params["cores"]))
    for s, js in zip(tres.spectra, jres.spectra):
        _close(s, js)
    # factors are less stable than what they represent when singular
    # values lie close: 1e-4
    signs = _bond_signs(tres.params["cores"], jres.params["cores"])
    for c, jc_ in zip(_align(tres.params["cores"], signs),
                      jres.params["cores"]):
        _close(c, jc_, 1e-4)
    _close(np.float32(tdmrg.reconstruction_error({"cores": tc},
                                                 tres.params)),
           np.float32(jdmrg.reconstruction_error({"cores": jc},
                                                 jres.params)))


@pytest.mark.parametrize("canonicalize", [False, True])
def test_dmrg_moment_transport_matches_jax(canonicalize):
    """nu is sign-free (squared transfer coefficients): compared
    directly; mu after each bond's sign is aligned to the JAX cores."""
    jc, tc = _cores(4, ranks=(6, 6, 6))
    (jmu, tmu), (jnu, tnu) = _cores(5, ranks=(6, 6, 6)), \
        _cores(6, ranks=(6, 6, 6))
    jnu = [x * x for x in jnu]
    tnu = [x * x for x in tnu]
    jres = jdmrg.dmrg_sweep({"cores": jc}, 4, canonicalize=canonicalize,
                            moments=({"cores": jmu}, {"cores": jnu}))
    tres = tdmrg.dmrg_sweep({"cores": tc}, 4, canonicalize=canonicalize,
                            moments=({"cores": tmu}, {"cores": tnu}))
    assert tres.ranks == jres.ranks == (4, 4, 4)
    (tm, tv), (jm, jv) = tres.moments, jres.moments
    for a, b in zip(tv["cores"], jv["cores"]):
        _close(a, b, 1e-4)
    signs = _bond_signs(tres.params["cores"], jres.params["cores"])
    for a, b in zip(_align(tm["cores"], signs), jm["cores"]):
        _close(a, b, 1e-4)


def test_rank_schedule_matches_jax():
    for args in ((10, 4, 1, 1, 2), (10, 8, 1, 1, 2), (6, 2, 2, 3, 1)):
        t, j = tdmrg.RankSchedule.linear(*args), \
            jdmrg.RankSchedule.linear(*args)
        assert t.milestones == j.milestones
        assert t.final_rank == j.final_rank
        for e in range(12):
            assert t.rank_after_epoch(e) == j.rank_after_epoch(e)
