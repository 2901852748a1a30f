"""The port's AdamW, schedules, clipping and warm-moment carry against the
JAX package (``src/repro/optim/adamw.py``), on the same numpy trees.

Tolerance 1e-6 relative: both compute every scalar (bias corrections,
learning rate) and every update in f32 in the same order; what differs is
the last ulp of a transcendental (cos, sqrt, pow) between the libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.optim import adamw as jadamw

from repro_torch.config.base import OptimizerConfig
from repro_torch.optim import adamw

TOL = 1e-6
SHAPES = [(1, 12, 4), (4, 3, 4), (4, 5, 1)]


def _tree(rng, scale=1.0):
    vals = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]
    return ({"cores": [jnp.asarray(v) for v in vals]},
            {"cores": [torch.from_numpy(v.copy()) for v in vals]})


def _close(got, want, tol=TOL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(
        float(np.abs(w).max()), 1e-12))


@pytest.mark.parametrize("clip,wd,sched", [(3.0, 0.0, "linear"),
                                           (0.0, 0.01, "cosine"),
                                           (0.5, 0.0, "constant")])
def test_update_matches_jax_over_steps(clip, wd, sched):
    kw = dict(lr=1e-2, grad_clip=clip, weight_decay=wd, schedule=sched,
              warmup_ratio=0.2)
    jcfg, cfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(0)
    jp, tp = _tree(rng)
    jst, tst = jadamw.init_state(jp), adamw.init_state(tp)
    jsch, tsch = jadamw.make_schedule(jcfg, 10), adamw.make_schedule(cfg, 10)
    for i in range(6):
        jg, tg = _tree(rng, scale=3.0 if i % 2 else 0.1)
        jp, jst, jn = jadamw.update(jg, jst, jp, jcfg, jsch(jst.step))
        tp, tst, tn = adamw.update(tg, tst, tp, cfg, tsch(tst.step))
        _close(tn, jn)
        assert tst.step == int(jst.step) == i + 1
    for a, b in zip(tp["cores"], jp["cores"]):
        _close(a, b)
    for a, b in zip(tst.mu["cores"] + tst.nu["cores"],
                    jst.mu["cores"] + jst.nu["cores"]):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("sched", ["linear", "cosine", "constant"])
def test_schedules_match_jax(sched):
    kw = dict(lr=3e-3, schedule=sched, warmup_ratio=0.06)
    for total in (1, 17, 200):
        jsch = jadamw.make_schedule(JOptimizerConfig(**kw), total)
        tsch = adamw.make_schedule(OptimizerConfig(**kw), total)
        for step in range(0, total + 3):
            got, want = tsch(step), jsch(jnp.int32(step))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= TOL * 3e-3, (total, step)


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(1)
    jg, tg = _tree(rng, scale=2.0)
    _close(adamw.global_norm(tg), jadamw.global_norm(jg))
    for max_norm in (0.5, 1e3):
        (tc, tn), (jc, jn) = (adamw.clip_by_global_norm(tg, max_norm),
                              jadamw.clip_by_global_norm(jg, max_norm))
        _close(tn, jn)
        for a, b in zip(tc["cores"], jc["cores"]):
            _close(a, b)
    assert float(adamw.global_norm(adamw.clip_by_global_norm(
        tg, 0.5)[0])) == pytest.approx(0.5, rel=1e-6)


def test_carry_state_matches_jax():
    rng = np.random.default_rng(2)
    jp, tp = _tree(rng)
    jmu, tmu = _tree(rng)
    jnu, tnu = _tree(rng)              # negative entries get clamped
    jst = jadamw.AdamWState(step=jnp.int32(7), mu=jmu, nu=jnu)
    tst = adamw.AdamWState(step=7, mu=tmu, nu=tnu)
    jout = jadamw.carry_state(jst, jmu, jnu)
    tout = adamw.carry_state(tst, tmu, tnu)
    assert tout.step == int(jout.step) == 7
    for a, b in zip(tout.mu["cores"] + tout.nu["cores"],
                    jout.mu["cores"] + jout.nu["cores"]):
        _close(a, b)
    assert min(float(v.min()) for v in tout.nu["cores"]) == 0.0
    fresh = adamw.reinit_state(tp)
    assert fresh.step == 0 and all(float(m.abs().max()) == 0
                                   for m in fresh.mu["cores"])
