"""The rest of the port's training slice against the JAX package:
``tt.slice_matrix``, ``metatt.apply``, ``dmrg.two_site_sweep``,
``distributed/compression.py``, ``train_step.make_full_ft_step`` and the
``Trainer`` with gradient compression, on the same seeded numpy arrays.

Tolerances: f32 1e-5 where the point is the algorithm (the TT algebra,
the sweep's cores after aligning each bond's SVD sign to the JAX cores,
the full fine-tuning loss and gradient norm); int8 codes, scales and the
top-k kept set bit for bit; the base after one AdamW step and ten
compressed Trainer steps 1e-4 (Adam divides each gradient by its own
running magnitude, which magnifies summation-order differences).

The two-site sweep's local gradient: JAX differentiates through an exact
SVD resplit, the port through an exact resplit without an SVD (the loss
depends on the pair only through their product). Where JAX's SVD
derivative is finite the two agree; on a merged pair of zeros (a
zero-initialised core) JAX's is NaN, so the zero-core cases hold the
port to ``jax.grad`` of the same local loss taken through the exact pair,
and to a JAX sweep with that gradient — shown equal to the JAX
``two_site_sweep`` wherever the latter is finite.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import TrainConfig as JTrainConfig
from repro.core import dmrg as jdmrg
from repro.core import metatt as jmetatt
from repro.core import tt as jtt
from repro.data import LMStream as JLMStream
from repro.distributed import compression as jcomp
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import dmrg as tdmrg
from repro_torch.core import metatt as tmetatt
from repro_torch.core import tt as ttt
from repro_torch.data import LMStream
from repro_torch.distributed import compression as tcomp
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

TOL = 1e-5
JCFG = jconfigs.get_smoke_config("stablelm-1.6b")
CFG = tconfigs.get_smoke_config("stablelm-1.6b")


def _pairs(seed, shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    vals = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]
    return ([jnp.asarray(v) for v in vals],
            [torch.from_numpy(v.copy()) for v in vals])


def _tt_shapes(modes, rank):
    bonds = (1,) + (rank,) * (len(modes) - 1) + (1,)
    return [(bonds[k], n, bonds[k + 1]) for k, n in enumerate(modes)]


def _rel(got, want) -> float:
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ------------------------------------------------------------ TT algebra


@pytest.mark.parametrize("modes,idx", [((12, 3, 2, 10), (2, 1)),
                                       ((12, 3, 2, 10), (0, 0)),
                                       ((8, 4, 3, 2, 6), (3, 1, 0)),
                                       ((7, 9), ())])
def test_slice_matrix_matches_jax(modes, idx):
    jc, tc = _pairs(1, _tt_shapes(modes, 4))
    got = ttt.slice_matrix(tc, idx)
    want = jtt.slice_matrix(jc, idx)
    assert _rel(got, want) <= TOL
    full = ttt.materialize(tc)
    torch.testing.assert_close(got, full[(slice(None), *idx)],
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        ttt.slice_matrix(tc, tuple(idx) + (0,))


def _mt_cfgs(variant):
    kw = dict(num_layers=3, matrix_types=("q", "v"), d_in=(16, 16),
              d_out=(16, 12), rank=4, alpha=2.0, variant=variant)
    if variant == "5d":
        kw.update(num_heads=4, head_dim=4, d_out=(16, 8))
    if variant == "4+1d":
        kw.update(num_tasks=3, d_out=(16, 16))
    return jmetatt.MetaTTConfig(**kw), tmetatt.MetaTTConfig(**kw)


@pytest.mark.parametrize("variant,task,layer,m", [
    ("4d", None, 0, "q"), ("4d", None, 2, "v"), ("5d", None, 1, "v"),
    ("5d", None, 0, "q"), ("4+1d", 2, 1, "q"), ("4+1d", 0, 2, "v")])
def test_apply_matches_jax(variant, task, layer, m):
    jcfg, tcfg = _mt_cfgs(variant)
    jc, tc = _pairs(2, _tt_shapes(jcfg.mode_sizes, 4), scale=0.4)
    xj, xt = _pairs(3, [(5, 16)], scale=1.0)
    got = tmetatt.apply({"cores": tc}, tcfg, xt[0], layer, m, task=task)
    want = jmetatt.apply({"cores": jc}, jcfg, xj[0], layer, m, task=task)
    assert _rel(got, want) <= TOL
    # and against the dense ΔW it represents
    dw = tmetatt.materialize_delta({"cores": tc}, tcfg, layer, m, task=task)
    torch.testing.assert_close(got, xt[0] @ dw, rtol=1e-4, atol=1e-5)


def test_apply_is_zero_at_init():
    for variant in ("4d", "5d", "4+1d"):
        _, tcfg = _mt_cfgs(variant)
        p = tmetatt.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        assert tmetatt.zero_at_init(p, tcfg)
        y = tmetatt.apply(p, tcfg, torch.ones(5, 16), 1, "v",
                          task=0 if variant == "4+1d" else None)
        assert float(y.abs().max()) == 0.0


# ------------------------------------------------------- two-site sweep


MODES = (12, 3, 2, 12)


def _bond_signs(tcores, jcores):
    """Per-bond sign vectors that map the port's factors onto JAX's,
    left to right (as tests/test_torch_dmrg.py)."""
    signs = []
    for tc, jc in zip(tcores[:-1], jcores[:-1]):
        c = tc.numpy()
        if signs:
            c = c * signs[-1][:, None, None]
        dot = (c * np.asarray(jc)).reshape(-1, c.shape[-1]).sum(0)
        signs.append(np.where(dot < 0, -1.0, 1.0).astype(np.float32))
    return signs


def _assert_cores_close(tcores, jcores, tol=TOL):
    signs = _bond_signs(tcores, jcores)
    for k, c in enumerate(tcores):
        c = c.numpy()
        if k > 0:
            c = c * signs[k - 1][:, None, None]
        if k < len(signs):
            c = c * signs[k][None, None, :]
        w = np.asarray(jcores[k])
        np.testing.assert_allclose(c, w, rtol=tol,
                                   atol=tol * max(float(np.abs(w).max()), 1))


def _losses(seed):
    """The same loss for both packages: a linear term (so a zero core
    has a gradient) plus the squared norm, on the full tensor."""
    (wj,), (wt,) = _pairs(seed, [MODES], scale=0.3)

    def jloss(p):
        full = jtt.materialize(p["cores"])
        return jnp.sum(full * wj) + jnp.sum(full ** 2)

    def tloss(p):
        full = ttt.materialize(p["cores"])
        return torch.sum(full * wt) + torch.sum(full ** 2)
    return jloss, tloss


def _jax_exact_pair(merged):
    r0, na, nb, r1 = merged.shape
    if r0 * na <= nb * r1:
        return (jnp.eye(r0 * na).reshape(r0, na, r0 * na),
                merged.reshape(r0 * na, nb, r1))
    return (merged.reshape(r0, na, nb * r1),
            jnp.eye(nb * r1).reshape(nb * r1, nb, r1))


def _jax_local_grad(loss_fn, cores, i, merged, svd: bool):
    """jax.grad of the local loss at bond i: through the JAX package's
    exact SVD resplit (``svd``, as ``two_site_sweep``) or through the
    exact pair without an SVD."""
    def local(mm):
        if svd:
            exact = min(mm.shape[0] * mm.shape[1], mm.shape[2] * mm.shape[3])
            a, b, _ = jtt.split_merged(mm, rank=exact)
        else:
            a, b = _jax_exact_pair(mm)
        cs = list(cores)
        cs[i], cs[i + 1] = a, b
        return loss_fn({"cores": cs})
    return jax.grad(local)(merged)


def _jax_sweep_exact_pair(cores, loss_fn, target, inner, lr):
    """The JAX package's two_site_sweep loop with the local gradient taken
    through the exact pair."""
    cores = list(cores)
    d = len(cores)
    for left, bonds in ((True, range(d - 1)), (False, range(d - 2, -1, -1))):
        for i in bonds:
            merged = jtt.merge_pair(cores[i], cores[i + 1])
            for _ in range(inner):
                merged = merged - lr * _jax_local_grad(loss_fn, cores, i,
                                                       merged, svd=False)
            a, b, _ = jtt.split_merged(merged, target, left_orthogonal=left)
            cores[i], cores[i + 1] = a, b
    return cores


@pytest.mark.parametrize("inner", [1, 3])
@pytest.mark.parametrize("kind", ["norm", "linear"])
def test_two_site_sweep_matches_jax(kind, inner):
    """Ranks, the call count 2·(d−1)·inner, the spectra and the cores
    (sign-aligned) against the JAX sweep; the norm loss shrinks the TT
    (as tests/test_dispatch.py)."""
    jc, tc = _pairs(4, _tt_shapes(MODES, 6), scale=0.3)
    if kind == "norm":
        def jloss(p):
            return jtt.tt_norm(p["cores"]) ** 2

        def tloss(p):
            return ttt.tt_norm(p["cores"]) ** 2
    else:
        jloss, tloss = _losses(5)
    calls = {"n": 0}

    def counted(p):
        calls["n"] += 1
        return tloss(p)
    jres = jdmrg.two_site_sweep({"cores": jc}, jloss, target_rank=4,
                                inner_steps=inner)
    res = tdmrg.two_site_sweep({"cores": tc}, counted, target_rank=4,
                               inner_steps=inner)
    assert res.ranks == jres.ranks == (4, 4, 4)
    assert calls["n"] == 2 * (len(tc) - 1) * inner
    for s, js in zip(res.spectra, jres.spectra):
        assert _rel(s, js) <= TOL
    _assert_cores_close(res.params["cores"], jres.params["cores"])
    if kind == "norm":
        assert float(ttt.tt_norm(res.params["cores"])) < \
            float(ttt.tt_norm(tc))


@pytest.mark.parametrize("zero", [0, 1, 3])
def test_two_site_local_gradient_with_a_zero_core(zero):
    """A zero core makes its merged pairs zero: every singular value 0.
    The port's local gradient is finite there and equals jax.grad of the
    local loss through the exact pair; at every bond where JAX's SVD-path
    gradient is finite it equals that too, and at a zero pair JAX's is
    NaN."""
    jc, tc = _pairs(6, _tt_shapes(MODES, 3), scale=0.4)
    jc[zero], tc[zero] = jnp.zeros_like(jc[zero]), torch.zeros_like(tc[zero])
    jloss, tloss = _losses(7)
    for i in range(len(tc) - 1):
        merged = ttt.merge_pair(tc[i], tc[i + 1])
        m = merged.clone().requires_grad_(True)
        cs = list(tc)
        cs[i], cs[i + 1] = tdmrg._exact_pair(m)
        (got,) = torch.autograd.grad(tloss({"cores": cs}), m)
        assert torch.isfinite(got).all()
        jm = jtt.merge_pair(jc[i], jc[i + 1])
        want = _jax_local_grad(jloss, jc, i, jm, svd=False)
        assert _rel(got, want) <= TOL
        via_svd = _jax_local_grad(jloss, jc, i, jm, svd=True)
        if zero in (i, i + 1):
            assert not bool(jnp.isfinite(via_svd).all())
        else:
            assert _rel(got, via_svd) <= TOL


@pytest.mark.parametrize("zero", [None, 0, 3])
def test_two_site_sweep_with_a_zero_core_matches_jax(zero):
    """The whole sweep from cores with one zero-initialised core (MetaTT's
    init): finite, and equal (sign-aligned, 1e-5) to the JAX loop taking
    its local gradient through the exact pair; with no zero core that loop
    is the JAX package's ``two_site_sweep`` itself."""
    jc, tc = _pairs(8, _tt_shapes(MODES, 5), scale=0.4)
    if zero is not None:
        jc[zero] = jnp.zeros_like(jc[zero])
        tc[zero] = torch.zeros_like(tc[zero])
    jloss, tloss = _losses(9)
    res = tdmrg.two_site_sweep({"cores": tc}, tloss, target_rank=3,
                               inner_steps=2, lr=1e-2)
    assert all(torch.isfinite(c).all() for c in res.params["cores"])
    assert res.ranks == (3, 3, 3)
    want = _jax_sweep_exact_pair(jc, jloss, 3, 2, 1e-2)
    _assert_cores_close(res.params["cores"], want)
    if zero is None:
        jres = jdmrg.two_site_sweep({"cores": jc}, jloss, target_rank=3,
                                    inner_steps=2, lr=1e-2)
        _assert_cores_close(res.params["cores"], jres.params["cores"])


@pytest.mark.parametrize("seed,rank", [(0, 1), (1, 3), (2, 6), (3, 4)])
def test_two_site_resplit_exact_at_full_rank(seed, rank):
    """Merge two cores and SVD-resplit at the full bond: an exact
    factorization (as tests/test_property.py); ``_exact_pair`` too."""
    _, tc = _pairs(seed, _tt_shapes((9, 7), rank))
    merged = ttt.merge_pair(*tc)
    full = min(merged.shape[0] * merged.shape[1],
               merged.shape[2] * merged.shape[3])
    a, b, _ = ttt.split_merged(merged, rank=full)
    torch.testing.assert_close(ttt.merge_pair(a, b), merged, rtol=0,
                               atol=1e-5)
    a, b = tdmrg._exact_pair(merged)
    assert a.shape[-1] == full
    torch.testing.assert_close(ttt.merge_pair(a, b), merged, rtol=0,
                               atol=1e-6)


# --------------------------------------------------------- compression


def _grad_arrays(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, 13)).astype(np.float32)
    # exact ties in magnitude and values on the int8 half-steps
    x[0, :4] = [0.5, -0.5, 0.5, -0.5]
    x[1, :3] = x[0, 5]
    x[2] = np.float32(2.0) * np.arange(13, dtype=np.float32) / 12.0 - 1.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_encode_is_bit_identical_to_jax(seed):
    x = _grad_arrays(seed)
    for arr in (x, np.zeros((3, 4), np.float32), x[2]):
        q, s = tcomp.int8_encode(torch.from_numpy(arr.copy()))
        jq, js = jcomp.int8_encode(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            tcomp.int8_decode(q, s).numpy(),
            np.asarray(jcomp.int8_decode(jq, js)))
    # round half to even, as jnp.round
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])),
                       torch.tensor([0.0, 2.0, 2.0, -0.0]))


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.25, 0.5])
def test_topk_kept_set_matches_jax_on_ties(frac):
    x = _grad_arrays(3)
    x[3] = 0.75           # a whole row of equal magnitudes
    x[4] = -0.75
    kept, idx, shape = tcomp.topk_encode(torch.from_numpy(x), frac)
    jkept, jidx, jshape = jcomp.topk_encode(jnp.asarray(x), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert shape == tuple(jshape)
    np.testing.assert_array_equal(
        tcomp.topk_decode(kept, idx, shape).numpy(),
        np.asarray(jcomp.topk_decode(jkept, jidx, jshape)))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_grad_compressor_matches_jax_over_steps(kind):
    """Five steps of the compressor on a tree of gradients: outputs and
    residuals identical to the JAX GradCompressor's."""
    rng = np.random.default_rng(4)
    shapes = {"a": (6, 5), "b": (11,), "c": (3, 2, 4)}
    comp = tcomp.GradCompressor(kind, topk_frac=0.2)
    jcomp_ = jcomp.GradCompressor(kind, topk_frac=0.2)
    g0 = {k: torch.zeros(s) for k, s in shapes.items()}
    res, jres = comp.init_residual(g0), jcomp_.init_residual(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        out, res = comp({k: torch.from_numpy(v) for k, v in g.items()}, res)
        jout, jres = jcomp_({k: jnp.asarray(v) for k, v in g.items()}, jres)
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(jout[k]))
            if kind == "topk":
                np.testing.assert_array_equal(res[k].numpy(),
                                              np.asarray(jres[k]))
            else:
                assert res is None and jres is None


def test_topk_error_feedback_carries_residual_across_steps():
    """As tests/test_compression.py: a coordinate too small for the top-k
    accumulates in the residual until it wins a later step, so nothing is
    lost, only delayed; without the residual it never transmits."""
    g = {"g": torch.tensor([1.0, 0.4, 0.3, 0.2])}
    comp = tcomp.GradCompressor("topk", topk_frac=0.25)    # k = 1
    n_steps = 12
    res = comp.init_residual(g)
    sent = torch.zeros(4)
    for _ in range(n_steps):
        out, res = comp(g, res)
        sent = sent + out["g"]
    torch.testing.assert_close(sent + res["g"], n_steps * g["g"], rtol=0,
                               atol=1e-5)
    assert all(float(s) > 0 for s in sent)
    sent_nofb = torch.zeros(4)
    for _ in range(n_steps):
        out, _ = comp(g, comp.init_residual(g))
        sent_nofb = sent_nofb + out["g"]
    assert float(sent_nofb[1]) == 0 and float(sent_nofb[3]) == 0


def test_topk_residual_dtype_and_structure_follow_grads():
    g = {"a": torch.ones((4, 4), dtype=torch.bfloat16), "b": torch.ones(8)}
    comp = tcomp.GradCompressor("topk", topk_frac=0.5)
    out, new_res = comp(g, comp.init_residual(g))
    assert out["a"].dtype == torch.bfloat16
    assert new_res["a"].dtype == torch.float32
    assert out["b"].shape == (8,)
    assert tcomp.GradCompressor("int8").init_residual(g) is None
    with pytest.raises(ValueError):
        tcomp.GradCompressor("fp4")


# --------------------------------------------------- full fine-tuning


def test_full_ft_step_matches_jax():
    """One full fine-tuning step on the stablelm smoke config (paper Table
    1 "FT" row): the loss and the gradient norm 1e-5, every updated base
    leaf 1e-4, against the JAX ``make_full_ft_step``; the base moved."""
    key = jax.random.PRNGKey(0)
    jbase = jtransformer.init_base_params(JCFG, key)
    base = from_jax_numpy(jax.device_get(jbase), device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
    opt, train = dict(lr=1e-3), dict(remat="none")
    jstep = jts.make_full_ft_step(JCFG, JOptimizerConfig(**opt),
                                  JTrainConfig(**train), 10)
    jnew, _, jm = jstep(jbase, jadamw.init_state(jbase),
                        {"tokens": jnp.asarray(tokens)})
    step = tts.make_full_ft_step(CFG, OptimizerConfig(**opt),
                                 TrainConfig(**train), 10, device="cpu")
    before = [t.clone() for t in TM.tensors(base)]
    new, new_opt, m = step(base, tadamw.init_state(base),
                           {"tokens": torch.from_numpy(tokens)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(
        float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= TOL * abs(
        float(jm["grad_norm"]))
    assert new_opt.step == 1
    got, want = TM.tensors(new), jax.tree_util.tree_leaves(
        jax.device_get(jnew))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    moved = sum(float((a - b).abs().sum()) for a, b in zip(got, before))
    assert moved > 0 and not any(t.requires_grad for t in got)


# ------------------------------------- the Trainer with compression


@functools.lru_cache(maxsize=None)
def _jax_compressed_run(kind):
    jrun = JRunConfig(
        model=JCFG, shape=SHAPES["train_4k"], adapter_kind="metatt",
        adapter_rank=4, adapter_alpha=4.0,
        optimizer=JOptimizerConfig(lr=2e-2, warmup_ratio=0.1),
        train=JTrainConfig(seed=3, remat="none", ckpt_every=0,
                           grad_compression=kind))
    jtr = JTrainer(run=jrun, data=JLMStream(
        vocab_size=CFG.vocab_size, seq_len=32, batch=8, seed=11,
        branching=2), total_steps=10)
    start = jax.device_get({"base": jtr.base, "frozen": jtr.frozen,
                            "adapter": jtr.state.adapter})
    jtr.train()
    return jtr, start


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_trainer_with_grad_compression_tracks_the_jax_trainer(kind):
    """Ten steps of the port's Trainer with int8 or top-k (error
    feedback) compression against the JAX Trainer from the same weights:
    losses, gradient norms and final cores 1e-4; the top-k residual
    too."""
    jtr, start = _jax_compressed_run(kind)
    run = RunConfig(
        model=CFG, adapter_kind="metatt", adapter_rank=4, adapter_alpha=4.0,
        optimizer=OptimizerConfig(lr=2e-2, warmup_ratio=0.1),
        train=TrainConfig(seed=3, remat="none", ckpt_every=0,
                          grad_compression=kind))
    tr = Trainer(run=run, data=LMStream(vocab_size=CFG.vocab_size,
                                        seq_len=32, batch=8, seed=11,
                                        branching=2),
                 total_steps=10, device="cpu")
    tp = from_jax_numpy(start, device="cpu")
    tr.base, tr.frozen = tp["base"], tp["frozen"]
    tr.state = tts.init_train_state(tp["adapter"], tr.compressor)
    assert (tr.state.residual is None) == (kind == "int8")
    tr.train()
    a, b = tr.losses(), jtr.losses()
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (a, b)
    np.testing.assert_allclose([m["grad_norm"] for _, m in tr.history],
                               [m["grad_norm"] for _, m in jtr.history],
                               rtol=1e-4)
    for c, jc in zip(tr.state.adapter["cores"], jtr.state.adapter["cores"]):
        assert _rel(c, jc) <= 1e-4
    if kind == "topk":
        for r, jr in zip(tr.state.residual["cores"],
                         jtr.state.residual["cores"]):
            assert _rel(r, jr) <= 1e-4
    assert np.isfinite(a).all()


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_launcher_trains_with_grad_compression(kind, capsys):
    """``--grad-compression`` reaches the Trainer: the launcher trains on
    the CPU at the smoke size with finite losses."""
    from repro_torch.launch import train as tlaunch
    hist = tlaunch.main(["--arch", "stablelm-1.6b", "--steps", "2",
                         "--device", "cpu", "--grad-compression", kind])
    assert len(hist) == 2
    assert all(np.isfinite(m["loss"]) for _, m in hist)


def test_topk_residual_survives_checkpoint_resume(tmp_path):
    """The top-k error-feedback residual is part of the saved train
    state, as in the JAX Trainer: a run failed at step 5 and resumed from
    its step-3 checkpoint restores the residual bit for bit and ends
    where the uninterrupted run does."""
    from repro_torch.distributed import FailureInjector, SimulatedFailure

    def run(ckpt_dir="", **kw):
        r = RunConfig(model=CFG, adapter_kind="metatt", adapter_rank=4,
                      adapter_alpha=4.0,
                      optimizer=OptimizerConfig(lr=2e-2, warmup_ratio=0.1),
                      train=TrainConfig(seed=3, remat="none",
                                        ckpt_dir=ckpt_dir,
                                        ckpt_every=3 if ckpt_dir else 0,
                                        grad_compression="topk"))
        return Trainer(run=r, data=LMStream(
            vocab_size=CFG.vocab_size, seq_len=32, batch=8, seed=11,
            branching=2), total_steps=8, device="cpu", **kw)
    full = run()
    full.train()
    third = run()
    third.train(3)
    d = str(tmp_path / "ck")
    with pytest.raises(SimulatedFailure):
        run(d, failure_injector=FailureInjector(fail_at_step=5)).train()
    resumed = run(d)
    assert resumed.state.step == 3
    for r, want in zip(resumed.state.residual["cores"],
                       third.state.residual["cores"]):
        assert torch.equal(r, want)
    resumed.train()
    for name in ("adapter", "residual"):
        for x, y in zip(getattr(resumed.state, name)["cores"],
                        getattr(full.state, name)["cores"]):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
