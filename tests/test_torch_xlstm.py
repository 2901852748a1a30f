"""The xLSTM mixers and xlstm-125m in the port against the JAX package
(f32, on the CPU).

xlstm-125m alternates mLSTM and sLSTM blocks (no FFN); on the card it is
served and trained at full width and full depth (``chip_smoke.py`` phase
20). The mixers (``models/xlstm.py``) are torch ops between K1 / K2
projections, as the JAX mixers are XLA between ``adapted_linear`` calls.
Here, with weights made by the JAX package (its PRNG) and carried across
with ``repro_torch.convert.from_jax_numpy``, and inputs made with numpy:

* the smoke and full configs field by field, the full config's base and
  4d adapter parameters equal to JAX's (meta device / ``jax.eval_shape``);
  at full width each package's bf16 forward sits more than 10% of the
  largest logit from its own f32 one (why the card holds xLSTM's kernels
  in f32);
* each mixer within 1e-5 (relative to the largest value) of the JAX one
  — the mLSTM parallel form unchunked (T = 8 at the default chunk of
  256) and chunked (T = 16 at chunk 4), and the sLSTM loop — with the
  input and weight gradients within 1e-4 of ``jax.vjp``'s; one recurrent
  step of each from a random state within 1e-5;
* the smoke model's logits (1e-5); token-by-token decode from zero
  caches equal to JAX's decode (1e-5) and to the parallel forward
  (``tests/test_serving.py::test_decode_matches_parallel_forward``'s
  2e-2); a 4+1d decode with a per-row task vector (1e-5);
* the MetaTT-4d loss (1e-5) and its gradients (1e-4), plain and with
  remat; ten Trainer steps against the JAX Trainer (1e-4, 1e-3 after
  the sweep);
* the ``mlstm_*`` / ``slstm_*`` folds (1e-5);
* the engine refuses the model as the JAX engine does, and the paged
  pools refuse the xLSTM positions.

Every JAX run is made once for the module (``jax_runs``).
"""
import dataclasses

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
from repro.core import merge as jmerge
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import LMStream as JLMStream
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models import xlstm as jxlstm
from repro.models.layers import AdapterCtx as JCtx
from repro.peft import api as jpeft
from repro.serving import engine as jengine
from repro.serving.adapter_runtime import AdapterRuntime as JRuntime
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import merge as tmerge
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as txlstm
from repro_torch.models.layers import AdapterCtx
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_map

ARCH = "xlstm-125m"
KEY = jax.random.PRNGKey(32)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
#: the adapter's ``random_tt`` scale (the JAX serving test's)
SCALE = 0.1
B, S = 2, 8
OPT = dict(lr=2e-2, warmup_ratio=0.1)


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _runs(cfg, jcfg, variant="4d", **kw):
    common = dict(adapter_kind="metatt", adapter_variant=variant,
                  adapter_rank=4, **kw)
    if variant == "4+1d":
        common["num_tasks"] = 3
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"], **common),
            RunConfig(model=cfg, **common))


def _make(variant):
    """The smoke config in both packages with a MetaTT adapter of
    ``variant`` at rank 4 on the default matrices, ``random_tt(SCALE)``,
    made by the JAX package. Returns (jcfg, jspec, jp, cfg, spec, tp)."""
    jcfg, cfg = (jconfigs.get_smoke_config(ARCH),
                 tconfigs.get_smoke_config(ARCH))
    jrun, trun = _runs(cfg, jcfg, variant)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = jax.jit(JM.init_params, static_argnums=(0, 1))(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=SCALE)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


@pytest.fixture(scope="module")
def setup():
    return _make("4d")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _factors(spec, tp):
    return tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Every JAX run the model tests compare with, made once: the
    parallel forward, token-by-token decode from zero caches, and the
    loss with its adapter gradients."""
    jcfg, jspec, jp, cfg, _, _ = setup
    bc, pl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    toks = _tokens(cfg, B, S)
    fwd = jax.jit(lambda t: JT.forward(jp["base"], jcfg, jspec, bc, pl,
                                       t).logits)(jnp.asarray(toks))
    step = jax.jit(lambda t, c, p: JT.decode_step(jp["base"], jcfg, jspec,
                                                  bc, pl, t, c, p))
    caches = JT.init_caches(jcfg, B, S, jnp.float32)
    dec = []
    for t in range(S):
        lg, caches = step(jnp.asarray(toks[:, t:t + 1]), caches,
                          jnp.int32(t))
        dec.append(np.asarray(lg))
    rng = np.random.default_rng(7)
    gtoks = _tokens(cfg, 3, 13, seed=8)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"],
        {"tokens": jnp.asarray(gtoks), "mask": jnp.asarray(mask)}, jcfg,
        jspec)
    return dict(toks=toks, logits=np.asarray(fwd),
                decode=np.stack(dec, 1), gtoks=gtoks, mask=mask,
                loss=float(jl), grads=jax.tree_util.tree_leaves(jg))


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_jax_field_by_field(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert ARCH in tconfigs.ALL_IDS
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        assert getattr(cfg, f.name) == DTYPES.get(want, want), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    TT.check_supported(cfg)
    if not smoke:   # tests/test_models_smoke.py's assigned values
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size,
                cfg.num_super_blocks) == (12, 768, 4, 4, 0, 50304, 6)
    spec = TM.build_adapter_spec(RunConfig(model=cfg))
    jspec = JM.build_adapter_spec(JRunConfig(model=jcfg,
                                             shape=SHAPES["train_4k"]))
    assert spec.cfg.matrix_types == jspec.cfg.matrix_types == (
        "mlstm_q", "mlstm_v", "slstm_z")
    assert TM.matrix_dims(cfg) == JM.matrix_dims(jcfg)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes


def test_full_width_bf16_forward_is_far_from_f32_in_both_packages():
    """xlstm-125m at random init is chaotic in bf16: at full width, 2 x 8
    tokens, each package's bf16 forward sits more than 10% of the largest
    logit from its own f32 forward on the same weights (the port's base
    carried from the JAX one), so a bf16 kernel leg cannot be held to the
    f32 witness rule (``chip_smoke.py`` phase 20 asserts in f32)."""
    jcfg, cfg = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = jax.jit(JM.init_params, static_argnums=(0, 1))(jcfg, jspec, KEY)
    bc, pl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    toks = _tokens(jcfg, 2, 8)
    j32 = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                              compute_dtype=jnp.float32)

    def jlogits(c, base):
        return np.asarray(jax.jit(lambda b: JT.forward(
            b, c, jspec, bc, pl, jnp.asarray(toks)).logits)(base),
            np.float32)
    gaps = [_rel(jlogits(jcfg, jp["base"]), jlogits(
        j32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jp["base"])))]
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    tbc, tpl = _factors(spec, tp)
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    with torch.no_grad():
        t16, t32 = (TT.forward(b, c, spec, tbc, tpl, toks,
                               device="cpu").logits.float()
                    for c, b in ((cfg, tp["base"]), (c32, tree_map(
                        lambda t: t.float(), tp["base"]))))
    gaps.append(_rel(t16, t32.numpy()))
    assert min(gaps) > 0.1, gaps


def test_full_width_parameter_counts_match_jax():
    """Base and 4d adapter parameters of full-width xlstm-125m from shapes
    alone in both packages."""
    cfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg, adapter_alpha=4.0)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert got["base"] > 7e7


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _mixer_args(setup, pos):
    """Pattern position ``pos``'s (0: mLSTM, 1: sLSTM) layer-``pos``
    weights and adapter slice in both packages: (jw, jctx, tw, tctx)."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    assert jcfg.block_pattern[pos][0] == ("mlstm", "slstm")[pos]
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    tbc, tpl = _factors(spec, tp)
    jw = jax.tree_util.tree_map(lambda a: a[0], jp["base"]["blocks"][pos]
                                ["mixer"])
    tw = TT._at(tp["base"]["blocks"][pos]["mixer"], 0)
    jctx = JCtx(jspec, jbc, jax.tree_util.tree_map(lambda a: a[pos], jpl))
    tctx = AdapterCtx(spec, tbc, TT._at(tpl, pos))
    return jw, jctx, tw, tctx


#: (mixer, T, chunk): the mLSTM parallel form unchunked (t <= chunk) and
#: chunked (t % chunk == 0 and t > chunk), and the sLSTM loop
MIXER_CASES = [("mlstm", 8, 256), ("mlstm", 16, 4), ("slstm", 8, 0)]
MIXER_IDS = ["mlstm-whole-T8", "mlstm-chunked-T16c4", "slstm-T8"]


def _mixers(name, chunk):
    if name == "mlstm":
        return (lambda *a, **k: jxlstm.mlstm_mixer(*a, chunk=chunk, **k),
                lambda *a, **k: txlstm.mlstm_mixer(*a, chunk=chunk, **k))
    return jxlstm.slstm_mixer, txlstm.slstm_mixer


@pytest.mark.parametrize("name,t,chunk", MIXER_CASES, ids=MIXER_IDS)
def test_mixer_matches_jax(setup, name, t, chunk):
    jcfg, cfg = setup[0], setup[3]
    jw, jctx, tw, tctx = _mixer_args(setup, int(name == "slstm"))
    jfn, tfn = _mixers(name, chunk)
    x = _x(cfg, 2, t)
    jy, jc = jax.jit(lambda x_: jfn(x_, jw, jctx, jcfg))(jnp.asarray(x))
    with torch.no_grad():
        y, c = tfn(torch.from_numpy(x), tw, tctx, cfg)
    assert jc is None and c is None        # no cache from the parallel form
    assert _rel(y, jy) <= 1e-5


@pytest.mark.parametrize("name,t,chunk", MIXER_CASES, ids=MIXER_IDS)
def test_mixer_gradients_match_jax_vjp(setup, name, t, chunk):
    """d(x) and every weight's gradient within 1e-4 (relative Frobenius)
    of ``jax.vjp``'s; the chunked mLSTM branch through its per-chunk
    checkpoints."""
    jcfg, cfg = setup[0], setup[3]
    jw, jctx, tw, tctx = _mixer_args(setup, int(name == "slstm"))
    jfn, tfn = _mixers(name, chunk)
    x = _x(cfg, 2, t, seed=3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    names = sorted(jw)

    @jax.jit
    def jvjp(x_, ws, c):
        return jax.vjp(lambda x__, *w_: jfn(x__, dict(zip(names, w_)), jctx,
                                            jcfg)[0], x_, *ws)[1](c)
    jgrads = jvjp(jnp.asarray(x), [jw[n] for n in names], jnp.asarray(cot))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        tw[n].clone().requires_grad_(True) for n in names]
    y, _ = tfn(leaves[0], dict(zip(names, leaves[1:])), tctx, cfg)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    for nm, g, want in zip(["x"] + names, grads, jgrads):
        assert float(np.abs(np.asarray(want)).max()) > 0, nm
        assert _fro(g, want) <= 1e-4, nm


def test_slstm_loop_backward_equals_autograd_through_the_loop():
    """``_SLSTMLoop``'s hand-written backward (the loop in reverse, the
    stabiliser held fixed) against autograd through the same loop of
    ``_slstm_step``s, T = 64, heads-first (T, H, B, ...): d(pre_x) and
    d(R) within 1e-5 (relative Frobenius), and the same forward bit for
    bit."""
    rng = np.random.default_rng(12)
    b, t, h, hd = 2, 64, 4, 16
    pre = torch.from_numpy(rng.standard_normal((t, h, b, 4, hd)).astype(
        np.float32)).requires_grad_(True)
    r = torch.from_numpy((rng.standard_normal((h, hd, 4 * hd))
                          / hd ** 0.5).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((t, h, b, hd)).astype(
        np.float32))
    carry, hs = txlstm._zero_carry(pre), []
    for i in range(t):
        carry, _ = txlstm._slstm_step(carry, pre[i], r)
        hs.append(carry[0])
    want = torch.stack(hs)
    got = txlstm._SLSTMLoop.apply(pre, r)
    assert torch.equal(got, want)
    for x, y in zip(torch.autograd.grad(got, (pre, r), g),
                    torch.autograd.grad(want, (pre, r), g)):
        assert float((x - y).norm() / y.norm()) <= 1e-5


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_mixer_decode_step_matches_jax(setup, name):
    """One recurrent step from a random state (m finite), the port's
    cache updated in place."""
    jcfg, cfg = setup[0], setup[3]
    jw, jctx, tw, tctx = _mixer_args(setup, int(name == "slstm"))
    rng = np.random.default_rng(5)
    hd = cfg.d_model // cfg.num_heads
    if name == "mlstm":
        shapes = {"c": (2, cfg.num_heads, hd, hd), "n": (2, cfg.num_heads,
                                                         hd),
                  "m": (2, cfg.num_heads)}
    else:
        shapes = {k: (2, cfg.d_model) for k in ("h", "c", "n", "m")}
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    state["n"] = np.abs(state["n"]) + 0.5
    jfn, tfn = _mixers(name, 256)
    x = _x(cfg, 2, 1, seed=6)
    jy, jc = jax.jit(lambda x_, c_: jfn(x_, jw, jctx, jcfg, cache=c_))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    with torch.no_grad():
        y, out = tfn(torch.from_numpy(x), tw, tctx, cfg, cache=cache)
    assert out is cache
    assert _rel(y, jy) <= 1e-5
    for k in shapes:
        assert _rel(cache[k], jc[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------


def test_forward_logits_match_jax(setup, jax_runs):
    _, _, _, cfg, spec, tp = setup
    bc, pl = _factors(spec, tp)
    with torch.no_grad():
        out = TT.forward(tp["base"], cfg, spec, bc, pl, jax_runs["toks"],
                         device="cpu", return_caches=True)
    assert _rel(out.logits, jax_runs["logits"]) <= 1e-5
    assert out.caches == [{}, {}]   # the parallel forms return none (JAX)


def test_decode_from_zero_caches_matches_jax_and_the_parallel_forward(
        setup, jax_runs):
    """Token-by-token decode from ``init_caches`` zeros: every step's
    logits within 1e-5 of JAX's decode, and of the parallel forward
    within the JAX serving test's 2e-2."""
    _, _, _, cfg, spec, tp = setup
    bc, pl = _factors(spec, tp)
    toks = jax_runs["toks"]
    caches = TT.init_caches(cfg, B, S, torch.float32, device="cpu")
    assert [next(iter(c)) for c in caches] == ["mlstm", "slstm"]
    assert caches[0]["mlstm"]["c"].shape == (
        cfg.num_super_blocks, B, cfg.num_heads, 16, 16)
    with torch.no_grad():
        steps = [TT.decode_step(tp["base"], cfg, spec, bc, pl,
                                toks[:, t:t + 1], caches, t,
                                device="cpu")[0] for t in range(S)]
    dec = torch.stack(steps, 1)
    assert _rel(dec, jax_runs["decode"]) <= 1e-5
    assert _rel(dec, jax_runs["logits"]) < 2e-2


def test_per_row_task_decode_matches_jax():
    """MetaTT 4+1d over 3 tasks, a (B,) task vector: three decode steps
    from zero caches, logits and every state within 1e-5."""
    jcfg, jspec, jp, cfg, spec, tp = _make("4+1d")
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = _factors(spec, tp)
    toks = _tokens(cfg, 3, 3, seed=9)
    task = np.array([2, 0, 1], np.int32)
    step = jax.jit(lambda t, c, p: JT.decode_step(
        jp["base"], jcfg, jspec, jbc, jpl, t, c, p, task=jnp.asarray(task)))
    jc = JT.init_caches(jcfg, 3, 3, jnp.float32)
    caches = TT.init_caches(cfg, 3, 3, torch.float32, device="cpu")
    for t in range(3):
        want, jc = step(jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        with torch.no_grad():
            got, caches = TT.decode_step(
                tp["base"], cfg, spec, bc, pl, toks[:, t:t + 1], caches, t,
                task=torch.from_numpy(task), device="cpu")
        assert _rel(got, want) <= 1e-5
    for gc, wc in zip(caches, jc):
        for kind, leaves in wc.items():
            for name, leaf in leaves.items():
                assert _rel(gc[kind][name], leaf) <= 1e-5, (kind, name)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_adapter_grads_match_jax(setup, jax_runs, remat):
    _, _, _, cfg, spec, tp = setup
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"],
                         {"tokens": torch.from_numpy(jax_runs["gtoks"]),
                          "mask": torch.from_numpy(jax_runs["mask"])}, cfg,
                         spec, remat=remat, device="cpu")
    jl = jax_runs["loss"]
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jax_runs["grads"]) == 4
    for g, want in zip(grads, jax_runs["grads"]):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer():
    """Ten steps, one warm-moment sweep 6 -> 4 after epoch 1 (step 3):
    losses within 1e-4 before the sweep and 1e-3 after it."""
    cfg, jcfg = (tconfigs.get_smoke_config(ARCH),
                 jconfigs.get_smoke_config(ARCH))
    tr_kw = {"seed": 3, "remat": "none", "ckpt_every": 0}
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=6, adapter_alpha=4.0)
    jrun = JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                      optimizer=JOptimizerConfig(**OPT),
                      train=JTrainConfig(**tr_kw), **common)
    trun = RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                     train=TrainConfig(**tr_kw), **common)

    def lm(pkg):
        return pkg(vocab_size=cfg.vocab_size, seq_len=16, batch=4, seed=11,
                   branching=2)
    jtr = JTrainer(run=jrun, data=lm(JLMStream), total_steps=10,
                   steps_per_epoch=3,
                   rank_schedule=JRankSchedule(milestones=((1, 4),)))
    tr = Trainer(run=trun, data=lm(LMStream), total_steps=10,
                 steps_per_epoch=3,
                 rank_schedule=RankSchedule(milestones=((1, 4),)),
                 device="cpu")
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "frozen": jtr.frozen,
         "adapter": jtr.state.adapter}), device="cpu")
    tr.base, tr.frozen = tp["base"], tp["frozen"]
    tr.state = tts.init_train_state(tp["adapter"])
    jtr.train()
    tr.train()
    assert tr._dmrg_applied == jtr._dmrg_applied == [1]
    a, b = tr.losses(), jtr.losses()
    rel = np.abs(a - b) / np.abs(b)
    assert rel[:3].max() <= 1e-4 and rel[3:].max() <= 1e-3, rel
    assert np.isfinite(a).all() and tr.state.opt.step == 10


def test_xlstm_folds_match_jax():
    """``fold_transformer`` of a 4d adapter on every xLSTM matrix type
    (``mlstm_q`` / ``mlstm_v`` / ``mlstm_o``, ``slstm_z`` / ``slstm_o``)
    as JAX folds it (1e-5); nothing else changed."""
    jcfg, cfg = (jconfigs.get_smoke_config(ARCH),
                 tconfigs.get_smoke_config(ARCH))
    types = ("mlstm_q", "mlstm_v", "mlstm_o", "slstm_z", "slstm_o")
    jrun, trun = _runs(cfg, jcfg, adapter_matrices=types)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=SCALE)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    want = jmerge.fold_transformer(jp["adapter"], jspec.cfg, jp["base"],
                                   jcfg)
    got = tmerge.fold_transformer(tp["adapter"], spec.cfg, tp["base"], cfg)
    jl = jax.tree_util.tree_leaves(want)
    tl = TM.tensors(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert _rel(t, j) <= 1e-5
    for pos, names in ((0, ("wq", "wv", "w_out")), (1, ("w_z", "w_out"))):
        for n in names:
            assert not torch.equal(got["blocks"][pos]["mixer"][n],
                                   tp["base"]["blocks"][pos]["mixer"][n])
    assert torch.equal(got["blocks"][0]["mixer"]["wk"],
                       tp["base"]["blocks"][0]["mixer"]["wk"])


def test_engine_and_paged_pools_refuse_xlstm(setup):
    """The slot engine refuses xlstm with the JAX engine's error before it
    touches a weight; the paged pools refuse the xLSTM positions."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    rt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                              tp["frozen"])
    msg = "slot engine needs attention KV caches; mixer 'mlstm'"
    with pytest.raises(NotImplementedError, match=msg):
        jengine.Engine(jcfg, jrt)
    with pytest.raises(NotImplementedError, match=msg):
        Engine(cfg, dataclasses.replace(rt, base=None), device="cpu")
    with pytest.raises(NotImplementedError, match="'mlstm'"):
        TT.init_paged_caches(cfg, 8, 16, torch.float32, device="cpu")
