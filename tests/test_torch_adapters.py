"""The paper's baselines (LoRA, VeRA, LoTR) and MetaTT-5d in the port,
against the JAX package on smoke stablelm.

* Parameter counts: the Table 1 / Table 2 rows of tests/test_param_counts.py
  against the port's configs and closed forms (exact), and the JAX
  configs' counts.
* For lora, vera, lotr and metatt-5d (weights made by the JAX package and
  carried across with ``convert.from_jax_numpy``, VeRA's frozen pair too:
  the JAX PRNG is not reproduced): the loss against JAX ``loss_fn`` at
  1e-5 relative and the adapter gradients at 1e-4 (relative Frobenius;
  the folds route them through K1's dA / dB and the fold's own autograd,
  f32 sums in another order); ``lora_form_factors`` at 1e-5 (f32); ten
  ``Trainer`` steps against the JAX ``Trainer`` at 1e-4 on the losses and
  the final adapter, in relative Frobenius norm: Adam magnifies
  summation-order differences (tests/test_torch_train.py), most where a
  gradient first turns non-zero — LoRA's A at step 2, after its B = 0
  moved — where an entry whose gradient is near Adam's eps takes a step
  of any size up to lr: 3.9e-4 of the largest entry, 3.9e-5 in norm.
* ``4+ed`` on a dense model raises (its default matrices name the MoE
  expert down-projection, which a dense model lacks), as in the JAX
  package; on granite-moe-1b's smoke config it builds, its q / v delta
  reads expert slice 0, and its parameter count equals the JAX one.
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
from repro.core import metatt as jmetatt
from repro.core import tt as jtt
from repro.data import LMStream as JLMStream
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.peft import lora as jlora
from repro.peft import lotr as jlotr
from repro.peft import vera as jvera
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import metatt
from repro_torch.data import LMStream
from repro_torch.models import model as TM
from repro_torch.peft import api as tpeft
from repro_torch.peft import lora, lotr, vera
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

JCFG = jconfigs.get_smoke_config("stablelm-1.6b")
CFG = tconfigs.get_smoke_config("stablelm-1.6b")
KEY = jax.random.PRNGKey(7)
OPT = dict(lr=2e-2, warmup_ratio=0.1)
#: (kind, variant, rank) of each adapter under test
KINDS = [("lora", "4d", 4), ("vera", "4d", 16), ("lotr", "4d", 8),
         ("metatt", "5d", 4)]
IDS = ["lora", "vera", "lotr", "metatt-5d"]


# ---------------------------------------------------------------------------
# parameter counts (paper Table 1 / Table 2)
# ---------------------------------------------------------------------------

def _qv(mod, D, L, r, **kw):
    return mod(num_layers=L, matrix_types=("q", "v"), d_in=(D, D),
               d_out=(D, D), rank=r, **kw)


COUNTS = [
    # MetaTT-4D: base r = 8 / 24 / 64, large r = 16 / 32
    *[("4d", dict(D=D, L=L, M=2, r=r), want) for D, L, r, want in (
        (768, 12, 8, 13184), (768, 12, 24, 44928), (768, 12, 64, 155648),
        (1024, 24, 16, 39424), (1024, 24, 32, 92160))],
    # MetaTT-5D: base r = 16 / 64, large r = 32 / 64
    *[("5d", dict(D=D, H=H, L=L, M=2, r=r), want) for D, H, L, r, want in (
        (768, 12, 12, 16, 19968), (768, 12, 12, 64, 159744),
        (1024, 16, 24, 32, 77824), (1024, 16, 24, 64, 241664))],
    ("lora", dict(D=768, L=12, M=2, r=8), 294912),
    ("lora", dict(D=1024, L=24, M=2, r=8), 786432),
    ("vera", dict(D=768, L=12, M=2, r=1024), 43008),
    ("vera", dict(D=1024, L=24, M=2, r=256), 61440),
    *[("lotr", dict(D=D, L=L, M=2, r=r), want) for D, L, r, want in (
        (768, 12, 40, 99840), (768, 12, 80, 276480), (768, 12, 88, 321024),
        (1024, 24, 64, 327680))],
]


@pytest.mark.parametrize("kind,a,want", COUNTS,
                         ids=[f"{k}-{a['D']}-r{a['r']}" for k, a, _ in COUNTS])
def test_param_counts_match_the_paper_and_jax(kind, a, want):
    D, L, r = a["D"], a["L"], a["r"]
    if kind in ("4d", "5d"):
        extra = ({} if kind == "4d" else
                 dict(variant="5d", num_heads=a["H"], head_dim=D // a["H"]))
        got = _qv(metatt.MetaTTConfig, D, L, r, **extra).num_params()
        jgot = _qv(jmetatt.MetaTTConfig, D, L, r, **extra).num_params()
        closed = (metatt.paper_count_4d(D, L, 2, r) if kind == "4d" else
                  metatt.paper_count_5d(D, a["H"], L, 2, r))
    else:
        mod, jmod = {"lora": (lora, jlora), "vera": (vera, jvera),
                     "lotr": (lotr, jlotr)}[kind]
        cname = {"lora": "LoRAConfig", "vera": "VeRAConfig",
                 "lotr": "LoTRConfig"}[kind]
        got = _qv(getattr(mod, cname), D, L, r).num_params()
        jgot = _qv(getattr(jmod, cname), D, L, r).num_params()
        closed = mod.paper_count(D, L, 2, r)
    assert got == jgot == closed == want


def test_compression_ranking_and_task_core_overhead():
    """§2.4: MetaTT-4D < LoTR < LoRA at matched rank; Table 2: the 4+1d
    task core adds T·r² parameters."""
    for D, L in ((768, 12), (1024, 24)):
        for r in (8, 16, 32):
            assert (metatt.paper_count_4d(D, L, 2, r)
                    < lotr.paper_count(D, L, 2, r)
                    < lora.paper_count(D, L, 2, r)
                    == metatt.paper_count_lora(D, L, 2, r))
    c4 = _qv(metatt.MetaTTConfig, 768, 12, 8)
    c41 = _qv(metatt.MetaTTConfig, 768, 12, 8, variant="4+1d", num_tasks=3)
    assert c41.num_params() - c4.num_params() == 3 * 64


def test_metatt_5d_init_is_zero_and_materializes_like_jax():
    """MetaTT-5d: ΔW = 0 at init (``zero_at_init``); under random cores the
    dense ``materialize_delta`` equals the JAX one and the lora-form fold
    α·A·B (f32, 1e-5)."""
    jspec, spec, jp, tp, _, _ = _setup("metatt", "5d", 4)
    fresh = metatt.init_params(spec.cfg, device="cpu")
    assert metatt.zero_at_init(fresh, spec.cfg)
    assert not metatt.zero_at_init(tp["adapter"], spec.cfg)
    layer, m = 1, "attn_v"
    got = metatt.materialize_delta(tp["adapter"], spec.cfg, layer, m)
    want = jmetatt.materialize_delta(jp["adapter"], jspec.cfg, layer, m)
    assert _fro(got, want) <= 1e-5
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    a, b, alpha = tpeft.lora_form_factors(
        spec, bc, {k: v[layer] for k, v in pl.items()}, m)
    torch.testing.assert_close(alpha * a @ b, got, rtol=1e-5, atol=1e-7)


def test_4ed_raises_naming_the_moe_slice():
    """A dense model has no MoE expert down-projection: 4+ed's default
    matrices (q, v, moe_down) raise naming it, in both packages."""
    run = RunConfig(model=CFG, adapter_kind="metatt", adapter_variant="4+ed")
    with pytest.raises(ValueError, match="moe_down"):
        TM.build_adapter_spec(run)
    with pytest.raises(ValueError, match="moe_down"):
        JM.build_adapter_spec(JRunConfig(
            model=JCFG, shape=SHAPES["train_4k"], adapter_kind="metatt",
            adapter_variant="4+ed"))


def test_4ed_builds_reads_expert_slice_0_and_counts_like_jax():
    """4+ed on granite-moe-1b's smoke config: mode sizes (D, L, E, M, D)
    and parameter count equal to JAX's, ΔW = 0 at init, and under random
    cores the q / v delta (no task) is expert slice 0's — the dense
    ``materialize_delta`` and the lora-form fold equal the JAX delta of
    task 0 (f32, 1e-5)."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    common = dict(adapter_kind="metatt", adapter_variant="4+ed",
                  adapter_rank=4)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["train_4k"], **common))
    spec = TM.build_adapter_spec(RunConfig(model=cfg, **common))
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes == (64, 2, 4, 3, 64)
    assert spec.cfg.num_params() == jspec.cfg.num_params()
    fresh = metatt.init_params(spec.cfg, device="cpu")
    assert metatt.zero_at_init(fresh, spec.cfg)
    assert tpeft.count_trainable(spec, fresh) == jspec.cfg.num_params()
    jad = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4, scale=0.5)}
    tad = from_jax_numpy(jax.device_get(jad), device="cpu")
    bc, pl = tpeft.adapter_factors(spec, tad, {})
    layer = 1
    for m in ("attn_q", "attn_v"):
        want = jmetatt.materialize_delta(jad, jspec.cfg, layer, m, task=0)
        got = metatt.materialize_delta(tad, spec.cfg, layer, m)
        assert _fro(got, want) <= 1e-5
        a, b, alpha = tpeft.lora_form_factors(
            spec, bc, {k: v[layer] for k, v in pl.items()}, m)
        assert _fro(alpha * a @ b, want) <= 1e-5
        other = jmetatt.materialize_delta(jad, jspec.cfg, layer, m, task=2)
        assert _fro(got, other) > 1e-2


# ---------------------------------------------------------------------------
# loss, gradients and folds against the JAX package
# ---------------------------------------------------------------------------

def _runs(kind, variant, rank, **train):
    common = dict(adapter_kind=kind, adapter_variant=variant,
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    return (JRunConfig(model=JCFG, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=CFG, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


def _randomize(jspec, adapter):
    """Non-zero trainable leaves, so that every gradient is non-trivial
    (the zero inits of B, g, S and the first core would zero the others)."""
    if jspec.kind == "metatt":
        return {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes,
                                       jspec.cfg.rank, scale=0.2)}
    out = {}
    for i, (k, v) in enumerate(sorted(adapter.items())):
        out[k] = 0.1 * jax.random.normal(jax.random.fold_in(KEY, i),
                                         v.shape, v.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _base():
    """The JAX base ``model.init_params`` draws (its first key), made once
    for every kind, and the port's copy."""
    jbase = JT.init_base_params(JCFG, jax.random.split(KEY)[0])
    return jbase, from_jax_numpy(jax.device_get(jbase), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(kind, variant, rank):
    jrun, trun = _runs(kind, variant, rank)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    adapter, frozen = jpeft.init_adapter(jspec, jax.random.split(KEY)[1])
    jbase, tbase = _base()
    jp = {"base": jbase, "adapter": _randomize(jspec, adapter),
          "frozen": frozen}
    tp = dict(from_jax_numpy(jax.device_get(
        {"adapter": jp["adapter"], "frozen": frozen}), device="cpu"),
        base=tbase)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jspec, spec, jp, tp, tokens, mask


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _pairs(tree, jtree):
    """(port leaf, JAX leaf) in the same order."""
    return list(zip(TM.tensors(tree), jax.tree_util.tree_leaves(jtree)))


@pytest.mark.parametrize("kind,variant,rank", KINDS, ids=IDS)
def test_loss_and_adapter_grads_match_jax(kind, variant, rank):
    jspec, spec, jp, tp, tokens, mask = _setup(kind, variant, rank)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, JCFG, jspec)
    adapter = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                   else [c.clone().requires_grad_(True) for c in v])
               for k, v in tp["adapter"].items()}
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"], batch, CFG,
                         spec, device="cpu")
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    leaves = TM.tensors(adapter)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


@pytest.mark.parametrize("kind,variant,rank", KINDS, ids=IDS)
def test_lora_form_factors_match_jax(kind, variant, rank):
    jspec, spec, jp, tp, _, _ = _setup(kind, variant, rank)
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    for layer in range(CFG.num_layers):
        for m in spec.matrix_types:
            ja, jb, jalpha = jpeft.lora_form_factors(
                jspec, jbc, jax.tree_util.tree_map(lambda t: t[layer], jpl),
                m)
            a, b, alpha = tpeft.lora_form_factors(
                spec, bc, {k: v[layer] for k, v in pl.items()}, m)
            assert alpha == pytest.approx(float(jalpha))
            assert _fro(a, ja) <= 1e-5 and _fro(b, jb) <= 1e-5


@pytest.mark.parametrize("kind,variant,rank", KINDS, ids=IDS)
def test_trainer_tracks_the_jax_trainer(kind, variant, rank):
    jrun, trun = _runs(kind, variant, rank)

    def lm(pkg):
        return pkg(vocab_size=CFG.vocab_size, seq_len=16, batch=4, seed=11,
                   branching=2)
    jtr = JTrainer(run=jrun, data=lm(JLMStream), total_steps=10)
    tr = Trainer(run=trun, data=lm(LMStream), total_steps=10, device="cpu")
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "frozen": jtr.frozen,
         "adapter": jtr.state.adapter}), device="cpu")
    tr.base, tr.frozen = tp["base"], tp["frozen"]
    tr.state = tts.init_train_state(tp["adapter"])
    jtr.train()
    tr.train()
    a, b = tr.losses(), jtr.losses()
    assert (np.abs(a - b) / np.abs(b)).max() <= 1e-4, (a, b)
    for got, want in _pairs(tr.state.adapter, jtr.state.adapter):
        assert _fro(got, want) <= 1e-4
    # the adapter moved off its ΔW = 0 init
    assert any(float(t.abs().max()) > 0 for t in TM.tensors(
        tpeft.adapter_factors(tr.spec, tr.state.adapter, tr.frozen)[1]))
