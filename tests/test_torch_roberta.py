"""RoBERTa-base / -large, the paper's own fine-tuning targets, in the port
against the JAX package (f32, on the CPU).

* ``get_config`` / ``get_smoke_config`` for both ids equal the JAX configs
  field by field (dtypes mapped).
* On the RoBERTa smoke model (layernorm with a bias, gelu, f32; weights
  made by the JAX package and carried across with
  ``convert.from_jax_numpy``): forward logits and caches at 1e-5 of the
  largest value, under a MetaTT-4d adapter of ``random_tt(scale=0.2)``
  (ΔW ≈ 1.6x the base q projection; at scale 0.5 ΔW is ~60x W and the
  f32 summation-order differences grow to ~1.4e-5); the loss (1e-5
  relative) and the adapter gradients (1e-4 relative Frobenius) for each
  Table 1 kind; ten ``Trainer`` steps with a DMRG sweep against the JAX
  ``Trainer`` (1e-4; 1e-3 after the sweep, as tests/test_torch_train.py).
* ``count_trainable`` at full roberta-base / -large widths equals the JAX
  count, the paper's closed form and Table 1's column for every row of
  ``benchmarks/bench_table1.py``.
* The launcher trains roberta-base on the CPU.
"""
import dataclasses
import functools
import pathlib
import sys

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
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import LMStream as JLMStream
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import metatt
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.peft import lora, lotr, vera
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:          # benchmarks/ is a package at the root
    sys.path.insert(0, str(ROOT))
from benchmarks import bench_table1  # noqa: E402

IDS = ["roberta-base", "roberta-large"]
KEY = jax.random.PRNGKey(11)
OPT = dict(lr=2e-2, warmup_ratio=0.1)
#: (kind, variant, rank) of each Table 1 adapter kind at smoke width
KINDS = [("metatt", "4d", 4), ("metatt", "5d", 4), ("lora", "4d", 4),
         ("vera", "4d", 16), ("lotr", "4d", 8)]
KIND_IDS = ["metatt-4d", "metatt-5d", "lora", "vera", "lotr"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", IDS)
def test_configs_match_jax_field_by_field(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
    assert arch in tconfigs.ALL_IDS
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        want = DTYPES.get(want, want)
        assert getattr(cfg, f.name) == want, f.name
    assert cfg.param_dtype == cfg.compute_dtype == torch.float32
    assert (cfg.norm_kind, cfg.mlp) == ("layernorm", "gelu")
    assert cfg.padded_vocab == jcfg.padded_vocab
    if not smoke:
        assert (cfg.num_layers, cfg.d_model) == \
            {"roberta-base": (12, 768), "roberta-large": (24, 1024)}[arch]
    TT.check_supported(cfg)


# ---------------------------------------------------------------------------
# the smoke model against the JAX model
# ---------------------------------------------------------------------------


def _runs(arch, kind, variant, rank, **train):
    """The same RunConfig for both packages, on the RoBERTa smoke config."""
    common = dict(adapter_kind=kind, adapter_variant=variant,
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    return (JRunConfig(model=jconfigs.get_smoke_config(arch),
                       shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=tconfigs.get_smoke_config(arch),
                      optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


def _randomize(jspec, adapter):
    """Non-zero trainable leaves (the zero inits of the first core, B, g
    and S would zero the other gradients)."""
    if jspec.kind == "metatt":
        return {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes,
                                       jspec.cfg.rank, scale=0.2)}
    return {k: 0.1 * jax.random.normal(jax.random.fold_in(KEY, i), v.shape,
                                       v.dtype)
            for i, (k, v) in enumerate(sorted(adapter.items()))}


@functools.lru_cache(maxsize=None)
def _setup(arch, kind, variant, rank):
    jrun, trun = _runs(arch, kind, variant, rank)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jrun.model, jspec, KEY)
    jp["adapter"] = _randomize(jspec, jp["adapter"])
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, trun.model.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jrun, trun, jspec, spec, jp, tp, tokens, mask


@pytest.mark.parametrize("tpolicy", ["default", "ref"])
@pytest.mark.parametrize("jpolicy", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("arch", IDS)
def test_forward_logits_and_caches_match_jax(arch, jpolicy, tpolicy):
    jrun, trun, jspec, spec, jp, tp, tokens, _ = _setup(arch, "metatt",
                                                        "4d", 4)
    assert tp["base"]["embed"]["tok"].dtype == torch.float32
    assert set(tp["base"]["blocks"][0]["norm1"]) == {"w", "b"}
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    want = JT.forward(jp["base"], jrun.model, jspec, jbc, jpl,
                      jnp.asarray(tokens), return_caches=True,
                      policy=None if jpolicy == "ref"
                      else jdispatch.PALLAS_INTERPRET)
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    got = TT.forward(tp["base"], trun.model, spec, bc, pl, tokens,
                     return_caches=True,
                     policy=tdispatch.REF if tpolicy == "ref" else None,
                     device="cpu")
    assert got.logits.dtype == torch.float32
    assert _rel(got.logits, want.logits) < 1e-5
    for gc, wc in zip(got.caches, want.caches):
        for name in ("k", "v"):
            assert _rel(gc["self"][name], wc["self"][name]) < 1e-5


@pytest.mark.parametrize("kind,variant,rank", KINDS, ids=KIND_IDS)
def test_loss_and_adapter_grads_match_jax(kind, variant, rank):
    jrun, trun, jspec, spec, jp, tp, tokens, mask = _setup(
        "roberta-base", kind, variant, rank)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, jrun.model, jspec)
    adapter = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                   else [c.clone().requires_grad_(True) for c in v])
               for k, v in tp["adapter"].items()}
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"], batch,
                         trun.model, spec, device="cpu")
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


@pytest.mark.parametrize("arch", IDS)
def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer(arch):
    """Ten steps, one warm-moment sweep 6 -> 4 after epoch 1 (step 3)."""
    jrun, trun = _runs(arch, "metatt", "4d", 6)

    def lm(pkg):
        return pkg(vocab_size=trun.model.vocab_size, seq_len=16, batch=4,
                   seed=11, branching=2)
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
    ranks = [tuple(c.shape[-1] for c in t.state.adapter["cores"][:-1])
             for t in (tr, jtr)]
    assert ranks[0] == ranks[1] == (4, 4, 4)
    a, b = tr.losses(), jtr.losses()
    rel = np.abs(a - b) / np.abs(b)
    assert rel[:3].max() <= 1e-4 and rel[3:].max() <= 1e-3, rel
    assert np.isfinite(a).all() and tr.state.opt.step == 10


# ---------------------------------------------------------------------------
# Table 1's trainable counts at full width
# ---------------------------------------------------------------------------

CLOSED = {"lora": lambda c, r: lora.paper_count(c.d_model, c.num_layers, 2,
                                                r),
          "vera": lambda c, r: vera.paper_count(c.d_model, c.num_layers, 2,
                                                r),
          "lotr": lambda c, r: lotr.paper_count(c.d_model, c.num_layers, 2,
                                                r),
          "metatt-4d": lambda c, r: metatt.paper_count_4d(
              c.d_model, c.num_layers, 2, r),
          "metatt-5d": lambda c, r: metatt.paper_count_5d(
              c.d_model, c.num_heads, c.num_layers, 2, r)}
TABLE1 = [("roberta-base", *row) for row in bench_table1.TABLE1_BASE] + \
    [("roberta-large", *row) for row in bench_table1.TABLE1_LARGE]


@pytest.mark.parametrize("arch,method,rank,count,paper_k", TABLE1,
                         ids=[f"{a}-{m}-r{r}" for a, m, r, _, _ in TABLE1])
def test_count_trainable_at_full_width_matches_jax_and_table1(
        arch, method, rank, count, paper_k):
    kind, _, variant = method.partition("-")
    kw = dict(adapter_kind=kind, adapter_variant=variant or "4d",
              adapter_rank=rank)
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    spec = TM.build_adapter_spec(RunConfig(model=cfg, **kw))
    jspec = JM.build_adapter_spec(JRunConfig(model=jcfg,
                                             shape=SHAPES["train_4k"], **kw))
    adapter, _ = tpeft.init_adapter(spec, torch.Generator().manual_seed(0),
                                    device="cpu")
    jadapter, _ = jpeft.init_adapter(jspec, KEY)
    n = tpeft.count_trainable(spec, adapter)
    assert n == jpeft.count_trainable(jspec, jadapter) == count \
        == CLOSED[method](cfg, rank)
    assert abs(n / 1000 - paper_k) < 1.0


def test_launcher_trains_roberta_on_the_cpu():
    hist = tlaunch.main(["--arch", "roberta-base", "--steps", "2",
                         "--device", "cpu"])
    assert len(hist) == 2
    assert np.isfinite([m["loss"] for _, m in hist]).all()
