"""Training granite-34b (MQA) and mistral-large-123b in the port against the
JAX package (f32, on the CPU).

Both train on the card through K1, #5 and the any-group #6 / #7
(``chip_smoke.py`` phase 15: granite's 48 query heads over one KV head,
mistral's 96 over 8); here the CPU tensors run their plain versions. On
each smoke config (G = 4) and on the variants of
``tests/test_torch_gqa_models.py`` with G = 12 (24 heads of 16 over 2)
and G = 48 (48 heads of 8 over 1), with weights made by the JAX package
(its PRNG) and carried across with ``repro_torch.convert.from_jax_numpy``:

* the MetaTT-4d q/v loss within 1e-5 (relative) of ``JM.loss_fn`` and its
  adapter gradients within 1e-4 (relative Frobenius) of
  ``jax.value_and_grad``'s, with a random non-zero adapter
  (``random_tt(scale=0.2)``) and a ragged mask, under the JAX reference
  path and its Pallas kernels in interpret mode; with remat per block too;
* ten ``Trainer`` steps with a DMRG sweep (6 -> 4 after epoch 1) against
  the JAX ``Trainer`` at G = 4, 48 (granite) and 12 (mistral): losses
  within 1e-4, 1e-3 after the sweep (as tests/test_torch_gemma_train.py),
  the same ranks and sweep epochs.

The plain backward itself at G = 12 and 48 is held to the JAX Pallas
backward in ``tests/test_torch_train_kernels.py``; the rule that cuts #7's
groups into slabs on the card (``dkv_slab_heads``) is checked here at the
training shapes of the zoo.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import TrainConfig as JTrainConfig
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import LMStream as JLMStream
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.train.trainer import Trainer as JTrainer

from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

from test_torch_gqa_models import ARCHS, VARIANTS, _configs

KEY = jax.random.PRNGKey(28)
OPT = dict(lr=2e-2, warmup_ratio=0.1)
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
CASES = [(a, v) for a in ARCHS for v in VARIANTS]
#: the Trainer's cases: G = 4 (granite's smoke config, gelu), 48 (MQA)
#: and 12 (mistral's SwiGLU), one each to keep the file near a minute
TRAINER_CASES = [("granite-34b", "smoke"), ("granite-34b", "g48"),
                 ("mistral-large-123b", "g12")]


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _runs(arch, variant, rank, **train):
    """The same RunConfig for both packages: ``arch``'s smoke config
    (``variant``: its group changed), MetaTT 4d on q/v."""
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    jcfg, cfg = _configs(arch, variant)
    assert cfg.param_dtype == torch.float32
    if variant != "smoke":
        assert cfg.q_dim != cfg.d_model
        assert cfg.num_heads // cfg.num_kv_heads == int(variant[1:])
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


@functools.lru_cache(maxsize=None)
def _setup(arch, variant):
    jrun, trun = _runs(arch, variant, 4)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jrun.model, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(len(arch) + 7 * len(variant))
    tokens = rng.integers(0, trun.model.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jrun, trun, jspec, spec, jp, tp, tokens, mask


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, variant, jpolicy):
    jrun, _, jspec, _, jp, _, tokens, mask = _setup(arch, variant)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    loss_fn = functools.partial(JM.loss_fn, policy=POLICIES[jpolicy])
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, jrun.model, jspec)
    return float(jl), jax.tree_util.tree_leaves(jg)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("jpolicy", sorted(POLICIES))
@pytest.mark.parametrize("arch,variant", CASES)
def test_loss_and_adapter_grads_match_jax(arch, variant, jpolicy, remat):
    _, trun, _, spec, _, tp, tokens, mask = _setup(arch, variant)
    jl, jleaves = _jax_grads(arch, variant, jpolicy)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"], batch,
                         trun.model, spec, remat=remat, device="cpu")
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jleaves) == 4
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


@pytest.mark.parametrize("arch,variant", TRAINER_CASES)
def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer(arch, variant):
    """Ten steps, one warm-moment sweep 6 -> 4 after epoch 1 (step 3)."""
    jrun, trun = _runs(arch, variant, 6)

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


@pytest.mark.parametrize("shape,heads", [
    ((4, 1024, 1, 48, 128), 6),     # granite-34b: 64 blocks -> 8 slabs
    ((4, 1000, 1, 48, 128), 6),     # its ragged T
    ((4, 1024, 8, 12, 128), 12),    # mistral-large: 512 blocks, unsplit
    ((4, 1024, 32, 1, 64), 1),      # stablelm-1.6b
    ((4, 1024, 16, 1, 256), 1),     # gemma-7b (one block an SM)
    ((1, 200, 1, 96, 256), 1),      # a short MQA batch: 4 blocks
])
def test_dkv_slab_heads_fill_an_h100(shape, heads):
    """#7's heads a block on an H100's 132 SMs: the whole group while the
    unsplit blocks fill the resident slots, else the largest divisor of G
    that makes at least ⌊2 · slots / blocks⌋ slabs."""
    b, s, kv, g, d = shape
    got = tfa.dkv_slab_heads(b, s, kv, g, d, 132)
    assert got == heads and g % got == 0
    blocks = b * kv * -(-s // tfa.DKV_ROWS)
    slots = (1 if d == 256 else 2) * 132
    assert (got == g) == (blocks >= slots)
    assert got == g or g // got >= min(g, 2 * slots // blocks)
