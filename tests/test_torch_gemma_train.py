"""Training gemma-7b in the port against the JAX package (f32, on the CPU).

gemma-7b (GeGLU with tanh gelu, the (1 + w) RMS norm, heads of 256, so
q_dim != d_model) is trained on the card through K1 and the head_dim 256
instances of #5, #6 and #7 (``chip_smoke.py`` phase 13); here the CPU
tensors run their plain versions. On the gemma smoke config (2 layers,
d_model 64, 4 heads, f32) at head_dim 32 and 256, with weights made by
the JAX package (its PRNG) and carried across with
``repro_torch.convert.from_jax_numpy``:

* the MetaTT-4d q/v loss within 1e-5 (relative) of ``JM.loss_fn`` and its
  adapter gradients within 1e-4 (relative Frobenius) of
  ``jax.value_and_grad``'s, with a random non-zero adapter
  (``random_tt(scale=0.2)``) and a ragged mask; with remat per block too;
* ten ``Trainer`` steps with a DMRG sweep (6 -> 4 after epoch 1) against
  the JAX ``Trainer``: losses within 1e-4, 1e-3 after the sweep (as
  tests/test_torch_train.py), the same ranks and sweep epochs;
* the launcher trains gemma-7b's smoke config on the CPU.
"""
import dataclasses
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
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import LMStream as JLMStream
from repro.models import model as JM
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

ARCH = "gemma-7b"
KEY = jax.random.PRNGKey(26)
OPT = dict(lr=2e-2, warmup_ratio=0.1)
HEAD_DIMS = [32, 256]


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _runs(head_dim, rank, **train):
    """The same RunConfig for both packages: gemma's smoke config at
    ``head_dim``, MetaTT 4d on q/v."""
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               head_dim=head_dim)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              head_dim=head_dim)
    assert cfg.param_dtype == torch.float32 and cfg.q_dim != cfg.d_model
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


@functools.lru_cache(maxsize=None)
def _setup(head_dim):
    jrun, trun = _runs(head_dim, 4)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jrun.model, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(head_dim)
    vocab = trun.model.vocab_size
    tokens = rng.integers(0, vocab, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jrun, trun, jspec, spec, jp, tp, tokens, mask


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_loss_and_adapter_grads_match_jax(head_dim, remat):
    jrun, trun, jspec, spec, jp, tp, tokens, mask = _setup(head_dim)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, jrun.model, jspec)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"], batch,
                         trun.model, spec, remat=remat, device="cpu")
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves) == 4
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer(head_dim):
    """Ten steps, one warm-moment sweep 6 -> 4 after epoch 1 (step 3)."""
    jrun, trun = _runs(head_dim, 6)

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


def test_launcher_trains_gemma_on_the_cpu():
    hist = tlaunch.main(["--arch", ARCH, "--steps", "2", "--device", "cpu"])
    assert len(hist) == 2
    assert np.isfinite([m["loss"] for _, m in hist]).all()
