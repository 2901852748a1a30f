"""Training MetaTT-(4+E)D on the MoE models in the port against the JAX
package (f32, on the CPU).

granite-moe-1b trains on the card with q / v through K1, #5, #6 and #7
and the 4+ed ``moe_down`` delta in plain PyTorch (``chip_smoke.py``
phase 16); here the CPU tensors run the plain versions. On the smoke
configs of ``tests/test_torch_moe.py`` (weights made by the JAX package,
carried across with ``repro_torch.convert.from_jax_numpy``):

* the loss — CE plus ``aux_weight`` · Σ aux (load balance, router z,
  summed over layers), with aux weights 0 and 0.01 — within 1e-5
  (relative) of ``JM.loss_fn``, its aux metrics too, and the 4+ed
  adapter gradients (q, v and the expert-indexed ``moe_down``) within
  1e-4 (relative Frobenius) of ``jax.value_and_grad``'s, under the JAX
  reference path (plain and with remat per block) and its Pallas kernels
  in interpret mode (aux weight 0.01);
* ten ``Trainer`` steps on granite-moe with a DMRG sweep 6 -> 4 after
  epoch 1 on the 5-core 4+ed TT (the expert axis a bond site like 4+1d's task axis),
  against the JAX ``Trainer``: losses within 1e-4, 1e-3 after the sweep,
  the same ranks and sweep epochs;
* a 4+ed run that fails after its post-sweep checkpoint resumes on the
  reshaped 5-core TT and its transported moments, and ends on the
  uninterrupted run's cores (1e-5).
"""
import dataclasses
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
from repro_torch.core import tt
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure)
from repro_torch.models import model as TM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

from test_torch_moe import ARCHS, GRANITE, _configs

KEY = jax.random.PRNGKey(30)
OPT = dict(lr=2e-2, warmup_ratio=0.1)
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _runs(arch, rank, aux, **train):
    """The same RunConfig for both packages: ``arch``'s smoke config at
    aux weight ``aux``, MetaTT 4+ed on q, v and moe_down."""
    common = dict(adapter_kind="metatt", adapter_variant="4+ed",
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    jcfg, cfg = _configs(arch, moe_aux_weight=aux)
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


@functools.lru_cache(maxsize=None)
def _setup(arch, aux):
    jrun, trun = _runs(arch, 4, aux)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.matrix_types == ("attn_q", "attn_v", "moe_down")
    jp = JM.init_params(jrun.model, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, trun.model.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jrun, trun, jspec, spec, jp, tp, tokens, mask


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, aux, jpolicy):
    jrun, _, jspec, _, jp, _, tokens, mask = _setup(arch, aux)
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    loss_fn = functools.partial(JM.loss_fn, policy=POLICIES[jpolicy])
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                           static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, jrun.model, jspec)
    return float(jl), {k: float(v) for k, v in jm.items()}, \
        jax.tree_util.tree_leaves(jg)


#: (aux weight, JAX policy, remat): remat and aux weight 0 on the JAX
#: reference leg; the Pallas kernels in interpret mode once, with the aux
#: terms in the loss
GRAD_CASES = [(aux, "ref", remat) for aux in (0.0, 0.01)
              for remat in (False, True)] + [(0.01, "pallas_interpret",
                                              False)]


@pytest.mark.parametrize("aux,jpolicy,remat", GRAD_CASES, ids=[
    f"{a}-{j}-{'remat' if r else 'plain'}" for a, j, r in GRAD_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_adapter_grads_match_jax(arch, aux, jpolicy, remat):
    _, trun, _, spec, _, tp, tokens, mask = _setup(arch, aux)
    jl, jm, jleaves = _jax_grads(arch, aux, jpolicy)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    loss, metrics = TM.loss_fn(adapter, tp["base"], tp["frozen"], batch,
                               trun.model, spec, remat=remat, device="cpu")
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    assert sorted(metrics) == sorted(jm)
    assert len(metrics) == (3 if aux else 1)
    for k, v in metrics.items():
        assert abs(float(v.detach()) - jm[k]) <= 1e-5 * abs(jm[k]), k
    if aux:       # the aux terms enter the loss at their weight
        assert float(loss) > float(metrics["ce"])
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jleaves) == 5
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


def test_aux_weight_override_matches_jax():
    """``loss_fn(aux_weight=0)`` drops the aux terms from the loss but
    still reports them, as the JAX package does."""
    jrun, trun, jspec, spec, jp, tp, tokens, mask = _setup(GRANITE, 0.01)
    jl, jm = JM.loss_fn(jp["adapter"], jp["base"], jp["frozen"],
                        {"tokens": jnp.asarray(tokens),
                         "mask": jnp.asarray(mask)}, jrun.model, jspec,
                        aux_weight=0.0)
    loss, metrics = TM.loss_fn(tp["adapter"], tp["base"], tp["frozen"],
                               {"tokens": torch.from_numpy(tokens),
                                "mask": torch.from_numpy(mask)},
                               trun.model, spec, aux_weight=0.0,
                               device="cpu")
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(loss) == float(metrics["ce"])
    assert sorted(metrics) == sorted(jm) == ["ce", "load_balance",
                                             "router_z"]


@pytest.mark.parametrize("arch", [GRANITE])
def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer(arch):
    """Ten 4+ed steps (aux weight 0.01 in the loss), one warm-moment sweep
    6 -> 4 after epoch 1 (step 3) over the 5-core TT (on granite-moe:
    kimi-k2's loss and gradients are held above)."""
    jrun, trun = _runs(arch, 6, 0.01)

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
    assert ranks[0] == ranks[1] == (4, 4, 4, 4)
    a, b = tr.losses(), jtr.losses()
    rel = np.abs(a - b) / np.abs(b)
    assert rel[:3].max() <= 1e-4 and rel[3:].max() <= 1e-3, rel
    assert np.isfinite(a).all() and tr.state.opt.step == 10
    assert {"load_balance", "router_z"} <= set(tr.history[-1][1])


def test_4ed_checkpoint_resume_lands_on_the_post_sweep_cores(tmp_path):
    """granite-moe's smoke config, 4+ed from rank 6 with a sweep to 4
    after epoch 1 (step 3) and a checkpoint every 3 steps: a run that
    fails at step 5 resumes from step 3's post-sweep 5-core TT, its
    transported moments and the data position, never replays the sweep,
    and ends on the uninterrupted run's cores."""
    _, trun = _runs(GRANITE, 6, 0.01)
    d = str(tmp_path / "ck")

    def run(ckpt_dir="", fail_at=None):
        r = dataclasses.replace(trun, train=dataclasses.replace(
            trun.train, ckpt_dir=ckpt_dir, ckpt_every=3 if ckpt_dir else 0))
        return Trainer(run=r, data=LMStream(
            vocab_size=trun.model.vocab_size, seq_len=16, batch=4, seed=11,
            branching=2), total_steps=8, steps_per_epoch=3,
            rank_schedule=RankSchedule(milestones=((1, 4),)), device="cpu",
            failure_injector=None if fail_at is None
            else FailureInjector(fail_at_step=fail_at))
    full = run()
    full.train()
    a = run(d, fail_at=5)
    with pytest.raises(SimulatedFailure):
        a.train()
    b = run(d)
    assert b.state.step == 3 and b.state.opt.step == 3
    assert tt.ranks(b.state.adapter["cores"]) == (4, 4, 4, 4)
    assert b._dmrg_applied == [1]
    for m, p in zip(TM.tensors(b.state.opt.mu), TM.tensors(b.state.adapter)):
        assert m.shape == p.shape
    b.train()
    assert b.state.step == 8
    for x, y in zip(full.state.adapter["cores"], b.state.adapter["cores"]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
