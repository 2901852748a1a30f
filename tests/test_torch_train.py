"""The port's training slice against the JAX package on smoke stablelm.

f32 weights made by the JAX package are carried across with
``convert.from_jax_numpy`` and installed in the port's ``Trainer`` by
assigning ``tr.base``, ``tr.frozen`` and ``tr.state``; both trainers read
the same synthetic stream (the port's ``data/synthetic.py`` is a copy).
The JAX trainer runs its reference path (``KernelConfig()`` on the CPU);
the port runs its kernel Functions, whose every step takes the plain
version on the CPU.

Tolerances: the loss and its adapter gradients 1e-5 relative (the
gradients in Frobenius norm; f32, the same algorithm with sums in another
order); ten trainer steps 1e-4 on the
losses and the final cores (Adam divides each gradient by its own running
magnitude, which magnifies the 1e-7 summation-order differences of small
entries); after a DMRG sweep 1e-3 on the losses (the SVDs of the two
backends agree to ~1e-6 and their sign conventions differ per bond).
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
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import ClassificationTasks as JClassificationTasks
from repro.data import LMStream as JLMStream
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import ClassificationTasks, LMStream
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

JCFG = jconfigs.get_smoke_config("stablelm-1.6b")
CFG = tconfigs.get_smoke_config("stablelm-1.6b")
KEY = jax.random.PRNGKey(5)
OPT = dict(lr=2e-2, warmup_ratio=0.1)


def _runs(variant="4d", rank=4, num_tasks=0, **train):
    """The same RunConfig for both packages."""
    common = dict(adapter_kind="metatt", adapter_variant=variant,
                  adapter_rank=rank, adapter_alpha=4.0, num_tasks=num_tasks)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    return (JRunConfig(model=JCFG, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=CFG, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


def _lm(pkg):
    return pkg(vocab_size=CFG.vocab_size, seq_len=32, batch=8, seed=11,
               branching=2)


def _install(ttr, jtr):
    """The JAX trainer's weights into the port's trainer."""
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "frozen": jtr.frozen,
         "adapter": jtr.state.adapter}), device="cpu")
    ttr.base, ttr.frozen = tp["base"], tp["frozen"]
    ttr.state = tts.init_train_state(tp["adapter"])


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _fro(got, want) -> float:
    """Relative Frobenius distance ||got - want|| / ||want||."""
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _losses_rel(tr, jtr) -> np.ndarray:
    a, b = tr.losses(), jtr.losses()
    assert a.shape == b.shape
    return np.abs(a - b) / np.abs(b)


# ---------------------------------------------------------------------------
# the objective and its adapter gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _loss_setup(variant):
    jrun, trun = _runs(variant=variant, rank=4,
                       num_tasks=3 if variant == "4+1d" else 0)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(JCFG, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jspec, spec, jp, tp, tokens, mask


@pytest.mark.parametrize("variant", ["4d", "4+1d"])
@pytest.mark.parametrize("jpolicy", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("tpolicy", ["default", "ref"])
def test_loss_and_adapter_grads_match_jax(variant, jpolicy, tpolicy):
    jspec, spec, jp, tp, tokens, mask = _loss_setup(variant)
    task = {"task": 2} if variant == "4+1d" else {}
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask),
              **{k: jnp.int32(v) for k, v in task.items()}}
    (jl, _), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp["adapter"], jp["base"], jp["frozen"], jbatch, JCFG, jspec,
        policy=None if jpolicy == "ref" else jdispatch.PALLAS_INTERPRET)
    cores = [c.clone().requires_grad_(True) for c in tp["adapter"]["cores"]]
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask), **task}
    loss, metrics = TM.loss_fn(
        {"cores": cores}, tp["base"], tp["frozen"], batch, CFG, spec,
        policy=tdispatch.REF if tpolicy == "ref" else None, device="cpu")
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert metrics["ce"] is loss
    grads = torch.autograd.grad(loss, cores)
    for g, want in zip(grads, jg["cores"]):
        assert _fro(g, want) <= 1e-5


def test_loss_with_remat_equals_without():
    """Remat recomputes each super-block in the backward: the same loss
    and gradients, and the recomputation runs the kernel Functions'
    forwards a second time (as the launch counts show on the card)."""
    _, spec, _, tp, tokens, mask = _loss_setup("4d")
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    calls = {"fwd": 0}
    orig = tops.flash_attention_fwd

    def counted(*a, **k):
        calls["fwd"] += 1
        return orig(*a, **k)
    out = []
    for remat in (False, True):
        cores = [c.clone().requires_grad_(True)
                 for c in tp["adapter"]["cores"]]
        calls["fwd"] = 0
        tops.flash_attention_fwd = counted
        try:
            loss, _ = TM.loss_fn({"cores": cores}, tp["base"], tp["frozen"],
                                 batch, CFG, spec, remat=remat, device="cpu")
            grads = torch.autograd.grad(loss, cores)
        finally:
            tops.flash_attention_fwd = orig
        out.append((loss, grads, calls["fwd"]))
    (l0, g0, n0), (l1, g1, n1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert n0 == CFG.num_layers and n1 == 2 * CFG.num_layers


def test_next_token_loss_masks_padded_vocab_and_positions():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(
        np.float32))
    tokens = torch.from_numpy(rng.integers(0, 6, (2, 5)))
    mask = torch.tensor([[1, 1, 0, 1, 1], [1, 1, 1, 1, 0]],
                        dtype=torch.float32)
    got = TM.next_token_loss(logits, tokens, mask, vocab_size=6)
    want = JM.next_token_loss(jnp.asarray(logits.numpy()),
                              jnp.asarray(tokens.numpy()),
                              jnp.asarray(mask.numpy()), vocab_size=6)
    assert abs(float(got) - float(want)) <= 1e-6
    lp = torch.log_softmax(logits[:, :-1, :6], -1)
    nll = -lp.gather(-1, tokens[:, 1:, None])[..., 0] * mask[:, 1:]
    assert abs(float(got) - float(nll.sum() / mask[:, 1:].sum())) <= 1e-6


def test_count_params_and_trainable_match_jax():
    jspec, spec, jp, tp, _, _ = _loss_setup("4+1d")
    from repro.peft import api as jpeft
    from repro_torch.peft import api as tpeft
    assert TM.count_params(tp) == JM.count_params(jp)
    assert tpeft.count_trainable(spec, tp["adapter"]) == \
        jpeft.count_trainable(jspec, jp["adapter"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _fresh_jax(jrun, data, steps, **kw):
    return JTrainer(run=jrun, data=data, total_steps=steps, **kw)


def test_trainer_tracks_the_jax_trainer():
    jrun, trun = _runs()
    jtr = _fresh_jax(jrun, _lm(JLMStream), 10)
    tr = Trainer(run=trun, data=_lm(LMStream), total_steps=10, device="cpu")
    _install(tr, jtr)
    jtr.train()
    tr.train()
    assert len(tr.history) == 10 and tr.state.step == 10
    assert tr.state.opt.step == 10
    assert _losses_rel(tr, jtr).max() <= 1e-4, (tr.losses(), jtr.losses())
    for c, jc in zip(tr.state.adapter["cores"], jtr.state.adapter["cores"]):
        assert _rel(c, jc) <= 1e-4
    for k in ("grad_norm", "lr", "ce"):
        got = np.array([m[k] for _, m in tr.history])
        want = np.array([m[k] for _, m in jtr.history])
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.mean(tr.losses()[-3:]) < np.mean(tr.losses()[:3])


def test_trainer_dmrg_schedule_matches_jax():
    """One warm-moment sweep after epoch 1: the same ranks, and the
    post-sweep losses track."""
    jrun, trun = _runs(rank=6)
    jtr = _fresh_jax(jrun, _lm(JLMStream), 7, steps_per_epoch=3,
                     rank_schedule=JRankSchedule(milestones=((1, 4),)))
    tr = Trainer(run=trun, data=_lm(LMStream), total_steps=7,
                 steps_per_epoch=3,
                 rank_schedule=RankSchedule(milestones=((1, 4),)),
                 device="cpu")
    _install(tr, jtr)
    jtr.train()
    tr.train()
    ranks = [tuple(c.shape[-1] for c in t.state.adapter["cores"][:-1])
             for t in (tr, jtr)]
    assert ranks[0] == ranks[1] == (4, 4, 4)
    assert tr._dmrg_applied == jtr._dmrg_applied == [1]
    rel = _losses_rel(tr, jtr)
    assert rel[:3].max() <= 1e-4 and rel[3:].max() <= 1e-3, rel
    # the carried step counter: the schedule did not rewind
    assert tr.state.opt.step == 7


def test_trainer_4plus1d_task_cycle_matches_jax():
    jrun, trun = _runs(variant="4+1d", rank=4, num_tasks=3)

    def tasks(pkg):
        return pkg(vocab_size=CFG.vocab_size, seq_len=8, batch=8,
                   num_tasks=3, seed=9)
    jtr = _fresh_jax(jrun, tasks(JClassificationTasks), 6,
                     task_cycle=(0, 1, 2))
    tr = Trainer(run=trun, data=tasks(ClassificationTasks), total_steps=6,
                 task_cycle=(0, 1, 2), device="cpu")
    _install(tr, jtr)
    jtr.train()
    tr.train()
    assert _losses_rel(tr, jtr).max() <= 1e-4
    for c, jc in zip(tr.state.adapter["cores"], jtr.state.adapter["cores"]):
        assert _rel(c, jc) <= 1e-4


def test_microbatch_accumulation_equals_the_full_batch():
    outs = []
    for nmb in (0, 2):
        _, trun = _runs(microbatch=nmb)
        tr = Trainer(run=trun, data=_lm(LMStream), total_steps=3,
                     device="cpu")
        tr.train()
        outs.append(tr)
    np.testing.assert_allclose(outs[0].losses(), outs[1].losses(),
                               rtol=1e-5)
    for a, b in zip(outs[0].state.adapter["cores"],
                    outs[1].state.adapter["cores"]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)


def test_remat_on_and_off_train_alike():
    outs = []
    for remat in ("none", "block"):
        _, trun = _runs(remat=remat)
        tr = Trainer(run=trun, data=_lm(LMStream), total_steps=3,
                     device="cpu")
        tr.train()
        outs.append(tr)
    np.testing.assert_allclose(outs[0].losses(), outs[1].losses(),
                               rtol=1e-6)
    for a, b in zip(outs[0].state.adapter["cores"],
                    outs[1].state.adapter["cores"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("train", [{"grad_compression": "int8"},
                                   {"train_base": True}])
def test_unported_train_options_raise(train):
    """Both options are ported now (``distributed/compression.py``;
    ``train_base`` is read by ``make_full_ft_step``, and the adapter
    Trainer ignores it as the JAX one does): the Trainer takes them and
    trains a finite step. What still raises is an unknown compression."""
    _, trun = _runs(**train)
    tr = Trainer(run=trun, data=_lm(LMStream), total_steps=1, device="cpu")
    tr.train()
    assert np.isfinite(tr.losses()).all()
    _, bad = _runs(grad_compression="fp4")
    with pytest.raises(ValueError):
        Trainer(run=bad, data=_lm(LMStream), total_steps=1, device="cpu")


def test_trainer_defaults_to_cuda_and_base_stays_frozen():
    _, trun = _runs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Trainer(run=trun, data=_lm(LMStream), total_steps=1)
    tr = Trainer(run=trun, data=_lm(LMStream), total_steps=2, device="cpu")
    tr.train()
    assert not any(t.requires_grad for t in TM.tensors(tr.base))
    tr.base["embed"]["tok"].requires_grad_(True)
    with pytest.raises(ValueError, match="requires_grad"):
        tr.train(3)


def test_launcher_trains_on_the_cpu(capsys):
    hist = tlaunch.main(["--arch", "stablelm-1.6b", "--steps", "4",
                         "--device", "cpu", "--dmrg-start-rank", "10",
                         "--rank", "8", "--steps-per-epoch", "2"])
    assert len(hist) == 4
    out = capsys.readouterr().out
    assert "DMRG sweep @step 2: ranks -> (8, 8, 8)" in out
    assert np.isfinite([m["loss"] for _, m in hist]).all()


def test_data_streams_are_identical():
    a, b = _lm(LMStream), _lm(JLMStream)
    for _ in range(2):
        x, y = next(a), next(b)
        assert np.array_equal(x["tokens"], y["tokens"])
    c = ClassificationTasks(vocab_size=64, seq_len=6, batch=4, num_tasks=3)
    d = JClassificationTasks(vocab_size=64, seq_len=6, batch=4, num_tasks=3)
    assert np.array_equal(c.sample(1)["tokens"], d.sample(1)["tokens"])
