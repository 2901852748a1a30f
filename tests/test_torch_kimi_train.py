"""Training kimi-k2 (heads of 112) in the port against the JAX package (CPU).

kimi-k2 trains on the card through K1, #5 and the d = 112 instances of
#6 and #7 (the d = 128 kernels on tiles padded in shared memory;
``chip_smoke.py`` phase 18). Here, with inputs made with numpy from a
seed and weights made by the JAX package:

* the plain version of the flash backward (#6 / #7) — what the card
  holds those instances to — at d = 112 and G = 8 against the JAX Pallas
  backward in interpret mode and its reference: each gradient within
  1e-5 (f32) or 2e-2 (bf16, the JAX package's bf16 gradient limit) of
  its largest value; with large q·k (q x 4) a backward
  whose softmax is scaled by 128^-0.5 (the tile width's) instead of
  112^-0.5 misses that limit;
* kimi-k2's smoke config widened to heads of 112 (``test_torch_kimi.py``'s
  d_model 896, 8 heads over 1 KV head, 2 layers, 8 experts, one shared),
  MetaTT-(4+E)D on q, v and ``moe_down``: the loss with the aux terms
  (weight 0.01) within 1e-5 of ``JM.loss_fn`` and the adapter gradients
  within 1e-4 (relative Frobenius) of ``jax.value_and_grad``'s, under the
  JAX reference path (plain and with remat per block) and under its
  Pallas kernels in interpret mode;
* ten ``Trainer`` steps with a DMRG sweep (6 -> 4 after epoch 1) against
  the JAX ``Trainer``, on that model narrowed to one head of 112: losses
  within 1e-4, 1e-3 after the sweep, the same ranks and sweep epochs.
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
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

from test_torch_kimi import D, KEY, KIMI, OVER, _np, _pair, _wrong_scale

OPT = dict(lr=2e-2, warmup_ratio=0.1)
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
AUX = 0.01


# ---------------------------------------------------------------------------
# the plain #6 / #7 at d = 112 against the Pallas backward
# ---------------------------------------------------------------------------

#: (B, T, H, d) queries over (B, S, KV, d) keys: G = 8, kimi-k2's group;
#: T = 70 crosses the Pallas kernel's tiles
Q_SHAPE, KV_SHAPE = (1, 70, 8, D), (1, 70, 1, D)
BWD_CASES = [pytest.param(dt, causal, qs, id=f"{dt}-{causal}-q{qs}")
             for dt, causal, qs in (("f32", True, 1.0), ("bf16", True, 1.0),
                                    ("f32", False, 1.0), ("f32", True, 4.0),
                                    ("bf16", True, 4.0))]


def _err(got, want, dt) -> float:
    """The miss against the gradient limit of ``dt``: max |got - want| /
    (tol · max |want|), tol 1e-5 (f32) or 2e-2 (bf16). At most 1 passes."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    tol = 2e-2 if dt == "bf16" else 1e-5
    return float(np.abs(g - w).max() / (tol * np.abs(w).max()))


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dt,causal,qs", BWD_CASES)
def test_flash_bwd_plain_at_d112_matches_jax(dt, causal, qs):
    """The same residuals (the JAX forward's o and lse) into both
    backwards; dq, dk and dv held to the Pallas backward in interpret
    mode and to the JAX reference. With q x 4, the backward over q scaled
    by (112 / 128)^0.5 — which computes what a 128^-0.5 scale would for
    dk and dv — misses the limit."""
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _pair(rng, Q_SHAPE, dt, qs), _pair(rng, KV_SHAPE, dt),
        _pair(rng, KV_SHAPE, dt), _pair(rng, Q_SHAPE, dt))
    jo, jl = jops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                      backend="pallas", interpret=True)
    to, tl = _to_torch(jo), _to_torch(jl)
    got = tfa.flash_attention_bwd(tq, tk, tv, to, tl, tg, causal)
    for t, ref in zip(got, (tq, tk, tv)):
        assert t.dtype == ref.dtype and t.shape == ref.shape
    want = None
    for backend in ("pallas", "ref"):
        kw = {"interpret": True} if backend == "pallas" else {}
        w = jops.flash_attention_bwd(jq, jk, jv, jo, jl, jg, causal=causal,
                                     backend=backend, **kw)
        want = want or w
        for name, x, y in zip(("dq", "dk", "dv"), got, w):
            assert _err(x, y, dt) <= 1.0, (backend, name, _err(x, y, dt))
    if qs > 1:
        wrong = tfa.flash_attention_bwd(_wrong_scale(tq), tk, tv, to, tl, tg,
                                        causal)
        assert max(_err(x, y, dt) for x, y in zip(wrong[1:], want[1:])) > 1


# ---------------------------------------------------------------------------
# a kimi smoke model at head_dim 112, MetaTT-(4+E)D trained
# ---------------------------------------------------------------------------


def _runs(rank, over=OVER, **train):
    """Both packages' RunConfigs: kimi-k2's smoke config at heads of 112
    (``over``) and aux weight ``AUX``, MetaTT 4+ed on q, v and moe_down."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(KIMI), **over,
                               moe_aux_weight=AUX)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(KIMI), **over,
                              moe_aux_weight=AUX)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == D
    common = dict(adapter_kind="metatt", adapter_variant="4+ed",
                  adapter_rank=rank, adapter_alpha=4.0)
    tr = {"seed": 3, "remat": "none", "ckpt_every": 0, **train}
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                       optimizer=JOptimizerConfig(**OPT),
                       train=JTrainConfig(**tr), **common),
            RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                      train=TrainConfig(**tr), **common))


@functools.lru_cache(maxsize=None)
def _setup():
    jrun, trun = _runs(4)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.matrix_types == ("attn_q", "attn_v", "moe_down")
    jp = jax.jit(JM.init_params, static_argnums=(0, 1))(jrun.model, jspec,
                                                        KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, trun.model.vocab_size, (3, 13)).astype(np.int32)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    return jrun, trun, jspec, spec, jp, tp, tokens, mask


@functools.lru_cache(maxsize=None)
def _jax_grads(jpolicy):
    jrun, _, jspec, _, jp, _, tokens, mask = _setup()
    loss_fn = functools.partial(JM.loss_fn, policy=POLICIES[jpolicy])
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                           static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"],
        {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)},
        jrun.model, jspec)
    return float(jl), {k: float(v) for k, v in jm.items()}, \
        jax.tree_util.tree_leaves(jg)


@pytest.mark.parametrize("jpolicy,remat", [("ref", False), ("ref", True),
                                           ("pallas_interpret", False)],
                         ids=["ref-plain", "ref-remat", "pallas_interpret"])
def test_loss_aux_and_adapter_grads_at_d112_match_jax(jpolicy, remat):
    _, trun, _, spec, _, tp, tokens, mask = _setup()
    jl, jm, jleaves = _jax_grads(jpolicy)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    loss, metrics = TM.loss_fn(adapter, tp["base"], tp["frozen"],
                               {"tokens": torch.from_numpy(tokens),
                                "mask": torch.from_numpy(mask)},
                               trun.model, spec, remat=remat, device="cpu")
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    assert sorted(metrics) == sorted(jm) == ["ce", "load_balance",
                                             "router_z"]
    for k, v in metrics.items():
        assert abs(float(v.detach()) - jm[k]) <= 1e-5 * abs(jm[k]), k
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jleaves) == 5
    for g, want in zip(grads, jleaves):
        w = np.asarray(want, np.float64)
        assert float(np.abs(w).max()) > 0
        err = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-4


def test_trainer_with_a_dmrg_sweep_at_d112_tracks_the_jax_trainer(
        monkeypatch):
    """Ten 4+ed steps (aux weight 0.01 in the loss), one warm-moment sweep
    6 -> 4 after epoch 1 (step 3) over the 5-core TT, on the smoke model
    narrowed to one head of 112 (d_model 112): the JAX Trainer's compiles
    are most of this file's time. Its init runs jitted (eager, it took
    5.5 s); the port's Trainer starts from the weights it drew."""
    monkeypatch.setattr(JM, "init_params", jax.jit(
        JM.init_params, static_argnums=(0, 1)))
    jrun, trun = _runs(6, over=dict(OVER, d_model=D, num_heads=1))

    def lm(pkg):
        return pkg(vocab_size=trun.model.vocab_size, seq_len=16, batch=4,
                   seed=13, branching=2)
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
