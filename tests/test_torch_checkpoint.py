"""The port's checkpoint slice against the JAX package.

* ``CheckpointManager`` (tests/test_checkpoint.py's six cases, on the
  port's manager and trees with tensors, ints and the port's dataclasses):
  roundtrip with bf16 / int8 / int dtypes kept, keep-k garbage collection,
  ``restore_latest``, async save, no partial files, shape-flexible restore
  after a DMRG-like reshape; a missing leaf raises ``KeyError``.
* Base snapshots cross packages: one the JAX package wrote of
  ``quantize_base(smoke base)`` loads in the port bit for bit (int8 kept),
  and the port's snapshot of the converted base has the same keys and
  arrays as the JAX one.
* The trainer: tests/test_train_integration.py's two resume cases on the
  port (f32, the final cores within 1e-5 absolute of an uninterrupted
  run, the JAX test's limit), and the resumed port run against the JAX
  ``Trainer``'s uninterrupted run at 1e-4 (test_torch_train.py's limit).
* Engines: tests/test_quant.py's snapshot roundtrip on the port's int8
  dense and paged engines — the same tokens after loading.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import TrainConfig as JTrainConfig
from repro.data import LMStream as JLMStream
from repro.kernels import quant as jquant
from repro.models import transformer as JT
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.config.base import (OptimizerConfig, QuantConfig, RunConfig,
                                     ServeConfig, TrainConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.core import tt
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.distributed import FailureInjector, SimulatedFailure
from repro_torch.kernels import quant as tquant
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWState
from repro_torch.serving import AdapterRuntime, Engine, Request
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

CFG = tconfigs.get_smoke_config("stablelm-1.6b")
JCFG = jconfigs.get_smoke_config("stablelm-1.6b")
KEY = jax.random.PRNGKey(0)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def _tree(v):
    return {"a": torch.full((3, 4), v),
            "b": [torch.full((2,), v + 1, dtype=torch.bfloat16),
                  torch.tensor(int(v), dtype=torch.int32),
                  torch.full((5,), int(v), dtype=torch.int8)],
            "opt": AdamWState(step=int(v), mu={"x": torch.full((2,), v)},
                              nu={"x": torch.full((2,), 2 * v)})}


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(5, _tree(1.0), meta={"data_state": {"step": 5, "seed": 11}})
    tree, meta = cm.restore(5, _tree(0.0))
    assert torch.equal(tree["a"], torch.full((3, 4), 1.0))
    assert tree["b"][0].dtype == torch.bfloat16
    assert torch.equal(tree["b"][0], torch.full((2,), 2.0,
                                                dtype=torch.bfloat16))
    assert tree["b"][1].dtype == torch.int32 and int(tree["b"][1]) == 1
    assert tree["b"][2].dtype == torch.int8
    assert isinstance(tree["opt"], AdamWState) and tree["opt"].step == 1
    assert isinstance(tree["opt"].step, int)
    assert torch.equal(tree["opt"].nu["x"], torch.full((2,), 2.0))
    assert meta["data_state"]["step"] == 5
    assert meta["shapes"]["opt/mu/x"] == [2]


@pytest.mark.parametrize("keep,steps,want", [(2, (1, 2, 3, 4), [3, 4]),
                                             (3, (7,), [7]),
                                             (0, (1, 2, 3), [1, 2, 3])])
def test_keep_k_gc_and_latest(tmp_path, keep, steps, want):
    cm = CheckpointManager(str(tmp_path), keep=keep)
    assert cm.latest_step() is None
    assert cm.restore_latest(_tree(0.0)) is None
    for s in steps:
        cm.save(s, _tree(float(s)))
    assert cm.all_steps() == want
    step, tree, _ = cm.restore_latest(_tree(0.0))
    assert step == cm.latest_step() == want[-1]
    assert torch.equal(tree["a"], torch.full((3, 4), float(want[-1])))


@pytest.mark.parametrize("async_save", [False, True])
def test_saves_leave_no_partial_files(tmp_path, async_save):
    cm = CheckpointManager(str(tmp_path), keep=3, async_save=async_save)
    cm.save(1, _tree(9.0))
    cm.save(2, _tree(8.0))
    cm.wait()
    assert cm.latest_step() == 2
    names = os.listdir(tmp_path)
    assert sorted(names) == ["ckpt_00000001.json", "ckpt_00000001.npz",
                             "ckpt_00000002.json", "ckpt_00000002.npz"]
    assert not any(".tmp." in n for n in names)


def test_shape_flexible_restore_and_missing_leaf(tmp_path):
    """After a DMRG sweep the cores' shapes change: the saved arrays win
    over a template of other shapes; a leaf the checkpoint lacks raises."""
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(3, {"cores": [torch.ones((1, 8, 4)), torch.ones((4, 8, 1))]})
    tree, _ = cm.restore(3, {"cores": [torch.zeros((1, 8, 2)),
                                       torch.zeros((2, 8, 1))]})
    assert tree["cores"][0].shape == (1, 8, 4)
    assert tree["cores"][1].shape == (4, 8, 1)
    with pytest.raises(KeyError, match="cores/2"):
        cm.restore(3, {"cores": [torch.zeros(1)] * 3})


# ---------------------------------------------------------------------------
# base snapshots across the packages
# ---------------------------------------------------------------------------

def test_jax_written_int8_snapshot_loads_bit_for_bit(tmp_path):
    base = JT.init_base_params(JCFG, KEY)
    qbase = jquant.quantize_base(base, group_size=0)
    path = jckpt.save_base_snapshot(str(tmp_path / "jax"), qbase)
    want = from_jax_numpy(jax.device_get(qbase), device="cpu")
    template = jax.tree_util.tree_map(torch.zeros_like, want)
    got = tckpt.load_base_snapshot(path, template)
    pairs = list(zip(TM.tensors(got), TM.tensors(want)))
    assert pairs and any(w.dtype == torch.int8 for _, w in pairs)
    for g, w in pairs:
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the port's snapshot of the converted fp and int8 bases: the JAX
    # package's keys and arrays
    tbase = from_jax_numpy(jax.device_get(base), device="cpu")
    for name, jtree, ttree in (("fp", base, tbase),
                               ("q8", qbase, tquant.quantize_base(tbase))):
        jp = jckpt.save_base_snapshot(str(tmp_path / f"j{name}"), jtree)
        tp = tckpt.save_base_snapshot(str(tmp_path / f"t{name}"), ttree)
        with np.load(jp) as jz, np.load(tp) as tz:
            assert sorted(jz.files) == sorted(tz.files)
            for k in jz.files:
                assert jz[k].dtype == tz[k].dtype, k
                np.testing.assert_array_equal(jz[k], tz[k])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

OPT = dict(lr=2e-2, warmup_ratio=0.1)


def _lm(pkg):
    return pkg(vocab_size=CFG.vocab_size, seq_len=32, batch=8, seed=11,
               branching=2)


def _run(steps, rank=4, ckpt_dir="", ckpt_every=0, **kw):
    run = RunConfig(model=CFG, adapter_kind="metatt", adapter_rank=rank,
                    adapter_alpha=4.0, optimizer=OptimizerConfig(**OPT),
                    train=TrainConfig(seed=3, remat="none",
                                      ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every))
    return Trainer(run=run, data=_lm(LMStream), total_steps=steps,
                   device="cpu", **kw)


def _same_cores(a, b, atol):
    for x, y in zip(a.state.adapter["cores"], b.state.adapter["cores"]):
        assert x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=0, atol=atol)


def test_checkpoint_resume_is_equivalent(tmp_path):
    d = str(tmp_path / "ck")
    full = _run(20)
    full.train()
    a = _run(20, ckpt_dir=d, ckpt_every=5,
             failure_injector=FailureInjector(fail_at_step=10))
    with pytest.raises(SimulatedFailure):
        a.train()
    b = _run(20, ckpt_dir=d, ckpt_every=5)
    assert b.state.step == 10 and b.state.opt.step == 10
    assert b.data.state() == {"step": 10, "seed": 11}
    b.train()
    assert b.state.step == 20
    _same_cores(full, b, 1e-5)
    assert CheckpointManager(d).latest_step() == 20


def test_dmrg_resume_lands_on_post_sweep_triple(tmp_path):
    """A checkpoint at an epoch boundary holds the post-sweep (params,
    optimizer state, schedule position): a resume continues on the
    reshaped cores and carried moments and never replays the sweep."""
    kw = dict(rank=8, steps_per_epoch=10,
              rank_schedule=RankSchedule(milestones=((1, 6),)))
    full = _run(20, **kw)
    full.train()
    d = str(tmp_path / "ck")
    a = _run(20, ckpt_dir=d, ckpt_every=10,
             failure_injector=FailureInjector(fail_at_step=15), **kw)
    with pytest.raises(SimulatedFailure):
        a.train()
    b = _run(20, ckpt_dir=d, ckpt_every=10, **kw)
    assert b.state.step == 10 and b.state.opt.step == 10
    assert max(tt.ranks(b.state.adapter["cores"])) <= 6
    assert b._dmrg_applied == [1]
    for m, p in zip(TM.tensors(b.state.opt.mu), TM.tensors(b.state.adapter)):
        assert m.shape == p.shape
    b.train()
    _same_cores(full, b, 1e-5)


def test_resumed_run_tracks_the_uninterrupted_jax_trainer(tmp_path):
    jrun = JRunConfig(model=JCFG, shape=SHAPES["train_4k"],
                      adapter_kind="metatt", adapter_rank=4,
                      adapter_alpha=4.0, optimizer=JOptimizerConfig(**OPT),
                      train=JTrainConfig(seed=3, remat="none", ckpt_every=0))
    jtr = JTrainer(run=jrun, data=_lm(JLMStream), total_steps=10)
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "adapter": jtr.state.adapter}), device="cpu")
    jtr.train()
    d = str(tmp_path / "ck")
    a = _run(10, ckpt_dir=d, ckpt_every=4,
             failure_injector=FailureInjector(fail_at_step=6))
    a.base, a.state = tp["base"], tts.init_train_state(tp["adapter"])
    with pytest.raises(SimulatedFailure):
        a.train()
    b = _run(10, ckpt_dir=d, ckpt_every=4)
    b.base = tp["base"]
    assert b.state.step == 4
    b.train()
    got, want = b.losses(), jtr.losses()[4:]
    assert (np.abs(got - want) / np.abs(want)).max() <= 1e-4
    for c, jc in zip(b.state.adapter["cores"], jtr.state.adapter["cores"]):
        w = np.asarray(jc)
        assert np.abs(c.numpy() - w).max() <= 1e-4 * np.abs(w).max()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _engine_setup():
    """tests/test_quant.py's ``_engine_setup``: a 4+1d adapter over two
    tasks, five requests."""
    spec = TM.build_adapter_spec(RunConfig(
        model=CFG, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=2, adapter_rank=4))
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(CFG, spec, gen, device="cpu")
    p["adapter"] = {"cores": tt.random_tt(gen, spec.cfg.mode_sizes, 4,
                                          scale=0.8)}
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, CFG.vocab_size, 4 + i), 6, task=i % 2)
            for i in range(5)]
    return rt, reqs


@pytest.mark.parametrize("mode,qc", [
    ("dense", dict(weights="int8")),
    ("paged", dict(weights="int8", kv="int8")),
])
def test_engine_snapshot_roundtrip_same_tokens(tmp_path, mode, qc):
    rt, reqs = _engine_setup()
    sv = dict(max_batch=2, cache_len=32, out_cap=8, cache_mode=mode,
              quant=QuantConfig(**qc))
    if mode == "paged":
        sv.update(page_size=8, prefill_chunk=4)
    eng1 = Engine(CFG, rt, serve=ServeConfig(**sv), device="cpu")
    out1 = [o.tolist() for o in eng1.generate(reqs)]
    path = eng1.save_base_snapshot(str(tmp_path / "snap"))
    assert path.endswith(".npz") and os.path.exists(path)
    eng2 = Engine(CFG, dataclasses.replace(rt), serve=ServeConfig(**sv),
                  device="cpu")
    # a different base in the new engine, replaced by the snapshot
    eng2._weights = (tquant.quantize_base(TM.init_params(
        CFG, rt.spec, torch.Generator().manual_seed(1),
        device="cpu")["base"]),) + eng2._weights[1:]
    eng2.load_base_snapshot(path)
    for g, w in zip(TM.tensors(eng2.base_weights),
                    TM.tensors(eng1.base_weights)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert any(t.dtype == torch.int8 for t in TM.tensors(eng2.base_weights))
    assert [o.tolist() for o in eng2.generate(reqs)] == out1
