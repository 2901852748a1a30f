"""The port's serving runtimes (live, lora, merged) and the core merges
behind them, against the JAX package.

Weights are made by the JAX package (its PRNG; smoke stablelm, MetaTT 4d,
5d or 4+1d) and carried across with ``convert.from_jax_numpy``; all in f32
on the CPU.

* ``to_lora_form``, ``fold_into_dense`` and ``fold_transformer`` within
  1e-5 of the largest JAX entry (f32, the same einsums summed in another
  order), including tests/test_engine.py's 2-position (4-layer) pattern,
  where the folded forward equals the live forward.
* Greedy tokens of the port's dense and paged engines under the live,
  lora and merged (task 1) runtimes IDENTICAL to the JAX engines'; a
  merged engine rejects a task-0 request.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.core import merge as jmerge
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import merge
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine, Request

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
JCFG0 = jconfigs.get_smoke_config(ARCH)
CFG0 = tconfigs.get_smoke_config(ARCH)


def _two_positions(cfg):
    """tests/test_engine.py's 2-position pattern over 4 layers."""
    return dataclasses.replace(
        cfg, name="stablelm-2pos", num_layers=4,
        block_pattern=(("attn", "dense"), ("attn", "dense")))


@functools.lru_cache(maxsize=None)
def _setup(variant="4+1d", num_tasks=2, two_pos=False):
    jcfg, cfg = JCFG0, CFG0
    if two_pos:
        jcfg, cfg = _two_positions(jcfg), _two_positions(cfg)
    kw = dict(adapter_kind="metatt", adapter_variant=variant,
              num_tasks=num_tasks, adapter_rank=4)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], **kw))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.8)}
    spec = TM.build_adapter_spec(RunConfig(model=cfg, **kw))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


def _rel(got, want) -> float:
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


VARIANTS = [("4d", 0), ("5d", 0), ("4+1d", 2)]


@pytest.mark.parametrize("variant,num_tasks", VARIANTS)
def test_to_lora_form_and_fold_into_dense_match_jax(variant, num_tasks):
    jcfg, jspec, jp, cfg, spec, tp = _setup(variant, num_tasks)
    jf = jmerge.to_lora_form(jp["adapter"], jspec.cfg)
    f = merge.to_lora_form(tp["adapter"], spec.cfg)
    assert _rel(f.a, jf.a) <= 1e-5 and _rel(f.b, jf.b) <= 1e-5
    task = 1 if variant == "4+1d" else None
    x = np.random.default_rng(0).standard_normal((3, cfg.d_model)).astype(
        np.float32)
    layer, m = 1, "attn_v"
    want = jf.delta(jspec.cfg, x, layer, m, task=task)
    assert _rel(f.delta(spec.cfg, torch.from_numpy(x), layer, m,
                        task=task), want) <= 1e-5
    blk = jp["base"]["blocks"][0]["mixer"]
    jw = {"attn_q": blk["wq"], "attn_v": blk["wv"]}
    tw = {k: from_jax_numpy(jax.device_get(v), device="cpu")
          for k, v in jw.items()}
    jout = jmerge.fold_into_dense(jp["adapter"], jspec.cfg, jw, task=task)
    out = merge.fold_into_dense(tp["adapter"], spec.cfg, tw, task=task)
    for k in jw:
        assert _rel(out[k], jout[k]) <= 1e-5


@pytest.mark.parametrize("two_pos", [False, True])
def test_fold_transformer_folds_all_layers_and_positions(two_pos):
    jcfg, jspec, jp, cfg, spec, tp = _setup("4d", 0, two_pos)
    jfold = jmerge.fold_transformer(jp["adapter"], jspec.cfg, jp["base"],
                                    jcfg)
    fold = merge.fold_transformer(tp["adapter"], spec.cfg, tp["base"], cfg)
    pairs = list(zip(TM.tensors(fold), jax.tree_util.tree_leaves(jfold)))
    assert len(pairs) == len(TM.tensors(tp["base"]))
    for g, w in pairs:
        assert _rel(g, w) <= 1e-5
    # the folded forward is the live one (f32), on every position
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    with torch.inference_mode():
        live = TT.forward(tp["base"], cfg, spec, bc, pl, tokens,
                          device="cpu").logits
        merged = TT.forward(fold, cfg, tpeft.NONE, {}, None, tokens,
                            device="cpu").logits
    assert _rel(merged, live.numpy()) <= 1e-4


def test_fold_needs_a_task_and_ported_mixers():
    """A 4+1d fold needs a task; a matrix type with no fold path
    (``moe_down``, the expert banks) raises ``ValueError`` in both
    packages, as JAX ``core/merge.py`` does (every mixer's fold path is
    ported)."""
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    with pytest.raises(ValueError, match="task"):
        merge.fold_transformer(tp["adapter"], spec.cfg, tp["base"], cfg)
    jmoe = dataclasses.replace(jspec.cfg, matrix_types=("moe_down",))
    moe = dataclasses.replace(spec.cfg, matrix_types=("moe_down",))
    with pytest.raises(ValueError, match="cannot be folded"):
        jmerge.fold_transformer(jp["adapter"], jmoe, jp["base"], jcfg,
                                task=0)
    with pytest.raises(ValueError, match="cannot be folded"):
        merge.fold_transformer(tp["adapter"], moe, tp["base"], cfg, task=0)


# ---------------------------------------------------------------------------
# engines: live, lora and merged runtimes, dense and paged
# ---------------------------------------------------------------------------

def _work(cfg):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab_size, 3 + 2 * i), 6, 1)
            for i in range(4)]


RUNTIMES = [("live", {}), ("lora", {}), ("merged", {"task": 1})]
GEOM = {"dense": dict(cache_mode="dense", max_batch=2, cache_len=32,
                      out_cap=8),
        "paged": dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
                      prefill_chunk=4)}


@pytest.mark.parametrize("cache", sorted(GEOM))
@pytest.mark.parametrize("mode,kw", RUNTIMES, ids=[m for m, _ in RUNTIMES])
def test_runtime_tokens_identical_to_jax(cache, mode, kw):
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    jrt = JRuntime.build(mode, jp["base"], jspec, jp["adapter"],
                         jp["frozen"], model_cfg=jcfg, **kw)
    trt = AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                               tp["frozen"], model_cfg=cfg, **kw)
    assert trt.tasked == jrt.tasked and trt.folded_task == jrt.folded_task
    jeng = JEngine(jcfg, jrt, serve=JServeConfig(**GEOM[cache]))
    eng = Engine(cfg, trt, serve=ServeConfig(**GEOM[cache]), device="cpu")
    work = _work(cfg)
    want = [o.tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got = [o.tolist() for o in eng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want
    if cache == "paged":
        assert eng.leaked_blocks() == 0


def test_merged_engine_rejects_another_task_and_lora_keeps_routing():
    _, _, _, cfg, spec, tp = _setup()
    rt = AdapterRuntime.build("merged", tp["base"], spec, tp["adapter"],
                              tp["frozen"], model_cfg=cfg, task=1)
    assert rt.spec.kind == "none" and rt.folded_task == 1
    eng = Engine(cfg, rt, serve=ServeConfig(**GEOM["dense"]), device="cpu")
    prompt = _work(cfg)[0][0]
    with pytest.raises(ValueError, match="serves task 1 only"):
        eng.generate([Request(prompt, 4, task=0)])
    lora = AdapterRuntime.build("lora", tp["base"], spec, tp["adapter"],
                                tp["frozen"])
    assert lora.tasked and set(lora.per_layer) == {"a"}
    lora.check_task(0)
    with pytest.raises(ValueError):
        lora.check_task(2)
    with pytest.raises(ValueError, match="metatt"):
        AdapterRuntime.build("lora", tp["base"],
                             tpeft.AdapterSpec("lora", spec.cfg), {}, {})
