"""granite-moe-1b-a400m and kimi-k2 served by the port's engines against
the JAX engines (f32, on the CPU).

Capacity dispatch couples the rows of one call: a token's experts depend
on every other row — inactive slots, the paged (B, C) block's pad
columns, the tail of a prefill bucket. So the port must feed each of
those rows exactly what the JAX step feeds, and on kimi-k2's smoke
config (top-2 of 8 experts at capacity factor 1.25, where the capacity
binds) the dense and the paged engine give different tokens for the same
requests — in both packages alike.

Over the setups of ``tests/test_torch_moe.py`` (weights and adapters made
by the JAX package): the dense, paged (a shared prefix, cold then warm)
and int8 (weights + KV, paged; then the dense engine over int8 weights)
engines give greedy tokens IDENTICAL to the JAX engines', with equal
admission / prefix / COW / peak-block / KV-byte counters and no leaked
block, for a 4+1d q/v adapter over 3 tasks (mixed tasks; also through
the ``lora`` and ``merged`` runtimes) and a 4+ed q/v + ``moe_down``
adapter with a scalar task. The JAX package's refusals are mirrored and
raise before any work: 4+ed under ``lora``, a merged fold of
``moe_down``, per-request tasks with ``moe_down`` adapted.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.models import model as JM
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config.base import QuantConfig, RunConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import merge
from repro_torch.models import model as TM
from repro_torch.serving import AdapterRuntime, Engine, Request

from test_torch_moe import GRANITE, KIMI, KEY, setup

BASE = dict(max_batch=2, cache_len=48, out_cap=8, page_size=8,
            prefill_chunk=4)
PAGED_COUNTERS = ("admitted", "evicted", "prefix_lookups",
                  "prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
                  "cache_evictions", "backpressure_waits", "kv_blocks_peak",
                  "tokens_generated")
INT8_STATS = ("weights_dtype", "kv_dtype", "num_blocks", "block_bytes",
              "kv_blocks_peak", "kv_bytes_peak", "prefix_hit_tokens",
              "cow_copies", "tokens_generated")
#: (arch, variant, runtime mode) of the served cases
CASES = [(GRANITE, "4+1d", "live"), (GRANITE, "4+ed", "live"),
         (KIMI, "4+1d", "live"), (KIMI, "4+ed", "live")]
#: the paged cases: kimi-k2's 4+ed is served paged by the int8 test
PAGED_CASES = CASES[:3]


def _runtimes(arch, variant, mode="live"):
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant, 0.0)
    kw = dict(model_cfg=jcfg) if mode == "merged" else {}
    jrt = JRuntime.build(mode, jp["base"], jspec, jp["adapter"],
                         jp["frozen"], **kw)
    trt = AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                               tp["frozen"],
                               **(dict(model_cfg=cfg) if kw else {}))
    return jcfg, jrt, cfg, trt


def _work(variant, n=5, prefix=0):
    """``n`` requests [(prompt, max_new, task)]: mixed tasks under 4+1d,
    task 0 otherwise; with ``prefix`` the even ones share a
    ``prefix``-token run (ending mid-page: a warm match copies it)."""
    shared = np.asarray(jax.random.randint(KEY, (prefix,), 0, 128))
    work = []
    for i in range(n):
        own = np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                            0, 128))
        p = np.concatenate([shared, own]) if i % 2 == 0 else own
        work.append((p, 5 + (i % 3), i % 3 if variant == "4+1d" else 0))
    return work


def _engines(arch, variant, mode="live", **kw):
    """A fresh JAX engine and a fresh port engine on ``BASE`` + ``kw``."""
    jcfg, jrt, cfg, trt = _runtimes(arch, variant, mode)
    quant = kw.pop("quant", {})
    sv = dict(BASE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(quant=JQuantConfig(**quant),
                                                  **sv)),
            Engine(cfg, trt, serve=ServeConfig(quant=QuantConfig(**quant),
                                               **sv), device="cpu"))


def _serve(jeng, teng, work, counters=()):
    """``work`` through both engines: tokens identical, ``counters`` of
    ``last_stats`` equal, every request finished. Returns the tokens."""
    want = [np.asarray(o).tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got = [o.tolist() for o in teng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want
    for name in counters:
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    assert all(r.status == "FINISHED" for r in teng.last_results)
    return got


@functools.lru_cache(maxsize=None)
def _dense_run(arch, variant, mode):
    """``_work(variant)`` through fresh dense engines of both packages
    (``_serve`` with the admission counters; one folded task under
    ``merged``): (the tokens, the port engine's stats). Shared by the
    dense test and the dense-vs-paged test."""
    jeng, teng = _engines(arch, variant, mode, cache_mode="dense")
    work = _work(variant)
    if mode == "merged":            # one folded task
        work = [(p, n, 0) for p, n, _ in work]
    got = _serve(jeng, teng, work, ("admitted", "evicted",
                                    "tokens_generated"))
    return got, teng.last_stats


@pytest.mark.parametrize("arch,variant,mode", CASES + [
    (GRANITE, "4+1d", "lora"), (GRANITE, "4+1d", "merged")])
def test_dense_engine_token_identical_to_jax(arch, variant, mode):
    """5 requests through 2 dense slots (inactive slots and the prompt
    bucket's tail run through the experts too): tokens and admission
    stats equal."""
    got, st = _dense_run(arch, variant, mode)
    assert st.admitted == 5 and st.evicted == 5
    assert [len(t) for t in got] == [5 + (i % 3) for i in range(5)]


@pytest.mark.parametrize("arch,variant,mode", PAGED_CASES)
def test_paged_engine_shared_prefix_token_identical_to_jax(arch, variant,
                                                           mode):
    """The paged engine with a 10-token shared prefix, cold then warm:
    tokens identical to the JAX paged engine's; prefix hits, COW and
    peak blocks equal; no leaked block. Warm equals cold on granite-moe,
    whose capacity never binds; on kimi-k2 the prefix hits change which
    rows share a step's capacity, and warm differs from cold in the JAX
    engine too."""
    work = _work(variant, prefix=10)
    jeng, teng = _engines(arch, variant, mode)
    cold = _serve(jeng, teng, work, PAGED_COUNTERS)
    warm = _serve(jeng, teng, work, PAGED_COUNTERS)
    assert (warm == cold) == (arch == GRANITE)
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies >= 1
    assert teng.leaked_blocks() == 0


def test_kimi_dense_and_paged_tokens_differ_as_in_jax():
    """kimi-k2's capacity binds (one slot an expert at a decode step of 2
    rows), so the paged engine's (B, 4) blocks — pad columns and prompt
    chunks — route other tokens than the dense engine's (1, bucket)
    prefills and (B, 1) steps: the two engines' tokens differ, and each
    equals its JAX counterpart's."""
    dense, _ = _dense_run(KIMI, "4+1d", "live")
    paged = _serve(*_engines(KIMI, "4+1d"), _work("4+1d"))
    assert dense != paged


@pytest.mark.parametrize("arch,variant", [(GRANITE, "4+1d"),
                                          (KIMI, "4+ed")])
def test_int8_engines_token_identical_to_jax(arch, variant):
    """int8 weights (the attention projections only: routers and expert
    banks stay f32) and int8 KV, paged, cold then warm; then the dense
    engine over int8 weights: tokens identical to the JAX int8 engines,
    dtype / KV-byte stats equal, kv_bytes_peak below the fp pools'."""
    work = _work(variant, prefix=10)
    jeng, teng = _engines(arch, variant,
                          quant=dict(weights="int8", kv="int8"))
    cold = _serve(jeng, teng, work, INT8_STATS)
    assert teng.last_stats.kv_dtype == "int8"
    warm = _serve(jeng, teng, work, INT8_STATS)
    assert (warm == cold) == (arch == GRANITE)
    assert teng.leaked_blocks() == 0
    ffn = teng.base_weights["blocks"][0]["ffn"]
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in ffn.values())
    assert set(teng.base_weights["blocks"][0]["mixer"]["wq"]) == {
        "q8", "scale"}
    _, _, cfg, trt = _runtimes(arch, variant)
    fp = Engine(cfg, trt, serve=ServeConfig(**BASE), device="cpu")
    fp.generate([Request(p, n, task=t) for p, n, t in work])
    assert teng.last_stats.kv_bytes_peak < fp.last_stats.kv_bytes_peak
    jeng, teng = _engines(arch, variant, cache_mode="dense",
                          quant=dict(weights="int8"))
    _serve(jeng, teng, work, ("weights_dtype", "tokens_generated"))


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_4ed_lora_runtime_raises_before_any_fold(monkeypatch):
    jcfg, jspec, jp, cfg, spec, tp = setup(GRANITE, "4+ed", 0.0)
    monkeypatch.setattr(merge, "to_lora_form", None)    # never reached
    with pytest.raises(ValueError, match="mode='live'"):
        AdapterRuntime.build("lora", tp["base"], spec, tp["adapter"])
    with pytest.raises(ValueError, match="mode='live'"):
        JRuntime.build("lora", jp["base"], jspec, jp["adapter"])


def test_merged_moe_down_fold_raises_before_any_work(monkeypatch):
    """A merged 4+ed adapter with ``moe_down`` raises a ValueError naming
    it (the JAX package has no fold path for it either) before any
    weight is folded; so do ``ffn_*`` adapters on kimi-k2's shared
    experts."""
    jcfg, jspec, jp, cfg, spec, tp = setup(GRANITE, "4+ed", 0.0)
    monkeypatch.setattr(merge, "fold_into_dense", None)  # never reached
    with pytest.raises(ValueError, match="moe_down"):
        AdapterRuntime.build("merged", tp["base"], spec, tp["adapter"],
                             model_cfg=cfg)
    with pytest.raises(ValueError):
        JRuntime.build("merged", jp["base"], jspec, jp["adapter"],
                       model_cfg=jcfg)
    jcfg, _, _, cfg, _, _ = setup(KIMI, "4d", 0.0)
    for c, build, R in ((cfg, TM.build_adapter_spec, RunConfig),
                        (jcfg, JM.build_adapter_spec, JRunConfig)):
        kw = {} if R is RunConfig else dict(shape=SHAPES["train_4k"])
        s = build(R(model=c, adapter_rank=2, adapter_matrices=(
            "attn_q", "ffn_up"), **kw))
        assert s.cfg.matrix_types == ("attn_q", "ffn_up")
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_rank=2, adapter_matrices=("attn_q", "ffn_up")))
    params = TM.init_params(cfg, spec, device="cpu")
    with pytest.raises(ValueError, match="shared experts"):
        merge.fold_transformer(params["adapter"], spec.cfg, params["base"],
                               cfg)


def test_per_request_tasks_with_moe_down_raise_before_any_work():
    """A 4+1d adapter on q/v and ``moe_down`` routes by request, and the
    expert-sorted moe_down path cannot take a (B,) task vector: both
    engines refuse it at construction; the model itself raises too."""
    jcfg, _, _, cfg, _, _ = setup(GRANITE, "4+1d", 0.0)
    types = ("attn_q", "attn_v", "moe_down")
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_variant="4+1d",
        num_tasks=3, adapter_rank=2, adapter_matrices=types))
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_variant="4+1d", num_tasks=3, adapter_rank=2,
        adapter_matrices=types))
    jp = JM.init_params(jcfg, jspec, KEY)
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"])
    assert trt.tasked and jrt.tasked
    with pytest.raises(NotImplementedError, match="moe_down"):
        JEngine(jcfg, jrt, serve=JServeConfig(**BASE))
    with pytest.raises(NotImplementedError, match="moe_down"):
        Engine(cfg, trt, serve=ServeConfig(**BASE), device="cpu")
    from repro_torch.models import transformer as TT
    with pytest.raises(NotImplementedError, match="scalar task"):
        TT.forward(tp["base"], cfg, spec, trt.broadcast, trt.per_layer,
                   np.zeros((2, 3), np.int64), task=torch.tensor([0, 1]),
                   device="cpu")
