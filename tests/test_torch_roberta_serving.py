"""Serving RoBERTa in f32: the port's engines against the JAX engines.

RoBERTa (layernorm with a bias, gelu, f32) is served as the causal LM the
JAX package builds. On roberta-base's smoke config, with weights made by
the JAX package (its PRNG) and a 4+1d MetaTT adapter over 3 tasks carried
across with ``repro_torch.convert.from_jax_numpy``, the port's dense,
paged (shared prefix, cold then warm), int8-KV paged, speculative dense,
int8-weight (w8) dense and w8 + int8-KV paged engines give greedy tokens
IDENTICAL to the JAX engines' on the CPU, with equal counters: admissions
and evictions (dense); prefix hits, COW and peak blocks (paged); weight
and KV dtypes and KV bytes (int8); draft / accept counts (speculative).
The cases mirror tests/test_torch_engine.py, test_torch_paged_engine.py,
test_torch_quant_engine.py and test_torch_speculative.py on this config.
On the card these engines run the f32 instances of K1, K2, K3, K4, #8,
#8q, #9 and #10 (``chip_smoke.py`` phase 11); here the CPU tensors run
their plain versions.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.config.base import SpecConfig as JSpecConfig
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs as tconfigs
from repro_torch.config.base import (QuantConfig, RunConfig, ServeConfig,
                                     SpecConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.serving import AdapterRuntime, Engine, Request

KEY = jax.random.PRNGKey(24)
ARCH = "roberta-base"
VOCAB = jconfigs.get_smoke_config(ARCH).vocab_size
BASE = dict(max_batch=2, cache_len=48, out_cap=8, page_size=8,
            prefill_chunk=4)
PAGED_COUNTERS = ("admitted", "evicted", "prefix_lookups",
                  "prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
                  "cache_evictions", "backpressure_waits", "kv_blocks_peak",
                  "tokens_generated")


#: the smoke model widened so that its matrices' K (256, 512) hold whole
#: groups of 128 rows: grouped int8 scales (G = 2, 4) at the smoke width
#: (K = 64, 128) would be per-channel ones
WIDE = dict(d_model=256, d_ff=512)


@functools.lru_cache(maxsize=None)
def _setup(wide=False):
    """roberta-base's smoke model in f32 (``wide``: at ``WIDE``'s widths),
    4+1d MetaTT on q/v over 3 tasks at rank 4 (``random_tt(scale=0.5)``),
    made by the JAX package; the JAX runtime and the port's runtime over
    the same weights."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    if wide:
        jcfg = dataclasses.replace(jcfg, **WIDE)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant="4+1d", num_tasks=3, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.5)}
    cfg = tconfigs.get_smoke_config(ARCH)
    if wide:
        cfg = dataclasses.replace(cfg, **WIDE)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=4))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    assert tp["base"]["embed"]["tok"].dtype == torch.float32
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jrt, cfg, trt


def _work(n=5, prefix=0):
    """``n`` mixed-task requests [(prompt, max_new, task)]; with
    ``prefix`` the even ones start with one shared ``prefix``-token run
    (ending mid-page, so a warm match copies that page on write)."""
    shared = np.asarray(jax.random.randint(KEY, (prefix,), 0, VOCAB))
    work = []
    for i in range(n):
        own = np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                            0, VOCAB))
        p = np.concatenate([shared, own]) if i % 2 == 0 else own
        work.append((p, 5 + (i % 3), i % 3))
    return work


def _engines(wide=False, **kw):
    """A fresh JAX engine and a fresh port engine on ``BASE`` + ``kw``
    (``quant`` / ``spec``: the port's configs, mapped to the JAX ones;
    ``wide``: the ``WIDE`` model)."""
    jcfg, jrt, cfg, trt = _setup(wide)
    quant, spec = kw.pop("quant", {}), kw.pop("spec", {})
    sv = dict(BASE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(
                quant=JQuantConfig(**quant), spec=JSpecConfig(**spec),
                **sv)),
            Engine(cfg, trt, serve=ServeConfig(
                quant=QuantConfig(**quant), spec=SpecConfig(**spec), **sv),
                device="cpu"))


def _serve(jeng, teng, work, counters=()):
    """``work`` through both engines: tokens identical, ``counters`` of
    ``last_stats`` equal. Returns the tokens."""
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


def test_dense_engine_token_identical_to_jax():
    """5 mixed-task requests through 2 dense slots (every admission lands
    while the other slot decodes): tokens and admission stats equal."""
    jeng, teng = _engines(cache_mode="dense")
    got = _serve(jeng, teng, _work(), ("admitted", "evicted",
                                       "tokens_generated"))
    assert teng.last_stats.admitted == 5 and teng.last_stats.evicted == 5
    # the task axis routes: the same prompt under the 3 tasks
    prompt = _work()[0][0]
    per_task = _serve(jeng, teng, [(prompt, 5, k) for k in range(3)])
    assert len({tuple(t) for t in per_task}) > 1
    assert [len(t) for t in got] == [n for _, n, _ in _work()]


def test_paged_engine_shared_prefix_token_identical_to_jax():
    """The paged engine (the default mode) with a 10-token shared prefix,
    cold then warm: tokens identical to the JAX paged engine's and the
    port's dense engine's; prefix hits, COW and peak blocks equal; no
    leaked block."""
    work = _work(prefix=10)
    jeng, teng = _engines()
    cold = _serve(jeng, teng, work, PAGED_COUNTERS)
    warm = _serve(jeng, teng, work, PAGED_COUNTERS)
    assert warm == cold
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies >= 1
    assert teng.leaked_blocks() == 0
    _, dense = _engines(cache_mode="dense")
    assert [o.tolist() for o in dense.generate(
        [Request(p, n, task=t) for p, n, t in work])] == cold


def test_int8_kv_paged_engine_token_identical_to_jax():
    """Int8 KV pools with f32 per-cell scales under f32 activations:
    tokens identical to the JAX int8 engine's, KV dtype, block bytes and
    kv_bytes_peak equal, and below the fp pools'; warm equals cold."""
    work = _work(prefix=10)
    stats = ("kv_dtype", "num_blocks", "block_bytes", "kv_blocks_peak",
             "kv_bytes_peak", "prefix_hit_tokens", "cow_copies",
             "tokens_generated")
    jeng, teng = _engines(quant=dict(kv="int8"))
    cold = _serve(jeng, teng, work, stats)
    assert teng.last_stats.kv_dtype == "int8"
    _, fp = _engines()
    fp.generate([Request(p, n, task=t) for p, n, t in work])
    assert teng.last_stats.kv_bytes_peak < fp.last_stats.kv_bytes_peak
    assert _serve(jeng, teng, work, stats) == cold
    assert teng.leaked_blocks() == 0


@pytest.mark.parametrize("stride", [1, 2])
def test_spec_dense_engine_token_identical_to_jax_and_non_spec(stride):
    """Speculative decode (k 3, a rank-2 truncated drafter, layer stride 1
    or 2) on the dense engine: tokens equal to the JAX speculative
    engine's and to the port's non-speculative engine's; draft / accept
    counts and spec steps equal to JAX's."""
    work = _work()
    spec = dict(spec_k=3, draft_rank=2, draft_layer_stride=stride)
    jeng, teng = _engines(cache_mode="dense", spec=spec)
    got = _serve(jeng, teng, work, ("tokens_generated",))
    _, base = _engines(cache_mode="dense")
    assert [o.tolist() for o in base.generate(
        [Request(p, n, task=t) for p, n, t in work])] == got
    st, jst = teng.last_stats, jeng.last_stats
    assert st.spec_k == 3 and st.spec_steps > 0 and st.draft_tokens > 0
    assert (st.draft_tokens, st.accepted_tokens, st.spec_steps) == (
        jst.draft_tokens, jst.accepted_tokens, jst.spec_steps)
    assert st.tokens_per_step == pytest.approx(jst.tokens_per_step)


@pytest.mark.parametrize("group", [0, 128])
def test_w8_dense_engine_token_identical_to_jax(group):
    """The dense engine over int8 base weights under f32 activations — #9
    at prefill, #10 at decode on the card — one f32 scale per output
    channel on the smoke model, or per group of 128 K rows on the ``WIDE``
    one (wq's K = 256: two groups): tokens identical to the JAX int8
    engine's, weight dtype and admissions equal."""
    quant = dict(weights="int8", group_size=group)
    jeng, teng = _engines(wide=bool(group), cache_mode="dense", quant=quant)
    _serve(jeng, teng, _work(), ("weights_dtype", "kv_dtype", "admitted",
                                 "evicted", "tokens_generated"))
    assert teng.last_stats.weights_dtype == "int8"
    wq = teng.base_weights["blocks"][0]["mixer"]["wq"]
    assert wq["q8"].dtype == torch.int8
    assert wq["scale"].shape[-2] == (WIDE["d_model"] // 128 if group else 1)


def test_w8_int8_kv_paged_engine_token_identical_to_jax():
    """int8 weights and int8 KV on the paged engine with a shared prefix,
    cold then warm: tokens identical to the JAX engine's, weight / KV
    dtypes, block and KV bytes, prefix hits and COW equal; warm equals
    cold; no leaked block."""
    work = _work(prefix=10)
    stats = ("weights_dtype", "kv_dtype", "num_blocks", "block_bytes",
             "kv_blocks_peak", "kv_bytes_peak", "prefix_hit_tokens",
             "cow_copies", "tokens_generated")
    jeng, teng = _engines(quant=dict(weights="int8", kv="int8"))
    cold = _serve(jeng, teng, work, stats)
    st = teng.last_stats
    assert (st.weights_dtype, st.kv_dtype) == ("int8", "int8")
    assert _serve(jeng, teng, work, stats) == cold
    assert teng.last_stats.prefix_hit_tokens > 0
    assert teng.leaked_blocks() == 0
