"""The port's paged serving engine against the JAX paged engine and the
port's dense engine.

Weights are made once by the JAX package (its PRNG, as
tests/test_paged_engine.py makes them: smoke stablelm-1.6b, 4+1d MetaTT
over 3 tasks at rank 4, or 4d untasked), carried across with
``repro_torch.convert.from_jax_numpy``, and the engines serve the
workloads of tests/test_paged_engine.py in f32 on the CPU. Greedy tokens
must be IDENTICAL — to the JAX paged engine (reference path and Pallas
interpret mode) and to the port's dense engine — and the block, prefix,
COW and backpressure counters equal to the JAX engine's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import KernelConfig as JKernelConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.serving import (AdapterRuntime, ChaosInjector, Engine,
                                 Request)

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
VOCAB = jconfigs.get_smoke_config(ARCH).vocab_size
PALLAS = JKernelConfig(backend="pallas", interpret=True)
BASE = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
            prefill_chunk=4)
COUNTERS = ("admitted", "evicted", "prefix_lookups", "prefix_hit_tokens",
            "prefix_lookup_tokens", "cow_copies", "cache_evictions",
            "backpressure_waits", "kv_blocks_peak", "tokens_generated")


@functools.lru_cache(maxsize=None)
def _setup(variant="4+1d", num_tasks=3):
    """tests/test_paged_engine.py's weights for the JAX engines, and the
    same weights as the port's runtime."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant=variant, num_tasks=num_tasks, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.8)}
    cfg = tconfigs.get_smoke_config(ARCH)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant=variant,
        num_tasks=num_tasks, adapter_rank=4))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jrt, cfg, trt


def _engines(variant="4+1d", num_tasks=3, kernels=None, **kw):
    """A fresh JAX paged engine and a fresh port paged engine (the pools
    and the prefix cache persist across generate calls)."""
    jcfg, jrt, cfg, trt = _setup(variant, num_tasks)
    sv = dict(BASE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(**sv), kernels=kernels),
            Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu"))


def _dense(reqs, variant="4+1d", num_tasks=3, **kw):
    _, _, cfg, trt = _setup(variant, num_tasks)
    sv = dict(BASE, cache_mode="dense", **kw)
    eng = Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu")
    return [o.tolist() for o in eng.generate(reqs)]


def _mixed(n=5, tasks=3):
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                             0, VOCAB)) for i in range(n)]
    return [(p, 5 + (i % 3), i % tasks) for i, p in enumerate(prompts)]


def _run(jeng, teng, work):
    """Serve ``work`` [(prompt, max_new, task)] on both engines; tokens
    must be identical and the counters equal. Returns the tokens."""
    want = [o.tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got = [o.tolist() for o in teng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want
    for name in COUNTERS:
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    assert teng.leaked_blocks() == 0
    return got


@pytest.mark.parametrize("kernels", [None, PALLAS],
                         ids=["jax_ref", "jax_pallas_interpret"])
def test_mixed_task_mixed_length_matches_jax_and_dense(kernels):
    work = _mixed()
    jeng, teng = _engines(kernels=kernels)
    got = _run(jeng, teng, work)
    assert got == _dense([Request(p, n, task=t) for p, n, t in work])
    assert len({tuple(g) for g in got}) == len(got)
    st = teng.last_stats
    assert st.cache_mode == "paged" and st.prefills == 0
    assert st.decode_steps > 0 and st.kv_blocks_peak <= st.num_blocks


@pytest.mark.parametrize("kernels", [None, PALLAS],
                         ids=["jax_ref", "jax_pallas_interpret"])
def test_default_serve_config_is_paged_and_serves(kernels):
    """``Engine(cfg, rt)`` with the default ServeConfig(): paged mode, the
    same tokens as the JAX engine's default and the port's dense engine."""
    jcfg, jrt, cfg, trt = _setup()
    work = _mixed(4)
    eng = Engine(cfg, trt, device="cpu")
    assert eng.paged and ServeConfig().cache_mode == "paged"
    _run(JEngine(jcfg, jrt, serve=JServeConfig(), kernels=kernels), eng,
         work)
    dense = Engine(cfg, trt, serve=ServeConfig(cache_mode="dense"),
                   device="cpu")
    reqs = [Request(p, n, task=t) for p, n, t in work]
    assert [o.tolist() for o in dense.generate(reqs)] == \
        [o.tolist() for o in eng.generate(reqs)]


def test_heterogeneous_prompts_untasked_match_jax():
    work = [(np.asarray(jax.random.randint(jax.random.PRNGKey(i),
                                           (2 + 3 * i,), 0, VOCAB)), 4, 0)
            for i in range(5)]          # prompt lengths 2, 5, 8, 11, 14
    jeng, teng = _engines("4d", 0)
    got = _run(jeng, teng, work)
    assert got == _dense([Request(p, n) for p, n, _ in work], "4d", 0)


def test_warm_prefix_cache_token_identical_and_hits():
    work = _mixed()
    jeng, teng = _engines()
    cold = _run(jeng, teng, work)
    assert teng.last_stats.prefix_hit_rate == 0.0
    warm = _run(jeng, teng, work)      # the pools persist across calls
    assert warm == cold
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies > 0


def test_shared_prefix_divergence_copy_on_write_parity():
    """A prefix ending mid-page, then divergence: the second request maps
    the cached partial page and copies it on write; the cached original
    still serves a third identical request unchanged."""
    base_p = np.asarray(jax.random.randint(KEY, (10,), 0, VOCAB))
    div = np.concatenate([base_p[:6], np.array([1, 2, 3])])
    work = [(base_p, 6, 1), (div, 6, 1), (base_p, 6, 1)]
    jeng, teng = _engines(max_batch=1)
    got = _run(jeng, teng, work)
    assert got == _dense([Request(p, n, task=t) for p, n, t in work])
    st = teng.last_stats
    assert st.cow_copies >= 1 and st.prefix_hit_tokens > 0


def test_out_of_blocks_backpressure_still_serves_everything():
    work = _mixed()
    jeng, teng = _engines(num_blocks=4, max_batch=4)
    got = _run(jeng, teng, work)
    assert got == _dense([Request(p, n, task=t) for p, n, t in work])
    assert teng.last_stats.backpressure_waits > 0
    assert teng.last_stats.kv_blocks_peak <= 4


def test_warm_request_in_tight_pool_falls_back_cold_not_deadlock():
    prompt = np.asarray(jax.random.randint(KEY, (9,), 0, VOCAB))
    jeng, teng = _engines("4d", 0, max_batch=1, cache_len=16)
    cold = _run(jeng, teng, [(prompt, 7, 0)])       # num_blocks == 2
    warm = _run(jeng, teng, [(prompt, 7, 0)])
    assert warm == cold
    assert teng.last_stats.backpressure_waits == 0  # resolved in plan()


def test_prefix_chains_are_namespaced_per_task():
    prompt = np.asarray(jax.random.randint(KEY, (9,), 0, VOCAB))
    jeng, teng = _engines()
    _run(jeng, teng, [(prompt, 5, 0)])
    other = _run(jeng, teng, [(prompt, 5, 1)])
    assert teng.last_stats.prefix_hit_tokens == 0   # no cross-task reuse
    same = _run(jeng, teng, [(prompt, 5, 1)])
    assert teng.last_stats.prefix_hit_tokens > 0    # within-task reuse
    assert other == same == _dense([Request(prompt, 5, task=1)])


def test_engine_rejects_oversized_request():
    _, _, cfg, trt = _setup("4d", 0)
    eng = Engine(cfg, trt, serve=ServeConfig(max_batch=1, cache_len=16,
                                             out_cap=8, page_size=8),
                 device="cpu")
    with pytest.raises(ValueError):
        eng.generate([Request(np.zeros(12, np.int64), 8)])   # 12+8 > 16
    big = Engine(cfg, trt, serve=ServeConfig(max_batch=1, cache_len=64,
                                             out_cap=8, page_size=8,
                                             num_blocks=8), device="cpu")
    with pytest.raises(ValueError):     # 9 pages > a pool of 8 blocks
        big.generate([Request(np.zeros(60, np.int64), 8)])
    with pytest.raises(ValueError):
        ServeConfig(cache_len=64, page_size=8, num_blocks=4).validate()
    with pytest.raises(ValueError):
        ServeConfig(page_size=12).validate()


def _statuses(eng):
    return [r.status for r in eng.last_results]


def test_cancel_and_deadline_match_the_dense_engine():
    """A queued cancel, a deadline already past, and a cancel of a slot
    admitted mid-run, in both modes: the same statuses and tokens."""
    _, _, cfg, trt = _setup()
    work = _mixed(4)
    outs = {}
    for mode in ("paged", "dense"):
        eng = Engine(cfg, trt, serve=ServeConfig(cache_mode=mode, **BASE),
                     device="cpu")
        eng.cancel("b")
        reqs = [Request(p, n, task=t, request_id=rid)
                for (p, n, t), rid in zip(work, "abcd")]
        reqs[2].deadline_s = 0.0
        got = eng.generate(reqs)
        outs[mode] = ([g.tolist() for g in got], _statuses(eng),
                      eng.last_stats.cancelled, eng.last_stats.timeouts)
        if mode == "paged":
            assert eng.leaked_blocks() == 0
    assert outs["paged"] == outs["dense"]
    toks, status, cancelled, timeouts = outs["paged"]
    assert status == ["FINISHED", "CANCELLED", "TIMEOUT", "FINISHED"]
    assert toks[1] == toks[2] == [] and cancelled == timeouts == 1


def test_cancel_in_flight_registers_the_computed_prefix():
    """A slot cancelled mid-generation ends with the tokens it emitted;
    its computed KV (prompt and emitted tokens) is indexed, so the same
    prompt served next is a warm hit with unchanged tokens."""
    _, _, cfg, trt = _setup()
    (p, _, t), = _mixed(1)
    eng = Engine(cfg, trt, serve=ServeConfig(**BASE), device="cpu")
    clean = eng.generate([Request(p, 8, task=t)])[0].tolist()
    eng._reset_paged_pool()

    calls = {"n": 0}
    step = eng._paged_step

    def step_then_cancel(*a):
        step(*a)
        calls["n"] += 1
        if calls["n"] == 1:     # the loop call ends when request 1 ends
            eng.cancel(0)
    eng._paged_step = step_then_cancel
    got = eng.generate([Request(p, 8, task=t),
                        Request(p[:3], 2, task=t)])
    del eng._paged_step
    assert eng.last_results[0].status == "CANCELLED"
    assert 0 < len(got[0]) < 8 and got[0].tolist() == clean[:len(got[0])]
    assert eng.leaked_blocks() == 0
    again = eng.generate([Request(p, 8, task=t)])[0].tolist()
    assert again == clean and eng.last_stats.prefix_hit_tokens > 0


@pytest.mark.parametrize("method", ["greedy", "top_k"])
def test_nan_guard_fails_only_the_poisoned_request(method):
    from repro_torch.serving import SamplingConfig
    _, _, cfg, trt = _setup("4+1d", 3)
    work = _mixed(2)
    outs = {}
    for mode in ("paged", "dense"):
        def engine():
            return Engine(cfg, trt, serve=ServeConfig(cache_mode=mode,
                                                      **BASE),
                          sampling=SamplingConfig(method=method, top_k=3),
                          device="cpu")
        reqs = [Request(p, 6, task=t) for p, _, t in work]
        clean = engine().generate(
            reqs, generator=torch.Generator().manual_seed(1))
        eng = engine()      # cold pools: the same steps as the clean run
        got = eng.generate(reqs, chaos=ChaosInjector(nan_after={1: 3}),
                           generator=torch.Generator().manual_seed(1))
        res = eng.last_results
        assert got[1].tolist() == clean[1][:3].tolist()
        assert eng.last_stats.failed_requests == 1
        outs[mode] = _statuses(eng)
        if mode == "paged":
            assert got[0].tolist() == clean[0].tolist()
            assert res[1].n_generated == 3 and eng.leaked_blocks() == 0
            # the failed request's KV is not indexed: its prompt is cold
            eng.generate([Request(work[1][0], 2, task=work[1][2])])
            assert eng.last_stats.prefix_hit_tokens == 0
    assert outs["paged"] == outs["dense"] == ["FINISHED", "FAILED"]


def test_a_failed_generate_resets_the_pools():
    _, _, cfg, trt = _setup()
    work = _mixed(3)
    eng = Engine(cfg, trt, serve=ServeConfig(**BASE), device="cpu")
    want = [o.tolist() for o in eng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    pools = eng._paged_caches

    def broken(*a):
        raise RuntimeError("injected")
    eng._paged_step = broken
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate([Request(p, n, task=t) for p, n, t in work])
    del eng._paged_step
    assert eng._paged_caches is not pools
    assert eng.bm.free_blocks == eng.sv.resolved_num_blocks
    assert len(eng.prefix) == 0
    got = [o.tolist() for o in eng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want and eng.last_stats.prefix_hit_tokens == 0
