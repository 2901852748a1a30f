"""The port's dense serving engine against the JAX dense engine.

Weights are made once by the JAX package (its PRNG), carried across with
``repro_torch.convert.from_jax_numpy``, and both engines serve the
workloads of tests/test_engine.py in f32 on the CPU. Greedy tokens must be
IDENTICAL: the plain versions the port runs on the CPU differ from the JAX
graph only by f32 summation order (~1e-6), far below the argmax gaps of
these workloads.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
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
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import (AdapterRuntime, ChaosInjector, Engine,
                                 Request)

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"


def _setup(variant="4d", num_tasks=0):
    return _setup_cached(variant, num_tasks)


@functools.lru_cache(maxsize=None)
def _setup_cached(variant, num_tasks, scale=0.8):
    """JAX params as tests/test_engine.py builds them, plus the port's
    config, spec and the same weights as tensors (built once per
    variant)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jrun = JRunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                      adapter_kind="metatt", adapter_variant=variant,
                      num_tasks=num_tasks, adapter_rank=4)
    jspec = JM.build_adapter_spec(jrun)
    jparams = JM.init_params(jcfg, jspec, KEY)
    jparams["adapter"] = {"cores": jtt.random_tt(
        KEY, jspec.cfg.mode_sizes, 4, scale=scale)}
    cfg = tconfigs.get_smoke_config(ARCH)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant=variant,
        num_tasks=num_tasks, adapter_rank=4))
    params = from_jax_numpy(jax.device_get(jparams), device="cpu")
    return (jcfg, jspec, jparams), (cfg, spec, params)


@functools.lru_cache(maxsize=None)
def _jax_engine(variant="4d", num_tasks=0, **kw):
    """One JAX dense engine per configuration (its jitted graphs are
    reused across the tests that share it)."""
    jcfg, jspec, jp = _setup(variant, num_tasks)[0]
    rt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                        jp["frozen"])
    return JEngine(jcfg, rt, serve=JServeConfig(cache_mode="dense", **kw))


def _torch_engine(t, **kw):
    cfg, spec, p = t
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    return Engine(cfg, rt, serve=ServeConfig(cache_mode="dense", **kw),
                  device="cpu")


def _python_loop(t, prompt, n_new, cache_len, task=None):
    """Greedy per-token loop over the port's forward / decode_step."""
    cfg, spec, p = t
    bc, pl = tpeft.adapter_factors(spec, p["adapter"], p["frozen"])
    with torch.inference_mode():
        out = TT.forward(p["base"], cfg, spec, bc, pl,
                         torch.as_tensor(prompt)[None], task=task,
                         return_caches=True, device="cpu")
        caches = TT.init_caches(cfg, 1, cache_len, cfg.compute_dtype,
                                device="cpu")
        TT.insert_cache_slot(caches, out.caches, 0)
        tok = out.logits[:, -1].argmax(-1)[:, None]
        toks = [int(tok[0, 0])]
        for i in range(n_new - 1):
            lg, caches = TT.decode_step(p["base"], cfg, spec, bc, pl, tok,
                                        caches, len(prompt) + i, task=task,
                                        device="cpu")
            tok = lg.argmax(-1)[:, None]
            toks.append(int(tok[0, 0]))
    return toks


def _prompts(seeds, lens, vocab):
    return [np.asarray(jax.random.randint(jax.random.PRNGKey(s), (n,), 0,
                                          vocab)) for s, n in zip(seeds, lens)]


def test_engine_matches_jax_engine_and_python_loop():
    j, t = _setup()
    prompts = _prompts(range(3), [5, 6, 7], t[0].vocab_size)
    kw = dict(max_batch=2, cache_len=32, out_cap=16)
    want = _jax_engine(**kw).generate([JRequest(p, 6) for p in prompts])
    got = _torch_engine(t, **kw).generate([Request(p, 6) for p in prompts])
    for p, g, w in zip(prompts, got, want):
        assert g.tolist() == w.tolist()
        assert g.tolist() == _python_loop(t, p, 6, 32)


def test_mixed_task_batch_matches_jax_and_solo_serving():
    j, t = _setup(variant="4+1d", num_tasks=3)
    prompt = np.asarray(jax.random.randint(KEY, (6,), 0, t[0].vocab_size))
    want = _jax_engine("4+1d", 3, max_batch=3, cache_len=32,
                       out_cap=8).generate(
        [JRequest(prompt, 5, task=k) for k in range(3)])
    mixed = _torch_engine(t, max_batch=3, cache_len=32, out_cap=8).generate(
        [Request(prompt, 5, task=k) for k in range(3)])
    assert [m.tolist() for m in mixed] == [w.tolist() for w in want]
    # the task axis must actually route: same prompt, different output
    assert len({tuple(m.tolist()) for m in mixed}) > 1
    solo = _torch_engine(t, max_batch=1, cache_len=32, out_cap=8)
    for k in range(3):
        assert solo.generate([Request(prompt, 5, task=k)])[0].tolist() \
            == mixed[k].tolist()
        assert mixed[k].tolist() == _python_loop(t, prompt, 5, 32, task=k)


def test_slot_eviction_admission_matches_jax():
    """5 requests through 2 slots with staggered budgets (one of them a
    single token): every admission lands while the other slot decodes."""
    j, t = _setup()
    prompts = _prompts(range(10, 15), [4, 5, 6, 7, 8], t[0].vocab_size)
    budgets = [3, 11, 1, 7, 5]
    kw = dict(max_batch=2, cache_len=32, out_cap=16)
    want = _jax_engine(**kw).generate(
        [JRequest(p, n) for p, n in zip(prompts, budgets)])
    eng = _torch_engine(t, **kw)
    got = eng.generate([Request(p, n) for p, n in zip(prompts, budgets)])
    for n, g, w in zip(budgets, got, want):
        assert len(g) == n
        assert g.tolist() == w.tolist()
    assert all(r.status == "FINISHED" for r in eng.last_results)
    assert eng.last_stats.admitted == 5 and eng.last_stats.evicted == 5


def test_single_token_request_never_decodes():
    j, t = _setup()
    prompt = _prompts([3], [9], t[0].vocab_size)[0]
    eng = _torch_engine(t, max_batch=2, cache_len=32, out_cap=8)
    got = eng.generate([Request(prompt, 1)])
    assert got[0].tolist() == _python_loop(t, prompt, 1, 32)
    assert eng.last_stats.decode_steps == 0
    assert eng.last_results[0].status == "FINISHED"


@pytest.mark.parametrize("method", ["greedy", "top_k"])
def test_nan_guard_fails_only_the_poisoned_request(method):
    from repro_torch.serving import SamplingConfig
    j, t = _setup(variant="4+1d", num_tasks=2)
    cfg, spec, p = t
    prompts = _prompts([5, 6], [6, 7], cfg.vocab_size)
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    eng = Engine(cfg, rt, serve=ServeConfig(cache_mode="dense", max_batch=2,
                                            cache_len=32, out_cap=8),
                 sampling=SamplingConfig(method=method, top_k=3),
                 device="cpu")
    clean = eng.generate([Request(p, 6, task=k)
                          for k, p in enumerate(prompts)],
                         generator=torch.Generator().manual_seed(1))
    got = eng.generate([Request(p, 6, task=k)
                        for k, p in enumerate(prompts)],
                       chaos=ChaosInjector(nan_after={1: 3}),
                       generator=torch.Generator().manual_seed(1))
    res = eng.last_results
    assert res[0].status == "FINISHED" and got[0].tolist() == clean[0].tolist()
    assert res[1].status == "FAILED"
    assert got[1].tolist() == clean[1][:3].tolist()
    assert eng.last_stats.failed_requests == 1


def test_cancel_and_deadline_end_requests_with_their_tokens():
    j, t = _setup()
    prompts = _prompts([7, 8, 9], [5, 6, 7], t[0].vocab_size)
    eng = _torch_engine(t, max_batch=2, cache_len=32, out_cap=8)
    eng.cancel("b")
    got = eng.generate([Request(prompts[0], 4, request_id="a"),
                        Request(prompts[1], 4, request_id="b"),
                        Request(prompts[2], 4, deadline_s=0.0)])
    status = [r.status for r in eng.last_results]
    assert status == ["FINISHED", "CANCELLED", "TIMEOUT"]
    assert len(got[0]) == 4 and len(got[1]) == 0 and len(got[2]) == 0
    assert eng.last_stats.cancelled == 1 and eng.last_stats.timeouts == 1


def test_entry_points_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j, t = _setup()
    cfg, spec, p = t
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    with pytest.raises(RuntimeError):
        Engine(cfg, rt, serve=ServeConfig(cache_mode="dense"))
    bc, pl = tpeft.adapter_factors(spec, p["adapter"], p["frozen"])
    with pytest.raises(RuntimeError):
        TT.forward(p["base"], cfg, spec, bc, pl, [[1, 2, 3]])
    with pytest.raises(RuntimeError):
        TT.init_base_params(cfg)
    with pytest.raises(RuntimeError):
        from_jax_numpy({"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("bad", [
    dict(disagg=True),                           # disaggregated prefill
    dict(cache_mode="dense", mesh_shape=(2, 1)),  # data replicas
])
def test_unported_serving_modes_raise(bad):
    j, t = _setup()
    cfg, spec, p = t
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    with pytest.raises(NotImplementedError):
        Engine(cfg, rt, serve=ServeConfig(**bad), device="cpu")


def test_sampling_methods_stay_in_vocab_and_follow_the_generator():
    from repro_torch.serving import SamplingConfig
    j, t = _setup()
    cfg, spec, p = t
    rt = AdapterRuntime.build("live", p["base"], spec, p["adapter"],
                              p["frozen"])
    prompt = _prompts([1], [5], cfg.vocab_size)[0]
    for sc in (SamplingConfig(method="top_k", temperature=0.8, top_k=5),
               SamplingConfig(method="top_p", top_p=0.9,
                              repetition_penalty=1.3),
               SamplingConfig(method="temperature", temperature=0.7)):
        eng = Engine(cfg, rt, serve=ServeConfig(
            cache_mode="dense", max_batch=2, cache_len=32, out_cap=8),
            sampling=sc, device="cpu")
        reqs = [Request(prompt, 6), Request(prompt, 6)]
        a = eng.generate(reqs, generator=torch.Generator().manual_seed(7))
        b = eng.generate(reqs, generator=torch.Generator().manual_seed(7))
        assert [x.tolist() for x in a] == [x.tolist() for x in b]
        assert all(0 <= int(v) < cfg.padded_vocab for o in a for v in o)
