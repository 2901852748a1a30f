"""The port's paged adapter registry against the JAX package's
(``src/repro/serving/adapter_registry.py`` and the registry paths of the
JAX engine), mirroring the single-device cases of
tests/test_adapter_registry.py.

The registry's unit cases run on both implementations. The pool helpers
(``task_slice`` / ``scatter_slot`` / ``pool_factors``) are held to the
JAX ones on live "c", lora "a" and quantized {"q8", "scale"} leaves.
The engine cases use the JAX test's weights (smoke stablelm-1.6b, 4+1d
MetaTT at rank 4, ``random_tt(scale=0.8)``), carried across with
``repro_torch.convert.from_jax_numpy``, in f32 on the CPU: the port's
registry engine must give tokens IDENTICAL to the JAX registry engine's
and to its own all-resident engine's, with the same adapter counters as
the JAX engine.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import RegistryConfig as JRegistryConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.config.base import SpecConfig as JSpecConfig
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import AdapterRegistry as JAdapterRegistry
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import adapter_registry as jreg

from repro_torch import configs as tconfigs
from repro_torch.config.base import (RegistryConfig, RunConfig, ServeConfig,
                                     SpecConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.serving import (AdapterRegistry, AdapterRuntime, Engine,
                                 Request, Scheduler, BlockManager,
                                 PrefixCache)
from repro_torch.serving import adapter_registry as treg

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
VOCAB = jconfigs.get_smoke_config(ARCH).vocab_size
IMPLS = pytest.mark.parametrize("Registry", [AdapterRegistry,
                                             JAdapterRegistry],
                                ids=["port", "jax"])
ADAPTER_COUNTERS = ("adapter_hits", "adapter_faults", "adapter_evictions",
                    "adapter_waits", "backpressure_waits",
                    "max_resident_tasks", "admitted", "evicted",
                    "prefix_hit_tokens", "tokens_generated")


# ---------------------------------------------------------------------------
# AdapterRegistry units (tests/test_adapter_registry.py, on both packages)
# ---------------------------------------------------------------------------

@IMPLS
def test_registry_validation(Registry):
    with pytest.raises(ValueError):
        Registry(0)
    with pytest.raises(ValueError):
        Registry(2, policy="random")


@IMPLS
def test_acquire_miss_fill_hit_evict(Registry):
    r = Registry(2)
    a = r.acquire(10)
    assert a.slot == 0 and a.fault and a.evicted is None
    r.mark_loaded(10)
    b = r.acquire(11)
    assert b.slot == 1 and b.fault
    r.mark_loaded(11)
    h = r.acquire(10)
    assert h.slot == 0 and not h.fault
    assert len(r) == 2 and r.resident_tasks == [10, 11]
    for t in (10, 10, 11):
        r.release(t)
    e = r.acquire(12)
    assert e.fault and e.evicted == 11 and e.slot == 1
    assert r.slot_of(11) is None and r.slot_of(10) == 0


@IMPLS
def test_pins_block_eviction_then_backpressure(Registry):
    r = Registry(2)
    r.acquire(1), r.acquire(2)
    r.mark_loaded(1), r.mark_loaded(2)
    assert r.acquire(3) is None
    assert r.pinned_slots == 2
    r.release(2)
    got = r.acquire(3)
    assert got is not None and got.evicted == 2
    r.acquire(1)
    assert r.pin_count(1) == 2
    r.release(1)
    assert r.pin_count(1) == 1


@IMPLS
def test_loaded_flag_is_transactional(Registry):
    r = Registry(2)
    a = r.acquire(7)
    assert a.fault
    r.release(7)                      # rollback WITHOUT mark_loaded
    b = r.acquire(7)
    assert b.slot == a.slot and b.fault
    r.mark_loaded(7)
    assert not r.acquire(7).fault


@IMPLS
def test_release_and_mark_loaded_errors(Registry):
    r = Registry(2)
    with pytest.raises(ValueError):
        r.release(5)
    with pytest.raises(ValueError):
        r.mark_loaded(5)
    r.acquire(5)
    r.release(5)
    with pytest.raises(ValueError):
        r.release(5)


@IMPLS
def test_fifo_policy_ignores_hits(Registry):
    for policy, victim in (("lru", 2), ("fifo", 1)):
        r = Registry(2, policy=policy)
        for t in (1, 2):
            r.acquire(t)
            r.mark_loaded(t)
            r.release(t)
        r.acquire(1)
        r.release(1)
        assert r.acquire(3).evicted == victim, policy


@IMPLS
def test_clear_resets_everything(Registry):
    r = Registry(2)
    r.acquire(1)
    r.mark_loaded(1)
    r.clear()
    assert len(r) == 0 and r.pinned_slots == 0
    a = r.acquire(9)
    assert a.slot == 0 and a.fault


def test_seeded_acquire_release_sequence_equals_jax():
    """A random acquire / mark / release sequence gives the same slot,
    fault and eviction answers, step by step, in both packages."""
    rng = np.random.default_rng(3)
    for policy in ("lru", "fifo"):
        regs = (AdapterRegistry(3, policy), JAdapterRegistry(3, policy))
        held = []
        for _ in range(300):
            if held and rng.random() < 0.45:
                t = held.pop(int(rng.integers(0, len(held))))
                for r in regs:
                    r.release(t)
                continue
            t = int(rng.integers(0, 7))
            got = [r.acquire(t) for r in regs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is None:
                continue
            assert (got[0].slot, got[0].fault, got[0].evicted) == \
                (got[1].slot, got[1].fault, got[1].evicted)
            if rng.random() < 0.8:
                for r in regs:
                    r.mark_loaded(t)
            held.append(t)
        assert regs[0].resident_tasks == regs[1].resident_tasks


def test_registry_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(registry=RegistryConfig(max_resident_tasks=-1)
                    ).validate()
    with pytest.raises(ValueError):
        ServeConfig(registry=RegistryConfig(max_resident_tasks=4,
                                            eviction="random")).validate()
    assert not RegistryConfig().enabled
    assert RegistryConfig(max_resident_tasks=4).enabled
    for mode in ("paged", "dense"):
        ServeConfig(cache_mode=mode, registry=RegistryConfig(
            max_resident_tasks=4)).validate()
    ServeConfig(preempt_after=2).validate()
    with pytest.raises(ValueError, match="paged"):
        ServeConfig(cache_mode="dense", preempt_after=2).validate()


@pytest.mark.parametrize("bad", [dict(mesh_shape=(2, 1)),
                                 dict(mesh_shape=(2, 2), row_parallel=True),
                                 dict(disagg=True)])
def test_multi_device_serving_still_raises(bad):
    """Data replicas (a data axis above 1) and disaggregated prefill are
    not ported; tensor parallelism (``mesh_shape=(1, tp)``) is
    (``tests/test_torch_sharded_engine.py``)."""
    with pytest.raises(NotImplementedError):
        ServeConfig(registry=RegistryConfig(max_resident_tasks=2),
                    **bad).validate()


# ---------------------------------------------------------------------------
# pool helpers vs the JAX ones
# ---------------------------------------------------------------------------

def _leaves():
    """Per-layer factor dicts with the task axis at 1: live "c", lora "a"
    and a quantized {"q8", "scale"} leaf."""
    rng = np.random.default_rng(0)
    return {
        "c": rng.standard_normal((3, 5, 2, 4, 4)).astype(np.float32),
        "a": rng.standard_normal((3, 5, 2, 6, 4)).astype(np.float32),
        "w": {"q8": rng.integers(-127, 128, (3, 5, 6, 4)).astype(np.int8),
              "scale": rng.random((3, 5, 1, 4)).astype(np.float32)},
    }


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("task", [0, 3, 4])
def test_task_slice_equals_jax(task):
    host = _leaves()
    jax_tree = jax.tree_util.tree_map(jnp.asarray, host)
    _assert_tree_equal(_to_numpy(treg.task_slice(_to_torch(host), task)),
                       _to_numpy(jreg.task_slice(jax_tree, task)))


def test_pool_factors_and_scatter_slot_equal_jax():
    host = _leaves()
    jax_tree = jax.tree_util.tree_map(jnp.asarray, host)
    jpool = jreg.pool_factors(jax_tree, 2)
    tpool = treg.pool_factors(_to_torch(host), 2)
    _assert_tree_equal(_to_numpy(tpool), _to_numpy(jpool))
    for slot, task in ((1, 4), (0, 2), (1, 0)):
        jpool = jreg.scatter_slot(jpool, jnp.int32(slot),
                                  jreg.task_slice(jax_tree, task))
        out = treg.scatter_slot(tpool, slot,
                                treg.task_slice(_to_torch(host), task))
        assert out is tpool                      # in place, same storage
        _assert_tree_equal(_to_numpy(tpool), _to_numpy(jpool))
    # the slot holds the task's column exactly; the other slot too
    np.testing.assert_array_equal(tpool["c"][:, 1].numpy(), host["c"][:, 0])
    np.testing.assert_array_equal(tpool["w"]["q8"][:, 0].numpy(),
                                  host["w"]["q8"][:, 2])


def test_host_factors_and_pools_keep_a_column_contiguous():
    """The host copy equals the factors; its columns and the pool's slots
    are each one contiguous block (a fault-in is one copy)."""
    host = _to_torch(_leaves())
    h = treg.host_factors(host)
    _assert_tree_equal(_to_numpy(h), _to_numpy(host))
    assert h["c"].data_ptr() != host["c"].data_ptr()
    pool = treg.pool_factors(host, 2)
    for tree in (h, pool):
        for leaf in (tree["c"], tree["a"], tree["w"]["q8"]):
            assert leaf[:, 1].is_contiguous()


# ---------------------------------------------------------------------------
# scheduler: a registry Scheduler gates on slots and rolls its pin back
# ---------------------------------------------------------------------------

def test_scheduler_rolls_the_pin_back_on_a_dry_pool():
    """Slots are acquired before blocks; a failed block allocation drops
    the pin and leaves the slot mapped-but-unloaded, as in the JAX
    Scheduler (both run the same sequence)."""
    from repro.serving import BlockManager as JBlockManager
    from repro.serving import PrefixCache as JPrefixCache
    from repro.serving import Scheduler as JScheduler
    outs = []
    for BM, PC, S, R in ((BlockManager, PrefixCache, Scheduler,
                          AdapterRegistry),
                         (JBlockManager, JPrefixCache, JScheduler,
                          JAdapterRegistry)):
        bm = BM(4, 4)
        reg = R(1)
        sched = S(bm, PC(bm), registry=reg)
        p1 = sched.plan([1, 2, 3], 5, task=7)          # 2 pages
        assert p1.adapter_slot == 0 and p1.adapter_fault
        reg.mark_loaded(7)
        assert sched.plan([4, 5], 2, task=8) is None   # slot pinned by 7
        p2 = sched.plan([4, 5, 6], 2, task=7)          # hit, 2 pages
        assert p2.adapter_slot == 0 and not p2.adapter_fault
        assert reg.pin_count(7) == 2
        assert sched.plan([9], 2, task=7) is None      # pool dry: roll back
        assert reg.pin_count(7) == 2
        sched.release([1, 2, 3], p1.blocks, task=7)
        sched.release([4, 5, 6], p2.blocks, register=False, task=7)
        assert reg.pin_count(7) == 0
        p3 = sched.plan([9], 2, task=8)                # evicts idle 7
        assert p3.adapter_fault and reg.slot_of(7) is None
        st = sched.stats
        outs.append((st.adapter_faults, st.adapter_hits,
                     st.adapter_evictions, st.adapter_waits,
                     st.backpressure_waits, st.admitted))
    assert outs[0] == outs[1] == (2, 1, 1, 1, 2, 3)


# ---------------------------------------------------------------------------
# engine parity (tests/test_adapter_registry.py's single-device cases)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(num_tasks=16, mode="live", variant="4+1d"):
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
    jrt = JRuntime.build(mode, jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jrt, cfg, trt


def _mixed(n=10, tasks=16):
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(i),
                                             (4 + i % 3,), 0, VOCAB))
               for i in range(n)]
    return [(p, 3 + (i % 3), (7 * i) % tasks) for i, p in enumerate(prompts)]


def _serve(work, *, num_tasks=16, mode="live", slots=0, jax_too=True,
           passes=1, **kw):
    """Serve ``work`` [(prompt, max_new, task)] through the port's engine
    (and the JAX engine of the same configuration) ``passes`` times.
    Returns (port tokens of the last pass, port engine, JAX engine)."""
    jcfg, jrt, cfg, trt = _setup(num_tasks, mode)
    sv = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
              prefill_chunk=4)
    sv.update(kw)
    jsv = dict(sv)
    if "spec" in sv:
        jsv["spec"] = JSpecConfig(spec_k=sv["spec"].spec_k,
                                  draft_rank=sv["spec"].draft_rank)
    if slots:
        sv["registry"] = RegistryConfig(max_resident_tasks=slots)
        jsv["registry"] = JRegistryConfig(max_resident_tasks=slots)
    teng = Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu")
    jeng = JEngine(jcfg, jrt, serve=JServeConfig(**jsv)) if jax_too else None
    for _ in range(passes):
        got = [o.tolist() for o in teng.generate(
            [Request(p, n, task=t) for p, n, t in work])]
        if jeng is not None:
            want = [o.tolist() for o in jeng.generate(
                [JRequest(p, n, task=t) for p, n, t in work])]
            assert got == want
            for name in ADAPTER_COUNTERS:
                assert getattr(teng.last_stats, name) == \
                    getattr(jeng.last_stats, name), name
    return got, teng, jeng


def _assert_drained(eng):
    assert eng.registry is not None, "registry engine expected"
    assert eng.registry.pinned_slots == 0, "leaked adapter-slot pins"
    if eng.paged:
        assert eng.leaked_blocks() == 0


def test_pool_of_8_serves_256_distinct_tasks_token_identical():
    work = [(np.asarray([1 + t % 7, 2, 3 + t % 5]), 2, t)
            for t in range(256)]
    sv = dict(max_batch=4, cache_len=16, out_cap=4, prefill_chunk=8)
    ref, _, _ = _serve(work, num_tasks=256, jax_too=False, **sv)
    got, eng, jeng = _serve(work, num_tasks=256, slots=8, **sv)
    assert got == ref
    st = eng.last_stats
    assert st.adapter_faults == 256 and st.adapter_hits == 0
    assert st.adapter_evictions == 256 - 8
    assert st.max_resident_tasks == 8
    _assert_drained(eng)
    assert len(eng.registry) == 8
    assert eng.registry.resident_tasks == jeng.registries[0].resident_tasks


def test_task_reuse_hits_without_refault():
    work = _mixed(n=12, tasks=4)
    ref, _, _ = _serve(work, jax_too=False)
    got, eng, _ = _serve(work, slots=4)
    assert got == ref
    st = eng.last_stats
    assert st.adapter_faults == 4 and st.adapter_hits == len(work) - 4
    assert st.adapter_evictions == 0
    assert st.adapter_hit_rate == pytest.approx((len(work) - 4) / len(work))
    assert "hit=0.67" in st.summary()
    _assert_drained(eng)


def test_backpressure_when_all_slots_pinned():
    work = _mixed(n=8, tasks=8)
    ref, _, _ = _serve(work, jax_too=False, max_batch=4)
    got, eng, _ = _serve(work, slots=2, max_batch=4)
    assert got == ref
    st = eng.last_stats
    assert st.adapter_waits > 0
    assert st.backpressure_waits >= st.adapter_waits
    _assert_drained(eng)


def test_prefix_cache_survives_adapter_eviction():
    """Namespaces key on the TASK ID: a task evicted from the pool between
    passes still warm-hits its cached pages, unpoisoned by the task that
    held its slot meanwhile."""
    work = _mixed(n=6, tasks=6)
    ref, _, _ = _serve(work, jax_too=False)
    warm, eng, _ = _serve(work, slots=2, passes=2)
    assert warm == ref
    assert eng.last_stats.prefix_hit_rate > 0.0
    _assert_drained(eng)


def test_dense_mode_registry_token_identical():
    work = _mixed(n=8, tasks=8)
    ref, _, _ = _serve(work, jax_too=False, cache_mode="dense")
    got, eng, _ = _serve(work, slots=3, cache_mode="dense")
    assert got == ref
    assert eng.last_stats.adapter_faults == 8
    _assert_drained(eng)


def test_lora_form_runtime_pages_identically():
    work = _mixed(n=8, tasks=8)
    ref, _, _ = _serve(work, mode="lora", jax_too=False)
    got, eng, _ = _serve(work, mode="lora", slots=3)
    assert got == ref
    assert eng.last_stats.adapter_faults == 8
    _assert_drained(eng)


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_speculative_drafter_pages_with_target(cache_mode):
    """The rank-truncated drafter's column is written at the same slot by
    the same fault-in; tokens exact (JAX's case is paged; the port's
    dense spec engine pages too)."""
    work = _mixed(n=6, tasks=6)
    sc = SpecConfig(spec_k=2, draft_rank=2)
    ref, _, _ = _serve(work, jax_too=False, spec=sc, cache_mode=cache_mode)
    got, eng, _ = _serve(work, slots=3, spec=sc, cache_mode=cache_mode,
                         jax_too=cache_mode == "paged")
    assert got == ref
    assert eng.last_stats.adapter_faults == 6
    _assert_drained(eng)


def test_registry_requires_tasked_runtime():
    jcfg, jrt, cfg, trt = _setup(1, "live", "4d")
    with pytest.raises(ValueError, match="task"):
        Engine(cfg, trt, serve=ServeConfig(
            max_batch=2, cache_len=32, out_cap=8,
            registry=RegistryConfig(max_resident_tasks=2)), device="cpu")


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
@pytest.mark.parametrize("bad", [-1, 16, 99])
def test_bad_task_id_rejected_at_submission(cache_mode, bad):
    _, _, cfg, trt = _setup()
    work = _mixed(n=2, tasks=2)
    reqs = [Request(p, n, task=t) for p, n, t in work]
    reqs.append(Request([1, 2, 3], 2, task=bad))
    eng = Engine(cfg, trt, serve=ServeConfig(
        max_batch=2, cache_len=32, out_cap=8, cache_mode=cache_mode,
        registry=RegistryConfig(max_resident_tasks=2)), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        eng.generate(reqs)
    assert eng.registry.pinned_slots == 0


def test_prefill_logits_pins_and_releases_its_slot():
    """``prefill_logits`` on a registry engine faults the task's column
    in, reads it, and drops the pin: the logits equal the all-resident
    engine's (1e-5: f32 sums over a pool of another width)."""
    _, _, cfg, trt = _setup()
    prompt = np.arange(1, 7)
    full = Engine(cfg, trt, serve=ServeConfig(cache_mode="dense"),
                  device="cpu")
    eng = Engine(cfg, trt, serve=ServeConfig(
        cache_mode="dense", registry=RegistryConfig(max_resident_tasks=1)),
        device="cpu")
    for task in (5, 11, 5):
        torch.testing.assert_close(eng.prefill_logits(prompt, task),
                                   full.prefill_logits(prompt, task),
                                   rtol=1e-5, atol=1e-5)
    assert eng.registry.pinned_slots == 0
    assert eng.registry.resident_tasks == [5]
