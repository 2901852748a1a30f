"""The port's serving resilience against the JAX package's
(``src/repro/serving/chaos.py`` and the engine's lifecycle paths),
mirroring the single-device cases of tests/test_chaos.py: request
lifecycle (cancel, deadline, NaN guard), allocation and adapter fault-in
chaos, recompute preemption, and the pool invariants under a random
interleaving of plan / release / evict.

Weights are the JAX test's (smoke stablelm-1.6b, 4+1d MetaTT over 3
tasks at rank 4, or 4d untasked, ``random_tt(scale=0.8)``), carried
across with ``repro_torch.convert.from_jax_numpy``; both engines serve in
f32 on the CPU under the same seeded ``ChaosInjector`` schedule. Tokens,
statuses and the fault / preemption counters must be IDENTICAL to the JAX
engine's, survivors identical to the fault-free run, and the port's
``audit`` must hold after every host-loop iteration.
"""
import functools

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.config.base import RegistryConfig as JRegistryConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import AdapterRegistry as JAdapterRegistry
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import BlockManager as JBlockManager
from repro.serving import ChaosInjector as JChaosInjector
from repro.serving import Engine as JEngine
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import audit_pools as jaudit_pools

from repro_torch import configs as tconfigs
from repro_torch.config.base import RegistryConfig, RunConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.serving import (CANCELLED, FAILED, FINISHED, TIMEOUT,
                                 AdapterRegistry, AdapterRuntime,
                                 BlockManager, ChaosInjector, Engine,
                                 PrefixCache, Request, Scheduler, audit,
                                 audit_pools)

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
VOCAB = jconfigs.get_smoke_config(ARCH).vocab_size
BASE = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
            prefill_chunk=4)
COUNTERS = ("cancelled", "timeouts", "preemptions", "failed_requests",
            "numerics_faults", "admitted", "evicted", "backpressure_waits",
            "adapter_faults", "adapter_hits", "adapter_waits",
            "prefix_hit_tokens", "tokens_generated")


@functools.lru_cache(maxsize=None)
def _setup(variant="4+1d", num_tasks=3):
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


def _prompt(i, n):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(i), (n,), 0,
                                         VOCAB))


def _work(n=4, tasks=3, max_new=6):
    """tests/test_chaos.py's ``_requests``: (prompt, max_new, task, id)."""
    return [(_prompt(i, 4 + i), max_new, i % tasks, f"r{i}")
            for i in range(n)]


def _reqs(work, cls=Request, **over):
    return [cls(p, n, task=t, request_id=rid, **over.get(rid, {}))
            for p, n, t, rid in work]


def _engines(variant="4+1d", num_tasks=3, slots=0, **kw):
    jcfg, jrt, cfg, trt = _setup(variant, num_tasks)
    sv = dict(BASE, **kw)
    jsv = dict(sv)
    if slots:
        sv["registry"] = RegistryConfig(max_resident_tasks=slots)
        jsv["registry"] = JRegistryConfig(max_resident_tasks=slots)
    return (Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu"),
            JEngine(jcfg, jrt, serve=JServeConfig(**jsv)))


def _run_both(work, chaos_kw=None, over=None, variant="4+1d", num_tasks=3,
              slots=0, **kw):
    """Serve ``work`` on a fresh port engine and a fresh JAX engine, each
    under its own ``ChaosInjector(**chaos_kw)`` (None: no chaos). Tokens,
    statuses, preemption counts and counters must be identical; the
    port's audit runs after every iteration. Returns (tokens, port
    engine, port injector)."""
    over = over or {}
    teng, jeng = _engines(variant, num_tasks, slots, **kw)
    tch = jch = None
    if chaos_kw is not None:
        tch, jch = ChaosInjector(**chaos_kw), JChaosInjector(**chaos_kw)
    got = [o.tolist() for o in teng.generate(_reqs(work, Request, **over),
                                             chaos=tch)]
    want = [o.tolist() for o in jeng.generate(_reqs(work, JRequest, **over),
                                              chaos=jch)]
    assert got == want
    assert [(r.status, r.n_generated, r.preemptions)
            for r in teng.last_results] == \
        [(r.status, r.n_generated, r.preemptions)
         for r in jeng.last_results]
    for name in COUNTERS:
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    if tch is not None:
        assert (tch.alloc_faults, tch.scatter_faults) == \
            (jch.alloc_faults, jch.scatter_faults)
    audit(teng)                     # at rest: drained, zero pins
    return got, teng, tch


def _clean(work, variant="4+1d", num_tasks=3, slots=0, **kw):
    teng, _ = _engines(variant, num_tasks, slots, **kw)
    return [o.tolist() for o in teng.generate(_reqs(work))]


def _statuses(eng):
    return [r.status for r in eng.last_results]


# ---------------------------------------------------------------------------
# request lifecycle
# ---------------------------------------------------------------------------

def test_cancel_scripted_spares_survivors():
    """r0 (short) finishes in host step 0; step 1's sweep catches r1
    (long) mid-decode: CANCELLED with a partial output, the survivors
    token-identical to the fault-free run."""
    lens, news = (4, 5, 6, 7), (3, 8, 6, 6)
    work = [(_prompt(i, lens[i]), news[i], i % 3, f"r{i}")
            for i in range(4)]
    baseline = _clean(work)
    out, eng, _ = _run_both(work, dict(cancel_at={1: ["r1"]}))
    res = eng.last_results
    assert res[1].status == CANCELLED
    assert res[1].n_generated < news[1]
    assert out[1] == baseline[1][:res[1].n_generated]
    for i in (0, 2, 3):
        assert res[i].status == FINISHED and out[i] == baseline[i], i
    assert eng.last_stats.cancelled == 1


def test_cancel_before_generate_kills_queued_request():
    work = _work(n=3)
    teng, jeng = _engines()
    for e in (teng, jeng):
        e.cancel("r2")
    got = [o.tolist() for o in teng.generate(_reqs(work))]
    want = [o.tolist() for o in jeng.generate(_reqs(work, JRequest))]
    assert got == want and got[2] == []
    assert _statuses(teng) == _statuses(jeng) == [FINISHED, FINISHED,
                                                  CANCELLED]
    assert teng.last_stats.cancelled == 1
    audit(teng)


def test_deadline_timeout_status_and_partial_tokens():
    work = _work(n=3)
    baseline = _clean(work)
    out, eng, _ = _run_both(work, over={"r0": dict(deadline_s=0.0)})
    assert _statuses(eng) == [TIMEOUT, FINISHED, FINISHED]
    assert out[0] == [] and out[1:] == baseline[1:]
    assert eng.last_stats.timeouts == 1


def test_lifecycle_on_dense_engine_too():
    """cancel / deadline through the chaos schedule on the dense engine,
    as the paged one."""
    lens, news = (4, 5, 6), (3, 8, 6)
    work = [(_prompt(i, lens[i]), news[i], i % 3, f"r{i}")
            for i in range(3)]
    baseline = _clean(work, cache_mode="dense")
    out, eng, _ = _run_both(work, dict(cancel_at={1: ["r1"]},
                                       audit_every_step=False),
                            over={"r2": dict(deadline_s=0.0)},
                            cache_mode="dense")
    res = eng.last_results
    assert res[2].status == TIMEOUT and out[2] == []
    assert res[1].status == CANCELLED and res[1].n_generated < news[1]
    assert out[1] == baseline[1][:res[1].n_generated]
    assert res[0].status == FINISHED and out[0] == baseline[0]


# ---------------------------------------------------------------------------
# numerics faults (the NaN guard)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_nan_injection_fails_request(cache_mode):
    work = _work()
    baseline = _clean(work, cache_mode=cache_mode)
    out, eng, _ = _run_both(work, dict(nan_after={"r2": 2}),
                            cache_mode=cache_mode)
    res = eng.last_results
    assert res[2].status == FAILED and res[2].n_generated == 2
    assert out[2] == baseline[2][:2]
    for i in (0, 1, 3):
        assert res[i].status == FINISHED and out[i] == baseline[i]
    st = eng.last_stats
    assert st.numerics_faults == 1 and st.failed_requests == 1


def test_nan_at_zero_fails_before_any_output():
    out, eng, _ = _run_both(_work(n=2), dict(nan_after={"r0": 0}))
    assert _statuses(eng) == [FAILED, FINISHED]
    assert out[0] == []


# ---------------------------------------------------------------------------
# allocation / fault-in chaos
# ---------------------------------------------------------------------------

def test_alloc_chaos_only_delays_never_corrupts():
    work = _work(n=5)
    baseline = _clean(work)
    out, eng, chaos = _run_both(work, dict(seed=7,
                                           alloc_fail_steps=(0, 1, 2),
                                           alloc_fail_rate=0.3))
    assert chaos.alloc_faults > 0
    assert out == baseline
    assert all(s == FINISHED for s in _statuses(eng))


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
def test_scatter_chaos_leaves_slot_mapped_but_unloaded_then_retries(
        cache_mode):
    """A failed fault-in unwinds the admission (blocks deref'd, pin
    dropped); the slot stays mapped-but-UNLOADED and the retry writes the
    column. Output equals the fault-free registry run."""
    work = _work(n=4, tasks=3)
    baseline = _clean(work, slots=2, cache_mode=cache_mode)
    out, eng, chaos = _run_both(work, dict(scatter_failures=2), slots=2,
                                cache_mode=cache_mode)
    assert chaos.scatter_faults == 2
    assert out == baseline
    assert all(s == FINISHED for s in _statuses(eng))
    assert eng.registry.pinned_slots == 0


def test_audit_runs_after_every_iteration(monkeypatch):
    from repro_torch.serving import engine as engine_mod
    calls = []
    real = engine_mod.chaos_lib.audit
    monkeypatch.setattr(engine_mod.chaos_lib, "audit",
                        lambda e: (calls.append(e.last_stats.decode_calls),
                                   real(e)))
    teng, _ = _engines(slots=2)
    teng.generate(_reqs(_work(n=4)), chaos=ChaosInjector(seed=1,
                                                         alloc_fail_rate=0.2))
    assert len(calls) >= teng.last_stats.decode_calls > 0
    calls.clear()
    teng.generate(_reqs(_work(n=4)),
                  chaos=ChaosInjector(audit_every_step=False))
    assert calls == []


def test_audit_catches_a_leaked_pin_and_block():
    """The audit is not vacuous: a pin or a block ref that no live slot
    holds fails it."""
    teng, _ = _engines(slots=2)
    teng.generate(_reqs(_work(n=2)))
    audit(teng)
    teng.registry.acquire(0)
    with pytest.raises(AssertionError, match="pins"):
        audit(teng)
    teng.registry.release(0)
    teng.bm.alloc()
    with pytest.raises(AssertionError, match="refcount"):
        audit(teng)


def test_kill_replica_at_is_not_ported():
    with pytest.raises(NotImplementedError, match="replica"):
        ChaosInjector(kill_replica_at=(1, 1))


# ---------------------------------------------------------------------------
# recompute preemption
# ---------------------------------------------------------------------------

def test_preemption_recomputes_victim_token_identically():
    """A 5-block pool where r1 (2 pages, long) and r2 (4 pages) never fit
    together: with preempt_after=1 the blocked head preempts r1, which
    re-enters with its generated prefix and still produces exactly the
    fault-free tokens — and the JAX engine's."""
    lens, news = (4, 9, 25), (4, 7, 7)
    work = [(_prompt(i, lens[i]), news[i], 0, f"r{i}") for i in range(3)]
    kw = dict(max_batch=2, num_blocks=5)
    baseline = _clean(work, "4d", 0, **kw)
    out, eng, _ = _run_both(work, dict(), variant="4d", num_tasks=0,
                            preempt_after=1, **kw)
    res = eng.last_results
    assert eng.last_stats.preemptions >= 1
    assert res[1].preemptions >= 1
    assert all(s == FINISHED for s in _statuses(eng))
    assert out == baseline
    assert "preempts=" in eng.last_stats.summary()


def test_preemption_with_the_registry_releases_the_victims_pin():
    lens, news = (4, 9, 25), (4, 7, 7)
    work = [(_prompt(i, lens[i]), news[i], i, f"r{i}") for i in range(3)]
    kw = dict(max_batch=2, num_blocks=5)
    baseline = _clean(work, slots=2, **kw)
    out, eng, _ = _run_both(work, dict(), slots=2, preempt_after=1, **kw)
    assert eng.last_stats.preemptions >= 1
    assert out == baseline and eng.registry.pinned_slots == 0


# ---------------------------------------------------------------------------
# pool invariants under a random interleaving (host only, no model)
# ---------------------------------------------------------------------------

def _drive_pools(seed, n_ops=150):
    """tests/test_chaos.py's drive: plan / release / cancel / evict over
    a Scheduler(BlockManager + PrefixCache + AdapterRegistry), run on the
    port's objects and the JAX ones in lockstep — every plan must give
    the same answer — with both audits after every operation, then a
    drain to empty."""
    rng = np.random.default_rng(seed)
    sides = []
    for BM, PC, R, S in ((BlockManager, PrefixCache, AdapterRegistry,
                          Scheduler),
                         (JBlockManager, JPrefixCache, JAdapterRegistry,
                          JScheduler)):
        bm = BM(8, 4)
        prefix = PC(bm)
        reg = R(2)
        sides.append(dict(bm=bm, prefix=prefix, reg=reg,
                          sched=S(bm, prefix, registry=reg)))
    live = []                   # (prompt, blocks per side, task)

    def check():
        for k, (side, fn) in enumerate(zip(sides, (audit_pools,
                                                   jaudit_pools))):
            fn(side["bm"], side["prefix"], [b[k] for _, b, _ in live],
               registry=side["reg"], pinned_tasks=[t for _, _, t in live])

    for _ in range(n_ops):
        op = rng.integers(0, 4)
        if op == 0:
            plen = int(rng.integers(1, 9))
            prompt = rng.integers(0, 50, plen).tolist()
            task = int(rng.integers(0, 5))
            max_new = int(rng.integers(0, 6))
            plans = [sd["sched"].plan(prompt, max_new, task=task)
                     for sd in sides]
            assert (plans[0] is None) == (plans[1] is None)
            if plans[0] is not None:
                assert plans[0].blocks == plans[1].blocks
                assert (plans[0].adapter_slot, plans[0].adapter_fault,
                        plans[0].n_cached, plans[0].cow) == \
                    (plans[1].adapter_slot, plans[1].adapter_fault,
                     plans[1].n_cached, plans[1].cow)
                if plans[0].adapter_fault:
                    for sd in sides:
                        sd["reg"].mark_loaded(task)
                live.append((prompt, [p.blocks for p in plans], task))
        elif op in (1, 2) and live:
            prompt, blocks, task = live.pop(rng.integers(0, len(live)))
            for k, sd in enumerate(sides):
                sd["sched"].release(prompt, blocks[k], register=op == 1,
                                    task=task)
        elif op == 3:
            n = int(rng.integers(1, 3))
            assert sides[0]["prefix"].evict_lru(n) == \
                sides[1]["prefix"].evict_lru(n)
        check()
    while live:
        prompt, blocks, task = live.pop()
        for k, sd in enumerate(sides):
            sd["sched"].release(prompt, blocks[k], task=task)
        check()
    for sd in sides:
        sd["prefix"].evict_lru(sd["bm"].num_blocks)
    check()
    for sd in sides:
        assert sd["bm"].free_blocks == sd["bm"].num_blocks
        assert all(p == 0 for p in sd["reg"]._pins)


def test_pool_invariants_random_interleaving_seeded():
    for seed in range(10):
        _drive_pools(seed)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as hst
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(seed=hst.integers(min_value=0, max_value=2**32 - 1))
    def test_pool_invariants_random_interleaving_hypothesis(seed):
        _drive_pools(seed, n_ops=80)
else:
    def test_pool_invariants_random_interleaving_hypothesis():
        pytest.importorskip("hypothesis")


def test_injector_counts_steps_audits_and_stalls():
    """Every host-loop iteration is ticked; each is audited unless it
    ended in an injected stall (JAX's engine retries those unaudited)."""
    teng, _ = _engines(slots=2)
    chaos = ChaosInjector(seed=3, alloc_fail_steps=(0, 1, 2, 3))
    teng.generate(_reqs(_work(n=4)), chaos=chaos)
    assert chaos.stalls >= 3 and chaos.audits > 0
    assert chaos.audits + chaos.stalls == chaos.steps
