"""The port's host-side paged-KV bookkeeping (``repro_torch.serving``:
lru.py, block_manager.py, scheduler.py) against the JAX package's.

Every case of tests/test_block_manager.py runs on the port's classes
(block manager refcounts, prefix-cache chain and partial-page matching,
LRU eviction of unpinned leaves, FIFO admission with backpressure, COW
planning), and one seeded random sequence of ``plan`` / ``release`` /
``evict_lru`` drives the JAX and the port objects side by side: block
ids, cached tokens, COW copies and stats must be equal at every step.
"""
import numpy as np
import pytest

from repro.serving.block_manager import BlockManager as JBlockManager
from repro.serving.block_manager import PrefixCache as JPrefixCache
from repro.serving.lru import LRUClock as JLRUClock
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.serving.block_manager import BlockManager, PrefixCache
from repro_torch.serving.lru import LRUClock
from repro_torch.serving.scheduler import Scheduler


def test_block_manager_alloc_free_refcount():
    bm = BlockManager(4, 8)
    assert bm.free_blocks == 4
    a, b = bm.alloc(), bm.alloc()
    assert bm.used_blocks == 2 and bm.refcount(a) == 1
    bm.ref(a)
    assert bm.refcount(a) == 2
    assert bm.deref(a) is False          # still shared
    assert bm.deref(a) is True           # freed
    assert bm.free_blocks == 3
    with pytest.raises(ValueError):
        bm.deref(a)                      # double free
    with pytest.raises(ValueError):
        bm.ref(a)                        # ref of a free block
    assert bm.writable(b)
    bm.ref(b)
    assert not bm.writable(b)            # shared -> COW before writing
    # exhaust the pool
    while bm.free_blocks:
        bm.alloc()
    with pytest.raises(RuntimeError):
        bm.alloc()


def test_prefix_cache_full_page_chain_match():
    bm = BlockManager(8, 4)
    pc = PrefixCache(bm)
    prompt = list(range(10))             # 2 full pages + partial(2)
    table = [bm.alloc() for _ in range(3)]
    assert pc.register(prompt, table) == 3
    # identical prompt: both full pages + the partial page match
    m = pc.match(prompt)
    assert m.tokens == 10 and m.blocks == table
    for bid in m.blocks:
        bm.deref(bid)
    # longer prompt sharing the 2 full pages only (page 3 differs)
    m = pc.match(list(range(8)) + [99, 98, 97])
    assert m.tokens == 8 and m.blocks == table[:2]
    for bid in m.blocks:
        bm.deref(bid)
    # divergence inside page 1 stops the chain at page 0
    m = pc.match([0, 1, 2, 3, 4, 99, 6, 7])
    assert m.tokens == 4 and m.blocks == table[:1]
    bm.deref(m.blocks[0])


def test_prefix_cache_partial_page_longest_common_prefix():
    bm = BlockManager(8, 4)
    pc = PrefixCache(bm)
    table = [bm.alloc(), bm.alloc()]
    pc.register([0, 1, 2, 3, 4, 5, 6], table)      # page + partial(3)
    # shares 2 of the partial page's 3 tokens, then diverges -> the
    # partial block is matched (the sharer copies-on-write before writing)
    m = pc.match([0, 1, 2, 3, 4, 5, 99])
    assert m.tokens == 6 and m.blocks == table
    assert bm.refcount(table[1]) == 3              # slot + cache + sharer
    for bid in m.blocks:
        bm.deref(bid)


def test_prefix_cache_register_dedups_and_keeps_one_cache_ref():
    bm = BlockManager(8, 4)
    pc = PrefixCache(bm)
    t1 = [bm.alloc()]
    pc.register([1, 2, 3, 4], t1)
    assert bm.refcount(t1[0]) == 2                 # slot + cache
    bm.deref(t1[0])                                # slot releases
    # a second request computed the same page cold: registration dedups,
    # its block stays owned by the request alone
    t2 = [bm.alloc()]
    assert pc.register([1, 2, 3, 4], t2) == 0
    assert bm.refcount(t2[0]) == 1
    assert len(pc) == 1


def test_prefix_cache_lru_evicts_unpinned_leaves_only():
    bm = BlockManager(6, 4)
    pc = PrefixCache(bm)
    t1 = [bm.alloc(), bm.alloc()]                  # chain a: 2 pages
    pc.register(list(range(8)), t1)
    t2 = [bm.alloc()]
    pc.register([9, 9, 9], t2)                     # chain b: partial page
    for bid in t1 + t2:
        bm.deref(bid)
    assert bm.free_blocks == 3
    # pin chain b by matching it (simulates a live slot using it)
    m = pc.match([9, 9, 9])
    assert m.tokens == 3
    # chain a's leaf (page 1) is LRU-evictable; its parent only after;
    # the pinned chain b must survive any demand
    freed = pc.evict_lru(10)
    assert freed == 2                              # both chain-a pages
    assert bm.free_blocks == 5
    assert pc.match([9, 9, 9]).tokens == 3         # still cached
    assert pc.match(list(range(8))).tokens == 0    # gone


def test_scheduler_admission_by_free_blocks_and_backpressure():
    bm = BlockManager(4, 4)
    sched = Scheduler(bm, PrefixCache(bm))
    # 6 prompt + 6 new = 12 tokens -> 3 pages
    p1 = sched.plan(list(range(6)), 6)
    assert p1 is not None and p1.total_pages == 3 and p1.n_cached == 0
    # next request needs 2 pages, only 1 free -> backpressure, no refs
    free_before = bm.free_blocks
    assert sched.plan([7] * 4, 4) is None
    assert bm.free_blocks == free_before
    assert sched.stats.backpressure_waits == 1
    # release the first -> its pages go to the prefix cache / free list
    sched.release(list(range(6)), p1.blocks)
    assert sched.plan([7] * 4, 4) is not None      # now admits (LRU evict)


def test_futile_backpressure_retry_does_not_drain_prefix_cache():
    """A head request that cannot fit even after full cache drain must
    not destroy cached blocks on every retry — eviction only runs when
    it can make the allocation succeed."""
    bm = BlockManager(4, 4)
    pc = PrefixCache(bm)
    sched = Scheduler(bm, pc)
    bm.alloc(), bm.alloc()                    # pinned by a live slot
    t = [bm.alloc()]
    pc.register([1, 2, 3, 4], t)
    bm.deref(t[0])                            # cached only: drainable
    # needs 3 pages; free=1 + drainable=1 < 3 -> infeasible: no eviction
    for _ in range(3):                        # retries must be harmless
        assert sched.plan([9] * 8, 4) is None
    assert len(pc) == 1
    m = pc.match([1, 2, 3, 4])                # cached block survived
    assert m.tokens == 4
    bm.deref(m.blocks[0])                     # drop the probe's ref
    # feasible 2-page request: eviction now runs and admission succeeds
    assert sched.plan([5] * 4, 4) is not None
    assert sched.stats.cache_evictions >= 1


def test_scheduler_cow_on_shared_partial_page():
    bm = BlockManager(8, 4)
    pc = PrefixCache(bm)
    sched = Scheduler(bm, pc)
    p1 = sched.plan([0, 1, 2, 3, 4, 5], 2)         # 2 pages, partial(2)
    assert p1.cow is None
    sched.release([0, 1, 2, 3, 4, 5], p1.blocks)
    # warm request diverging inside the shared partial page: the partial
    # block must be COW'd (fresh dst, cached src untouched)
    p2 = sched.plan([0, 1, 2, 3, 4, 99], 2)
    assert p2.n_cached == 5                        # 4 full + 1 partial tok
    assert p2.cow is not None
    src, dst = p2.cow
    assert p2.blocks[1] == dst and src != dst
    assert bm.refcount(dst) == 1                   # private writable copy
    assert pc.match([0, 1, 2, 3, 4, 5]).tokens == 6  # original intact


def test_lru_clock_orders_by_touch_and_breaks_ties_by_candidate_order():
    for clock in (LRUClock(), JLRUClock()):
        assert clock.oldest([]) is None
        assert clock.oldest(["b", "a"]) == "b"     # never touched: order
        clock.touch("a")
        clock.touch("b")
        clock.touch("a")
        assert clock.oldest(["a", "b", "c"]) == "c"
        assert clock.oldest(["a", "b"]) == "b"
        clock.forget("b")
        assert "b" not in clock and clock.tick_of("b") == 0
        assert len(clock) == 1 and clock.tick_of("a") == 3


def test_scheduler_takes_no_registry():
    """Without a registry ``task=`` is ignored (no slot, no fault); with
    one, admission gates on a free or idle adapter slot, and a plan that
    fails on a dry block pool rolls its pin back, leaving the slot mapped
    but unloaded — the JAX Scheduler gives the same answers."""
    from repro.serving.adapter_registry import AdapterRegistry as JReg
    from repro_torch.serving.adapter_registry import AdapterRegistry
    bm = BlockManager(4, 8)
    plan = Scheduler(bm, PrefixCache(bm)).plan([1, 2, 3], 4, task=5)
    assert plan.adapter_slot is None and not plan.adapter_fault
    answers = []
    for BM, PC, S, R in ((BlockManager, PrefixCache, Scheduler,
                          AdapterRegistry),
                         (JBlockManager, JPrefixCache, JScheduler, JReg)):
        bm = BM(3, 8)
        reg = R(1)
        sched = S(bm, PC(bm), registry=reg)
        p1 = sched.plan([1, 2, 3], 12, task=5)       # 2 of 3 blocks
        assert (p1.adapter_slot, p1.adapter_fault) == (0, True)
        assert sched.plan([4], 2, task=6) is None    # the one slot pinned
        assert sched.stats.adapter_waits == 1
        reg.mark_loaded(5)
        assert sched.plan([7] * 9, 8, task=5) is None  # 3 pages: dry
        assert reg.pin_count(5) == 1                   # pin rolled back
        sched.release([1, 2, 3], p1.blocks, task=5)
        p2 = sched.plan([7] * 9, 8, task=6)          # evicts idle task 5
        assert (p2.adapter_slot, p2.adapter_fault) == (0, True)
        assert reg.slot_of(5) is None and reg.pin_count(6) == 1
        answers.append((p1.blocks, p2.blocks, sched.stats.adapter_faults,
                        sched.stats.adapter_evictions,
                        sched.stats.backpressure_waits))
    assert answers[0] == answers[1]


STATS = ("admitted", "evicted", "prefix_lookups", "prefix_hit_tokens",
         "prefix_lookup_tokens", "cow_copies", "cache_evictions",
         "backpressure_waits", "kv_blocks_peak")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_plan_release_evict_sequence_matches_jax(seed):
    """200 seeded operations on a 12-block pool of 4-token pages: plans of
    prompts built from a few shared stems (so chains, partial pages and
    COW recur), in two namespaces; releases with and without
    registration; explicit LRU evictions. Both implementations must make
    the same decision at every step."""
    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, 6, 9)) for _ in range(3)]
    jbm, bm = JBlockManager(12, 4), BlockManager(12, 4)
    jpc, pc = JPrefixCache(jbm), PrefixCache(bm)
    js, ts = JScheduler(jbm, jpc), Scheduler(bm, pc)
    live = []
    for step in range(200):
        op = rng.integers(0, 10)
        if op < 5 or not live:
            stem = stems[rng.integers(0, 3)]
            cut = int(rng.integers(1, len(stem) + 1))
            prompt = [int(t) for t in stem[:cut]] + [
                int(t) for t in rng.integers(0, 6, rng.integers(0, 4))]
            max_new = int(rng.integers(1, 6))
            ns = [None, 1][int(rng.integers(0, 2))]
            jp = js.plan(prompt, max_new, namespace=ns)
            tp = ts.plan(prompt, max_new, namespace=ns)
            assert (jp is None) == (tp is None), step
            if tp is not None:
                assert (tp.blocks, tp.n_cached, tp.cow, tp.total_pages) == (
                    jp.blocks, jp.n_cached, jp.cow, jp.total_pages), step
                live.append((prompt, tp.blocks, ns))
        elif op < 9:
            prompt, blocks, ns = live.pop(int(rng.integers(0, len(live))))
            register = bool(rng.integers(0, 4))
            js.release(prompt, blocks, namespace=ns, register=register)
            ts.release(prompt, blocks, namespace=ns, register=register)
        else:
            need = int(rng.integers(1, 4))
            assert pc.evict_lru(need) == jpc.evict_lru(need), step
        for name in STATS:
            assert getattr(ts.stats, name) == getattr(js.stats, name), (
                step, name)
        assert bm.free_blocks == jbm.free_blocks, step
        assert [bm.refcount(i) for i in range(12)] == [
            jbm.refcount(i) for i in range(12)], step
        assert len(pc) == len(jpc) and pc.drainable_count() == \
            jpc.drainable_count(), step
    assert ts.stats.cow_copies > 0 and ts.stats.prefix_hit_tokens > 0
    assert ts.stats.backpressure_waits > 0
