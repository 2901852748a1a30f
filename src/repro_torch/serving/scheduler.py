"""Admission scheduler for the paged serving engine (counterpart of
``src/repro/serving/scheduler.py``).

Admission is gated on **free KV blocks**, not free slots: a request enters
a slot only when the block pool (after prefix-cache reuse and, if needed,
LRU eviction of unpinned cached blocks) can supply every page it may ever
touch — ``ceil((prompt + max_new_tokens) / page_size)`` pages, minus the
shared prefix, plus one copy-on-write block when the first writable
position lands inside a shared page. Allocating the worst case up front
means the decode loop never has to stop for an allocation or a COW: all
device-side bookkeeping happens at admit/evict boundaries, which the loop
already crosses (the engine's host loop admits into freed slots).

Policy is strict FIFO — the head request either fits or everybody waits
(no starvation; documented tradeoff vs. best-fit packing). ``plan`` returns
None under backpressure; the engine decodes on, finishing slots return
blocks, and the head is retried.

With an ``AdapterRegistry`` admission also gates on adapter-slot
residency: the request's task is pinned into a pool slot BEFORE its blocks
are allocated, and a failed block allocation rolls the pin back.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.adapter_registry import AdapterRegistry
from repro_torch.serving.block_manager import BlockManager, PrefixCache
from repro_torch.serving.stats import EngineStats


@dataclasses.dataclass
class AdmitPlan:
    """Everything the engine needs to place one request into a slot:
    ``blocks[i]`` is the physical block backing logical page ``i``
    (refs already taken), ``n_cached`` the prompt tokens whose KV is
    already in those blocks (the chunked prefill starts at ``done0 =
    n_cached``), ``cow`` an optional ``(src, dst)`` device block copy to
    run before decoding, ``total_pages == len(blocks)``."""
    blocks: List[int]            # physical block per logical page
    n_cached: int                # prompt tokens already in cache (done0)
    cow: Optional[Tuple[int, int]] = None   # (src, dst) device block copy
    total_pages: int = 0
    # adapter registry: the pool slot the request's task is pinned into
    # (None when the registry is off), and whether the engine must write
    # the task's column into the pool before this slot decodes
    adapter_slot: Optional[int] = None
    adapter_fault: bool = False


class Scheduler:
    """FIFO admission over a BlockManager (+ optional PrefixCache)."""

    def __init__(self, bm: BlockManager, prefix: Optional[PrefixCache],
                 stats: Optional[EngineStats] = None,
                 registry: Optional[AdapterRegistry] = None):
        """bm: the block pool; prefix: optional prefix cache consulted /
        populated at admit / release; stats: counter sink (the engine
        swaps in its per-generate EngineStats); registry: optional
        adapter-slot pool — when set, admission also gates on task
        residency."""
        self.bm = bm
        self.prefix = prefix
        self.stats = stats if stats is not None else EngineStats()
        self.registry = registry
        # chaos seam (serving/chaos.py): when set, consulted at the top of
        # every plan() — True forces this admission attempt to report
        # backpressure, exercising the retry path on demand
        self.fault_hook = None

    def _alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks, evicting LRU prefix blocks under pressure —
        but only when eviction can actually make the allocation succeed:
        a head request backpressured on slot-pinned blocks must not drain
        the prefix cache on every futile retry."""
        short = n - self.bm.free_blocks
        if short > 0 and self.prefix is not None \
                and self.prefix.drainable_count() >= short:
            self.stats.cache_evictions += self.prefix.evict_lru(short)
        if self.bm.free_blocks < n:
            return None
        return [self.bm.alloc() for _ in range(n)]

    def plan(self, prompt, max_new: int, *,
             namespace=None, task=None) -> Optional[AdmitPlan]:
        """Try to admit one request; None means not enough blocks — or,
        with a registry, no adapter slot (the caller keeps decoding and
        retries after the next eviction / harvest).

        prompt: host int sequence; namespace: prefix-cache chain key space
        (None = shared across tasks; the engine passes the TASK ID — not
        the pool slot — when the adapter is task-routed, because any
        adapted matrix makes deep-layer KV task-dependent, and a task
        evicted from the adapter pool still warm-hits its prefixes later);
        task: task id to pin into the adapter pool (ignored without a
        registry).

        Adapter residency is acquired FIRST: slots are the scarcer
        resource and the acquire is trivially reversible — on block
        failure the pin is dropped and the slot stays mapped-but-unloaded,
        so nothing was wasted."""
        if self.fault_hook is not None and self.fault_hook():
            # injected allocation failure (ChaosInjector): the same
            # contract as a dry pool — the caller decodes on and retries
            self.stats.backpressure_waits += 1
            return None
        acq = None
        if self.registry is not None and task is not None:
            acq = self.registry.acquire(task)
            if acq is None:
                # every pool slot is pinned by an in-flight request
                self.stats.adapter_waits += 1
                self.stats.backpressure_waits += 1
                return None
        page = self.bm.page_size
        plen = len(prompt)
        total_pages = -(-(plen + max_new) // page)
        shared: List[int] = []
        n_cached = 0
        if self.prefix is not None:
            m = self.prefix.match(prompt, namespace=namespace)
            shared, n_cached = m.blocks, m.tokens
            # at least the last prompt token must run through the model —
            # its logits seed the first sampled token
            n_cached = min(n_cached, plen - 1)
        n_shared_pages = len(shared)
        # first writable position: inside a shared page -> COW one block
        cow_needed = (n_cached // page) < n_shared_pages
        need = (total_pages - n_shared_pages) + (1 if cow_needed else 0)
        fresh = self._alloc(need)
        if fresh is None and shared:
            # the match's own refs pin the matched blocks (unevictable),
            # which can starve a pool that would fit this request cold —
            # drop the match and retry with every page fresh before
            # reporting backpressure
            for bid in shared:
                self.bm.deref(bid)
            shared, n_cached, n_shared_pages, cow_needed = [], 0, 0, False
            need = total_pages
            fresh = self._alloc(need)
        if fresh is None:
            for bid in shared:
                self.bm.deref(bid)
            if acq is not None:
                # roll the pin back; the slot stays mapped-but-UNLOADED,
                # so the successful retry writes the column properly
                self.registry.release(task)
            self.stats.backpressure_waits += 1
            return None
        cow = None
        if cow_needed:
            dst = fresh.pop(0)
            wpage = n_cached // page
            src = shared[wpage]
            cow = (src, dst)
            self.bm.deref(src)
            shared[wpage] = dst
            self.stats.cow_copies += 1
        blocks = shared + fresh
        assert len(blocks) == total_pages, (len(blocks), total_pages)
        # stats count ADMISSIONS only — a backpressured head retries
        # plan() many times and must not multi-count lookups/hits
        if self.prefix is not None:
            self.stats.prefix_lookups += 1
            self.stats.prefix_lookup_tokens += plen - 1
            self.stats.prefix_hit_tokens += n_cached
        self.stats.admitted += 1
        self.stats.kv_blocks_peak = max(self.stats.kv_blocks_peak,
                                        self.bm.used_blocks)
        if acq is not None:
            if acq.fault:
                self.stats.adapter_faults += 1
                if acq.evicted is not None:
                    self.stats.adapter_evictions += 1
            else:
                self.stats.adapter_hits += 1
        return AdmitPlan(blocks=blocks, n_cached=n_cached, cow=cow,
                         total_pages=total_pages,
                         adapter_slot=None if acq is None else acq.slot,
                         adapter_fault=acq is not None and acq.fault)

    def release(self, prompt, blocks: List[int], *, namespace=None,
                register: bool = True, task=None) -> None:
        """Finished request: index its prompt pages into the prefix cache
        (their KV is now fully computed), then drop the slot's refs —
        pages holding only generated tokens go straight back to the free
        list. ``register=False`` skips the prefix indexing (a request
        whose KV is suspect: the NaN guard fired). ``task``: drop the
        request's adapter-slot pin (the slot stays resident for future
        hits)."""
        if register and self.prefix is not None and len(prompt) > 0:
            self.prefix.register(prompt, blocks, namespace=namespace)
        for bid in blocks:
            self.bm.deref(bid)
        if self.registry is not None and task is not None:
            self.registry.release(task)
        self.stats.evicted += 1
