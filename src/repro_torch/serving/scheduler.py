"""Admission scheduler for the paged serving engine (counterpart of
``src/repro/serving/scheduler.py`` without the adapter registry).

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

The adapter registry (task-slot paging) is not ported: ``registry`` must
be None.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


class Scheduler:
    """FIFO admission over a BlockManager (+ optional PrefixCache)."""

    def __init__(self, bm: BlockManager, prefix: Optional[PrefixCache],
                 stats: Optional[EngineStats] = None, registry=None):
        """bm: the block pool; prefix: optional prefix cache consulted /
        populated at admit / release; stats: counter sink (the engine
        swaps in its per-generate EngineStats)."""
        if registry is not None:
            raise NotImplementedError(
                "the adapter registry is not ported yet (registry=None)")
        self.bm = bm
        self.prefix = prefix
        self.stats = stats if stats is not None else EngineStats()

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
             namespace=None) -> Optional[AdmitPlan]:
        """Try to admit one request; None means not enough blocks (the
        caller keeps decoding and retries after the next eviction).

        prompt: host int sequence; namespace: prefix-cache chain key space
        (None = shared across tasks; the engine passes the task id when
        the adapter is task-routed, because any adapted matrix makes
        deep-layer KV task-dependent)."""
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
        return AdmitPlan(blocks=blocks, n_cached=n_cached, cow=cow,
                         total_pages=total_pages)

    def release(self, prompt, blocks: List[int], *, namespace=None,
                register: bool = True) -> None:
        """Finished request: index its prompt pages into the prefix cache
        (their KV is now fully computed), then drop the slot's refs —
        pages holding only generated tokens go straight back to the free
        list. ``register=False`` skips the prefix indexing (a request
        whose KV is suspect: the NaN guard fired)."""
        if register and self.prefix is not None and len(prompt) > 0:
            self.prefix.register(prompt, blocks, namespace=namespace)
        for bid in blocks:
            self.bm.deref(bid)
        self.stats.evicted += 1
