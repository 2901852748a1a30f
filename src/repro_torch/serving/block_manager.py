"""Host-side KV block management for the paged serving engine (a copy of
``src/repro/serving/block_manager.py``).

The device holds one flat pool of KV blocks per layer (leaves shaped
``(nb, num_blocks, page_size, kv_heads, head_dim)``, models/transformer.py
``init_paged_caches``); everything about *which* request owns *which*
block lives here, in plain Python, where it is cheap to test:

  * ``BlockManager`` — free list + per-block reference counts. A block is
    writable only while its refcount is exactly 1 (one slot, no sharers);
    the engine copies-on-write before a slot ever writes into a block it
    shares (the copy itself is a device op, ``transformer.copy_cache_block``
    — this module only decides *when*).
  * ``PrefixCache`` — hash-chained prompt-prefix index. Each full prompt
    page is keyed by ``(parent_key, page_tokens)``, so a chain lookup walks
    the prompt page by page; the final partial page is cached too (keyed by
    its exact token tuple under the same parent) and matched by longest
    common token prefix — that is what makes warm requests that *diverge*
    mid-page share the page and then copy-on-write. The cache holds one
    refcount on every cached block; eviction (LRU over chain leaves) only
    frees blocks no live slot references.

MetaTT context: on a task-routed (4+1d) runtime, ANY task-adapted matrix
(q/v in the paper's default) perturbs the residual stream, so prefix KV
at layers >= 1 is task-dependent even where the k/v projections
themselves are frozen — tasked runtimes therefore key chains per task id
(the ``namespace`` argument). What the ONE shared tensor train still
buys over per-task LoRA/TT-LoRA stacks: every task lives in one engine
with one block pool (shared capacity, one admission queue), untasked /
merged / single-task runtimes share one global namespace, and within a
task the common system-prompt prefix of a request stream is cached once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.lru import LRUClock


class BlockManager:
    """Free list + refcounts over ``num_blocks`` KV blocks of ``page_size``
    tokens. Pure host state.

    COW rule (the one invariant everything else leans on): a block is
    WRITABLE only at refcount exactly 1 — one slot, no prefix-cache
    sharers. The scheduler checks ``writable`` at admit time and, when a
    request's first writable position lands inside a shared page,
    allocates a fresh block and schedules ONE device copy
    (``transformer.copy_cache_block``) before the slot ever decodes;
    the jitted loop itself never copies or allocates.

    Sharding note (DESIGN.md §9): block ids are shard-agnostic — pools
    shard on the kv-head axis, never on blocks, so id ``bid`` addresses
    row ``bid`` of EVERY shard's pool and one host-side decision is
    valid on all shards. One BlockManager serves any mesh size.
    """

    def __init__(self, num_blocks: int, page_size: int):
        """num_blocks: pool capacity; page_size: tokens per block (both
        >= 1). All blocks start free with refcount 0."""
        if num_blocks < 1 or page_size < 1:
            raise ValueError((num_blocks, page_size))
        self.num_blocks = num_blocks
        self.page_size = page_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks

    # -- introspection -------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks currently allocatable (refcount 0)."""
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks held by at least one slot or the prefix cache."""
        return self.num_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        """Current reference count of block ``bid`` (0 = free)."""
        return self._ref[bid]

    # -- alloc / share / free ------------------------------------------
    def alloc(self) -> int:
        """Take a free block with refcount 1. Raises if the pool is empty
        (callers check ``free_blocks`` / run cache eviction first)."""
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        bid = self._free.pop()
        assert self._ref[bid] == 0, bid
        self._ref[bid] = 1
        return bid

    def ref(self, bid: int) -> int:
        """Add a reference to an in-use block (prefix sharing)."""
        if self._ref[bid] <= 0:
            raise ValueError(f"ref of free block {bid}")
        self._ref[bid] += 1
        return bid

    def deref(self, bid: int) -> bool:
        """Drop one reference; returns True if the block was freed."""
        if self._ref[bid] <= 0:
            raise ValueError(f"deref of free block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def writable(self, bid: int) -> bool:
        """A slot may write into a block only if nobody else (slot or
        prefix cache) also holds it — otherwise copy-on-write first."""
        return self._ref[bid] == 1

    # -- cross-pool migration (disaggregated prefill, DESIGN.md §11) ---
    def migrate_to(self, dst: "BlockManager",
                   blocks: List[int]) -> Optional[List[Tuple[int, int]]]:
        """Transfer ownership of ``blocks`` from this pool to ``dst``:
        allocate one twin per block in ``dst`` (refcount 1) and drop this
        pool's reference. Returns the ``(src, dst)`` id pairs — the
        device-side batched block copy the engine runs between the two
        physical pools — or None (nothing moved, no refs touched) when
        ``dst`` cannot supply enough blocks; the caller retries after
        decode-side evictions.

        This is the prefill→decode handoff's host half: block ids are
        pool-local, so the transfer is pure bookkeeping — refcounts move,
        page order is preserved, and the prefill-side blocks return to
        their free list (or stay pinned by the prefill prefix cache if it
        also holds a ref)."""
        if dst.free_blocks < len(blocks):
            return None
        pairs = []
        for bid in blocks:
            if self._ref[bid] <= 0:
                raise ValueError(f"migrate of free block {bid}")
            pairs.append((bid, dst.alloc()))
        for bid in blocks:
            self.deref(bid)
        return pairs


@dataclasses.dataclass
class _Entry:
    key: tuple                 # (parent_key, tokens) — the chain hash key
    block: int
    parent: Optional[tuple]
    tokens: Tuple[int, ...]    # tokens stored in this page (may be partial)
    full: bool                 # len(tokens) == page_size
    children: int = 0


#: chain root sentinel (start of every prompt)
_ROOT = ("root",)


@dataclasses.dataclass
class PrefixMatch:
    """Result of a prefix-cache lookup: device-visible block ids covering
    the first ``tokens`` prompt tokens (refs already taken)."""
    blocks: List[int]
    tokens: int


class PrefixCache:
    """Hash-chained prompt-prefix → KV-block index (see module docstring).

    The cache owns one refcount per cached block, so cached blocks survive
    the requests that produced them; ``evict_lru`` releases leaf entries
    (no cached children, no live-slot references) when the pool runs dry.
    ``namespace`` isolates chains (used to key per-task when the adapter
    adapts k/v projections per task — KV then differs across tasks).
    """

    def __init__(self, bm: BlockManager):
        """bm: the pool whose blocks this cache pins (one refcount per
        cached entry). Starts empty."""
        self.bm = bm
        self._entries: Dict[tuple, _Entry] = {}
        self._partials: Dict[tuple, List[tuple]] = {}  # parent -> entry keys
        # recency over entry keys — same helper the AdapterRegistry uses
        # over pool slots, so both caches share one eviction ordering
        self._clock = LRUClock()

    def __len__(self) -> int:
        """Number of cached page entries (== pinned blocks)."""
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently pinned by the cache (one per entry)."""
        return len(self._entries)

    def _touch(self, e: _Entry) -> None:
        self._clock.touch(e.key)

    @staticmethod
    def _root(namespace) -> tuple:
        return _ROOT if namespace is None else (_ROOT, namespace)

    # -- lookup --------------------------------------------------------
    def match(self, tokens, namespace=None) -> PrefixMatch:
        """Longest cached prefix of ``tokens``. Takes one ref per matched
        block (caller derefs on release). Full pages chain exactly; the
        remainder matches a cached partial page by longest common token
        prefix (shared-then-diverge requests reuse the page and COW)."""
        page = self.bm.page_size
        toks = [int(t) for t in tokens]
        blocks: List[int] = []
        n = 0
        parent = self._root(namespace)
        for i in range(0, len(toks) - page + 1, page):
            key = (parent, tuple(toks[i:i + page]))
            e = self._entries.get(key)
            if e is None:
                break
            self._touch(e)
            blocks.append(self.bm.ref(e.block))
            n += page
            parent = key
        rest = toks[n:]
        if rest:
            best, best_n = None, 0
            for key in self._partials.get(parent, ()):
                e = self._entries[key]
                common = 0
                for a, b in zip(rest, e.tokens):
                    if a != b:
                        break
                    common += 1
                if common > best_n:
                    best, best_n = e, common
            if best is not None and best_n > 0:
                self._touch(best)
                blocks.append(self.bm.ref(best.block))
                n += best_n
        return PrefixMatch(blocks=blocks, tokens=n)

    # -- registration --------------------------------------------------
    def register(self, tokens, table: List[int], namespace=None) -> int:
        """Index a finished request's prompt pages (the engine calls this
        at evict time, when every prompt cell's KV has been computed).

        tokens: the full prompt; table[i]: the block holding page i. Pages
        already cached are skipped (the request derefs its own copy later);
        new pages gain a cache refcount. Cells past the prompt in the last
        partial page may hold generated-token KV — harmless, a future
        sharer masks cells beyond its own position and copies-on-write
        before writing. Returns the number of newly cached blocks.
        """
        page = self.bm.page_size
        toks = [int(t) for t in tokens]
        parent = self._root(namespace)
        added = 0
        for pi in range(-(-len(toks) // page)):
            ptoks = tuple(toks[pi * page:(pi + 1) * page])
            full = len(ptoks) == page
            key = (parent, ptoks)
            e = self._entries.get(key)
            if e is None:
                e = _Entry(key=key, block=self.bm.ref(table[pi]),
                           parent=parent, tokens=ptoks, full=full)
                self._entries[key] = e
                if parent in self._entries:
                    self._entries[parent].children += 1
                if not full:
                    self._partials.setdefault(parent, []).append(key)
                added += 1
            self._touch(e)
            if not full:
                break
            parent = key
        return added

    # -- eviction ------------------------------------------------------
    def _evictable(self) -> List[_Entry]:
        return [e for e in self._entries.values()
                if e.children == 0 and self.bm.refcount(e.block) == 1]

    def drainable_count(self) -> int:
        """How many cached blocks COULD come back to the pool if eviction
        ran to exhaustion right now: an entry drains iff nothing but the
        cache holds it and its whole subtree drains (leaf-first order).
        The scheduler checks this before evicting anything, so infeasible
        admissions never destroy cache state they cannot benefit from."""
        kids: Dict[tuple, List[_Entry]] = {}
        for e in self._entries.values():
            kids.setdefault(e.parent, []).append(e)
        memo: Dict[tuple, bool] = {}

        def drains(e: _Entry) -> bool:
            if e.key not in memo:
                memo[e.key] = (self.bm.refcount(e.block) == 1
                               and all(drains(c)
                                       for c in kids.get(e.key, ())))
            return memo[e.key]

        return sum(1 for e in self._entries.values() if drains(e))

    def evict_lru(self, need_blocks: int) -> int:
        """Free least-recently-used leaf entries until ``need_blocks``
        blocks came back to the pool (or nothing more is evictable).
        Returns how many blocks were freed."""
        freed = 0
        while freed < need_blocks:
            cands = self._evictable()
            if not cands:
                break
            e = self._entries[self._clock.oldest(c.key for c in cands)]
            self._drop(e)
            freed += 1
        return freed

    def _drop(self, e: _Entry) -> None:
        del self._entries[e.key]
        self._clock.forget(e.key)
        if e.parent in self._entries:
            self._entries[e.parent].children -= 1
        if not e.full:
            sibs = self._partials.get(e.parent)
            if sibs:
                sibs.remove(e.key)
                if not sibs:
                    del self._partials[e.parent]
        self.bm.deref(e.block)

    def clear(self) -> None:
        """Drop every entry and release the cache's refcounts (blocks
        still held by live slots stay allocated)."""
        for e in list(self._entries.values()):
            self._drop(e)
