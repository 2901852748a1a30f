"""LRU bookkeeping for the host-side caches (a copy of
``src/repro/serving/lru.py``).

The ``PrefixCache`` (KV-block prefix index, block_manager.py) needs a
monotonic recency clock over hashable keys, where eviction picks the
least-recently-touched entry among whatever subset the caller deems
evictable (unpinned leaves). ``LRUClock`` is that primitive; the JAX
package's adapter registry uses the same one.

Pure host state. The clock never decides *what* is evictable; callers
pass the candidate set and get the stalest member back.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, Optional


class LRUClock:
    """Monotonic recency clock: ``touch`` stamps a key with the next tick,
    ``oldest`` returns the least-recently-touched of a candidate set.

    Keys never touched rank older than any touched key (tick 0), and ties
    — only possible among never-touched keys — break toward the earliest
    candidate in iteration order, keeping eviction deterministic.
    """

    def __init__(self) -> None:
        self._tick = 0
        self._ticks: Dict[Hashable, int] = {}

    def __len__(self) -> int:
        return len(self._ticks)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._ticks

    def touch(self, key: Hashable) -> int:
        """Stamp ``key`` as most-recently-used; returns its new tick."""
        self._tick += 1
        self._ticks[key] = self._tick
        return self._tick

    def forget(self, key: Hashable) -> None:
        """Drop ``key``'s stamp (evicted / released entries)."""
        self._ticks.pop(key, None)

    def tick_of(self, key: Hashable) -> int:
        """Current stamp of ``key`` (0 = never touched == infinitely old)."""
        return self._ticks.get(key, 0)

    def oldest(self, candidates: Iterable[Hashable]) -> Optional[Hashable]:
        """The least-recently-touched member of ``candidates`` (None when
        empty). ``min`` is stable, so equal-tick (never-touched) keys fall
        back to candidate order — deterministic for list inputs."""
        cands = list(candidates)
        if not cands:
            return None
        return min(cands, key=self.tick_of)
