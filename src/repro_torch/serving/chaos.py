"""Seeded chaos injection and invariant audits for the serving engine
(counterpart of ``src/repro/serving/chaos.py``, one replica).

The refcounted host state behind continuous batching — BlockManager free
lists, PrefixCache entry refs, AdapterRegistry pins — is exactly the state
that silently corrupts when an abort / preemption path forgets one deref.
This module gives both halves of the defence:

  * ``ChaosInjector`` — a deterministic, seeded fault schedule the engine
    consults between steps: forced allocation failures (the Scheduler's
    ``fault_hook`` seam makes ``plan`` report backpressure), adapter
    fault-in failures (the admission unwinds and the slot stays
    mapped-but-unloaded, exercising the registry's transactional loaded
    flag), request cancellations at host step k, and per-request NaN
    logits (the engine's NaN guard fails the request instead of emitting
    garbage). Its trigger is ``distributed/fault_tolerance.FailureInjector``,
    the fail-at-step primitive of the training tests. A replica kill
    needs data-parallel replicas and the router, which the port does not
    have yet: ``kill_replica_at`` raises ``NotImplementedError``.
  * ``audit(engine)`` / ``audit_pools(...)`` — the invariants every host
    step must keep: block conservation (free + held == num_blocks, the
    free list exactly the refcount-0 set), per-block refcounts equal to
    the number of live holders (slot tables + prefix entries), no adapter
    slot pinned but unloaded, and registry pin counts equal to the live
    requests per task. When a ``ChaosInjector`` rides a ``generate``
    call, the engine runs ``audit`` after EVERY host-loop iteration
    (``audit_every_step=False`` opts out).

Everything here is host state; injection is deterministic given the seed,
so a chaos run replays exactly.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure)


class ChaosInjector:
    """Deterministic seeded fault schedule for one ``generate`` call.

    seed: seeds the allocation-failure draw (``alloc_fail_rate``); every
        other fault is scheduled by explicit step / request keys.
    kill_replica_at: ``(step, replica)`` — raises ``NotImplementedError``:
        a replica kill drains a data-parallel replica through the router,
        and the port serves one device without either (ROADMAP.md Queue 1
        item 6, multi-GPU).
    alloc_fail_steps: host-loop iterations on which every ``plan`` call
        is forced to report backpressure.
    alloc_fail_rate: per-``plan`` probability of a forced failure, drawn
        from the seeded rng (composes with ``alloc_fail_steps``).
    scatter_failures: fail the first N adapter fault-ins — the admission
        that triggered one unwinds (blocks deref'd, pin released) and the
        slot stays mapped-but-UNLOADED until a retry's write succeeds.
    nan_after: ``{request_id: widx}`` — NaN logits in that request's row
        once it is about to emit token ``widx`` (0 fails it before any
        output); the engine's NaN guard turns it into a FAILED request and
        ``EngineStats.numerics_faults``.
    cancel_at: ``{step: [request_id, ...]}`` — ``Engine.cancel`` of those
        ids at host-loop iteration ``step``.
    audit_every_step: run ``audit(engine)`` after every host-loop
        iteration of the generate this injector rides (default True).

    One injector rides ONE generate call: ``scatter_failures`` is consumed
    statefully.
    """

    def __init__(self, seed: int = 0, *,
                 kill_replica_at: Optional[Tuple[int, int]] = None,
                 alloc_fail_steps: Iterable[int] = (),
                 alloc_fail_rate: float = 0.0,
                 scatter_failures: int = 0,
                 nan_after: Optional[Dict[object, int]] = None,
                 cancel_at: Optional[Dict[int, Sequence[object]]] = None,
                 audit_every_step: bool = True):
        if kill_replica_at is not None:
            raise NotImplementedError(
                "ChaosInjector(kill_replica_at=...) drains a data-parallel "
                "replica through the router; the port serves one device "
                "without replicas or a router yet (ROADMAP.md Queue 1 "
                "item 6)")
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.alloc_fail_steps = frozenset(int(s) for s in alloc_fail_steps)
        self.alloc_fail_rate = float(alloc_fail_rate)
        self._scatter_budget = int(scatter_failures)
        self.nan_after = dict(nan_after or {})
        self.cancel_at = {int(k): tuple(v)
                          for k, v in (cancel_at or {}).items()}
        self.audit_every_step = audit_every_step
        self._step = 0
        # the scripted-cancel trigger: the training tests' fail-at-step
        # primitive, re-armed at the next scheduled step after each fire
        self._cancel_steps = sorted(self.cancel_at)
        self._trigger = FailureInjector(
            fail_at_step=self._cancel_steps[0] if self._cancel_steps else -1)
        # what actually fired (tests assert against these)
        self.alloc_faults = 0
        self.scatter_faults = 0
        self.killed: List[int] = []
        # host-loop iterations seen, audits run after them, and iterations
        # that ended in an injected stall (nothing admitted, stepped or
        # harvested because of a forced failure: retried, not audited)
        self.steps = 0
        self.audits = 0
        self.stalls = 0

    # -- engine-facing hooks -------------------------------------------
    def tick(self, step: int) -> dict:
        """Events for host-loop iteration ``step``: request ids to cancel
        (``kill`` is always None: no replicas)."""
        self._step = step
        self.steps += 1
        cancels: Tuple[object, ...] = ()
        try:
            self._trigger.check(step)
        except SimulatedFailure:
            cancels = self.cancel_at[step]
            later = [s for s in self._cancel_steps if s > step]
            self._trigger.fail_at_step = later[0] if later else -1
        return dict(kill=None, cancels=cancels)

    def fail_alloc(self) -> bool:
        """Scheduler ``fault_hook``: force this ``plan`` call to report
        backpressure?"""
        fire = (self._step in self.alloc_fail_steps
                or (self.alloc_fail_rate > 0.0
                    and self._rng.random() < self.alloc_fail_rate))
        if fire:
            self.alloc_faults += 1
        return fire

    def fail_scatter(self) -> bool:
        """Fail the next adapter fault-in? (the first N calls)"""
        if self._scatter_budget > 0:
            self._scatter_budget -= 1
            self.scatter_faults += 1
            return True
        return False

    def nan_for(self, request_id) -> int:
        """NaN-injection threshold for ``request_id``'s slot (-1: never;
        the engine's guard compares ``widx >= threshold``)."""
        return int(self.nan_after.get(request_id, -1))


# ---------------------------------------------------------------------------
# invariant audits
# ---------------------------------------------------------------------------


def audit_pools(bm, prefix, holders: Iterable[List[int]],
                registry=None,
                pinned_tasks: Optional[Iterable[int]] = None) -> None:
    """Component invariants over one BlockManager (+ optional PrefixCache
    / AdapterRegistry). Raises AssertionError on a violation.

    holders: one block-id list per live holder (a slot) — each appearance
    counts one reference; the prefix cache adds one per cached entry.
    pinned_tasks: one task id per live pin holder.
    """
    expected = collections.Counter()
    for blocks in holders:
        for bid in blocks:
            expected[bid] += 1
    if prefix is not None:
        for e in prefix._entries.values():
            expected[e.block] += 1
    free = set(bm._free)
    assert len(free) == len(bm._free), \
        f"free list holds duplicates: {sorted(bm._free)}"
    for bid in range(bm.num_blocks):
        rc = bm.refcount(bid)
        assert rc == expected.get(bid, 0), (
            f"block {bid}: refcount {rc} != {expected.get(bid, 0)} "
            "live holders (leak or double-free)")
        assert (rc == 0) == (bid in free), (
            f"block {bid}: refcount {rc} but "
            f"{'in' if bid in free else 'not in'} the free list")
    assert bm.free_blocks + bm.used_blocks == bm.num_blocks
    if registry is not None:
        pins = collections.Counter()
        for t in (pinned_tasks or ()):
            pins[t] += 1
        for task, n in pins.items():
            assert registry.slot_of(task) is not None, \
                f"task {task} has {n} live pins but no slot mapping"
        for slot in range(registry.num_slots):
            task = registry._task_of.get(slot)
            want = pins.get(task, 0) if task is not None else 0
            assert registry._pins[slot] == want, (
                f"adapter slot {slot} (task {task}): {registry._pins[slot]} "
                f"pins != {want} live holders")
            if registry._pins[slot] > 0:
                assert registry._loaded[slot], (
                    f"adapter slot {slot} (task {task}) is pinned but "
                    "UNLOADED — a request would decode a stale or zero "
                    "column")
        assert registry._slot_of == {
            t: s for s, t in registry._task_of.items()}, \
            "task <-> slot mapping is not a bijection"


def audit(engine) -> None:
    """Engine invariants, valid between host-loop iterations and at rest.
    Raises AssertionError on a violation.

    Mid-generate the engine publishes its live bookkeeping on
    ``engine._live`` (``meta``: one dict per occupied slot with its
    ``blocks`` (paged) and ``task``); at rest the block pool holds
    prefix-cache blocks only and the registry carries zero pins — "the
    pool drains to empty". A dense engine has no block pool: only its
    registry is audited.
    """
    live = getattr(engine, "_live", None)
    meta = live["meta"] if live else []
    slots = [m for m in meta if m is not None]
    if engine.paged:
        audit_pools(engine.bm, engine.prefix, [m["blocks"] for m in slots])
    if engine.registry is not None:
        audit_pools(BlockManagerStub(), None, [], registry=engine.registry,
                    pinned_tasks=[m["task"] for m in slots])


class BlockManagerStub:
    """A zero-block stand-in so ``audit_pools`` can check a registry alone
    (decode blocks and adapter pins have different holder sets)."""
    num_blocks = 0
    free_blocks = 0
    used_blocks = 0
    _free: List[int] = []

    def refcount(self, bid: int) -> int:    # pragma: no cover
        raise IndexError(bid)
