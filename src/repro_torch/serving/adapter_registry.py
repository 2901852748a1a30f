"""Host-side adapter residency for multi-task serving (counterpart of
``src/repro/serving/adapter_registry.py``).

MetaTT's task mode makes the per-task marginal cost ONE core column
(paper Eq. (4)/(6)): a live runtime adds ``C[:, t]`` (L, M, r, r), a lora
runtime adds ``A[:, t]`` (L, M, d_in, r). The engine therefore does not
need the whole ``num_tasks`` axis on the card: it keeps a fixed-shape
POOL of ``K`` task slots there and pages task columns in on demand, as
the paged KV cache treats token pages:

  * ``AdapterRegistry`` (this module) is the host half — task id → pool
    slot, per-slot pins held by in-flight requests, LRU (or FIFO)
    eviction of idle residents. Pure Python, like BlockManager /
    PrefixCache; the shared ``LRUClock`` gives the recency order.
  * The device half is one in-place slot write per fault
    (``pool[:, slot].copy_(col)``, the engine's ``_adapter_fault_in``)
    from a host copy of the full factors. The pool's shape and storage
    never change, so the kernels see the same operands whatever flows
    through.
  * The per-slot (B,) task vector carries POOL-SLOT indices instead of
    task ids: the gather that builds the per-row A for K2 / #10
    (``peft/api.py::lora_form_factors``) is unchanged; only its index
    space shrank from ``num_tasks`` to ``K``.

Slot lifecycle (one slot, over time)::

      free ──acquire(miss)──> mapped+pinned ──release──> mapped+idle
       ^                          ^                          │
       │                          └────acquire(hit)──────────┤
       └────────── (clear) ───────────evict (new task faults)┘

``acquire`` is transactional against the device write: a slot reports
``fault=True`` until the engine confirms the write ran (``mark_loaded``),
so an admission that acquires a slot but then fails KV-block allocation
(and releases the pin) leaves the slot mapped-but-unloaded — the retry
faults again instead of decoding a stale or zero column.

The helpers at the bottom (``task_slice`` / ``scatter_slot`` /
``pool_factors``) move data between the host factors and the pool over
whole per-layer factor dicts, per adapter form ("c" live, "a" lora,
anything else — e.g. quantized ``{"q8","scale"}`` leaf dicts —
generically on the shared task-axis-1 layout).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import merge as merge_lib
from repro_torch.core import metatt as metatt_lib
from repro_torch.serving.lru import LRUClock
from repro_torch.tree import tree_map

POLICIES = ("lru", "fifo")


@dataclasses.dataclass
class AcquireResult:
    """Outcome of one ``acquire``: the pool slot the task maps to (the
    index the decode state carries), whether the engine must write the
    task's column before using it, and — on an evicting fault — which
    resident task was displaced."""
    slot: int
    fault: bool
    evicted: Optional[int] = None


class AdapterRegistry:
    """task id → device pool slot, with pins and LRU/FIFO eviction.

    Pure host state (like BlockManager). ``num_slots`` is
    ``RegistryConfig.max_resident_tasks``.

    Pin discipline: one pin per in-flight request (taken at admission via
    ``acquire``, dropped at harvest via ``release``). A pinned slot is
    never evicted — when every slot is pinned by distinct in-flight tasks,
    ``acquire`` returns None and admission backpressures exactly like a
    dry KV-block pool.
    """

    def __init__(self, num_slots: int, policy: str = "lru"):
        if num_slots < 1:
            raise ValueError(f"need >= 1 adapter slot, got {num_slots}")
        if policy not in POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"want one of {POLICIES}")
        self.num_slots = num_slots
        self.policy = policy
        self.clear()

    # -- introspection -------------------------------------------------
    def __len__(self) -> int:
        """Number of resident (mapped) tasks."""
        return len(self._slot_of)

    @property
    def resident_tasks(self) -> List[int]:
        """Task ids currently mapped to a slot (loaded or not)."""
        return sorted(self._slot_of)

    @property
    def pinned_slots(self) -> int:
        """Slots pinned by at least one in-flight request."""
        return sum(1 for p in self._pins if p > 0)

    def pin_count(self, task: int) -> int:
        """In-flight requests currently pinning ``task`` (0 if absent)."""
        slot = self._slot_of.get(task)
        return 0 if slot is None else self._pins[slot]

    def slot_of(self, task: int) -> Optional[int]:
        """Pool slot ``task`` is mapped to, or None."""
        return self._slot_of.get(task)

    # -- acquire / load / release --------------------------------------
    def acquire(self, task: int) -> Optional[AcquireResult]:
        """Pin ``task`` into a slot for one admission.

        Hit (mapped and loaded): pin + recency touch, no device work.
        Miss: take a free slot, else evict the least-recently-used
        UNPINNED resident; either way the result says ``fault=True`` and
        the engine must write the column and ``mark_loaded`` before the
        slot is read. None: every slot is pinned (admission backpressure;
        the caller retries after a harvest releases pins).
        """
        slot = self._slot_of.get(task)
        evicted = None
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._clock.oldest(
                    s for s in range(self.num_slots) if self._pins[s] == 0)
                if slot is None:
                    return None
                evicted = self._task_of.pop(slot)
                del self._slot_of[evicted]
                self._loaded[slot] = False
            self._slot_of[task] = slot
            self._task_of[slot] = task
        self._pins[slot] += 1
        # fifo ranks by load order only; lru also refreshes on every hit
        if self.policy == "lru" or not self._loaded[slot]:
            self._clock.touch(slot)
        return AcquireResult(slot=slot, fault=not self._loaded[slot],
                             evicted=evicted)

    def mark_loaded(self, task: int) -> None:
        """Engine confirmation that the device write for ``task``'s slot
        ran — until then every ``acquire`` keeps reporting a fault."""
        slot = self._slot_of.get(task)
        if slot is None:
            raise ValueError(f"mark_loaded of unmapped task {task}")
        self._loaded[slot] = True

    def release(self, task: int) -> None:
        """Drop one pin (request finished / admission rolled back). The
        slot stays mapped — an idle resident is a future hit — until an
        eviction reclaims it."""
        slot = self._slot_of.get(task)
        if slot is None or self._pins[slot] <= 0:
            raise ValueError(f"release of unpinned task {task}")
        self._pins[slot] -= 1

    def clear(self) -> None:
        """Forget every mapping and pin (engine pool reset)."""
        self._slot_of: Dict[int, int] = {}      # task id -> slot
        self._task_of: Dict[int, int] = {}      # slot -> task id
        self._pins = [0] * self.num_slots       # in-flight requests a slot
        self._loaded = [False] * self.num_slots  # device write confirmed
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._clock = LRUClock()                # recency over slot indices


# --------------------------------------------------------------------------
# pool data motion
# --------------------------------------------------------------------------
#
# Per-layer factor dicts map adapter-form keys to tensors (or to quantized
# {"q8","scale"} sub-dicts) whose TASK MODE IS AXIS 1: live "c" (L, T, M,
# r, r), lora "a" (L, T, M, d_in, r). The named core helpers hold that
# contract; other keys take the same axis-1 slice / write generically.

def _take_fn(key):
    if key == "c":
        return metatt_lib.take_task_slice
    if key == "a":
        return merge_lib.lora_task_slice
    return lambda x, task: x[:, task]


def _put_fn(key):
    if key == "c":
        return metatt_lib.put_task_slice
    if key == "a":
        return merge_lib.lora_task_put
    return lambda pool, slot, col: pool[:, slot].copy_(col,
                                                       non_blocking=True)


def task_slice(per_layer: dict, task) -> dict:
    """ONE task's column of every per-task factor leaf (views of
    ``per_layer``) — what a fault-in writes into a pool slot."""
    return {key: tree_map(lambda x, take=_take_fn(key): take(x, task), leaf)
            for key, leaf in per_layer.items()}


def scatter_slot(per_layer: dict, slot, col: dict) -> dict:
    """Write one task column (``task_slice`` output, on any device) into
    pool slot ``slot`` of every leaf, in place; the pool keeps its shape
    and storage. Returns ``per_layer``."""
    for key, leaf in per_layer.items():
        tree_map(lambda pool, c, put=_put_fn(key): put(pool, slot, c),
                 leaf, col[key])
    return per_layer


def _task_major(shape, dtype, device, pin_memory=False) -> torch.Tensor:
    """Zeros of ``shape`` (task axis 1) stored task-major: the returned
    view's ``[:, t]`` is one contiguous block, so a column moves in one
    copy."""
    shape = tuple(shape)
    return torch.zeros((shape[1], shape[0]) + shape[2:], dtype=dtype,
                       device=device, pin_memory=pin_memory).movedim(0, 1)


def pool_factors(per_layer: dict, num_slots: int, device=None) -> dict:
    """A zeroed pool with the task axis (axis 1) resized to ``num_slots``
    — the fixed geometry the kernels see — on ``device`` (default: each
    leaf's own), each slot one contiguous block. Slots hold zeros
    (ΔW == 0, a valid no-op adapter) until a fault loads them; the
    registry's loaded flags keep any request from decoding against an
    unloaded slot."""
    def widen(x):
        return _task_major(x.shape[:1] + (num_slots,) + x.shape[2:],
                           x.dtype, x.device if device is None else device)

    return tree_map(widen, per_layer)


def host_factors(per_layer: dict) -> dict:
    """A host copy of the full per-layer factors (the same shapes, task
    axis 1), each task's column one contiguous block of page-locked
    memory when CUDA is available: a fault-in's copy to the card is one
    DMA."""
    def host(x):
        return _task_major(x.shape, x.dtype, "cpu",
                           pin_memory=torch.cuda.is_available()).copy_(x)

    return tree_map(host, per_layer)
