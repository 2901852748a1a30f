"""Per-``generate`` engine observability (counterpart of
``src/repro/serving/stats.py``: the fields that mean something for the
eager engine, dense and paged; no trace counters — nothing is traced).

Byte accounting is GLOBAL (all ranks): ``block_bytes`` / ``kv_bytes_peak``
describe the whole logical cache whatever the serve mesh, so paged-vs-
dense and int8-vs-fp comparisons read alike on one device and under
tensor parallelism. ``shards`` is how many ways the kv-head axis is split
(1 without a mesh); the ``*_per_shard`` properties divide the global
figures down to what one rank holds."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EngineStats:
    """Counters for one ``Engine.generate`` call (host-side numbers)."""
    cache_mode: str = "paged"
    requests: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0
    admitted: int = 0
    evicted: int = 0
    decode_calls: int = 0        # decode-loop invocations (host -> loop)
    decode_steps: int = 0        # model steps inside those loops
    prefills: int = 0            # dense: bucketed prefills (paged: 0, the
    #                              prompt runs in-loop in chunks)
    prefill_s: float = 0.0       # host wall time of prefill + admission
    decode_s: float = 0.0        # host wall time inside decode loops
    weights_dtype: str = "fp"    # "fp" | "int8" — frozen base matmul leaves
    kv_dtype: str = "fp"         # "fp" | "int8" — KV cache cells
    # --- KV memory ---
    page_size: int = 0           # dense: cache_len (one "block" per slot)
    num_blocks: int = 0          # paged: pool budget; dense: max_batch
    kv_blocks_peak: int = 0      # max blocks simultaneously in use
    block_bytes: int = 0         # global device bytes per block (all
    #                              layers, k+v; every rank holds 1/shards)
    shards: int = 1              # kv-head shards (the tensor-parallel
    #                              ranks; 1 = one device)
    # --- latency phase split (paged; host clock at loop exits) ---
    ttft_s: float = 0.0          # mean time-to-first-token over requests
    tpot_s: float = 0.0          # mean per-token time after the first
    # --- prefix cache (paged) ---
    prefix_lookups: int = 0      # admissions that consulted the cache
    prefix_hit_tokens: int = 0   # prompt tokens served from cached blocks
    prefix_lookup_tokens: int = 0  # prompt tokens eligible for reuse
    cow_copies: int = 0          # copy-on-write block copies
    cache_evictions: int = 0     # prefix blocks reclaimed under pressure
    # --- scheduler ---
    backpressure_waits: int = 0  # admissions deferred for lack of blocks
    #                              or of an adapter slot
    # --- adapter registry ---
    max_resident_tasks: int = 0  # device task-slot pool size (0: the whole
    #                              task axis resident, registry off — the
    #                              adapter_* counters stay 0)
    adapter_hits: int = 0        # admissions whose task was already pooled
    adapter_faults: int = 0      # host->device task-slice fault-ins
    adapter_evictions: int = 0   # idle residents displaced by a fault
    adapter_waits: int = 0       # admissions deferred: all slots pinned
    #                              (also counted in backpressure_waits)
    # --- speculative decode ---
    spec_k: int = 0              # drafts per engine step (0: spec off)
    spec_steps: int = 0          # engine steps (decode-loop iterations)
    draft_tokens: int = 0        # drafter proposals (active decode rows)
    accepted_tokens: int = 0     # proposals the verifier accepted
    # --- resilience ---
    cancelled: int = 0
    timeouts: int = 0
    preemptions: int = 0         # recompute preemptions (victim re-queued)
    failed_requests: int = 0
    numerics_faults: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of reuse-eligible prompt tokens served from cached
        blocks (0.0 when nothing was eligible)."""
        if not self.prefix_lookup_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_lookup_tokens

    @property
    def kv_bytes_peak(self) -> int:
        """Peak GLOBAL (all-rank) KV bytes in use."""
        return self.kv_blocks_peak * self.block_bytes

    @property
    def block_bytes_per_shard(self) -> int:
        """Device bytes one rank holds per block: the kv-head axis splits
        ``shards`` ways and every other dim stays whole."""
        return self.block_bytes // max(self.shards, 1)

    @property
    def kv_bytes_peak_per_shard(self) -> int:
        """Peak KV bytes resident on ONE rank (the global peak on one
        device, global / shards under TP)."""
        return self.kv_blocks_peak * self.block_bytes_per_shard

    @property
    def adapter_hit_rate(self) -> float:
        """Fraction of admissions whose task slice was already in the
        device pool (0.0 when the registry is off or nothing admitted)."""
        n = self.adapter_hits + self.adapter_faults
        return self.adapter_hits / n if n else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafter proposals the verifier accepted (0.0 when
        speculation is off or no decode step ran)."""
        if not self.draft_tokens:
            return 0.0
        return self.accepted_tokens / self.draft_tokens

    @property
    def tokens_per_step(self) -> float:
        """Committed tokens per engine step (chunked-prefill steps count
        too)."""
        if not self.spec_steps:
            return 0.0
        return self.tokens_generated / self.spec_steps

    def summary(self) -> str:
        paged = self.cache_mode == "paged"
        return (f"mode={self.cache_mode} w={self.weights_dtype} "
                f"kv={self.kv_dtype} shards={self.shards} "
                f"reqs={self.requests} "
                f"toks={self.tokens_generated} "
                f"tok/s={self.tokens_per_s:.1f} "
                + (f"ttft={self.ttft_s * 1e3:.1f}ms "
                   f"tpot={self.tpot_s * 1e3:.2f}ms " if self.ttft_s else "")
                + f"prefills={self.prefills} decode_steps={self.decode_steps} "
                f"kv_blocks_peak={self.kv_blocks_peak}/{self.num_blocks} "
                f"kv_bytes_peak={self.kv_bytes_peak} "
                f"(per_shard={self.kv_bytes_peak_per_shard}) "
                + (f"prefix_hit_rate={self.prefix_hit_rate:.2f} "
                   f"cow={self.cow_copies} waits={self.backpressure_waits} "
                   if paged else "")
                + f"admits={self.admitted} evicts={self.evicted}"
                + (f" adapters={self.max_resident_tasks}slots "
                   f"hit={self.adapter_hit_rate:.2f} "
                   f"faults={self.adapter_faults} "
                   f"aevicts={self.adapter_evictions} "
                   f"awaits={self.adapter_waits}"
                   if self.max_resident_tasks else "")
                + (f" spec_k={self.spec_k} "
                   f"accept={self.acceptance_rate:.2f} "
                   f"tok/step={self.tokens_per_step:.2f}"
                   if self.spec_k else "")
                + (f" cancelled={self.cancelled} timeouts={self.timeouts} "
                   f"preempts={self.preemptions} "
                   f"failed={self.failed_requests} "
                   f"nan_faults={self.numerics_faults}"
                   if (self.cancelled or self.timeouts or self.preemptions
                       or self.failed_requests or self.numerics_faults)
                   else ""))
