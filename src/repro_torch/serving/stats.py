"""Per-``generate`` engine observability (counterpart of
``src/repro/serving/stats.py``: the fields that mean something for the
dense eager engine; no trace counters — nothing is traced)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EngineStats:
    """Counters for one ``Engine.generate`` call (host-side numbers)."""
    cache_mode: str = "dense"
    requests: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0
    admitted: int = 0
    evicted: int = 0
    decode_calls: int = 0        # decode-loop invocations (host -> loop)
    decode_steps: int = 0        # model steps inside those loops
    prefills: int = 0
    prefill_s: float = 0.0       # host wall time of prefill + admission
    decode_s: float = 0.0        # host wall time inside decode loops
    # --- KV memory ---
    page_size: int = 0           # dense: cache_len (one "block" per slot)
    num_blocks: int = 0          # dense: max_batch
    kv_blocks_peak: int = 0
    block_bytes: int = 0
    # --- resilience ---
    cancelled: int = 0
    timeouts: int = 0
    failed_requests: int = 0
    numerics_faults: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0

    @property
    def kv_bytes_peak(self) -> int:
        return self.kv_blocks_peak * self.block_bytes

    def summary(self) -> str:
        return (f"mode={self.cache_mode} reqs={self.requests} "
                f"toks={self.tokens_generated} "
                f"tok/s={self.tokens_per_s:.1f} "
                f"prefills={self.prefills} decode_steps={self.decode_steps} "
                f"kv_bytes_peak={self.kv_bytes_peak} "
                f"admits={self.admitted} evicts={self.evicted}"
                + (f" cancelled={self.cancelled} timeouts={self.timeouts} "
                   f"failed={self.failed_requests} "
                   f"nan_faults={self.numerics_faults}"
                   if (self.cancelled or self.timeouts
                       or self.failed_requests) else ""))
