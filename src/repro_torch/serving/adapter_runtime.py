"""Adapter runtime for serving (counterpart of
``src/repro/serving/adapter_runtime.py``, modes ``live`` and ``none``).

  live — the TT contraction runs per step (G1 / C[l,t,m] / G4); on a 4+1d
         adapter each request is routed by its task id.
  none — the base model only.
The ``lora`` and ``merged`` modes are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.peft import api as peft_api

MODES = ("live", "lora", "merged", "none")
PORTED = ("live", "none")


@dataclasses.dataclass
class AdapterRuntime:
    mode: str
    spec: peft_api.AdapterSpec
    base: Any
    broadcast: Any
    per_layer: Any
    tasked: bool = False
    folded_task: Optional[int] = None

    @classmethod
    def build(cls, mode: str, base, spec: peft_api.AdapterSpec, adapter,
              frozen=None, *, model_cfg=None,
              task: Optional[int] = None) -> "AdapterRuntime":
        if mode not in MODES:
            raise ValueError(f"unknown runtime mode {mode!r}; want {MODES}")
        if mode not in PORTED:
            raise NotImplementedError(
                f"runtime mode {mode!r} is not ported yet (live, none)")
        if mode == "none" or spec.kind == "none":
            return cls(mode="none", spec=peft_api.NONE, base=base,
                       broadcast={}, per_layer=None)
        has_tasks = spec.kind == "metatt" and spec.cfg.variant == "4+1d"
        bc, pl = peft_api.adapter_factors(spec, adapter, frozen or {})
        return cls(mode="live", spec=spec, base=base, broadcast=bc,
                   per_layer=pl, tasked=has_tasks)

    def check_task(self, task: int) -> None:
        """Reject requests whose task id this runtime cannot honor."""
        if self.tasked:
            if not 0 <= task < self.spec.cfg.num_tasks:
                raise ValueError(
                    f"task id {task} out of range for num_tasks="
                    f"{self.spec.cfg.num_tasks}")
            return
        if task != 0:
            raise ValueError(
                f"runtime (mode={self.mode}) has no task routing and serves "
                f"task 0 only; request for task {task} needs a live runtime "
                "on a 4+1d adapter")
