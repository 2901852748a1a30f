"""Adapter runtime for serving (counterpart of
``src/repro/serving/adapter_runtime.py``). One trained adapter is served
one of four ways; the runtime hands the engine a uniform (spec, base,
broadcast, per_layer) bundle:

  live   — the TT contraction runs per step (G1 / C[l,t,m] / G4); on a
           4+1d adapter each request is routed by its task id.
  lora   — ``core/merge.to_lora_form`` folds α and the middle cores into
           the left boundary once (A = α·G1·C), so serving runs the same
           two rank-r products as LoRA (paper §2.4: "match the speeds of
           LoRA"); the task axis survives as a leading axis of A.
  merged — ``core/merge.fold_transformer`` adds ΔW into the frozen
           weights: no adapter work at serving time. A 4+1d adapter is
           frozen to ONE task (``folded_task``); other tasks are rejected.
           A MetaTT-(4+E)D adapter serves ``live`` only: its expert axis
           is contracted inside the MoE layers (``models/moe.py``).
           Under int8 weights the engine quantizes the folded base.
  none   — the base model only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import merge
from repro_torch.peft import api as peft_api

MODES = ("live", "lora", "merged", "none")


@dataclasses.dataclass
class AdapterRuntime:
    mode: str
    spec: peft_api.AdapterSpec     # effective spec (NONE for merged / none)
    base: Any                      # effective base (folded for merged)
    broadcast: Any
    per_layer: Any
    tasked: bool = False           # per-request task ids route the adapter
    folded_task: Optional[int] = None

    @classmethod
    def build(cls, mode: str, base, spec: peft_api.AdapterSpec, adapter,
              frozen=None, *, model_cfg=None,
              task: Optional[int] = None) -> "AdapterRuntime":
        """base: frozen model weights; (spec, adapter, frozen): the
        trained adapter; model_cfg: the ModelConfig (mode="merged");
        task: the task folded into the weights for mode="merged" on a
        4+1d adapter (default 0)."""
        if mode not in MODES:
            raise ValueError(f"unknown runtime mode {mode!r}; want {MODES}")
        frozen = frozen or {}
        if mode == "none" or spec.kind == "none":
            return cls(mode="none", spec=peft_api.NONE, base=base,
                       broadcast={}, per_layer=None)
        # any 4+1d adapter routes by task; 4+ed's extra axis is expert-,
        # not request-, indexed, so it is not request-routed
        has_tasks = spec.kind == "metatt" and spec.cfg.variant == "4+1d"
        if mode == "live":
            bc, pl = peft_api.adapter_factors(spec, adapter, frozen)
            return cls(mode="live", spec=spec, base=base, broadcast=bc,
                       per_layer=pl, tasked=has_tasks)
        if spec.kind != "metatt":
            raise ValueError(
                f"runtime mode {mode!r} pre-merges TT cores and only applies "
                f"to metatt adapters (got {spec.kind!r}); use mode='live'")
        if mode == "lora":
            if spec.cfg.variant == "4+ed":
                raise ValueError(
                    "4+ed expert routing (models/moe.py) contracts g1 / C "
                    "directly; serve MoE-expert adapters with mode='live'")
            form = merge.to_lora_form(adapter, spec.cfg)
            return cls(mode="lora", spec=spec, base=base,
                       broadcast={"g4": form.b}, per_layer={"a": form.a},
                       tasked=has_tasks)
        if model_cfg is None:
            raise ValueError("mode='merged' needs model_cfg to locate every "
                             "adapted weight in the base tree")
        fold_task = task
        if spec.cfg.variant in ("4+1d", "4+ed") and fold_task is None:
            fold_task = 0
        folded = merge.fold_transformer(adapter, spec.cfg, base, model_cfg,
                                        task=fold_task)
        return cls(mode="merged", spec=peft_api.NONE, base=folded,
                   broadcast={}, per_layer=None, folded_task=fold_task)

    def check_task(self, task: int) -> None:
        """Reject requests whose task id this runtime cannot honor."""
        if self.tasked:
            if not 0 <= task < self.spec.cfg.num_tasks:
                raise ValueError(
                    f"task id {task} out of range for num_tasks="
                    f"{self.spec.cfg.num_tasks}")
            return
        # untasked: only the task it serves (the folded slice, or task 0
        # for task-axis-free adapters); anything else would silently
        # ignore the routing the client asked for
        served = self.folded_task if self.folded_task is not None else 0
        if task != served:
            raise ValueError(
                f"runtime (mode={self.mode}) has no task routing and serves "
                f"task {served} only; request for task {task} needs a "
                "live/lora runtime on a 4+1d adapter")
