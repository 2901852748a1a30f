"""Training loop: checkpoint / restart, DMRG rank-adaptive sweeps,
straggler watchdog, multi-task cycling (counterpart of
``src/repro/train/trainer.py``).

The loop is host-driven: a DMRG sweep changes the adapter's shapes
mid-run. At an epoch end with a scheduled target rank the trainer sweeps
the cores (with the AdamW moments transported through each two-site
resplit when ``train.dmrg_warm_moments``, else the paper's cold re-init)
and carries on at the new ranks. With ``train.ckpt_dir`` it saves the
train state every ``train.ckpt_every`` steps and at the end (keeping
``train.ckpt_keep``), and a new Trainer on the same directory resumes
from the newest checkpoint: adapter, optimizer state, step counter,
data-iterator state, the DMRG schedule position and, with top-k gradient
compression (``train.grad_compression``), the error-feedback residual.
Sweeps run BEFORE the boundary save, so a resume lands on the post-sweep
triple and never replays a sweep.

Parameters come from ``torch.Generator(device).manual_seed(train.seed)``.
To train from other weights, assign ``tr.base``, ``tr.frozen`` and
``tr.state`` (``train_step.init_train_state(adapter, tr.compressor)``)
before ``train``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config.base import RunConfig
from repro_torch.core import dmrg as dmrg_lib
from repro_torch.core import tt
from repro_torch.device import resolve_device
from repro_torch.distributed import FailureInjector, Watchdog
from repro_torch.distributed.compression import GradCompressor
from repro_torch.models import model as model_lib
from repro_torch.peft import api as peft_api
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class Trainer:
    run: RunConfig
    data: Any                                  # iterator with state()/restore()
    total_steps: int
    steps_per_epoch: int = 0                   # 0 -> no epoch semantics
    rank_schedule: Optional[dmrg_lib.RankSchedule] = None
    failure_injector: Optional[FailureInjector] = None
    on_metrics: Optional[Callable[[int, dict], None]] = None
    task_cycle: tuple = ()                     # MTL: task ids for joint training
    device: Any = None                         # None -> the CUDA device

    def __post_init__(self):
        run = self.run
        self.device = resolve_device(self.device)
        self.cfg = run.model
        self.spec = model_lib.build_adapter_spec(run)
        gen = torch.Generator(self.device).manual_seed(run.train.seed)
        params = model_lib.init_params(self.cfg, self.spec, gen,
                                       device=self.device)
        self.base, self.frozen = params["base"], params["frozen"]
        self.compressor = GradCompressor(run.train.grad_compression)
        self.state = ts.init_train_state(params["adapter"], self.compressor)
        self.step_fn = ts.make_train_step(
            self.cfg, self.spec, run.optimizer, run.train, self.total_steps,
            kernels=run.kernels, device=self.device)
        self.ckpt = (CheckpointManager(run.train.ckpt_dir,
                                       keep=run.train.ckpt_keep)
                     if run.train.ckpt_dir else None)
        self.watchdog = Watchdog()
        self.straggler_events: list = []
        self.watchdog.on_straggler = lambda s, dt, ew: \
            self.straggler_events.append((s, dt, ew))
        self.history: list = []
        self._dmrg_applied: list = []      # epochs whose sweep already ran
        self._resume()

    # ------------------------------------------------------------------
    def _resume(self) -> None:
        """Load the newest checkpoint, if any, over the fresh state (its
        shapes win: the ranks may have changed at a sweep)."""
        if self.ckpt is None:
            return
        got = self.ckpt.restore_latest(self.state)
        if got is None:
            return
        step, state, meta = got
        self.state = state
        if "data_state" in meta and hasattr(self.data, "restore"):
            self.data.restore(meta["data_state"])
        dm = meta.get("dmrg") or {}
        self._dmrg_applied = list(dm.get("applied_epochs", []))
        extra = (f" (dmrg epochs {self._dmrg_applied}, "
                 f"ranks {tuple(dm.get('ranks', ()))})" if dm else "")
        print(f"[trainer] resumed from checkpoint step {step}{extra}")

    def _save(self, step: int) -> None:
        if self.ckpt is None:
            return
        meta = {}
        if hasattr(self.data, "state"):
            meta["data_state"] = self.data.state()
        adapter = self.state.adapter
        if isinstance(adapter, dict) and "cores" in adapter:
            # the schedule position rides with the reshaped params and
            # optimizer state, so a resume cannot lose a rank change
            meta["dmrg"] = {
                "applied_epochs": list(self._dmrg_applied),
                "ranks": [int(r) for r in tt.ranks(adapter["cores"])],
            }
        self.ckpt.save(step, self.state, meta)

    # ------------------------------------------------------------------
    def _maybe_dmrg(self, step: int) -> None:
        """End-of-epoch DMRG sweep per the rank schedule (paper Fig. 2)."""
        if (self.rank_schedule is None or not self.steps_per_epoch
                or self.spec.kind != "metatt"):
            return
        if step == 0 or step % self.steps_per_epoch:
            return
        epoch = step // self.steps_per_epoch
        target = self.rank_schedule.rank_after_epoch(epoch)
        if target is None or epoch in self._dmrg_applied:
            return
        warm = self.run.train.dmrg_warm_moments
        moments = (self.state.opt.mu, self.state.opt.nu) if warm else None
        res = dmrg_lib.dmrg_sweep(self.state.adapter, target_rank=target,
                                  moments=moments)
        n_before = peft_api.count_trainable(self.spec, self.state.adapter)
        n_after = peft_api.count_trainable(self.spec, res.params)
        self.state = ts.reinit_after_dmrg(self.state, res.params,
                                          self.compressor,
                                          moments=res.moments)
        self._dmrg_applied.append(epoch)
        print(f"[trainer] DMRG sweep @step {step}: ranks -> {res.ranks} "
              f"params {n_before} -> {n_after} "
              f"({'warm' if warm else 'cold'} moments)")

    # ------------------------------------------------------------------
    def _next_batch(self, step: int) -> dict:
        if self.task_cycle:
            task = self.task_cycle[step % len(self.task_cycle)]
            raw = self.data.sample(task)
        else:
            raw = next(self.data)
        batch = {}
        for k in ("tokens", "mask", "task", "embeds", "enc_embeds"):
            if k not in raw:
                continue
            v = np.asarray(raw[k])
            batch[k] = (int(v) if k == "task" and v.ndim == 0 else
                        torch.as_tensor(v, device=self.device))
        return batch

    def train(self, steps: Optional[int] = None) -> list:
        steps = steps or self.total_steps
        for step in range(self.state.step, steps):
            if self.failure_injector is not None:
                self.failure_injector.check(step)
            batch = self._next_batch(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, self.base,
                                               self.frozen, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            self.watchdog.step(step, dt)
            metrics["step_time_s"] = dt
            self.history.append((step, metrics))
            if self.on_metrics is not None:
                self.on_metrics(step, metrics)
            # sweep BEFORE the boundary checkpoint: a save at an epoch edge
            # must hold the post-sweep triple
            self._maybe_dmrg(step + 1)
            if (self.run.train.ckpt_every
                    and (step + 1) % self.run.train.ckpt_every == 0):
                self._save(step + 1)
        if self.ckpt is not None:
            self._save(steps)
            self.ckpt.wait()
        return self.history

    # ------------------------------------------------------------------
    def losses(self) -> np.ndarray:
        return np.array([m["loss"] for _, m in self.history])
