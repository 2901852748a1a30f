"""Straggler watchdog and failure injection for the trainer (counterpart
of ``src/repro/distributed/fault_tolerance.py``; ``remesh`` waits for the
multi-device slice).

The watchdog keeps a per-step wall-clock EWMA; a step slower than
``threshold`` x the EWMA calls ``on_straggler``. ``FailureInjector`` raises
``SimulatedFailure`` at a chosen step, so tests can model a node loss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Watchdog:
    """Wall-clock straggler detector with an EWMA baseline."""
    threshold: float = 3.0
    decay: float = 0.9
    min_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ewma: float = 0.0
    _steps: int = 0

    def step(self, step_idx: int, dt: float) -> bool:
        """Record one step duration; True if flagged as a straggler.
        Flagged durations stay out of the EWMA, so one straggler does not
        raise the baseline and mask the next."""
        flagged = False
        if self._steps >= self.min_steps and dt > self.threshold * self._ewma:
            flagged = True
            if self.on_straggler is not None:
                self.on_straggler(step_idx, dt, self._ewma)
        if not flagged:
            if self._ewma == 0.0:
                self._ewma = dt
            else:
                self._ewma = self.decay * self._ewma + (1 - self.decay) * dt
        self._steps += 1
        return flagged


class SimulatedFailure(RuntimeError):
    """Raised to model a node loss mid-training."""


@dataclasses.dataclass
class FailureInjector:
    """Fail deterministically at a given step."""
    fail_at_step: int = -1

    def check(self, step: int) -> None:
        if step == self.fail_at_step:
            raise SimulatedFailure(f"simulated node failure at step {step}")
