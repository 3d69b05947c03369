"""Fault tolerance: step supervision, straggler detection, elastic re-mesh
(reference ``runtime/fault_tolerance.py``, pure Python, copied).

Steps fail (preemptions, flaky hosts, link flaps) and some fail *slowly*
(stragglers).  This module provides:

  * ``StepSupervisor`` -- per-step latency log, straggler flagging (step
    time > ``straggler_factor`` x the trailing median), and a retry wrapper
    that reruns a failed step (the training step leaves the params as they
    were when it raises before its commit, so a rerun starts from the same
    state);
  * ``ElasticPlan`` -- given a device loss, pick the largest valid sub-mesh
    (the plan only: re-sharding from a checkpoint comes with the mesh
    slice);
  * crash-only design: every recovery path goes through the checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    ok: bool
    straggler: bool
    error: str = ""


class StepSupervisor:
    """Wraps step execution with timing, retry and straggler detection."""

    def __init__(self, *, window: int = 64, straggler_factor: float = 3.0,
                 max_retries: int = 2):
        self.window = window
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.history: deque[StepRecord] = deque(maxlen=4096)
        self._recent = deque(maxlen=window)

    def median_step_time(self) -> float | None:
        if not self._recent:
            return None
        xs = sorted(self._recent)
        return xs[len(xs) // 2]

    def is_straggler(self, seconds: float) -> bool:
        med = self.median_step_time()
        return med is not None and seconds > self.straggler_factor * med

    def run_step(self, step: int, fn: Callable[[], Any]) -> Any:
        """Run one step with retries; records timing + straggler flags."""
        last_err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                out = fn()
                dt = time.perf_counter() - t0
                rec = StepRecord(step, dt, True, self.is_straggler(dt))
                self.history.append(rec)
                self._recent.append(dt)
                return out
            except Exception as e:  # noqa: BLE001 - any step failure retries
                dt = time.perf_counter() - t0
                self.history.append(
                    StepRecord(step, dt, False, False, f"{type(e).__name__}: {e}"))
                last_err = e
        raise RuntimeError(
            f"step {step} failed after {self.max_retries + 1} attempts"
        ) from last_err

    def straggler_report(self) -> dict[str, Any]:
        n = len(self.history)
        stragglers = [r.step for r in self.history if r.straggler]
        failures = [r.step for r in self.history if not r.ok]
        return {
            "steps": n,
            "median_s": self.median_step_time(),
            "stragglers": stragglers,
            "failures": failures,
        }


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A re-mesh decision after losing devices."""

    data: int
    model: int
    dropped: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(
    n_healthy: int, *, model_parallel: int, prefer_pow2: bool = True
) -> ElasticPlan:
    """Largest (data, model) mesh using <= n_healthy devices.

    The model axis is preserved (TP degree is a property of the model
    sharding); the data axis shrinks — global batch is then re-split by the
    trainer, and params are re-sharded from checkpoint on restore.
    """
    if n_healthy < model_parallel:
        raise ValueError(
            f"{n_healthy} healthy devices cannot host TP={model_parallel}")
    data = n_healthy // model_parallel
    if prefer_pow2:
        data = 2 ** int(math.log2(data))
    used = data * model_parallel
    return ElasticPlan(data=data, model=model_parallel, dropped=n_healthy - used)
