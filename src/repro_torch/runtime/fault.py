"""Fault-tolerance runtime: stragglers, restore-and-resume, elastic plans
(port of `repro.runtime.fault`).

  * FaultTolerantLoop -- drives a step loop: periodic async checkpoints
    (`repro_torch.checkpoint.manager.CheckpointManager`), a SIGTERM hook
    that flushes a final checkpoint, and resume from the newest intact
    generation on (re)start.
  * StragglerMonitor -- windowed-median step times; flags steps slower
    than ``threshold x`` the median.
  * plan_remesh -- given the surviving device count, the largest (data,
    model) grid the model's divisibility allows: pure arithmetic, the
    decision an elastic restart makes; `FaultTolerantLoop.restore_or`'s
    ``shardings`` then places the restored state on the new mesh.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..checkpoint.manager import CheckpointManager

__all__ = ["ElasticPlan", "plan_remesh", "StragglerMonitor", "FaultTolerantLoop"]


@dataclasses.dataclass
class ElasticPlan:
    data: int
    model: int
    dropped_devices: int

    @property
    def world(self) -> int:
        return self.data * self.model


def plan_remesh(
    surviving_devices: int,
    *,
    model_divisors: Tuple[int, ...] = (16, 8, 4, 2, 1),
    prefer_model: int = 16,
) -> ElasticPlan:
    """Largest usable (data × model) grid ≤ surviving_devices.

    Keeps the model axis at the largest divisor ≤ prefer_model that still
    divides a usable world size; data gets the rest.  Drops remainder
    devices (they idle until the next full re-plan).
    """
    for m in model_divisors:
        if m > prefer_model:
            continue
        data = surviving_devices // m
        if data >= 1:
            return ElasticPlan(data=data, model=m,
                               dropped_devices=surviving_devices - data * m)
    raise ValueError("no usable mesh for zero devices")


class StragglerMonitor:
    """EWMA + median step-time tracking with a slow-step callback.

    A step is flagged once the history holds at least ``min(8, window)``
    samples AND the step exceeds ``threshold ×`` the windowed median —
    STRICTLY exceeds, so a step landing exactly on the threshold is not a
    straggler.  (The warm-up used to be a flat 8, so a monitor configured
    with ``window < 8`` could never flag anything.)
    """

    WARMUP = 8

    def __init__(self, threshold: float = 2.0, window: int = 64,
                 on_straggle: Optional[Callable[[int, float, float], None]] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []
        self.on_straggle = on_straggle

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window :]
        med = float(np.median(hist))
        warmup = min(self.WARMUP, self.window)
        slow = len(hist) >= warmup and seconds > self.threshold * med
        if slow:
            self.flagged.append(step)
            if self.on_straggle:
                self.on_straggle(step, seconds, med)
        return slow


class FaultTolerantLoop:
    """Checkpointed, preemption-aware step loop driver.

    Usage:
        loop = FaultTolerantLoop(ckpt_dir, every=100)
        state, start = loop.restore_or(init_state)       # resume if possible
        for step in range(start, total):
            state, metrics = step_fn(state, batch)
            loop.after_step(step, state)                  # async ckpt + timing
    """

    def __init__(
        self,
        directory: str,
        *,
        every: int = 100,
        keep: int = 3,
        straggler_threshold: float = 2.0,
        install_signal_handler: bool = False,
    ):
        self.manager = CheckpointManager(directory, keep=keep)
        self.every = every
        self.monitor = StragglerMonitor(threshold=straggler_threshold)
        self._last_state: Any = None
        self._last_step: int = -1
        self._last_saved_step: Optional[int] = None
        self.last_restore_skipped: List[int] = []
        # Step timing starts at the first after_step: anchoring it here
        # would bill construction + restore wall time (checkpoint reads,
        # host-to-device copies, first-step builds...) to step 0 and poison
        # the straggler median for the whole window.
        self._t_prev: Optional[float] = None
        self.preempted = False
        if install_signal_handler:
            signal.signal(signal.SIGTERM, self._on_preempt)

    # -- resume -----------------------------------------------------------
    def restore_or(self, init_state: Any, shardings: Any = None) -> Tuple[Any, int]:
        """Resume from the newest INTACT generation, or start fresh.

        Restores walk back past torn/corrupt generations
        (`repro_torch.checkpoint.manager.restore_latest_intact`); the ones
        skipped are recorded in ``last_restore_skipped`` so the caller can
        surface the freshness loss.  When every retained generation is
        corrupt, resume-from-zero beats dying — the cold start is taken and
        the skipped list says why.  ``shardings`` places the restored
        leaves on the current mesh (`restore_pytree`): a generation written
        at another world size restores here.
        """
        from ..checkpoint.manager import CheckpointCorrupt, restore_latest_intact

        self.last_restore_skipped: List[int] = []
        try:
            state, step, skipped = restore_latest_intact(
                init_state, self.manager.directory, shardings
            )
        except FileNotFoundError:
            return init_state, 0
        except CheckpointCorrupt as e:
            from ..checkpoint.manager import list_steps

            self.last_restore_skipped = list(
                reversed(list_steps(self.manager.directory))
            )
            import warnings

            warnings.warn(
                f"every retained checkpoint generation is corrupt — "
                f"starting fresh ({e})",
                RuntimeWarning,
            )
            return init_state, 0
        self.last_restore_skipped = skipped
        return state, step + 1

    # -- per-step ---------------------------------------------------------
    def after_step(self, step: int, state: Any) -> None:
        now = time.monotonic()
        if self._t_prev is not None:
            self.monitor.record(step, now - self._t_prev)
        self._t_prev = now
        self._last_state, self._last_step = state, step
        if self.every and (step + 1) % self.every == 0:
            self.manager.save(state, step)
            self._last_saved_step = step
        if self.preempted:
            self.checkpoint_now()
            raise SystemExit(f"preempted at step {step}; checkpoint flushed")

    # -- preemption -------------------------------------------------------
    def _on_preempt(self, signum, frame):  # pragma: no cover - signal path
        self.preempted = True

    def checkpoint_now(self) -> None:
        # skip the re-save when the periodic path already wrote this step —
        # the duplicate serialized the same state twice on every preemption
        # that landed on a checkpoint boundary
        if self._last_state is not None and self._last_step != self._last_saved_step:
            self.manager.save(self._last_state, self._last_step)
            self._last_saved_step = self._last_step
        self.manager.flush()

    def close(self) -> None:
        self.manager.close()
