"""Fault tolerance and straggler mitigation for the training supervisor: the JAX
package's ``distributed/fault.py``, host code carried across.

* NaN/Inf loss -> restore the last good checkpoint and skip the poisoned data window.
* Stalled or slow steps (EWMA watchdog) -> a straggler event, logged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StepWatchdog:
    """EWMA step-time tracker; flags steps slower than `threshold` x the EWMA."""

    alpha: float = 0.1
    threshold: float = 3.0
    warmup_steps: int = 5
    ewma: Optional[float] = None
    seen: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self.seen > self.warmup_steps and dt > self.threshold * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        else:
            # don't fold straggler outliers into the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class FaultInjector:
    """Test hook: schedule NaN-loss / slow-step faults at given steps."""

    def __init__(self, nan_steps=(), slow_steps=(), slow_s: float = 0.0):
        self.nan_steps = set(nan_steps)
        self.slow_steps = set(slow_steps)
        self.slow_s = slow_s

    def corrupt_loss(self, step: int, loss):
        if step in self.nan_steps:
            return loss * float("nan")
        return loss

    def maybe_stall(self, step: int):
        if step in self.slow_steps and self.slow_s > 0:
            time.sleep(self.slow_s)


def loss_is_bad(loss) -> bool:
    v = float(loss)
    return not (v == v) or v in (float("inf"), float("-inf"))
