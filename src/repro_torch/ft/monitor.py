"""Fault-tolerance runtime pieces: straggler detection and preemption-aware
shutdown (a copy of the JAX package's ``ft/monitor.py``; no tensors). On a real multi-pod job these hooks feed the cluster scheduler; on a
single host they degrade to logging + clean checkpoint-on-SIGTERM.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from typing import List, Optional


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    flagged: bool


class StragglerMonitor:
    """Flags steps slower than `threshold` x the trailing-median step time.

    At pod scale the same statistic is computed per host from all-gathered
    step timestamps; hosts that flag persistently get drained/replaced. Here
    the monitor records and exposes the decision signal.
    """

    def __init__(self, window: int = 32, threshold: float = 2.0, patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.history: List[StepStats] = []
        self._consecutive = 0

    def record(self, step: int, seconds: float) -> StepStats:
        recent = [s.seconds for s in self.history[-self.window :]]
        median = sorted(recent)[len(recent) // 2] if recent else seconds
        flagged = len(recent) >= 8 and seconds > self.threshold * median
        stat = StepStats(step=step, seconds=seconds, flagged=flagged)
        self.history.append(stat)
        self._consecutive = self._consecutive + 1 if flagged else 0
        return stat

    @property
    def should_replace(self) -> bool:
        """True when this worker has been a persistent straggler."""
        return self._consecutive >= self.patience

    def median_step(self) -> Optional[float]:
        recent = [s.seconds for s in self.history[-self.window :]]
        return sorted(recent)[len(recent) // 2] if recent else None


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the train loop polls; the loop then writes
    a final checkpoint and exits cleanly (standard preemption protocol)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = threading.Event()
        self._prev = {}
        self.signals = signals

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._requested.set()

    @property
    def preempted(self) -> bool:
        return self._requested.is_set()
