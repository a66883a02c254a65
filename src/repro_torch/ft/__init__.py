"""Fault-tolerance runtime pieces of the port (a copy of the JAX package's
``ft/monitor.py``, numpy only): straggler detection and preemption-aware
shutdown."""
from .monitor import PreemptionHandler, StepStats, StragglerMonitor

__all__ = ["PreemptionHandler", "StepStats", "StragglerMonitor"]
