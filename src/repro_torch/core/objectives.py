"""Objective-side types of the port (only ``TuningFailure`` so far)."""
from __future__ import annotations


class TuningFailure(RuntimeError):
    """Raised by an evaluation backend when a configuration crashes / times out.

    ``transient=True`` marks failures caused by environment faults (injected
    chaos, lost segments, flaky builds) rather than the configuration itself:
    the session retries those with backoff instead of telling the tuner
    worst-value feedback, so the GP only ever sees genuine config faults.
    """

    def __init__(self, message: str = "", transient: bool = False):
        super().__init__(message)
        self.transient = bool(transient)
