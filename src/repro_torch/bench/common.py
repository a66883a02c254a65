"""Shared benchmark output helpers."""
from __future__ import annotations


def emit(name: str, us_per_call: float, derived: str):
    """CSV row in the ``name,us_per_call,derived`` format of the JAX
    package's benchmarks."""
    print(f"{name},{us_per_call:.2f},{derived}")
