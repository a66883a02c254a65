"""Tuning core of the port. This slice carries only what the evaluation
path needs: the search space and the failure type."""
from .objectives import TuningFailure
from .space import Config, Param, SearchSpace

__all__ = ["Config", "Param", "SearchSpace", "TuningFailure"]
