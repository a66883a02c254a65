"""LM stack of the port: the five model families and their model API."""
from .api import Model, build_model, named_from_numpy, params_from_numpy

__all__ = ["Model", "build_model", "named_from_numpy", "params_from_numpy"]
