"""LM stack of the port: the dense transformer and its model API."""
from .api import Model, build_model
from .transformer import params_from_numpy

__all__ = ["Model", "build_model", "params_from_numpy"]
