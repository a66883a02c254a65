"""Architecture configs of the port: the JAX package's ten."""
from .base import ArchConfig, get_arch, list_archs, reduce, register

__all__ = ["ArchConfig", "get_arch", "list_archs", "reduce", "register"]
