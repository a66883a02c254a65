"""Architecture configs of the port (the dense models so far)."""
from .base import ArchConfig, get_arch, list_archs, reduce, register

__all__ = ["ArchConfig", "get_arch", "list_archs", "reduce", "register"]
