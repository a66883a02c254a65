"""Architecture configs of the port (the JAX package's ten) and the input
shape suites."""
from .base import (
    SHAPES, ArchConfig, ShapeConfig, get_arch, input_specs, list_archs,
    reduce, register, shape_applicable,
)

__all__ = [
    "SHAPES", "ArchConfig", "ShapeConfig", "get_arch", "input_specs",
    "list_archs", "reduce", "register", "shape_applicable",
]
