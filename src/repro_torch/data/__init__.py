"""The training data pipeline (numpy; the same batches as the JAX package's)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
