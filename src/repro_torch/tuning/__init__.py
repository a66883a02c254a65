"""VDTuner applied to the port's own LM stack (the counterpart of the JAX
package's ``tuning``)."""
from .serve_tuner import HBM_PER_DEV, ServeTuningEnv, make_serving_space

__all__ = ["HBM_PER_DEV", "ServeTuningEnv", "make_serving_space"]
