"""Model zoo of the torch port: the dense decoder family."""

from .params import from_jax_params
from .registry import build_model

__all__ = ["build_model", "from_jax_params"]
