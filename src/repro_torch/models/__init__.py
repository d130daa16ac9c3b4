"""Model zoo of the torch port: the dense and MoE / MLA decoders
(``dense``, ``moe``), Mamba2 (``ssm``) and Zamba2 (``hybrid``)."""

from .params import from_jax_params
from .registry import build_model

__all__ = ["build_model", "from_jax_params"]
