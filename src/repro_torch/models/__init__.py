"""Model zoo of the torch port: the dense, MoE / MLA and Qwen2-VL decoders
(``dense``, ``moe``, ``vlm``), Mamba2 (``ssm``), Zamba2 (``hybrid``) and
the Whisper encoder-decoder (``encdec``)."""

from .params import from_jax_params
from .registry import build_model

__all__ = ["build_model", "from_jax_params"]
