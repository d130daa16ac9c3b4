"""Model factory: config → model instance."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .hybrid import Zamba2LM
from .ssm import Mamba2LM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to torch yet (ROADMAP A.10: "
        f"other model families); the port builds 'dense', 'ssm' and "
        f"'hybrid' models")
