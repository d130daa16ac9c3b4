"""Model factory: config → model instance."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return DecoderLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to torch yet (ROADMAP A.10: "
        f"other model families); the port builds 'dense' models only")
