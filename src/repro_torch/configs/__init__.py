"""Assigned architecture configs (--arch <id>)."""

from .base import ModelConfig, ShapeSpec, SHAPES, get_config, list_configs, register

# importing these modules registers the configs
from . import (  # noqa: F401
    tinyllama_1_1b,
    qwen3_8b,
    qwen3_32b,
    llama3_405b,
    olmoe_1b_7b,
    deepseek_v2_236b,
    mamba2_1_3b,
    zamba2_1_2b,
    whisper_base,
    qwen2_vl_72b,
)

ALL_ARCHS = [
    "qwen2-vl-72b",
    "zamba2-1.2b",
    "mamba2-1.3b",
    "deepseek-v2-236b",
    "olmoe-1b-7b",
    "tinyllama-1.1b",
    "qwen3-32b",
    "llama3-405b",
    "qwen3-8b",
    "whisper-base",
]

__all__ = [
    "ModelConfig", "ShapeSpec", "SHAPES", "get_config", "list_configs",
    "register", "ALL_ARCHS",
]
