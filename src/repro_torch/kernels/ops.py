"""The public kernel API used by the models and the serving engine.

Dispatch is by the tensor's device, not by a backend flag: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor runs the plain
PyTorch version.  There is no ``try`` that falls back from one to the
other, so a run on the card either went through the kernels or failed."""

from __future__ import annotations

import torch

from . import build, ref
from .flash_attention import flash_attention
from .packed_prefill import packed_prefill_attention
from .paged_attention import paged_attention
from .ssd_scan import ssd_scan as ssd

__all__ = ["flash_attention", "paged_attention", "packed_prefill_attention",
           "ssd", "sample_tokens", "prepare"]


def prepare(device) -> None:
    """Build and load every kernel of the port on ``device`` (a no-op on
    the CPU).  The serving engine calls it when a shard is constructed, so
    the first build never lands inside a step, where it would hold the
    step lock and read as a stall to the watchdog."""
    if torch.device(device).type == "cuda":
        for name in build.SOURCES:
            build.library(name)


def sample_tokens(logits, temperature):
    """Token selection: logits (B,V) and a host-side (B,) sequence of
    temperatures → (tokens (B,) int64, logprobs (B,) float32).  Greedy
    rows (``temperature <= 0``) are an exact argmax with logprob 0; see
    :func:`repro_torch.kernels.ref.sample_tokens_ref`."""
    return ref.sample_tokens_ref(logits, temperature)
