"""The public kernel API used by the models and the serving engine.

Dispatch is by the tensor's device, not by a backend flag: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor runs the plain
PyTorch version.  There is no ``try`` that falls back from one to the
other, so a run on the card either went through the kernels or failed."""

from __future__ import annotations

import torch

from . import build, ref
from .flash_attention import flash_attention
from .mla_attention import mla_attention, mla_latent_store, mla_splits
from .fused_block import add_rms_norm, qk_norm_rope_write, silu_mul
from .packed_prefill import packed_prefill_attention
from .paged_attention import paged_attention, paged_splits
from .ssd_scan import ssd_scan as ssd

__all__ = ["flash_attention", "paged_attention", "paged_splits",
           "packed_prefill_attention", "ssd", "add_rms_norm",
           "qk_norm_rope_write", "silu_mul", "mla_attention",
           "mla_latent_store", "mla_splits", "sample_tokens",
           "spec_verify_rows", "prepare"]


def prepare(device) -> None:
    """Build and load every kernel of the port on ``device`` (a no-op on
    the CPU).  The serving engine calls it when a shard is constructed, so
    the first build never lands inside a step, where it would hold the
    step lock and read as a stall to the watchdog."""
    if torch.device(device).type == "cuda":
        for name in build.SOURCES:
            build.library(name)


def sample_tokens(logits, temperature, top_k, top_p, seed, position, *,
                  stream=ref.STREAM_TARGET):
    """Fused replay-exact token sampling: logits (B,V) + per-row operands
    (B,) → (tokens (B,) int64, logprobs (B,) float32).  ``temperature <=
    0`` rows are exact ``argmax(logits)`` (logprob 0); the others draw from
    the stateless counter PRNG keyed ``(seed, position, stream)`` (see
    :mod:`repro_torch.kernels.ref`), JAX's threefry bits, which is what
    makes swap/migration replay reproduce tokens without RNG state.

    There is no kernel: as in the JAX package (whose ``sample_tokens`` has
    no Pallas variant) the math is a handful of (B,V) tensor ops on the
    logits' device.  The operands may be host arrays; when they say every
    row is greedy, only the argmax runs (the same tokens and logprobs the
    full formula gives those rows, without its sort and PRNG launches)."""
    temps = torch.as_tensor(temperature, dtype=torch.float32)
    if temps.device.type == "cpu" and not bool((temps > 0.0).any()):
        toks = torch.argmax(logits, dim=-1)
        return toks, torch.zeros(toks.shape, dtype=torch.float32,
                                 device=logits.device)
    return ref.sample_tokens_ref(logits, temps, top_k, top_p, seed,
                                 position, stream=stream)


def spec_verify_rows(p_dist, q_dist, draft_toks, n_draft, seed, base_pos):
    """Fused speculative-decode rejection sampling (batched rows); see
    :func:`repro_torch.kernels.ref.spec_verify_rows_ref` for the accept
    rule, residual construction and replay-keying contract.  Like
    :func:`sample_tokens` it is plain tensor math on the device (the JAX
    package has no Pallas variant either)."""
    return ref.spec_verify_rows_ref(p_dist, q_dist, draft_toks, n_draft,
                                    seed, base_pos)
