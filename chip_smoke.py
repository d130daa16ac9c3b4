#!/usr/bin/env python3
"""Chip smoke for the torch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; each prints one line and any failure exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: compile the hand-written kernels (``csrc/*.cu``) with ``nvcc``
   into ``build/kernels/``;
3. the paged-decode kernel against its plain PyTorch version at the decode
   step's shapes (B = 8, H = 32, Hkv = 4, D = 64, page 8, 128 pages), fp32
   and bf16, with kernel, plain, library (SDPA over the gathered keys) and
   bound times, each row naming the variant that ran (``mma`` for bf16,
   ``fma`` for fp32) with the profiler's device time beside the CUDA-event
   mean; the bf16 row also times a batch whose every context is 0 (no key
   read: the fixed cost of one call) and one row of 2048 keys (B = 1: the
   fewest blocks, eight splits of one kv head each);
4. the packed-prefill kernel against its plain version at the packed
   chunk's shapes (C = 256 lanes, 1 and 8 segments), likewise, each row
   naming the variant that ran (``wgmma`` for bf16, ``tf32x3`` for fp32)
   and the device time of one launch read from ``torch.profiler`` beside
   the CUDA-event mean; and the 8-segment chunk at D = 96 on the ``fma``
   variant, in both dtypes (padding exactly 0);
4b. the packed-prefill kernel at the speculative verify
   chunk's layout, built by the engine's ``verify_lanes``: TinyLlama's
   widths, max_batch 8 x (spec_k 4 + 1) = 40 lanes, draft depths 0-4 so
   dead lanes sit between segments, one row unoccupied, two rows whose
   dead lanes lie past their page run; fp32 (``tf32x3``) and bf16
   (``wgmma``); dead lanes must be exactly 0; times as phase 4;
4c. the decoder block's three fused kernels (``add_rms_norm``,
   ``qk_norm_rope_write``, ``silu_mul``) against their plain versions at
   Qwen3-32B's widths (5120, 64 / 8 heads, D 128, FFN 25600) and the
   engine's three layouts: the decode step's 32 rows, the packed chunk's
   512 lanes, the spec verify's 160 (32 rows x 5), each with padding rows
   or lanes, fp32 and bf16; padding must leave every page byte as it was;
   kernel, profiler, plain and bound times (no single PyTorch call
   computes any of the three, so no library time);
4d. the MLA kernels (``mla_attention``, ``mla_latent_store``) against
   their plain versions at the DeepSeek-V2 cell's shapes, bf16: a decode
   call of 256 rows x 128 heads over contexts of 300-2,000 keys (mean
   ~1,150) in a 96,000-page pool, its last 4 rows unoccupied; a prefill
   chunk of 2,048 lanes (two prompts of 1,024, context = position + 1,
   the last 48 lanes padding) under the prefill entry names; the latent
   store of the decode step's 256 lanes and the chunk's 2,048, padding
   lanes at page -1; unoccupied rows exactly 0, and every pool row but a
   live lane's target byte-equal to its value before the store; the split
   count the engine's 256-row shard takes; kernel, profiler, plain and
   bound times (bytes: the keys' latent rows, the queries and outputs;
   operations: 128 x 1,088 x 2 a key);
5. serving TinyLlama-1.1B at full width in fp32 (seeded random weights)
   under the ``chunked`` and ``packed`` schedulers, holding the greedy
   tokens against the model's contiguous-cache decode;
6. serving TinyLlama-1.1B in bf16 (its config's dtype) under ``packed``:
   16 requests, every one must complete, both kernels must launch, every
   packed launch must be the tensor-core variant, 22 (one a layer) per
   packed chunk, and every paged launch the ``mma`` variant, 22 per decode
   step and 22 per packed chunk that carries decode riders (their
   attention), the two printed apart; every decoder-block pass through
   the fused kernels (``stats()``'s ``fused_blocks``, none eager), and
   one decode call on the live engine launching ``add_rms_norm`` 45
   times (two a layer and the final norm), ``qk_norm_rope_write`` and
   ``silu_mul`` 22 times each; every decode call (decode steps and rider
   calls) a replay of the shard's CUDA graph of the decode call, whose
   private pool's bytes are printed; then the same prompts served again
   with the decode call launched eagerly: the two token streams' digests
   must be equal;
6b. serving DeepSeek-V2 in bf16 under ``packed`` at its published widths
   but 4 layers (1 dense, 3 expert layers of 20 held experts behind a
   160-wide group-limited router, YaRN): 24 requests, each completes with
   its 48 tokens, none fails; with the launch counts zeroed just before,
   ``mla_attention`` launches its decode entry names once a layer for
   each decode call (decode steps and packed chunks with riders), its
   prefill names once a layer a packed chunk, and ``mla_latent_store``
   once a layer for each of both; no decode call replays a graph (a
   latent stack runs eagerly);
7. the flash-attention kernel against its plain version at the models'
   full-sequence shapes (B = 4, S = 1024 and 1000, H = 32 with Hkv = 32
   as Zamba2 and Hkv = 4 as TinyLlama, D = 64), at DeepSeek-V2's MLA
   prefill (B = 2, S = 1024, H = Hkv = 128, D = 192), at Whisper-base's
   encoder (B = 4, S = 1500, H = Hkv = 8, D = 64, full) and
   cross-attention (448 queries to 1500 keys, full) and at Qwen2-VL-72B's
   text backbone (B = 2, S = 1024, H 64, Hkv 8, D 128), fp32 and bf16, with
   kernel, plain, library (one causal GQA ``scaled_dot_product_attention``
   call) and bound times, the variant and the profiler's device time, as
   in phase 4 (causal rows compare with a causal call, full rows with a
   full one), and for a tensor-core variant (``wgmma`` bf16, ``tf32x3``
   fp32) the times of both its tiles (64 and 128 query rows a block) in
   the same call; and the ``fma`` variant, fp32 and bf16, at 18c's
   training shape (B = 8, S = 64, H = 4, Hkv = 2, D = 16, timed) and at
   D = 96 (B = 4, S = 1000, H = 32, Hkv = 4);
8. the SSD kernel against its plain version at the Mamba2 block's shapes
   (B = 4, S = 1024 and 1000, H = 64, P = 64, N = 128 as Mamba2-1.3B and
   64 as Zamba2-1.2B, chunk 128, with d_skip), fp32 and bf16, likewise,
   with the variant (``mma`` for bf16) and the profiler's device time (no
   single PyTorch call computes SSD, so no library time); each row prints
   the share of its limit that the worst element of y and of the final
   state uses, and the bf16 rows the same for the ``fma`` kernel on the
   same inputs (reached with chunk 64: the same function, fp32 inside);
9. Mamba2-1.3B and Zamba2-1.2B at published widths and depths in fp32
   (seeded weights, the decay, skip and conv-bias leaves perturbed from
   their zero init): ``logits_fn`` over 2 prompts of 300 tokens held
   against token-by-token ``decode_step`` at every position, then 16
   greedy tokens held against the forward over prompt and tokens; the
   launch counters must show one SSD launch per Mamba2 block and one flash
   launch per Zamba2 attention site in each forward;
10. both models in bf16 (their configs' dtype): ``logits_fn`` over 4
   prompts of 1024 tokens, then 32 greedy decode steps at B = 4 from a
   fresh cache fed the prefill's greedy tokens; wall times, tokens/s and
   launches; everything finite, every kernel of the path launched,
   Zamba2's 7 flash launches all the tensor-core variant, and every SSD
   launch (48 and 38, one a Mamba2 block) the ``mma`` variant; then the
   prefill's logits against the fp32 forward on the same (bf16-rounded)
   weights: their relative L2 distance may be at most
   ``LOGITS_RATIO`` times that of the same bf16 forward with the SSD on
   the ``fma`` kernel (chunk 64), so a rounding fault of the tensor-core
   kernel at model level fails the run;
11. the sampler on the card: threefry keys and random bits bit-equal to
   the CPU over (seed, position, stream), and ``sample_tokens`` at
   (8, 32000), temperature 0.8, top-k 50, top-p 0.9 equal to the CPU (a
   flip only at a near-tie of the gumbel-perturbed scores, < 1e-3);
12. sampled and speculative serving of TinyLlama-1.1B at published
   widths: in fp32, seeded ``TemperatureSampling`` tokens under
   ``chunked`` and ``packed`` equal the contiguous-cache decode with the
   same sampler keyed by absolute position; ``spec_k=4`` greedy tokens
   equal plain greedy (both with a near-tie exception, top-2 gap < 1e-3);
   a spec-sampled run gives identical tokens in a fresh session; every
   packed launch is a prefill layer (``tf32x3``) and every paged launch a
   verify layer (the verify lanes run as paged rows, ``fma``); the
   accept rate and verify launches are printed, and the first op whose
   bytes differ between the verify chunk's x_last lane and the decode
   step at the same position.  In bf16, ``spec_k=4`` greedy under
   ``chunked`` and ``packed``: every request completes, the verify
   launches are paged ``mma`` and the prefill launches packed ``wgmma``;
   each stream's first divergence from plain bf16 greedy (``chunked``:
   every generated position in the decode step) is printed with its
   margin in bf16 ulps, as is plain greedy under ``packed`` (its rows
   ride prefill chunks, run there as the decode step), with the first
   differing op at the first diverging spec stream's position, and the
   first op whose bytes differ between a packed chunk's rider and the
   dedicated decode step (in fp32 too);
   then every spec stream, and plain ``packed``, is held by ``held()``
   (exact, or a first divergence at a top-2 margin < 1e-3, PERF.md
   section 2);
13. the swap tier in bf16: four low-priority requests fill the batch and a
   132-page pool, two high-priority arrivals preempt them mid-decode into
   the host arena; every stream equals its uncontended run token for
   token, preemptions >= 1 and resumed == preemptions, and after close no
   arena slot is used and the pool is whole; the page moves' host seconds
   are printed;
13b. the same with ``spec_k=4`` (the uncontended runs with ``spec_k=4``
   too, all six together on the large pool), every stream held to its
   uncontended run by ``held()`` (exact, or a first divergence at a
   top-2 margin < 1e-3);
13c. live migration in bf16: two shards, each with a greedy and a seeded
   ``TemperatureSampling(0.8)`` request (200 prompt tokens, 64 new);
   shard 0 stalls mid-decode and the watchdog migrates its two requests
   to shard 1, carrying their pages; every stream held to its
   uninterrupted run by ``held()``; both pools whole after close;
14a. OLMoE-1B-7B (16 layers) and DeepSeek-V2 (published widths, 3 of 60
   layers: the dense first layer and two MoE layers) in fp32 at capacity
   factor E / k (no token dropped): ``logits_fn`` over 2 prompts of 256
   tokens held against ``decode_step`` at every position, then 16 greedy
   tokens against the forward (rtol = atol = 2e-3); every flash launch
   the variant ``kernel_variant`` names (``tf32x3``: D 128 and 192), 16
   and 3 per forward;
14b. both in bf16 at capacity factor 1.25: prefill of 4 (OLMoE) and 2
   (DeepSeek-V2) prompts of 1024 tokens and 32 decode steps, timed;
   finite logits; every flash launch ``wgmma`` (D 128 and 192); the
   prefill's logits against the fp32 forward on the same weights within
   ``LOGITS_RATIO`` times the distance of the same bf16 forward with
   attention on the flash kernel's plain version;
15a. Whisper-base (6 + 6 layers, enc_seq 1500) and Qwen2-VL-72B (published
   widths, 8 of 80 layers) in fp32: ``logits_fn`` over 2 sequences of
   128 tokens (Whisper: against 2 x 1500 frames; Qwen2-VL: text at M-RoPE
   positions t = h = w = i) held against ``decode_step`` at every position
   (rtol = atol = 2e-3; Whisper's cross cache is each decoder layer's
   K/V of the port's own encoder memory); every flash launch the
   ``tf32x3`` variant (D 64 and 128), 18 (Whisper: 6 encoder, 6 decoder
   self, 6 cross) and 8 per forward;
15b. both in bf16: Whisper over 4 x 1500 frames and 448 tokens (its text
   context), Qwen2-VL over 2 x 1024 positions of which 256 are patch
   embeddings on a 16 x 16 grid at t = 0 and 768 text tokens after them,
   then 32 decode steps each, timed; finite logits; every flash launch
   ``wgmma``, 18 and 8 a forward; the prefill's logits against the fp32
   forward on the same weights within ``LOGITS_RATIO`` times the
   distance of the same bf16 forward with attention on the flash
   kernel's plain version;
16. training (``--only 16`` runs 16a-16d):
16a. each kernel under autograd, fp32 and bf16: flash at the shapes
   training gives it (TinyLlama-1.1B, H 32, Hkv 4, D 64, causal: 16c's
   B 8 x S 1024 and 16d's B 4 x S 256) and at Whisper's cross shape
   (Sq 448, Sk 1500, full), SSD at phase 8's shape; the kernel's output
   held against the plain version's on the same inputs (phases 7 and 8's
   tolerances; flash also within relative L2 1e-4 in fp32, 1e-2 in
   bf16), the ``autograd.Function``'s output equal to the kernel call's
   byte for byte in one launch of the expected variant, and every input
   gradient equal to ``torch.autograd.grad`` of the plain version byte for
   byte (the backward is that code); the forward kernel's, the backward's
   and the plain forward + backward's times are printed, not held;
16b. one ``loss_fn`` + backward at published widths and depth in fp32,
   B 2 x 512: TinyLlama-1.1B (44 flash launches: forward and remat
   recompute) and Mamba2-1.3B (96 SSD launches), then again with the
   kernel swapped for its plain version inside the phase (no launch);
   every gradient present and finite, wq / wk / wv and in_proj non-zero,
   each leaf within relative L2 1e-4 of the plain path's;
16b-seeds. Mamba2-1.3B's fp32 gradients at seeds 0-3 (seed 0 is 16b's
   weights and batch) beside an fp64 plain path (the module in fp64, the
   SSD by its fp64 quadratic form): the kernel path's median and worst
   per-leaf relative L2 distance to fp64 each at most ``GRAD_FP64_RATIO``
   (2) times the plain fp32 path's, at every seed;
16c. the ``Trainer`` on TinyLlama-1.1B at published widths in bf16,
   ``remat="full"``, AdamW, lr 3e-4, warmup 5, global batch 8 x 1024, 20
   steps: finite losses whose last five average at least 0.2 below the
   first five, exactly 880 flash launches, all ``wgmma``; the median step
   time, tokens/s and peak memory are printed;
16d. checkpoint and restart (TinyLlama-1.1B widths, 2 layers, fp32,
   B 4 x 256): 20 steps with a checkpoint every 10, then step 10 restored
   and 10 replayed within rtol = atol = 2e-4 of the first run's losses;
   then a bf16 Trainer state saved and restored byte for byte;
17. the distribution layer and the launchers (``--only 17`` runs
   17a-17d):
17a. the serve launcher (``launch.serve.main``) on TinyLlama-1.1B at
   published widths in bf16, 8 requests: 8 completed, 0 failed, greedy
   tokens equal to the same requests served straight through
   ``serving.serve`` with the same weights and config, paged launches
   22 x decode steps and packed launches 22 x prefill chunks;
17b. TinyLlama-1.1B fp32, B 2 x 512, remat as configured, on a 1 x 1
   NCCL mesh: one AdamW step of a ``Trainer`` with the mesh (DTensor
   parameters, flash through ``local_map``) against the unsharded step
   (loss rtol 2e-5, parameters rtol = atol 2e-4), 44 flash launches;
   ``compressed_psum`` of the step's gradients byte-equal to the CPU's
   quantization with ``residual == target - sent``; ``restore(mesh=...)``
   byte-equal to the saved state; ``gpipe_forward`` (one stage, 22
   blocks, 4 microbatches) byte-equal to the sequential stack;
17c. the dry run in a subprocess (TinyLlama-1.1B x train_4k and
   x decode_32k, OLMoE-1B-7B x train_4k, on the 16 x 16 fake mesh) and
   the roofline rows with the H100 constants: positive FLOPs and bytes,
   256 devices, an all-gather on each train cell; the records, each train
   cell's per-device FLOPs and bytes, and the rows are printed;
17d. the per-rank bodies of the mesh's splits, rank by rank on the card
   (``split_bodies``): ``gqa_local`` at TinyLlama's attention shape and
   ``ssd_scan`` on head blocks at phase 8's Mamba2 shape, 16 ways each,
   fp32 and bf16,
   reassembled against one unsharded kernel call at phases 7's and 8's
   tolerances; OLMoE-1B-7B's ``expert_partial`` over 2 token blocks and
   16 expert blocks: the unsharded FFN's kept set exactly, the partials'
   sum within relative L2 1e-5;
18. the examples (``examples/torch_*.py``; ``--only 18`` runs 18a-18c):
18a. the serving example through its ``build`` / ``run`` and a
   ``Recorder`` that keeps each prompt's handle, at TinyLlama-1.1B's
   published widths in bf16 (``--no-reduced --dtype bfloat16 --max-new
   64``): the default mix (12 requests and 2 long prompts of 192 tokens,
   3 client threads of the reference's ``run_serving_workload``, 2
   shards under IBR), once under ``chunked`` and once under ``packed``:
   every request completes, none fails, the prefix cache hits, no page
   outlives the session, one paged ``mma`` launch a layer a decode step
   (and a rider chunk) and one packed ``wgmma`` launch a layer a prefill
   chunk, and every stream is held to its uninterrupted run (one request
   at a time on one shard) by ``held()``;
18b. the same mix under a paced stall: 8 clients (more than
   ``max_batch`` 4), 0.2 s between a client's requests, shard 0 stalled
   for 3 s after its first completion, the heartbeat timeout cut to 1 s
   in the example's config, the watchdog migrating: at least one
   migration, at least one by re-prefill (the watchdog found the request
   queued or prefilling, no pages carried), none failed, no page leaked,
   launches as 18a, every stream held to its uninterrupted run;
18c. the training example, reduced fp32 as the reference's: 20 steps,
   then ``--resume`` for 10 into the same fresh directory: the second
   run starts at step 20, every loss finite, the first run's last five
   losses average below its first five, and one flash launch a layer a
   step (60), of the variant ``kernel_variant`` names at the reduced
   config's D 16 (``fma``);
19. the kernel table as one JSON line (each row with the variant of the
   main path and that variant's launches; the paged row's launches, of
   either variant, count the verify chunks of phases 12 and 13b, the
   riders of phases 6 and 12 and the decode steps of 17a and 18a-18b;
   the packed ``wgmma`` row's also 17a's and 18a-18b's prefill chunks;
   the flash ``wgmma`` row's those of phases 10, 14b, 15b, 16c and the
   bf16 runs of 16d and 17d; the SSD row's, of either variant, those of
   phases 10, 16b and 17d; the three fused kernels' rows (4c's bf16
   decode layout) phase 6's launches; the MLA rows (4d's decode, prefill
   and 256-lane store) phase 6b's; a row for each other variant of
   flash and packed, ``flash_attention_tf32x3`` with the ``tf32x3``
   launches of phases 14a, 15a, 16b, 16d, 17b and 17d,
   ``flash_attention_fma`` with
   18c's, ``packed_prefill_attention_tf32x3`` with those of phase 12's
   fp32 prefill chunks; a row of no launch fails), the card line, and the
   result line ``{"ok": true, "device": {...}}`` last.

``--only 7,13c`` runs just those phases, for iterating on a few: it
prints no kernel table and no result line.  With no argument every phase
runs.  ``--grad-seeds 0,1,2`` runs no phase: it measures 16b's Mamba2
hold at those seeds beside an fp64 plain path (``grad_noise``).

Bounds use the published H100 SXM peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, and for fp32 495 / 3 = 165 TFLOP/s (3xTF32 on
the tensor cores, above the 67 TFLOP/s of fp32 FMA).  It imports
nothing of JAX and nothing of the JAX package.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
# fp32 at 165 TFLOP/s: the 3xTF32 kernels do fp32-accurate work on the
# tensor cores at 495 / 3 (three TF32 products a product), above the
# card's 67 TFLOP/s of fp32 FMA, so that is the least time for fp32 work.
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
PAGED_TPU = "src/repro/kernels/paged_attention.py:103"
PACKED_TPU = "src/repro/kernels/packed_prefill.py:93"
FLASH_TPU = "src/repro/kernels/flash_attention.py:72"
SSD_TPU = "src/repro/kernels/ssd_scan.py:70"
SSD_TOL = {"float32": 2e-4, "bfloat16": 4e-2}
MODEL_TOL = 2e-3   # decode against forward, as tests/test_models_smoke.py
# bf16 logits against the fp32 forward: at most this times as far as with
# the SSD on the fma kernel.  Random weights at full depth amplify any bf16
# rounding (both routes land 0.1-0.4 apart from fp32 in relative L2), so
# the limit is set against the route whose kernel keeps fp32 inside.
LOGITS_RATIO = 2.0
DEVICE = "cuda"


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event timing of one call, averaged over ``iters`` launches,
    with the 50 MB L2 flushed before each (a decode step finds each
    layer's pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=DEVICE)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def profiled_ms(torch, timer, fn, names, iters: int = 10):
    """Device time of one call of ``fn`` from ``torch.profiler``: the
    kernels whose names contain one of ``names``, summed over ``iters``
    calls (the L2 flushed before each, as the event timer does) and
    divided by ``iters``.  None where the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if any(n in evt.key for n in names):
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = getattr(evt, "self_cuda_time_total", 0.0)
            total += t
    return total / iters / 1e3 if total > 0 else None


PACKED_KERNELS = ("packed_prefill_kernel", "plan_kernel", "partial_kernel",
                  "partial_tf32x3_kernel", "combine_kernel")
FLASH_KERNELS = ("flash_attention_kernel", "flash_tc_kernel",
                 "flash_tf32x3_kernel")
PAGED_KERNELS = ("paged_partial_kernel", "paged_combine_kernel",
                 "paged_mma_kernel")
SSD_KERNELS = ("ssd_scan_kernel", "ssd_mma_kernel")


def sdpa_call(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call computing the same
    function (the yardstick ``library_ms``; the port never calls it).
    q (N, H, Lq, D); k/v (N, Hkv, Lk, D); mask (N, 1, Lq, Lk) bool."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def close_enough(out, want, tol: float) -> float:
    """max |out - want|; raises unless |out - want| <= tol + tol * |want|
    everywhere (numpy's assert_allclose with rtol = atol = tol)."""
    o = out.float().cpu().numpy()
    w = want.float().cpu().numpy()
    np.testing.assert_allclose(o, w, rtol=tol, atol=tol)
    return float(np.max(np.abs(o - w)))


def limit_share(out, want, tol: float) -> float:
    """The share of the rtol = atol = tol limit that the worst element
    uses: max |out - want| / (tol (1 + |want|)); 1 is at the limit."""
    o, w = out.float(), want.float()
    return float(((o - w).abs() / (tol * (1 + w.abs()))).max())


def rel_l2(out, want) -> float:
    """||out - want|| / ||want|| over every element, in fp32."""
    o, w = out.float(), want.float()
    return float((o - w).norm() / w.norm())


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------- phase 3


def paged_case(torch, dtype, seed=3):
    """Decode-step shapes: ctx spread over 1..1024 plus a ctx-0 row and an
    unoccupied row whose block table aliases a live row's pages."""
    b, h, hkv, d, page, npg = 8, 32, 4, 64, 8, 128
    n_phys = b * npg + 16
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (n_phys, page, hkv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (n_phys, page, hkv, d)).astype(np.float32))
    bt = rng.permutation(n_phys)[:b * npg].reshape(b, npg).astype(np.int32)
    ctx = np.asarray([0, 1, 64, 200, 377, 640, 1000, 1024], np.int32)
    occ = np.ones((b,), bool)
    occ[4] = False
    bt[4] = bt[5]
    args = [q.to(dt), kp.to(dt), vp.to(dt), torch.from_numpy(bt),
            torch.from_numpy(ctx), torch.from_numpy(occ)]
    return [a.to(DEVICE) for a in args], ctx, occ


def phase_paged(torch, timer, dtype):
    from repro_torch.kernels import paged_attention as pa
    (q, kp, vp, bt, ctx, occ), ctx_np, occ_np = paged_case(torch, dtype)
    want = pa.paged_attention_plain(q, kp, vp, bt, ctx, occ)
    dead = ~occ_np | (ctx_np == 0)
    variant = pa.kernel_variant(q.dtype, q.shape[2],
                                q.shape[1] // kp.shape[2], q.device)
    errs = {}
    for ns in (None, 3, 8):
        before = pa.launches.of(variant)
        out = pa.paged_attention(q, kp, vp, bt, ctx, occupancy=occ,
                                 num_splits=ns)
        torch.cuda.synchronize()
        if pa.launches.of(variant) != before + 1:
            raise AssertionError(f"paged_attention[{ns}]: the {variant} "
                                 f"variant did not launch")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"paged_attention[{ns}]: non-finite output")
        if not (out[torch.from_numpy(dead).to(DEVICE)] == 0).all():
            raise AssertionError(f"paged_attention[{ns}]: dead rows not 0")
        errs[ns] = close_enough(out, want, TOL[dtype])
    b, h, d = q.shape
    _, page, hkv, _ = kp.shape
    live = np.where(occ_np, ctx_np, 0)
    elt = q.element_size()
    nbytes = (live.sum() * hkv * d * 2 * elt + 2 * b * h * d * elt +
              4 * np.ceil(live / page).sum() + 9 * b)
    flops = 4.0 * h * d * live.sum()
    kernel_ms = timer.ms(lambda: pa.paged_attention(
        q, kp, vp, bt, ctx, occupancy=occ))
    device_ms = profiled_ms(torch, timer, lambda: pa.paged_attention(
        q, kp, vp, bt, ctx, occupancy=occ), PAGED_KERNELS)
    extra = {}
    if variant == "mma":
        # every context 0: no K/V byte is read, what is left is the fixed
        # cost of one call on the device
        no_keys = torch.zeros_like(ctx)
        extra = {"no_keys_profiler_ms": profiled_ms(
                     torch, timer, lambda: pa.paged_attention(
                         q, kp, vp, bt, no_keys, occupancy=occ),
                     PAGED_KERNELS),
                 "long_row": paged_long_row(torch, timer, dtype)}
    plain_ms = timer.ms(lambda: pa.paged_attention_plain(
        q, kp, vp, bt, ctx, occ))
    n_pages = bt.shape[1]
    kg = kp[bt.long()].reshape(b, n_pages * page, hkv, d) \
        .transpose(1, 2).contiguous()
    vg = vp[bt.long()].reshape(b, n_pages * page, hkv, d) \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(n_pages * page, device=DEVICE)[None, :] <
            ctx.long()[:, None]) & occ[:, None]
    lib_ms = timer.ms(sdpa_call(q[:, :, None, :], kg, vg,
                                mask[:, None, None, :]))
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {"name": "paged_attention", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": PAGED_TPU, "max_abs_err": errs[None],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "profiler_ms": device_ms,
            "errs": {str(k): v for k, v in errs.items()},
            "splits": pa.default_num_splits(b, hkv, n_pages, variant),
            **extra}


def paged_long_row(torch, timer, dtype, seed=3):
    """One row of 2048 keys (B = 1, H = 32, Hkv = 4, D = 64, 256 pages of
    8): the fewest blocks the decode step launches, each split walking 256
    keys.  Returns its errors, times and bound."""
    from repro_torch.kernels import paged_attention as pa
    b, h, hkv, d, page, npg = 1, 32, 4, 64, 8, 256
    rng = np.random.RandomState(seed + npg)
    dt = getattr(torch, dtype)
    q, kp, vp = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(DEVICE, dt) for shape in
        ((b, h, d), (npg + 8, page, hkv, d), (npg + 8, page, hkv, d))]
    bt = torch.from_numpy(rng.permutation(npg + 8)[:npg].reshape(b, npg)
                          .astype(np.int32)).to(DEVICE)
    ctx = torch.full((b,), npg * page, dtype=torch.int32, device=DEVICE)
    occ = torch.ones((b,), dtype=torch.bool, device=DEVICE)
    err = close_enough(pa.paged_attention(q, kp, vp, bt, ctx, occupancy=occ),
                       pa.paged_attention_plain(q, kp, vp, bt, ctx, occ),
                       TOL[dtype])

    def call():
        return pa.paged_attention(q, kp, vp, bt, ctx, occupancy=occ)
    elt = q.element_size()
    nbytes = npg * page * hkv * d * 2 * elt + 2 * b * h * d * elt + \
        4 * npg + 9 * b
    kg, vg = [t[bt.long()].reshape(b, npg * page, hkv, d).transpose(1, 2)
              .contiguous() for t in (kp, vp)]
    bound_ms, bound_by = bound(nbytes, 4.0 * h * d * npg * page, dtype)
    return {"max_abs_err": err, "ms": timer.ms(call),
            "profiler_ms": profiled_ms(torch, timer, call, PAGED_KERNELS),
            "library_ms": timer.ms(sdpa_call(q[:, :, None, :], kg, vg, None)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "splits": pa.default_num_splits(
                b, hkv, npg, pa.kernel_variant(q.dtype, d, h // hkv,
                                               q.device))}


# ----------------------------------------------------------- phase 4


def packed_case(torch, dtype, n_segs, seed=4, d=64):
    """Packed-chunk shapes: C = 256 lanes (the prefill budget; decode
    riders run as the decode step beside the chunk), head dim ``d``.
    With 8 segments: a padding run in the middle of the chunk, three
    one-lane prompt tails, and segment 1 sharing its first eight physical
    pages (a 64-token prefix-cache hit) with segment 0."""
    c, h, hkv, page, npg = 256, 32, 4, 8, 128
    n_phys = 2048
    rng = np.random.RandomState(seed + n_segs)
    dt = getattr(torch, dtype)
    seg = np.full((c,), -1, np.int32)
    pos = np.zeros((c,), np.int32)
    if n_segs == 1:
        spans = [(0, 0, 256, 512)]        # (segment, first lane, n, start)
    else:
        spans = [(0, 0, 96, 0), (1, 109, 64, 64), (2, 173, 40, 200),
                 (3, 213, 32, 424), (4, 245, 8, 800), (5, 253, 1, 1000),
                 (6, 254, 1, 700), (7, 255, 1, 37)]   # lanes 96..108: padding
    ctx = np.zeros((n_segs,), np.int32)
    for si, lane, n, start in spans:
        seg[lane:lane + n] = si
        pos[lane:lane + n] = np.arange(start, start + n)
        ctx[si] = start + n
    rows = rng.permutation(n_phys)[:n_segs * npg].reshape(n_segs, npg) \
        .astype(np.int32)
    if n_segs > 1:
        rows[1, :8] = rows[0, :8]
    q = torch.from_numpy(rng.standard_normal((c, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (n_phys, page, hkv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (n_phys, page, hkv, d)).astype(np.float32))
    args = [q.to(dt), kp.to(dt), vp.to(dt), torch.from_numpy(rows),
            torch.from_numpy(seg), torch.from_numpy(pos),
            torch.from_numpy(ctx)]
    return [a.to(DEVICE) for a in args], (rows, seg, pos, ctx)


def verify_case(torch, dtype, seed=12):
    """The speculative verify chunk at TinyLlama's widths, laid out by the
    engine's own ``verify_lanes``: max_batch 8 rows x (spec_k 4 + 1) = 40
    lanes, draft depths nd mixed in 0..4 (dead lanes between segments),
    row 6 unoccupied, contexts 64..1000; each row's block table holds its
    run of ceil((ctx + nd) / 8) pages and zeros after it, as the engine's,
    so the dead lanes of rows 1 and 7 sit at positions past their run."""
    from repro_torch.serving.engine import verify_lanes
    b, k, h, hkv, d, page, npg = 8, 4, 32, 4, 64, 8, 128
    n_phys = 2048
    ctx = np.asarray([64, 1000, 130, 377, 200, 640, 512, 997])
    nd = np.asarray([4, 0, 3, 1, 4, 2, 0, 1])
    occ = np.ones((b,), bool)
    occ[6] = False
    _, pos, seg, seg_ctx = verify_lanes(ctx, nd, occ, k)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_phys)
    rows = np.zeros((b, npg), np.int32)
    used = 0
    for i in range(b):
        n = -(-int(seg_ctx[i]) // page)
        rows[i, :n] = perm[used:used + n]
        used += n
    dt = getattr(torch, dtype)
    c = len(seg)
    q, kp, vp = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dt) for shape in
        ((c, h, d), (n_phys, page, hkv, d), (n_phys, page, hkv, d))]
    args = [q, kp, vp] + [torch.from_numpy(a) for a in
                          (rows, seg, pos, seg_ctx)]
    return [a.to(DEVICE) for a in args], (rows, seg, pos, seg_ctx)


def phase_packed(torch, timer, dtype, n_segs, case=None, d=64,
                 want_variant=None):
    """One packed-prefill row: the packed chunk of ``n_segs`` segments at
    head dim ``d``, or ``case`` (inputs as :func:`packed_case` returns
    them).  ``want_variant``: the variant that must serve the call."""
    from repro_torch.kernels import packed_prefill as pp
    (q, kp, vp, rows, seg, pos, ctx), (rows_np, seg_np, pos_np, ctx_np) = \
        case or packed_case(torch, dtype, n_segs, d=d)
    want = pp.packed_prefill_plain(q, kp, vp, rows, seg, pos, ctx)
    variant = pp.kernel_variant(q.dtype, q.shape[2], q.shape[1] // kp.shape[2],
                                q.device)
    if want_variant is not None and variant != want_variant:
        raise AssertionError(f"packed_prefill[S={n_segs}, D={q.shape[2]}]: "
                             f"variant {variant}, want {want_variant}")
    before = pp.launches.of(variant)
    out = pp.packed_prefill_attention(q, kp, vp, rows, seg, pos, ctx)
    torch.cuda.synchronize()
    if pp.launches.of(variant) != before + 1:
        raise AssertionError(f"packed_prefill[S={n_segs}]: the {variant} "
                             f"variant did not launch")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"packed_prefill[S={n_segs}]: non-finite")
    if not (out[torch.from_numpy(seg_np < 0).to(DEVICE)] == 0).all():
        raise AssertionError(f"packed_prefill[S={n_segs}]: padding not 0")
    err = close_enough(out, want, TOL[dtype])
    c, h, d = q.shape
    _, page, hkv, _ = kp.shape
    elt = q.element_size()
    live = set()
    for si in range(n_segs):
        live.update(rows_np[si, :-(-ctx_np[si] // page)].tolist())
    valid = seg_np >= 0
    nbytes = (len(live) * page * hkv * d * 2 * elt + 2 * c * h * d * elt +
              4 * sum(-(-int(x) // page) for x in ctx_np) + 8 * c +
              4 * n_segs)
    flops = 4.0 * h * d * float((pos_np[valid] + 1).sum())
    kernel_ms = timer.ms(lambda: pp.packed_prefill_attention(
        q, kp, vp, rows, seg, pos, ctx))
    device_ms = profiled_ms(torch, timer, lambda: pp.packed_prefill_attention(
        q, kp, vp, rows, seg, pos, ctx), PACKED_KERNELS)
    plain_ms = timer.ms(lambda: pp.packed_prefill_plain(
        q, kp, vp, rows, seg, pos, ctx))
    n_pages = rows.shape[1]
    t = n_segs * n_pages * page
    kg = kp[rows.long()].reshape(1, t, hkv, d).transpose(1, 2).contiguous()
    vg = vp[rows.long()].reshape(1, t, hkv, d).transpose(1, 2).contiguous()
    key = torch.arange(t, device=DEVICE)
    mask = (seg.long()[:, None] == (key // (n_pages * page))[None, :]) & \
        ((key % (n_pages * page))[None, :] <= pos.long()[:, None])
    lib_ms = timer.ms(sdpa_call(q.transpose(0, 1)[None].contiguous(), kg,
                                vg, mask[None, None]))
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {"name": "packed_prefill_attention", "route": "cuda",
            "variant": variant,
            "source": "src/repro_torch/kernels/csrc/packed_prefill.cu",
            "replaces": PACKED_TPU, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "profiler_ms": device_ms}


# ----------------------------------------------------------- phase 4c

FUSED_OPS = ("add_rms_norm", "qk_norm_rope_write", "silu_mul")
# Qwen3-32B: d, H, Hkv, D, FFN, rope theta; the engine's lanes a layout
FUSED_WIDTHS = (5120, 64, 8, 128, 25600, 1e6)
FUSED_LAYOUTS = {"decode": 32, "packed": 512, "verify": 160}


def fused_case(torch, dtype, op, layout, seed=20):
    """Inputs of one fused op at Qwen3-32B's widths and a layout's lanes:
    the decode step's 32 rows (the last 4 padding), the packed chunk's 512
    lanes (the last 40 padding), the spec verify's 32 x 5 lanes (lanes
    past each row's draft depth dead, two rows unoccupied).  Returns (the
    op's arguments, bytes it must move)."""
    d, h, hkv, hd, d_ff, theta = FUSED_WIDTHS
    n = FUSED_LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    elt = torch.empty((), dtype=dt).element_size()

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=DEVICE, dtype=dt)
    if op == "add_rms_norm":
        return [randn(n, d), randn(n, d), randn(d)], (4 * n + 1) * d * elt
    if op == "silu_mul":
        return [randn(n, d_ff), randn(n, d_ff)], 3 * n * d_ff * elt
    n_pages, page = 1024, 8
    slots = rng.permutation(n_pages * page)[:n]
    lane = np.arange(n)
    if layout == "decode":
        dead = lane >= n - 4
    elif layout == "packed":
        dead = lane >= n - 40
    else:
        nd = rng.randint(0, 5, size=n // 5)
        nd[-2:] = -1
        dead = lane % 5 > nd[lane // 5]
    wr_page = np.where(dead, -1, slots // page).astype(np.int64)
    half = hd // 2
    angles = rng.randint(0, 2048, size=(n, 1)) / (
        theta ** (np.arange(half) / half))
    live = int((~dead).sum())
    nbytes = ((n * (2 * h + 2 * hkv) * hd + 2 * hd) * elt + n * hd * 4 +
              16 * n + 2 * live * hkv * hd * elt)
    return [randn(n, h, hd), randn(n, hkv, hd), randn(n, hkv, hd),
            randn(hd), randn(hd),
            torch.from_numpy(np.cos(angles).astype(np.float32)).to(DEVICE),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(DEVICE),
            randn(n_pages, page, hkv, hd), randn(n_pages, page, hkv, hd),
            torch.from_numpy(wr_page).to(DEVICE),
            torch.from_numpy((slots % page).astype(np.int64)).to(DEVICE)
            ], nbytes


def phase_fused(torch, timer, dtype, op, layout):
    """One fused kernel against its plain version at one layout: within
    the dtype's tolerance, one launch, and (the K/V store) every page slot
    outside a live lane's target byte-equal to its value before the call;
    then its ms, profiler ms, plain ms and bound (its bytes at
    3.35 TB/s)."""
    from repro_torch.kernels import fused_block as fb
    args, nbytes = fused_case(torch, dtype, op, layout)
    plain = getattr(fb, f"{op}_plain")
    kernel = getattr(fb, op)
    if op == "qk_norm_rope_write":
        k0, v0 = args[7].clone(), args[8].clone()
        p_args = args[:7] + [k0.clone(), v0.clone()] + args[9:]
        want = [plain(*p_args), p_args[7], p_args[8]]
    else:
        want = plain(*args)
        want = list(want) if isinstance(want, tuple) else [want]
    before = fb.launches.of(op)
    got = kernel(*args)
    torch.cuda.synchronize()
    if fb.launches.of(op) != before + 1:
        raise AssertionError(f"{op} [{layout}]: the kernel did not launch")
    if op == "qk_norm_rope_write":
        got = [got, args[7], args[8]]
        live = args[9] >= 0
        keep = torch.ones(args[7].shape[:2], dtype=torch.bool, device=DEVICE)
        keep[args[9][live], args[10][live]] = False
        if not (torch.equal(args[7][keep], k0[keep]) and
                torch.equal(args[8][keep], v0[keep])):
            raise AssertionError(f"{op} [{layout}]: a padding lane wrote a "
                                 f"page")
    elif not isinstance(got, tuple):
        got = [got]
    err = max(close_enough(g, w, TOL[dtype]) for g, w in zip(got, want))
    kernel_ms = timer.ms(lambda: kernel(*args))
    device_ms = profiled_ms(torch, timer, lambda: kernel(*args),
                            (f"{op}_kernel",))
    plain_ms = timer.ms(lambda: plain(*args))
    bound_ms, bound_by = bound(nbytes, 0.0, dtype)
    return {"name": op, "route": "cuda", "variant": layout,
            "source": "src/repro_torch/kernels/csrc/fused_block.cu",
            "replaces": "none (XLA fuses the chain inside jit)",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "profiler_ms": device_ms}


# ----------------------------------------------------------- phase 4d

# DeepSeek-V2: heads, latent + rope, latent; the cell's pool, page, table
MLA_SHAPE = (128, 576, 512)
MLA_POOL_PAGES, MLA_PAGE, MLA_TABLE = 96000, 8, 320
MLA_SCALE = 0.11472   # DeepSeek-V2's YaRN score scale
MLA_KERNELS = {"decode": ("mla_decode_partial_kernel",
                          "mla_decode_combine_kernel"),
               "prefill": ("mla_prefill_partial_kernel",
                           "mla_prefill_combine_kernel"),
               "store": ("mla_latent_store_kernel",)}


def mla_case(torch, layout, seed=21):
    """One MLA call at the cell's shapes: the decode step's 256 rows
    (contexts 300-2,000, the last 4 rows unoccupied) or a prefill chunk's
    2,048 lanes (two prompts of 1,024 lanes, context = position + 1, the
    last 48 lanes unoccupied).  Returns (q, pool, tables, contexts,
    occupancy, live keys)."""
    h, dim, _ = MLA_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = 256 if layout == "decode" else 2048
    q = torch.randn((n, h, dim), generator=g, device=DEVICE).bfloat16()
    pool = torch.randn((MLA_POOL_PAGES, MLA_PAGE, dim), generator=g,
                       device=DEVICE).bfloat16()
    tables = torch.randint(0, MLA_POOL_PAGES, (n, MLA_TABLE), generator=g,
                           device=DEVICE, dtype=torch.int32)
    occ = torch.ones(n, dtype=torch.bool, device=DEVICE)
    if layout == "decode":
        ctx = torch.randint(300, 2001, (n,), generator=g, device=DEVICE,
                            dtype=torch.int32)
        occ[-4:] = False
    else:
        lane = torch.arange(n, device=DEVICE)
        ctx = (lane % 1024 + 1).to(torch.int32)
        tables = tables[lane // 1024 * 1024].contiguous()
        occ[-48:] = False
    keys = int(ctx[occ].sum())
    return q, pool, tables, ctx, occ, keys


def phase_mla(torch, timer, layout):
    """The MLA attention kernel against its plain version on the same
    inputs at one layout: within bf16's tolerance, unoccupied rows exactly
    0, one launch of the layout's entry names; its ms, profiler ms, plain
    ms and bound."""
    from repro_torch.kernels import mla_attention as mla
    from repro_torch.kernels import ops
    q, pool, tables, ctx, occ, keys = mla_case(torch, layout)
    n, h, dim = q.shape
    rank = MLA_SHAPE[2]
    prefill = layout == "prefill"
    splits = ops.mla_splits(256, h, MLA_TABLE * MLA_PAGE, DEVICE)

    def kernel():
        return ops.mla_attention(q, pool, tables, ctx, scale=MLA_SCALE,
                                 occupancy=occ, num_splits=splits,
                                 prefill=prefill)

    def plain():
        return mla.mla_attention_plain(q, pool, tables, ctx, occ, MLA_SCALE,
                                       rank)
    before = mla.launches.of(layout)
    got = kernel()
    torch.cuda.synchronize()
    if mla.launches.of(layout) != before + 1:
        raise AssertionError(f"mla {layout}: the kernel did not launch")
    if got[~occ].abs().max() != 0:
        raise AssertionError(f"mla {layout}: an unoccupied row is not 0")
    err = close_enough(got, plain(), TOL["bfloat16"])
    nbytes = keys * dim * 2 + int(occ.sum()) * h * (dim + rank) * 2 + \
        n * (MLA_TABLE * 4 + 5)
    flops = keys * h * (dim + rank) * 2
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    return {"name": f"mla_{layout}", "route": "cuda", "variant": layout,
            "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
            "replaces": "none (the JAX package attends over a contiguous "
                        "latent cache with einsums)",
            "max_abs_err": err, "ms": timer.ms(kernel),
            "profiler_ms": profiled_ms(torch, timer, kernel,
                                       MLA_KERNELS[layout]),
            "plain_ms": timer.ms(plain, iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "rows": n, "keys": keys, "splits": splits}


def phase_mla_store(torch, timer, layout):
    """The latent store against its plain version: a lane's latent norm
    and key rope (interleaved, as DeepSeek-V2 reads it) at its pool row,
    padding lanes (page -1) writing nothing, every other pool row
    byte-equal to before; its ms, profiler ms, plain ms and bound."""
    from repro_torch.kernels import mla_attention as mla
    from repro_torch.kernels import ops
    _, dim, rank = MLA_SHAPE
    n = 256 if layout == "decode" else 2048
    n_dead = 4 if layout == "decode" else 48
    g = torch.Generator(device=DEVICE).manual_seed(22)
    kv = torch.randn((n, dim), generator=g, device=DEVICE).bfloat16()
    gain = (1 + 0.1 * torch.randn((rank,), generator=g, device=DEVICE)
            ).bfloat16()
    ang = torch.rand((n, (dim - rank) // 2), generator=g, device=DEVICE) * 6
    cos, sin = torch.cos(ang), torch.sin(ang)
    pages = 4096
    pool0 = torch.randn((pages, MLA_PAGE, dim), generator=g,
                        device=DEVICE).bfloat16()
    slots = torch.randperm(pages * MLA_PAGE, generator=g, device=DEVICE)[:n]
    wr_page, wr_slot = slots // MLA_PAGE, slots % MLA_PAGE
    wr_page[-n_dead:] = -1
    args = (kv, gain, cos, sin)
    kw = dict(interleaved=True, eps=1e-6)
    want = pool0.clone()
    mla.mla_latent_store_plain(*args, want, wr_page, wr_slot, True, 1e-6)
    got = pool0.clone()
    before = mla.launches.of("latent_store")
    ops.mla_latent_store(*args, got, wr_page, wr_slot, **kw)
    torch.cuda.synchronize()
    if mla.launches.of("latent_store") != before + 1:
        raise AssertionError(f"mla store {layout}: the kernel did not "
                             f"launch")
    live = wr_page >= 0
    keep = torch.ones((pages, MLA_PAGE), dtype=torch.bool, device=DEVICE)
    keep[wr_page[live], wr_slot[live]] = False
    if not torch.equal(got[keep], pool0[keep]):
        raise AssertionError(f"mla store {layout}: a row outside the live "
                             f"lanes' targets changed")
    err = close_enough(got[~keep], want[~keep], TOL["bfloat16"])
    work = pool0.clone()

    def kernel():
        ops.mla_latent_store(*args, work, wr_page, wr_slot, **kw)

    def plain():
        mla.mla_latent_store_plain(*args, work, wr_page, wr_slot, True, 1e-6)
    nbytes = n * dim * 2 + rank * 2 + n * (dim - rank) * 4 + 16 * n + \
        int(live.sum()) * dim * 2
    bound_ms, bound_by = bound(nbytes, 0.0, "bfloat16")
    return {"name": "mla_latent_store", "route": "cuda", "variant": layout,
            "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
            "replaces": "none (XLA fuses the norm, rope and cache write)",
            "max_abs_err": err, "ms": timer.ms(kernel),
            "profiler_ms": profiled_ms(torch, timer, kernel,
                                       MLA_KERNELS["store"]),
            "plain_ms": timer.ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "rows": n}


# ------------------------------------------------------- phases 5 and 6


def reference_greedy(torch, model, params, prompt, n_new):
    """Greedy decode through the model's contiguous cache, one token at a
    time; returns (tokens, top-2 logit margin at each generated step)."""
    cache = model.init_cache(1, len(prompt) + n_new + 1, device=DEVICE)
    toks, out, margins = list(prompt), [], []
    for t in range(len(prompt) + n_new):
        batch = {"tokens": torch.tensor([[toks[t]]], device=DEVICE),
                 "cache_len": torch.tensor([t + 1], dtype=torch.int32,
                                           device=DEVICE)}
        logits, cache = model.decode_step(params, cache, batch)
        if t >= len(prompt) - 1:
            top = torch.topk(logits[0].float(), 2).values.cpu().numpy()
            out.append(int(torch.argmax(logits[0]).item()))
            margins.append(float(top[0] - top[1]))
            if len(out) == n_new:
                break
            toks.append(out[-1])
    return out, margins


def serve_fp32(torch):
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import packed_prefill, paged_attention
    from repro_torch.models import build_model

    cfg = get_config("tinyllama-1.1b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(5)
    v = cfg.vocab_size
    shared = rng.randint(1, v, size=64).tolist()
    prompts = [shared + rng.randint(1, v, size=36).tolist(),
               shared + rng.randint(1, v, size=136).tolist(),
               rng.randint(1, v, size=64).tolist(),
               rng.randint(1, v, size=150).tolist()]
    n_new = 16
    with torch.inference_mode():
        refs = [reference_greedy(torch, model, params, p, n_new)
                for p in prompts]
    lines = []
    for sched in ("chunked", "packed"):
        paged_attention.launches.reset()
        packed_prefill.launches.reset()
        session = serving.serve(
            model, params,
            serving.ServingConfig(num_pages=2048, max_batch=4,
                                  max_seq_len=512, prefill_chunk_tokens=128,
                                  scheduler=sched), device=DEVICE)
        try:
            # the first shared-prefix prompt completes first, so the second
            # finds its 64-token prefix in the cache
            outs = [session.submit(prompts[0], max_new_tokens=n_new)
                    .result(timeout=300)]
            handles = [session.submit(p, max_new_tokens=n_new)
                       for p in prompts[1:]]
            outs += [hnd.result(timeout=300) for hnd in handles]
            hits = session.stats()["totals"]["prefix_hits"]
        finally:
            session.close()
        if hits < 1:
            raise AssertionError(f"fp32 {sched}: no prefix-cache hit")
        if paged_attention.launches.count < 1 or \
                packed_prefill.launches.count < 1:
            raise AssertionError(f"fp32 {sched}: a kernel never launched")
        notes = []
        for i, (out, (want, margins)) in enumerate(zip(outs, refs)):
            if len(out) != n_new:
                raise AssertionError(f"fp32 {sched}: request {i} gave "
                                     f"{len(out)} tokens")
            for j, (a, b) in enumerate(zip(out, want)):
                if a != b:
                    if margins[j] >= 1e-3:
                        raise AssertionError(
                            f"fp32 {sched}: request {i} token {j}: {a} != "
                            f"reference {b} at top-2 margin {margins[j]:.3g}")
                    notes.append(f"req {i} diverges at token {j}, margin "
                                 f"{margins[j]:.3g}")
                    break
        lines.append(f"{sched}: 4/4 requests match the reference"
                     f" ({'; '.join(notes) or 'all tokens identical'}),"
                     f" prefix hits {hits}, launches paged "
                     f"{paged_attention.launches.count} packed "
                     f"{packed_prefill.launches.count}")
    del params
    torch.cuda.empty_cache()
    return lines


def serve_bf16(torch):
    """The main path: bf16 TinyLlama-1.1B under the packed scheduler.
    Returns (summary, launches per kernel during the run)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_block, packed_prefill, \
        paged_attention
    from repro_torch.models import build_model

    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(128, 513, size=16)]
    n_new = 64
    session = serving.serve(
        model, params,
        serving.ServingConfig(num_pages=8192, max_batch=8, max_seq_len=1024,
                              prefill_chunk_tokens=256, scheduler="packed"),
        device=DEVICE)
    try:
        paged_attention.launches.reset()
        packed_prefill.launches.reset()
        fused_block.launches.reset()
        t0 = time.perf_counter()
        handles = session.submit_many(prompts, max_new_tokens=n_new)
        outs = [hnd.result(timeout=600) for hnd in handles]
        wall = time.perf_counter() - t0
        launches = {"paged_attention": paged_attention.launches.count,
                    "packed_prefill_attention":
                        packed_prefill.launches.count}
        launches.update({f"fused_block:{op}": fused_block.launches.of(op)
                         for op in FUSED_OPS})
        packed_tc = packed_prefill.launches.of("wgmma")
        paged_tc = paged_attention.launches.of("mma")
        stats = session.stats()["totals"]
        # one decode call of max_batch padding rows (no page written) on
        # the live engine, under its step lock: the fused launches a step
        shard = session.engine.shards[0]
        with shard._step_lock, torch.inference_mode():
            fused_block.launches.reset()
            shard._decode_logits([])
            per_step = dict(fused_block.launches.by_variant)
        graph_bytes = shard._decode_graph.pool_bytes
    finally:
        session.close()
    decode_calls = stats["decode_steps"] + stats["rider_chunks"]
    if stats["decode_graph_replays"] != decode_calls:
        raise AssertionError(
            f"bf16: {stats['decode_graph_replays']} graph replays for "
            f"{decode_calls} decode calls: every one must replay")
    eager_outs = serve_eager(model, params, prompts, n_new, session.config)
    graph_digest, eager_digest = token_digest(outs), token_digest(eager_outs)
    if graph_digest != eager_digest:
        raise AssertionError(
            f"bf16: graph tokens {graph_digest} differ from eager "
            f"{eager_digest}; first difference "
            f"{first_token_difference(outs, eager_outs)}")
    n_l = cfg.n_layers
    want_step = {"add_rms_norm": 2 * n_l + 1, "qk_norm_rope_write": n_l,
                 "silu_mul": n_l}
    if per_step != want_step:
        raise AssertionError(f"bf16: fused launches a decode step "
                             f"{per_step}, want {want_step}")
    if stats["eager_blocks"] or not (
            launches["fused_block:qk_norm_rope_write"] ==
            launches["fused_block:silu_mul"] == stats["fused_blocks"]):
        raise AssertionError(
            f"bf16: {stats['fused_blocks']} fused and "
            f"{stats['eager_blocks']} eager block passes, fused launches "
            f"{launches}: every block must run the fused kernels once")
    if any(len(o) != n_new for o in outs) or stats["failed"]:
        raise AssertionError(f"bf16: not every request completed with "
                             f"{n_new} tokens ({[len(o) for o in outs]})")
    if min(launches.values()) < 1:
        raise AssertionError(f"bf16: a kernel never launched: {launches}")
    want_packed = cfg.n_layers * stats["packed_chunks"]
    if not packed_tc == launches["packed_prefill_attention"] == want_packed:
        raise AssertionError(
            f"bf16: packed launches {launches['packed_prefill_attention']} "
            f"(wgmma variant {packed_tc}), want {want_packed}: one "
            f"tensor-core launch a layer for each of "
            f"{stats['packed_chunks']} packed chunks")
    rider_paged = cfg.n_layers * stats["rider_chunks"]
    if not (paged_tc == launches["paged_attention"] and
            paged_tc % cfg.n_layers == 0 and stats["rider_chunks"] >= 1):
        raise AssertionError(
            f"bf16: paged launches {launches['paged_attention']} (mma "
            f"variant {paged_tc}) with {stats['rider_chunks']} rider "
            f"chunks, want every one the mma variant, {cfg.n_layers} (one "
            f"a layer) per decode step and per packed chunk with riders")
    ttft = [hnd.ttft() for hnd in handles]
    itl = [g for hnd in handles for g in hnd.itl()]
    summary = {
        "requests": len(prompts), "completed": len(outs),
        "prompt_tokens": sum(len(p) for p in prompts),
        "new_tokens": sum(len(o) for o in outs), "wall_s": wall,
        "tok_s": sum(len(o) for o in outs) / wall,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "itl_p50_ms": float(np.percentile(itl, 50)) * 1e3,
        "itl_p99_ms": float(np.percentile(itl, 99)) * 1e3,
        "steps": stats["steps"], "packed_chunks": stats["packed_chunks"],
        "launches": launches, "packed_wgmma_launches": packed_tc,
        "paged_mma_launches": paged_tc,
        "paged_launches_decode_steps": paged_tc - rider_paged,
        "paged_launches_riders": rider_paged,
        "decode_steps": (paged_tc - rider_paged) // cfg.n_layers,
        "rider_chunks": stats["rider_chunks"],
        "fused_block_passes": stats["fused_blocks"],
        "fused_launches_a_decode_step": per_step,
        "decode_graph_replays": stats["decode_graph_replays"],
        "decode_graph_pool_bytes": graph_bytes,
        "token_digest_graph": graph_digest,
        "token_digest_eager": eager_digest}
    return summary, launches


def serve_eager(model, params, prompts, n_new, config):
    """``prompts`` served in a session under ``config`` whose decode calls
    run eagerly (the shard's decode graph taken away before it starts)."""
    from repro_torch import serving
    session = serving.serve(model, params, config, device=DEVICE,
                            start=False)
    try:
        for shard in session.engine.shards:
            shard._decode_graph = None
        session.start()
        handles = session.submit_many(prompts, max_new_tokens=n_new)
        outs = [hnd.result(timeout=600) for hnd in handles]
        replays = session.stats()["totals"]["decode_graph_replays"]
    finally:
        session.close()
    if replays:
        raise AssertionError(f"eager serving replayed {replays} graphs")
    return outs


def token_digest(outs) -> str:
    """sha256 of every request's tokens, in order."""
    return hashlib.sha256(json.dumps(
        [list(map(int, o)) for o in outs]).encode()).hexdigest()


def first_token_difference(outs, refs):
    """(request, position, token, reference token) of the first token
    that differs, or None."""
    for i, (o, r) in enumerate(zip(outs, refs)):
        for j, (a, b) in enumerate(zip(o, r)):
            if a != b:
                return i, j, int(a), int(b)
        if len(o) != len(r):
            return i, min(len(o), len(r)), None, None
    return None


def serve_deepseek_bf16(torch):
    """DeepSeek-V2 in bf16 under ``packed``: the published widths, 4
    layers (1 dense, 3 expert layers holding experts 0-19 of 160), the
    published routing and YaRN.  Returns (summary, launches per kernel
    during the run)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_attention as mla
    from repro_torch.models import build_model
    from repro_torch.models.config import options

    cfg = options(get_config("deepseek-v2-236b")).replace(
        n_layers=4, topk_method="group_limited_greedy", n_group=8,
        topk_group=3, norm_topk_prob=False, routed_scaling_factor=16.0,
        experts_held=20, first_expert=0, yarn_factor=40.0, yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707, yarn_original_max_position=4096,
        yarn_beta_fast=32.0, yarn_beta_slow=1.0, rope_interleaved=True,
        dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(29)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(64, 401, size=24)]
    n_new = 48
    session = serving.serve(
        model, params,
        serving.ServingConfig(num_pages=4096, max_batch=16, max_seq_len=512,
                              prefill_chunk_tokens=512, scheduler="packed",
                              watchdog="off"),
        device=DEVICE)
    try:
        mla.launches.reset()
        t0 = time.perf_counter()
        handles = session.submit_many(prompts, max_new_tokens=n_new)
        outs = [hnd.result(timeout=600) for hnd in handles]
        wall = time.perf_counter() - t0
        counts = dict(mla.launches.by_variant)
        stats = session.stats()["totals"]
    finally:
        session.close()
    n_l = cfg.n_layers
    calls = stats["decode_steps"] + stats["rider_chunks"]
    want = {"decode": n_l * calls, "prefill": n_l * stats["packed_chunks"],
            "latent_store": n_l * (calls + stats["packed_chunks"])}
    if any(len(o) != n_new for o in outs) or stats["failed"]:
        raise AssertionError(f"deepseek bf16: not every request completed "
                             f"with {n_new} tokens ({[len(o) for o in outs]})")
    if counts != want or not stats["rider_chunks"]:
        raise AssertionError(
            f"deepseek bf16: MLA launches {counts} with "
            f"{stats['decode_steps']} decode steps, {stats['rider_chunks']} "
            f"rider chunks, {stats['packed_chunks']} packed chunks; want "
            f"{want}")
    if stats["decode_graph_replays"]:
        raise AssertionError(f"deepseek bf16: {stats['decode_graph_replays']}"
                             f" graph replays: a latent stack runs eagerly")
    summary = {
        "requests": len(prompts), "completed": len(outs),
        "prompt_tokens": sum(len(p) for p in prompts),
        "new_tokens": sum(len(o) for o in outs), "wall_s": wall,
        "decode_steps": stats["decode_steps"],
        "rider_chunks": stats["rider_chunks"],
        "packed_chunks": stats["packed_chunks"],
        "mla_prefill_rows": stats["mla_prefill_rows"],
        "moe_decode_passes": stats["moe_decode_passes"],
        "moe_decode_local_pairs": stats["moe_decode_local_pairs"],
        "launches": counts}
    return summary, {f"mla_attention:{k}": v for k, v in counts.items()}


# ----------------------------------------------------------- phase 11


def phase_sampler(torch, timer):
    """The sampler on the card against its CPU run: PRNG keys and random
    bits bit-equal over a grid of (seed, position, stream); tokens of
    ``sample_tokens`` at (8, 32000), temperature 0.8, with top-k 50 and
    top-p 0.9 equal (a flip only where the CPU's top two gumbel-perturbed
    scores lie within 1e-3)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    seeds = torch.tensor([0, 1, 7, 2**31 - 1, 2**32 - 1])
    pos = torch.tensor([0, 1, 7, 1023, 2**20])
    grid = [t.reshape(-1) for t in torch.meshgrid(
        seeds, pos, torch.arange(4), indexing="ij")]
    cpu_key = kref.sample_key_ref(*grid)
    card_key = kref.sample_key_ref(*[t.to(DEVICE) for t in grid],
                                   device=DEVICE)
    if not all(torch.equal(a, b.cpu()) for a, b in zip(cpu_key, card_key)):
        raise AssertionError("sampler: keys differ on the card")
    v = 32000
    if not torch.equal(kref.random_bits(cpu_key, v),
                       kref.random_bits(card_key, v).cpu()):
        raise AssertionError("sampler: random bits differ on the card")
    g = torch.Generator().manual_seed(11)
    logits = torch.randn((8, v), generator=g) * 3
    b = logits.shape[0]
    args = ([0.8] * b, [50] * b, [0.9] * b, list(range(b)),
            [5, 99, 1023, 2**20, 0, 1, 7, 300])
    cpu_t, _ = ops.sample_tokens(logits, *args)
    card_logits = logits.to(DEVICE)
    card_t, _ = ops.sample_tokens(card_logits, *args)
    dist = kref.filtered_dist_ref(logits, *args[:3])
    score = torch.log(torch.clamp(dist, min=1e-30)) + kref.gumbel(
        kref.sample_key_ref(torch.tensor(args[3]), torch.tensor(args[4]), 0),
        v)
    top2 = torch.topk(score, 2).values
    flips = [i for i in range(b) if int(card_t[i]) != int(cpu_t[i])]
    for i in flips:
        if float(top2[i, 0] - top2[i, 1]) >= 1e-3:
            raise AssertionError(f"sampler: row {i} token {int(card_t[i])}"
                                 f" != CPU {int(cpu_t[i])}")
    ms = timer.ms(lambda: ops.sample_tokens(card_logits, *args), iters=10)
    device_ms, top = sampler_profile(torch, lambda: ops.sample_tokens(
        card_logits, *args))
    return (f"keys and bits of {len(grid[0])} (seed, position, stream) "
            f"keys bit-equal to the CPU; tokens (8, {v}) at T 0.8, top-k "
            f"50, top-p 0.9: {b - len(flips)}/{b} equal"
            f"{' (flips at near-ties: ' + str(flips) + ')' if flips else ''};"
            f" sample_tokens {ms:.3f} ms by events, {device_ms:.3f} ms of "
            f"device time (plain tensor ops; largest: {top})")


def sampler_profile(torch, fn, iters: int = 5):
    """Device time of one call of ``fn`` (every kernel it launches) and its
    three largest ops by device time, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def dev(evt):
        t = getattr(evt, "self_device_time_total", None)
        return t if t is not None else getattr(evt, "self_cuda_time_total",
                                               0.0)
    evts = sorted(prof.key_averages(), key=dev, reverse=True)
    total = sum(dev(e) for e in evts) / iters / 1e3
    top = ", ".join(f"{e.key} {dev(e) / iters / 1e3:.3f} ms"
                    for e in evts[:3])
    return total, top


# ------------------------------------------------------ phases 12 and 13


def reference_sampled(torch, model, params, prompt, n_new, policy):
    """Contiguous-cache decode with the port's sampler keyed by ABSOLUTE
    position (the oracle the engine must reproduce); returns (tokens,
    gap between the top two gumbel-perturbed scores at each pick)."""
    from repro_torch.kernels import ref as kref
    t_f, k_i, p_f, seed = policy.operands()
    cache = model.init_cache(1, len(prompt) + n_new + 1, device=DEVICE)
    toks, out, margins = list(prompt), [], []
    for t in range(len(prompt) + n_new):
        batch = {"tokens": torch.tensor([[toks[t]]], device=DEVICE),
                 "cache_len": torch.tensor([t + 1], dtype=torch.int32,
                                           device=DEVICE)}
        logits, cache = model.decode_step(params, cache, batch)
        if t < len(prompt) - 1:
            continue
        dist = kref.filtered_dist_ref(logits, [t_f], [k_i], [p_f])
        key = kref.sample_key_ref(torch.tensor([seed], device=DEVICE),
                                  torch.tensor([t + 1], device=DEVICE), 0,
                                  DEVICE)
        score = (torch.log(torch.clamp(dist, min=1e-30)) +
                 kref.gumbel(key, dist.shape[-1]))[0]
        top = torch.topk(score, 2).values.cpu().numpy()
        out.append(int(torch.argmax(score).item()))
        margins.append(float(top[0] - top[1]))
        if len(out) == n_new:
            return out, margins
        toks.append(out[-1])


def held(label, outs, refs, limit=1e-3):
    """Each stream equals its reference, or first differs where the
    reference's top-two margin is below ``limit``; returns notes."""
    notes = []
    for i, (out, (want, margins)) in enumerate(zip(outs, refs)):
        if len(out) != len(want):
            raise AssertionError(f"{label}: request {i} gave {len(out)} "
                                 f"tokens, want {len(want)}")
        for j, (a, b) in enumerate(zip(out, want)):
            if a != b:
                if margins[j] >= limit:
                    raise AssertionError(
                        f"{label}: request {i} token {j}: {a} != reference "
                        f"{b} at top-2 margin {margins[j]:.3g}")
                notes.append(f"req {i} diverges at token {j}, margin "
                             f"{margins[j]:.3g}")
                break
    return "; ".join(notes) or "all tokens identical"


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def forced_margins(torch, model, params, prompt, tokens, policy=None):
    """Margins along a recorded stream: ``logits_fn`` over prompt +
    tokens[:-1] (teacher-forced, one pass) and, at the position that
    picked each token, the gap between the top two scores the pick
    compares (greedy: logits; sampled: gumbel-perturbed log-probs of the
    filtered distribution, keyed by absolute position, as the engine
    draws).  Returns (margins, top logit at each pick)."""
    from repro_torch.kernels import ref as kref
    seq = list(prompt) + list(tokens[:-1])
    with torch.inference_mode():
        logits, _ = model.logits_fn(params, {"tokens": torch.tensor(
            [seq], device=DEVICE)})
        rows = logits[0, len(prompt) - 1:].float()        # (n, V)
        top = rows.max(-1).values
        if policy is None:
            score = rows
        else:
            t_f, k_i, p_f, seed = policy.operands()
            n = rows.shape[0]
            dist = kref.filtered_dist_ref(rows, [t_f] * n, [k_i] * n,
                                          [p_f] * n)
            pos = torch.arange(len(prompt), len(prompt) + n, device=DEVICE)
            key = kref.sample_key_ref(torch.full((n,), seed, device=DEVICE),
                                      pos, 0, DEVICE)
            score = torch.log(torch.clamp(dist, min=1e-30)) + kref.gumbel(
                key, dist.shape[-1])
        top2 = torch.topk(score, 2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]).cpu().tolist(), top.cpu().tolist())


def first_divergences(outs, refs, tops):
    """Per stream: None where it equals its reference, else (token index,
    token, reference token, reference margin there, that margin in bf16
    ulps of the reference's top logit)."""
    rows = []
    for out, (want, margins), top in zip(outs, refs, tops):
        j = next((j for j, (a, b) in enumerate(zip(out, want)) if a != b),
                 None)
        rows.append(None if j is None else (
            j, out[j], want[j], margins[j], margins[j] / bf16_ulp(top[j])))
    return rows


def divergence_notes(rows):
    return "; ".join(
        f"req {i}: identical" if r is None else
        f"req {i}: first differs at token {r[0]} ({r[1]} vs {r[2]}), "
        f"margin {r[3]:.4g} = {r[4]:.2f} bf16 ulps of the top logit"
        for i, r in enumerate(rows))


def serve_run(torch, model, params, prompts, n_new, sampling=None,
              warm=False, **config):
    """One session: submit every prompt at once, wait, close.  Returns
    (tokens, totals, launches by kernel and variant during the run)."""
    from repro_torch import serving
    session = serving.serve(model, params, serving.ServingConfig(**config),
                            device=DEVICE)
    try:
        if warm:
            session.warm()
        reset_launches()
        handles = [session.submit(p, max_new_tokens=n_new,
                                  sampling=sampling) for p in prompts]
        outs = [hnd.result(timeout=600) for hnd in handles]
        counts = launch_counts()
        totals = session.stats()["totals"]
    finally:
        session.close()
    if totals["failed"]:
        raise AssertionError(f"serve: {totals['failed']} requests failed")
    return outs, totals, counts


def launch_counts():
    from repro_torch.kernels import packed_prefill, paged_attention
    return {"paged_attention": paged_attention.launches.count,
            "packed_prefill_attention": packed_prefill.launches.count,
            "packed_by_variant": dict(packed_prefill.launches.by_variant),
            "paged_by_variant": dict(paged_attention.launches.by_variant)}


def check_verify_launches(label, cfg, totals, counts, variants):
    """Spec mode replaces the decode step: every packed launch is one
    layer of a prefill chunk, every paged launch one layer of a verify
    chunk (its lanes run as paged rows), of the variants ``variants``
    (paged, packed).  Returns the verify launches."""
    n_l = cfg.n_layers
    rounds, chunks = totals["spec_rounds"], totals["prefill_chunks"]
    paged, packed = counts["paged_attention"], \
        counts["packed_prefill_attention"]
    if rounds < 1 or paged != n_l * rounds or packed != n_l * chunks or \
            counts["paged_by_variant"].get(variants[0], 0) != paged or \
            counts["packed_by_variant"].get(variants[1], 0) != packed:
        raise AssertionError(
            f"{label}: paged launches {counts['paged_by_variant']} for "
            f"{rounds} verify rounds, packed {counts['packed_by_variant']} "
            f"for {chunks} prefill chunks (want {n_l} per round and per "
            f"chunk, of the {variants} variants)")
    return n_l * rounds


LANE_OPS = ("x", "rms_norm", "q_proj", "k_proj", "v_proj", "attention",
            "o_proj", "ffn")


def traced_layers(stack, rec, keep=lambda x: True):
    """A copy of ``DenseStack.layers`` (``serving/paged_stack.py``), op
    for op, that records lane 0 of every op's output in every layer into
    ``rec`` (for the calls whose lanes ``keep`` accepts): the decode
    step's row 0, or the verify chunk's lane 0 (row 0's x_last).  Set it
    as the shard's ``stack.layers``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.layers import rope_angles

    def layers(x, positions, wr_page, wr_slot, attend):
        cfg = stack.cfg
        n = x.shape[0]
        record = keep(x)
        angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        cos, sin = torch.cos(angles), torch.sin(angles)
        r = None
        for i, blk in enumerate(stack.params.blocks):
            a, f = blk.attn, blk.ffn
            x, h = ops.add_rms_norm(x, r, blk.ln1)
            q = (h @ a.wq).view(n, cfg.n_heads, cfg.head_dim)
            k = (h @ a.wk).view(n, cfg.n_kv_heads, cfg.head_dim)
            v = (h @ a.wv).view(n, cfg.n_kv_heads, cfg.head_dim)
            step = {"x": x, "rms_norm": h, "q_proj": q, "k_proj": k,
                    "v_proj": v}
            q = ops.qk_norm_rope_write(
                q, k, v, a.q_norm if cfg.qk_norm else None,
                a.k_norm if cfg.qk_norm else None, cos, sin,
                stack.k_pages[i], stack.v_pages[i], wr_page, wr_slot)
            out = attend(i, q).reshape(n, -1)
            o = out @ a.wo
            x, h = ops.add_rms_norm(x, o, blk.ln2)
            r = ops.silu_mul(h @ f.wi_gate, h @ f.wi_up) @ f.wo
            step.update(attention=out, o_proj=o, ffn=r)
            if record:
                rec.append({name: t[0].clone() for name, t in step.items()})
        return x + r
    return layers


def first_differing_op(torch, dec, other):
    """The first op in program order whose output bytes differ between
    two recorded runs, as (layer, op, max |diff|, max |value|), or
    None."""
    for i, (a, b) in enumerate(zip(dec, other)):
        for name in LANE_OPS:
            if not torch.equal(a[name], b[name]):
                return (i, name,
                        float((a[name].float() - b[name].float()).abs()
                              .max()),
                        float(a[name].float().abs().max()))
    return None


def lane_vs_decode(torch, model, params, prompt, conf):
    """The verify chunk's x_last lane against the decode step at the same
    position, token and pages.  After the prompt's prefill (which emits
    a greedy row's first token), the decode step (a (max_batch, 1, d)
    product per weight, paged kernel) writes position ctx-1; then one
    spec round's lane 0 (a (1, max_batch * (spec_k + 1), d) product, the
    lane a paged row) rewrites it.  Both run
    through :func:`traced_layers`.  Returns (K/V bytes of that slot equal
    in every layer, max |dK|, max |dV|, the first op in program order
    whose output bytes differ as (layer, op, max |diff|, max |value|), or
    None)."""
    from repro_torch import serving
    session = serving.serve(model, params, serving.ServingConfig(
        spec_k=4, **conf), device=DEVICE, start=False)
    shard = session.engine.shards[0]
    dec, ver = [], []
    try:
        session.submit(prompt, max_new_tokens=8)
        with torch.inference_mode():
            while not shard._active:
                shard.step()                 # prefill
            seq = shard._active[0]
            pos = len(seq.tokens) - 1
            page = int(seq.page_row[pos // shard.page_size])
            slot = pos % shard.page_size

            def kv():
                return (shard.k_pages[:, page, slot].clone(),
                        shard.v_pages[:, page, slot].clone())
            # the traced copy records as it runs: the decode call eager
            shard._decode_graph = None
            shard.stack.layers = traced_layers(shard.stack, dec)
            shard._decode_batch([seq])       # the decode step's write
            dk, dv = kv()
            shard.stack.layers = traced_layers(shard.stack, ver)
            shard.step()                     # one round: lane 0 rewrites
            vk, vv = kv()
    finally:
        session.close()
    return (bool(torch.equal(dk, vk) and torch.equal(dv, vv)),
            float((dk.float() - vk.float()).abs().max()),
            float((dv.float() - vv.float()).abs().max()),
            first_differing_op(torch, dec, ver))


def rider_vs_decode(torch, model, params, prompt, other, conf):
    """A fused packed step's rider against the dedicated decode step at
    the same position, token and pages.  ``prompt`` is ingested alone (its
    first token comes from that chunk) and its row becomes active; the
    decode step writes position ctx-1; then ``other`` arrives and the next
    step ingests it as a packed chunk that the row rides, rewriting ctx-1.
    Both run through :func:`traced_layers`, which in the fused step
    records the riders' layer loop only (one token a row).  Returns what
    :func:`lane_vs_decode` returns."""
    from repro_torch import serving
    session = serving.serve(model, params, serving.ServingConfig(
        scheduler="packed", **conf), device=DEVICE, start=False)
    shard = session.engine.shards[0]
    dec, rode = [], []
    try:
        session.submit(prompt, max_new_tokens=8)
        with torch.inference_mode():
            while not shard._active:
                shard.step()                 # prefill, alone
            seq = shard._active[0]
            pos = len(seq.tokens) - 1
            page = int(seq.page_row[pos // shard.page_size])
            slot = pos % shard.page_size

            def kv():
                return (shard.k_pages[:, page, slot].clone(),
                        shard.v_pages[:, page, slot].clone())
            # the traced copy records as it runs: the decode call eager
            shard._decode_graph = None
            shard.stack.layers = traced_layers(shard.stack, dec)
            shard._decode_batch([seq])       # the decode step's write
            dk, dv = kv()
            # the riders' decode step: max_batch rows (the chunk is C lanes)
            shard.stack.layers = traced_layers(
                shard.stack, rode, lambda x: x.shape[0] == shard.max_batch)
            chunks = shard.rider_chunks
            session.submit(other, max_new_tokens=1)
            shard.step()                     # the row rides other's chunk
            if shard.rider_chunks != chunks + 1:
                raise AssertionError("rider_vs_decode: the step carried "
                                     "no rider")
            vk, vv = kv()
    finally:
        session.close()
    return (bool(torch.equal(dk, vk) and torch.equal(dv, vv)),
            float((dk.float() - vk.float()).abs().max()),
            float((dv.float() - vv.float()).abs().max()),
            first_differing_op(torch, dec, rode))


def lane_note(diag, lane="x_last lane"):
    eq, dk, dv, first = diag
    where = "none: every op's bytes are equal" if first is None else (
        f"layer {first[0]} {first[1]} (max |diff| {first[2]:.3g}, max "
        f"|value| {first[3]:.3g})")
    return (f"{lane} vs decode step at ctx-1: K/V bytes "
            f"{'equal' if eq else 'differ'} (max |dK| {dk:.3g}, |dV| "
            f"{dv:.3g}); first op whose bytes differ: {where}")


def serve_spec_fp32(torch):
    """Phase 12: sampled and speculative serving, fp32, TinyLlama-1.1B at
    published widths (seeded weights).  Returns (lines, launches)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import packed_prefill as pp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build_model

    cfg = get_config("tinyllama-1.1b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(12)
    v = cfg.vocab_size
    prompts = [rng.randint(1, v, size=n).tolist() for n in (40, 97, 150, 64)]
    n_new = 16
    conf = dict(num_pages=512, max_batch=4, max_seq_len=256,
                prefill_chunk_tokens=128)
    pol = serving.TemperatureSampling(temperature=0.8, seed=42)
    with torch.inference_mode():
        refs_s = [reference_sampled(torch, model, params, p, n_new, pol)
                  for p in prompts]
        refs_g = [reference_greedy(torch, model, params, p, n_new)
                  for p in prompts]
    lines, launches = [], {}
    # (paged, packed) variants of the verify and prefill launches
    variants = (pa.kernel_variant(torch.float32, cfg.head_dim,
                                  cfg.n_heads // cfg.n_kv_heads, DEVICE),
                pp.kernel_variant(torch.float32, cfg.head_dim,
                                  cfg.n_heads // cfg.n_kv_heads, DEVICE))

    def add(counts):
        for name in ("paged_attention", "packed_prefill_attention"):
            launches[name] = launches.get(name, 0) + counts[name]
        for v, n in counts["packed_by_variant"].items():
            key = f"packed_prefill_attention:{v}"
            launches[key] = launches.get(key, 0) + n

    for sched in ("chunked", "packed"):
        outs, _, counts = serve_run(torch, model, params, prompts, n_new,
                                    sampling=pol, scheduler=sched, **conf)
        add(counts)
        lines.append(f"sampled T 0.8 {sched}: 4/4 requests match the "
                     f"position-keyed contiguous decode "
                     f"({held('sampled ' + sched, outs, refs_s)})")
    outs, totals, counts = serve_run(torch, model, params, prompts, n_new,
                                     warm=True, spec_k=4, **conf)
    add(counts)
    n_verify = check_verify_launches("spec greedy fp32", cfg, totals, counts,
                                     variants)
    lines.append(f"spec_k 4 greedy: 4/4 requests match plain greedy "
                 f"({held('spec greedy', outs, refs_g)}); accept rate "
                 f"{totals['accept_rate']:.3f} ({totals['draft_accepted']}/"
                 f"{totals['draft_proposed']}); {totals['spec_rounds']} "
                 f"rounds, verify launches {n_verify} "
                 f"(paged by variant {counts['paged_by_variant']})")
    spol = serving.TemperatureSampling(temperature=0.8, seed=7)
    runs = []
    for _ in range(2):
        outs, totals, counts = serve_run(torch, model, params, prompts,
                                         n_new, sampling=spol, spec_k=4,
                                         scheduler="packed", **conf)
        add(counts)
        check_verify_launches("spec sampled fp32", cfg, totals, counts,
                              variants)
        runs.append((outs, totals["accept_rate"]))
    if runs[0][0] != runs[1][0] or any(len(o) != n_new for o in runs[0][0]):
        raise AssertionError("spec sampled: a fresh session gave other "
                             "tokens")
    lines.append(f"spec_k 4 sampled T 0.8 packed: identical in two fresh "
                 f"sessions, accept rate {runs[0][1]:.3f}")
    lines.append(lane_note(lane_vs_decode(torch, model, params, prompts[1],
                                          conf)))
    lines.append(lane_note(rider_vs_decode(torch, model, params, prompts[0],
                                           prompts[1], conf), "rider"))
    del params
    torch.cuda.empty_cache()
    return lines, launches


def serve_spec_bf16(torch):
    """Phase 12, bf16: speculative greedy decoding under ``chunked`` and
    ``packed``, the verify chunk's lanes as paged ``mma`` rows; every
    request completes.  The reference is plain bf16 greedy under
    ``chunked``, which computes every generated position in the decode
    step.  Each spec stream is held to it by :func:`held`: equal, or a
    first divergence where plain's top-two margin (one teacher-forced
    ``logits_fn`` pass over prompt + plain tokens) is below section 2's
    1e-3.  Before the hold each first divergence is printed with its
    margin in bf16 ulps of the top logit; so is plain greedy under
    ``packed``, whose rows ride prefill chunks while prompts are still
    being ingested (spec rows never ride) and run there as the decode
    step; it is held the same way.  :func:`lane_vs_decode` at the first
    diverging spec stream's position names the first op whose bytes
    differ between the verify lane and the decode step, and
    :func:`rider_vs_decode` the same for a rider."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(64, 257, size=8)]
    n_new = 32
    conf = dict(num_pages=2048, max_batch=8, max_seq_len=512,
                prefill_chunk_tokens=256)
    plain, _, _ = serve_run(torch, model, params, prompts, n_new,
                            scheduler="chunked", **conf)
    forced = [forced_margins(torch, model, params, p, t)
              for p, t in zip(prompts, plain)]
    refs = [(t, m) for t, (m, _) in zip(plain, forced)]
    tops = [top for _, top in forced]
    runs, lines, launches = {}, [], {}
    for sched in ("chunked", "packed"):
        t0 = time.perf_counter()
        outs, totals, counts = serve_run(torch, model, params, prompts,
                                         n_new, warm=True, spec_k=4,
                                         scheduler=sched, **conf)
        wall = time.perf_counter() - t0
        if any(len(o) != n_new for o in outs):
            raise AssertionError(f"spec bf16 {sched}: a request came back "
                                 f"short")
        n_verify = check_verify_launches(f"spec greedy bf16 {sched}", cfg,
                                         totals, counts, ("mma", "wgmma"))
        for name in ("paged_attention", "packed_prefill_attention"):
            launches[name] = launches.get(name, 0) + counts[name]
        rows = first_divergences(outs, refs, tops)
        runs[sched] = (outs, rows)
        same = sum(a == b for o, q in zip(outs, plain)
                   for a, b in zip(o, q))
        say(f"[12 spec bf16] spec {sched} against plain bf16 greedy "
            f"(chunked; margins from one teacher-forced logits_fn pass): "
            f"{divergence_notes(rows)}")
        lines.append(
            f"spec_k 4 greedy {sched}: 8/8 requests complete in "
            f"{wall:.2f} s, accept rate "
            f"{totals['accept_rate']:.3f}, {totals['spec_rounds']} rounds, "
            f"verify launches {n_verify} all paged mma (paged by variant "
            f"{counts['paged_by_variant']}); tokens equal to plain bf16 "
            f"greedy {same}/{8 * n_new}, "
            f"{sum(r is None for r in rows)}/8 streams identical")
    riders, totals, counts = serve_run(torch, model, params, prompts,
                                       n_new, scheduler="packed", **conf)
    if totals["rider_chunks"] < 1 or \
            counts["paged_by_variant"].get("mma", 0) != \
            counts["paged_attention"]:
        raise AssertionError(
            f"plain greedy bf16 packed: {totals['rider_chunks']} chunks "
            f"carried riders, paged launches {counts['paged_by_variant']} "
            f"(want riders aboard and every paged launch mma)")
    rows = first_divergences(riders, refs, tops)
    say(f"[12 spec bf16] plain greedy packed (decode rows ride "
        f"{totals['rider_chunks']} prefill chunks as the decode step) "
        f"against plain chunked: {divergence_notes(rows)}")
    lines.append(
        f"plain packed: {sum(r is None for r in rows)}/8 streams identical "
        f"to plain chunked, {totals['rider_chunks']} rider chunks, paged "
        f"launches {counts['paged_attention']} all mma")
    diag = rider_vs_decode(torch, model, params, prompts[0], prompts[1],
                           conf)
    say(f"[12 spec bf16] {lane_note(diag, 'rider')}")
    i, first = next(((j, r) for _, rows in runs.values()
                     for j, r in enumerate(rows) if r), (0, None))
    at = prompts[i] + plain[i][:first[0] if first else 0]
    diag = lane_vs_decode(torch, model, params, at,
                          dict(conf, scheduler="chunked"))
    where = (f"at req {i}'s first divergence" if first else
             f"no spec stream diverges; at req {i}'s first token")
    say(f"[12 spec bf16] {where}: {lane_note(diag)}")
    for sched, (outs, _) in runs.items():
        held(f"spec greedy bf16 {sched}", outs, refs)
    held("plain greedy bf16 packed", riders, refs)
    del params
    torch.cuda.empty_cache()
    return [f"bf16 {line}; every stream held to plain chunked greedy at "
            f"1e-3" for line in lines], launches


def hold_streams(label, torch, model, params, prompts, outs, refs,
                 policies):
    """Hold each stream to its uninterrupted run through :func:`held`:
    equal, or a first divergence where the uninterrupted run's top-two
    margin (:func:`forced_margins`, the stream's sampling policy) is below
    section 2's 1e-3.  Returns the notes, with each divergence's margin
    in bf16 ulps of the top logit."""
    forced = [forced_margins(torch, model, params, p, t, pol)
              for p, t, pol in zip(prompts, refs, policies)]
    held(label, outs, [(t, m) for t, (m, _) in zip(refs, forced)])
    return divergence_notes(first_divergences(
        outs, [(t, m) for t, (m, _) in zip(refs, forced)],
        [top for _, top in forced]))


def serve_swap_bf16(torch, spec_k=0):
    """Phase 13 (``spec_k`` 0) and 13b (``spec_k`` 4): the swap tier in
    bf16, TinyLlama-1.1B at published widths.  Four low-priority requests
    fill the batch and the 132-page pool; two high-priority arrivals
    preempt them mid-decode into the host arena.  Every stream equals its
    uncontended run (on a large pool, with the same ``spec_k``: one
    request at a time, or with ``spec_k`` all six submitted together) — a
    victim gets every written position back bit for bit
    and resumes straight into decode (or the next spec round).  Phase 13
    holds the streams exactly; 13b through :func:`hold_streams`.
    Preemptions >= 1, resumed == preemptions, and after close the arena
    and the pool are whole.  Returns (summary, launches)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.swap import page_nbytes

    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(14)
    v = cfg.vocab_size
    lows = [rng.randint(1, v, size=200).tolist() for _ in range(4)]
    highs = [rng.randint(1, v, size=200).tolist() for _ in range(2)]
    n_lo, n_hi = 64, 32
    base = dict(page_size=8, max_batch=4, max_seq_len=512,
                prefill_chunk_tokens=128, spec_k=spec_k)
    # uncontended: a pool that never fills, so nothing is preempted; one
    # request at a time, or with spec_k all at once (a verify lane's bytes
    # do not depend on the rows beside it, and one at a time costs a spec
    # round a token)
    session = serving.serve(model, params, serving.ServingConfig(
        num_pages=1024, **base), device=DEVICE)
    jobs = [(p, n_lo) for p in lows] + [(p, n_hi) for p in highs]
    try:
        session.warm()
        if spec_k:
            handles = [session.submit(p, max_new_tokens=n) for p, n in jobs]
            refs = [h.result(timeout=600) for h in handles]
        else:
            refs = [session.submit(p, max_new_tokens=n).result(timeout=600)
                    for p, n in jobs]
    finally:
        session.close()
    n_pages = 4 * (-(-(200 + n_lo) // 8))            # 4 lows fill the pool
    slots = 256
    conf = serving.ServingConfig(
        num_pages=n_pages, admission="priority", eviction="swap",
        # a bf16 page is sized as uint16 (same itemsize; numpy has no
        # bfloat16 without ml_dtypes)
        swap_bytes=slots * page_nbytes(cfg.n_layers, 8, cfg.n_kv_heads,
                                       cfg.head_dim, "uint16"),
        priority_classes=("hi:priority=10", "lo:priority=0"), **base)
    session = serving.serve(model, params, conf, device=DEVICE)
    shard = session.engine.shards[0]
    try:
        session.warm()
        reset_launches()
        t0 = time.perf_counter()
        lo_h = [session.submit(p, max_new_tokens=n_lo, priority_class="lo")
                for p in lows]
        deadline = time.perf_counter() + 300
        while sum(1 for h in lo_h if len(h.out_tokens) >= 8) < 4:
            if time.perf_counter() > deadline:
                raise AssertionError("swap: the lows never all decoded")
            time.sleep(0.005)
        hi_h = [session.submit(p, max_new_tokens=n_hi, priority_class="hi")
                for p in highs]
        outs = [h.result(timeout=600) for h in lo_h + hi_h]
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st = shard.stats()
        totals = session.stats()["totals"]
        preempted = [h.preemptions for h in lo_h + hi_h]
    finally:
        session.close()
    label = f"swap{' spec_k ' + str(spec_k) if spec_k else ''}"
    if totals["failed"] or totals["preemptions"] < 1 or \
            totals["resumed"] != totals["preemptions"]:
        raise AssertionError(f"{label}: preemptions "
                             f"{totals['preemptions']}, resumed "
                             f"{totals['resumed']}, failed "
                             f"{totals['failed']}")
    if shard.swap_arena.slots_used() or \
            shard.pool.free_count() != n_pages:
        raise AssertionError(f"{label}: leaked "
                             f"{shard.swap_arena.slots_used()} arena slots,"
                             f" pool {shard.pool.free_count()}/{n_pages} "
                             f"free")
    if spec_k:
        check_verify_launches(label, cfg, totals, counts, ("mma", "wgmma"))
        tokens = hold_streams(label, torch, model, params, lows + highs,
                              outs, refs, [None] * len(outs))
    else:
        for i, (out, want) in enumerate(zip(outs, refs)):
            if out != want:
                j = next((j for j, (a, b) in enumerate(zip(out, want))
                          if a != b), min(len(out), len(want)))
                raise AssertionError(
                    f"{label}: request {i} (preempted {preempted[i]}x) "
                    f"differs from its uncontended run at token {j} of "
                    f"{len(out)}")
        tokens = "all identical to the uncontended runs"
    del params
    torch.cuda.empty_cache()
    summary = {"requests": len(outs), "spec_k": spec_k,
               "preemptions": totals["preemptions"],
               "resumed": totals["resumed"],
               "preempted_per_request": preempted,
               "pages_out": totals["swapped_out"],
               "pages_in": totals["swapped_in"],
               "page_bytes": shard.swap_arena.slot_nbytes,
               "swap_out_s": st["swap_out_s"], "swap_in_s": st["swap_in_s"],
               "wall_s": wall, "tokens": tokens,
               "arena_slots_used_after": shard.swap_arena.slots_used(),
               "pool_free_after": shard.pool.free_count()}
    if spec_k:
        summary.update(spec_rounds=totals["spec_rounds"],
                       accept_rate=totals["accept_rate"],
                       packed_by_variant=counts["packed_by_variant"])
    return summary, {"packed_prefill_attention":
                     counts["packed_prefill_attention"],
                     "paged_attention": counts["paged_attention"]}


def prompt_for_shard(router, rng, shard, length, vocab):
    """A random prompt that ``router`` places on ``shard``."""
    for _ in range(1000):
        p = rng.randint(1, vocab, size=length).tolist()
        if router.shard_of(p) == shard:
            return p
    raise AssertionError("the router never placed a prompt on the shard")


def serve_migrate_bf16(torch):
    """Phase 13c: live migration in bf16, TinyLlama-1.1B at published
    widths.  Two shards each run a greedy and a seeded
    ``TemperatureSampling(0.8)`` request of 200 prompt tokens and 64 new;
    shard 0 also runs a 12-token request whose completion arms a stall of
    shard 0 (3 s, past the 1 s heartbeat timeout), so its two long
    requests are mid-decode when the watchdog migrates them to shard 1.
    Every stream is held to its uninterrupted run (one request at a time
    on one shard) through :func:`hold_streams`; at least one migration,
    none failed, both pools whole after close.  Returns (summary,
    launches)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.faults import FaultSpec

    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=DEVICE)
    rng = np.random.RandomState(15)
    base = dict(page_size=8, max_batch=4, max_seq_len=512,
                prefill_chunk_tokens=128, num_pages=512)
    conf = serving.ServingConfig(
        num_shards=2, heartbeat_timeout_s=1.0, watchdog_interval_s=0.02,
        faults=(FaultSpec(kind="stall", shard=0, after_done=1,
                          duration_s=3.0),), **base)
    session = serving.serve(model, params, conf, device=DEVICE, start=False)
    router = session.engine.router
    short = prompt_for_shard(router, rng, 0, 200, cfg.vocab_size)
    longs = [prompt_for_shard(router, rng, sh, 200, cfg.vocab_size)
             for sh in (0, 0, 1, 1)]
    pols = [None, serving.TemperatureSampling(temperature=0.8, seed=21),
            None, serving.TemperatureSampling(temperature=0.8, seed=22)]
    n_new = 64
    try:
        session.warm()
        session.start()
        reset_launches()
        t0 = time.perf_counter()
        first = session.submit(short, max_new_tokens=12)
        handles = [session.submit(p, max_new_tokens=n_new, sampling=pol)
                   for p, pol in zip(longs, pols)]
        outs = [h.result(timeout=600) for h in handles]
        first.result(timeout=600)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        totals = session.stats()["totals"]
        gaps = [len(h.gaps()) for h in handles]
        shards = session.engine.shards
    finally:
        session.close()
    if totals["migrations"] < 2 or totals["failed"] or \
            sum(1 for g in gaps[:2] if g) < 2:
        raise AssertionError(f"migrate: {totals['migrations']} migrations, "
                             f"{totals['failed']} failed, adoption gaps "
                             f"per request {gaps} (want shard 0's two "
                             f"long requests migrated mid-decode)")
    for shard in shards:
        if shard.pool.free_count() != shard.config.num_pages:
            raise AssertionError(f"migrate: shard {shard.shard_id} pool "
                                 f"{shard.pool.free_count()}/"
                                 f"{shard.config.num_pages} free")
    # uninterrupted: one request at a time on one shard
    ref_session = serving.serve(model, params, serving.ServingConfig(**base),
                                device=DEVICE)
    try:
        ref_session.warm()
        refs = [ref_session.submit(p, max_new_tokens=n_new, sampling=pol)
                .result(timeout=600) for p, pol in zip(longs, pols)]
    finally:
        ref_session.close()
    tokens = hold_streams("migrate", torch, model, params, longs, outs, refs,
                          pols)
    del params
    torch.cuda.empty_cache()
    summary = {"requests": len(outs), "migrations": totals["migrations"],
               "migrated_per_request": gaps, "wall_s": wall,
               "tokens": tokens,
               "pools_free_after": [s.pool.free_count() for s in shards]}
    return summary, {"packed_prefill_attention":
                     counts["packed_prefill_attention"],
                     "paged_attention": counts["paged_attention"]}


# ----------------------------------------------------------- phase 7


class forced_rows:
    """``with forced_rows(fa, r):`` the flash wrapper launches the
    tensor-core tile of ``r`` query rows a block at every D (to time the
    tile that ``fa.query_rows`` does not pick)."""

    def __init__(self, fa, rows):
        self.fa, self.rows = fa, rows

    def __enter__(self):
        self.saved = self.fa.query_rows
        self.fa.query_rows = lambda d: self.rows

    def __exit__(self, *exc):
        self.fa.query_rows = self.saved


def phase_flash(torch, timer, dtype, s, hkv, timed, seed=7, b=4, h=32,
                d=64, sk=None, causal=True, want_variant=None):
    """Attention at a model's full-sequence shape: causal, B = 4, H = 32,
    D = 64, S tokens, Hkv kv heads (DeepSeek-V2's MLA prefill: B = 2,
    H = Hkv = 128, D = 192; Qwen2-VL: B = 2, H 64, Hkv 8, D 128), or
    not causal from S queries to ``sk`` keys (Whisper's encoder and
    cross-attention).  ``want_variant``: the variant that must serve the
    call.
    Returns a row (times only if ``timed``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    sk = s if sk is None else sk
    rng = np.random.RandomState(seed + s + hkv)
    dt = getattr(torch, dtype)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(DEVICE, dt) for shape in
        ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    label = f"flash_attention[S={s}, Sk={sk}, Hkv={hkv}, D={d}]"
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    variant = fa.kernel_variant(q.dtype, d, q.device)
    if want_variant is not None and variant != want_variant:
        raise AssertionError(f"{label}: variant {variant}, want "
                             f"{want_variant}")
    before = fa.launches.of(variant)
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if fa.launches.of(variant) != before + 1:
        raise AssertionError(f"{label}: the {variant} variant did not "
                             f"launch")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{label}: non-finite")
    row = {"name": "flash_attention", "route": "cuda", "variant": variant,
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": FLASH_TPU,
           "max_abs_err": close_enough(out, want, TOL[dtype])}
    del want
    if not timed:
        return row
    elt = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * sk * hkv * d) * elt
    flops = 4.0 * b * h * d * (s * (s + 1) / 2 if causal else s * sk)
    qt, kt, vt = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    row["ms"] = timer.ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    if variant in ("wgmma", "tf32x3"):
        # both tiles of the variant in this call: 64 and 128 query rows a
        # block (``query_rows`` picks one; patched here to force the other)
        row["rows"] = fa.query_rows(d)
        row["ms_by_rows"] = {}
        for r in (64, 128):
            with forced_rows(fa, r):
                row["ms_by_rows"][r] = timer.ms(
                    lambda: fa.flash_attention_cuda(q, k, v, causal=causal))
    row["profiler_ms"] = profiled_ms(
        torch, timer, lambda: fa.flash_attention(q, k, v, causal=causal),
        FLASH_KERNELS)
    row["plain_ms"] = timer.ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=causal), iters=5)
    row["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    return row


# ----------------------------------------------------------- phase 8


def ssd_flops(s, chunk, h, p, n, b):
    """Operations of the chunked dual form for this length: per chunk of q
    positions, the causal half of the C·Bᵀ scores and of their product with
    x, the carried state's contribution to y, and the state update."""
    total = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        tri = q * (q + 1) / 2
        total += 2 * (tri * n + tri * p + 2 * q * p * n)
    return float(total) * b * h


def phase_ssd(torch, timer, dtype, s, n, timed, seed=8):
    """The SSD chunk scan at a Mamba2 block's shape: B = 4, H = 64, P = 64,
    G = 1, state N, chunk 128, with d_skip; dt and a in fp32 as the model
    passes them."""
    from repro_torch.kernels import ssd_scan as ss
    b, h, p, g, chunk = 4, 64, 64, 1, 128
    rng = np.random.RandomState(seed + s + n)
    dt_ = getattr(torch, dtype)

    def dev(a, to=dt_):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE, to)
    x = dev(rng.standard_normal((b, s, h, p)))
    dt = dev(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)),
             torch.float32)
    a = dev(-np.exp(rng.standard_normal((h,)) * 0.5), torch.float32)
    bm = dev(rng.standard_normal((b, s, g, n)) * 0.3)
    cm = dev(rng.standard_normal((b, s, g, n)) * 0.3)
    ds = dev(rng.standard_normal((h,)), torch.float32)
    want_y, want_f = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk=chunk,
                                       d_skip=ds)
    variant = ss.kernel_variant(x.dtype, p, n, chunk, x.device)
    before = ss.launches.of(variant)
    y, final = ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk, d_skip=ds)
    torch.cuda.synchronize()
    if ss.launches.of(variant) != before + 1:
        raise AssertionError(f"ssd_scan[S={s}, N={n}]: the {variant} "
                             f"variant did not launch")
    if not (torch.isfinite(y.float()).all() and
            torch.isfinite(final).all()):
        raise AssertionError(f"ssd_scan[S={s}, N={n}]: non-finite")
    tol = SSD_TOL[dtype]
    row = {"name": "ssd_scan", "route": "cuda", "variant": variant,
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": SSD_TPU,
           "max_abs_err": max(close_enough(y, want_y, tol),
                              close_enough(final, want_f, tol)),
           "shares": {"y": limit_share(y, want_y, tol),
                      "final": limit_share(final, want_f, tol)}}
    if variant == "mma":
        # the fma kernel on the same inputs: chunk 64 computes the same
        # function and routes bf16 to it (fp32 scores, products and state)
        before = ss.launches.of("fma")
        y2, final2 = ss.ssd_scan(x, dt, a, bm, cm, chunk=64, d_skip=ds)
        torch.cuda.synchronize()
        if ss.launches.of("fma") != before + 1:
            raise AssertionError(f"ssd_scan[S={s}, N={n}]: chunk 64 did not "
                                 f"launch the fma variant")
        row["fma"] = {"max_abs_err": max(close_enough(y2, want_y, tol),
                                         close_enough(final2, want_f, tol)),
                      "y": limit_share(y2, want_y, tol),
                      "final": limit_share(final2, want_f, tol)}
        del y2, final2
    del want_y, want_f
    if not timed:
        return row
    elt = x.element_size()
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * elt + \
        4 * (b * s * h + 2 * h + b * h * p * n)
    row["ms"] = timer.ms(lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                             d_skip=ds))
    row["profiler_ms"] = profiled_ms(
        torch, timer, lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                          d_skip=ds), SSD_KERNELS)
    row["plain_ms"] = timer.ms(lambda: ss.ssd_scan_plain(
        x, dt, a, bm, cm, chunk=chunk, d_skip=ds), iters=5)
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, ssd_flops(s, chunk, h, p, n, b), dtype)
    return row


# ------------------------------------------------------ phases 9 and 10


def reset_launches():
    from repro_torch.kernels import (flash_attention, packed_prefill,
                                     paged_attention, ssd_scan)
    for mod in (flash_attention, packed_prefill, paged_attention, ssd_scan):
        mod.launches.reset()


def read_launches():
    from repro_torch.kernels import flash_attention, ssd_scan
    return {"ssd_scan": ssd_scan.launches.count,
            "flash_attention": flash_attention.launches.count}


def variant_launches():
    """Flash launches by variant since the last reset, keyed
    ``flash_attention:<variant>`` (the kernel table's variant rows)."""
    from repro_torch.kernels import flash_attention
    return {f"flash_attention:{v}": n
            for v, n in flash_attention.launches.by_variant.items()}


def tc_launches():
    """Launches of the tensor-core variants: flash's wgmma, SSD's mma."""
    from repro_torch.kernels import flash_attention, ssd_scan
    return flash_attention.launches.of("wgmma"), ssd_scan.launches.of("mma")


def perturbed_model(torch, arch, dtype=None, seed=0):
    """A full-width model with seeded weights, its zero-initialised
    ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b`` replaced by seeded
    normal values (scale 0.5), so heads decay differently and the skip
    term is exercised."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    with torch.no_grad():
        for blk in params.blocks:
            for name in ("a_log", "dt_bias", "d_skip", "conv_b"):
                t = getattr(blk, name)
                t.copy_(torch.randn(t.shape, generator=gen, device=DEVICE)
                        * 0.5)
    return model, params


def model_fp32(torch, arch, b=2, s=300, n_new=16):
    """Forward against token-by-token decode at full width in fp32."""
    model, params = perturbed_model(torch, arch, "float32")
    cfg = model.cfg
    rng = np.random.RandomState(9)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(
        DEVICE)
    want_launches = {"ssd_scan": cfg.n_layers,
                     "flash_attention": getattr(model, "n_sites", 0)}

    def forward(toks):
        reset_launches()
        logits, _ = model.logits_fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        if read_launches() != want_launches:
            raise AssertionError(f"{arch} fp32: launches per forward "
                                 f"{read_launches()} != {want_launches}")
        return logits

    def step(cache, toks, t):
        return model.decode_step(params, cache, {
            "tokens": toks, "cache_len": torch.full(
                (b,), t + 1, dtype=torch.int32, device=DEVICE)})

    with torch.inference_mode():
        full = forward(tokens)
        cache = model.init_cache(b, s + n_new + 1, device=DEVICE)
        dec = []
        for t in range(s):
            logits, cache = step(cache, tokens[:, t:t + 1], t)
            dec.append(logits)
        err_prompt = close_enough(torch.stack(dec, 1), full, MODEL_TOL)
        gen, gen_logits = [torch.argmax(dec[-1], -1)], []
        for t in range(s, s + n_new):
            logits, cache = step(cache, gen[-1][:, None], t)
            gen_logits.append(logits)
            gen.append(torch.argmax(logits, -1))
        both = torch.cat([tokens, torch.stack(gen[:-1], 1)], 1)
        err_gen = close_enough(torch.stack(gen_logits, 1),
                               forward(both)[:, s:], MODEL_TOL)
    del params, cache, full
    torch.cuda.empty_cache()
    return (f"{arch}: logits_fn (B={b}, S={s}) vs decode_step at every "
            f"position max_abs_err {err_prompt:.3g}; {n_new} greedy tokens "
            f"vs forward max_abs_err {err_gen:.3g} (tol {MODEL_TOL}); "
            f"launches per forward {want_launches}")


def model_bf16(torch, arch, b=4, s=1024, n_new=32):
    """The main path of the slice for one family, in its configs' dtype:
    prefill through ``logits_fn``, then greedy decode.  Returns (summary,
    launches during the run)."""
    model, params = perturbed_model(torch, arch)
    cfg = model.cfg
    rng = np.random.RandomState(10)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(
        DEVICE)
    with torch.inference_mode():
        cache = model.init_cache(b, n_new + 1, device=DEVICE)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, _ = model.logits_fn(params, {"tokens": tokens})
        tok = torch.argmax(logits[:, -1], -1)
        finite = bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill = logits
        outs = []
        for t in range(n_new):
            logits, cache = model.decode_step(params, cache, {
                "tokens": tok[:, None], "cache_len": torch.full(
                    (b,), t + 1, dtype=torch.int32, device=DEVICE)})
            finite = finite and bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits, -1)
            outs.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches()
        flash_tc, ssd_tc = tc_launches()
        vs_fp32 = logits_against_fp32(torch, model, params, tokens, prefill)
    if not finite:
        raise AssertionError(f"{arch} bf16: non-finite logits")
    want = ["ssd_scan"] + (["flash_attention"] if cfg.family == "hybrid"
                           else [])
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"{arch} bf16: a kernel never launched: "
                             f"{launches}")
    n_sites = getattr(model, "n_sites", 0)
    if not flash_tc == launches["flash_attention"] == n_sites:
        raise AssertionError(
            f"{arch} bf16: flash launches {launches['flash_attention']} "
            f"(wgmma variant {flash_tc}), want the tensor-core variant at "
            f"each of {n_sites} attention sites of the forward")
    if not ssd_tc == launches["ssd_scan"] == cfg.n_layers:
        raise AssertionError(
            f"{arch} bf16: SSD launches {launches['ssd_scan']} (mma variant "
            f"{ssd_tc}), want the mma variant in each of {cfg.n_layers} "
            f"Mamba2 blocks of the forward")
    if not vs_fp32["mma"] <= LOGITS_RATIO * vs_fp32["fma"]:
        raise AssertionError(
            f"{arch} bf16: logits {vs_fp32['mma']:.4g} (relative L2) from "
            f"the fp32 forward, more than {LOGITS_RATIO} x the "
            f"{vs_fp32['fma']:.4g} of the same forward with the SSD on the "
            f"fma kernel")
    del params, cache, prefill
    torch.cuda.empty_cache()
    summary = {"model": arch, "batch": b, "prompt_tokens": s,
               "prefill_s": t1 - t0, "prefill_tok_s": b * s / (t1 - t0),
               "decode_steps": n_new, "decode_s": t2 - t1,
               "decode_tok_s": b * n_new / (t2 - t1),
               "launches": launches, "flash_wgmma_launches": flash_tc,
               "ssd_mma_launches": ssd_tc, "logits_vs_fp32": vs_fp32}
    return summary, launches


def logits_against_fp32(torch, model, params, tokens, logits):
    """The bf16 prefill's ``logits`` (SSD on the mma kernel) and the same
    bf16 forward with the SSD on the fma kernel (chunk 64: the same
    function, fp32 inside), each against the fp32 forward on the same
    bf16-rounded weights: relative L2 distance and top-1 agreement."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import build_model
    cfg = model.cfg
    before = ssd_scan.launches.of("fma")
    fma_logits, _ = build_model(cfg.replace(ssm_chunk=64)).logits_fn(
        params, {"tokens": tokens})
    torch.cuda.synchronize()
    if ssd_scan.launches.of("fma") != before + cfg.n_layers:
        raise AssertionError(f"{cfg.name}: chunk 64 did not run the fma "
                             f"SSD kernel in every Mamba2 block")
    model32 = build_model(cfg.replace(dtype="float32"))
    params32 = model32.init(seed=0, device=DEVICE)
    with torch.no_grad():
        for p32, p16 in zip(params32.parameters(), params.parameters()):
            p32.copy_(p16)
    want, _ = model32.logits_fn(params32, {"tokens": tokens})
    del params32
    top1 = want.argmax(-1)
    out = {"mma": rel_l2(logits, want), "fma": rel_l2(fma_logits, want),
           "mma_top1": float((logits.argmax(-1) == top1).float().mean()),
           "fma_top1": float((fma_logits.argmax(-1) == top1).float().mean()),
           "ratio_limit": LOGITS_RATIO}
    del fma_logits, want
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ phases 14a and 14b

MOE_ARCHS = {
    # arch: (config overrides, flash launches per forward)
    "olmoe-1b-7b": ({}, 16),
    # 60 layers (236 B parameters) do not fit one 80 GB card: the dense
    # first layer and two MoE layers at published widths
    "deepseek-v2-236b": ({"n_layers": 3}, 3),
}


def moe_model(torch, arch, **over):
    """A MoE / MLA decoder at published widths with seeded weights on the
    card (``MOE_ARCHS``' depth cut, then ``over``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).replace(**MOE_ARCHS[arch][0], **over)
    model = build_model(cfg)
    return model, model.init(seed=0, device=DEVICE)


def moe_fp32(torch, arch, b=2, s=256, n_new=16):
    """Phase 14a: fp32 at capacity factor n_experts / top_k (dropless:
    with finite capacity a batch drops other tokens than one token at a
    time), ``logits_fn`` over B prompts of S tokens held against
    token-by-token ``decode_step`` at every position, then ``n_new``
    greedy tokens against the forward over prompt and tokens; every flash
    launch the variant ``kernel_variant`` names for fp32 at the config's
    head dim, one per attention layer of a forward.
    Returns (line, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    base = get_config(arch)
    model, params = moe_model(
        torch, arch, dtype="float32",
        capacity_factor=base.n_experts / base.top_k)
    cfg = model.cfg
    per_forward = MOE_ARCHS[arch][1]
    rng = np.random.RandomState(16)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(
        DEVICE)
    variant = fa.kernel_variant(torch.float32, cfg.head_dim, DEVICE)
    counted = {"flash_attention": 0, f"flash_attention:{variant}": 0}

    def forward(toks):
        reset_launches()
        logits, _ = model.logits_fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        if not fa.launches.count == fa.launches.of(variant) == per_forward:
            raise AssertionError(
                f"{arch} fp32: flash launches per forward "
                f"{fa.launches.by_variant}, want {per_forward} {variant}")
        counted["flash_attention"] += fa.launches.count
        counted[f"flash_attention:{variant}"] += fa.launches.count
        return logits

    def step(cache, toks, t):
        return model.decode_step(params, cache, {
            "tokens": toks, "cache_len": torch.full(
                (b,), t + 1, dtype=torch.int32, device=DEVICE)})

    t0 = time.perf_counter()
    with torch.inference_mode():
        full = forward(tokens)
        cache = model.init_cache(b, s + n_new + 1, device=DEVICE)
        dec = []
        for t in range(s):
            logits, cache = step(cache, tokens[:, t:t + 1], t)
            dec.append(logits)
        err_prompt = close_enough(torch.stack(dec, 1), full, MODEL_TOL)
        del dec, full
        gen, gen_logits = [torch.argmax(logits, -1)], []
        for t in range(s, s + n_new):
            logits, cache = step(cache, gen[-1][:, None], t)
            gen_logits.append(logits)
            gen.append(torch.argmax(logits, -1))
        both = torch.cat([tokens, torch.stack(gen[:-1], 1)], 1)
        err_gen = close_enough(torch.stack(gen_logits, 1),
                               forward(both)[:, s:], MODEL_TOL)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del params, cache
    torch.cuda.empty_cache()
    return (f"{arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
            f"{cfg.capacity_factor:.4g}): logits_fn (B={b}, S={s}) vs "
            f"decode_step at every position max_abs_err {err_prompt:.3g}; "
            f"{n_new} greedy tokens vs forward max_abs_err {err_gen:.3g} "
            f"(tol {MODEL_TOL}); flash launches per forward {per_forward} "
            f"{variant}; {wall:.1f} s"), counted


def moe_bf16(torch, arch, b, s=1024, n_new=32):
    """Phase 14b: bf16 at the config's capacity factor (1.25):
    :func:`bf16_prefill_decode` over B prompts of S tokens, one
    ``wgmma`` flash launch per attention layer.  Returns (summary,
    launches)."""
    model, params = moe_model(torch, arch)
    cfg = model.cfg
    rng = np.random.RandomState(17)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(
        DEVICE)
    run = bf16_prefill_decode(torch, model, params, {"tokens": tokens},
                              MOE_ARCHS[arch][1], n_new)
    del params
    torch.cuda.empty_cache()
    summary = {"model": arch, "layers": cfg.n_layers,
               "capacity_factor": cfg.capacity_factor, "batch": b,
               "prompt_tokens": s, "prefill_s": run["prefill_s"],
               "prefill_tok_s": b * s / run["prefill_s"],
               "decode_steps": n_new, "decode_s": run["decode_s"],
               "decode_tok_s": b * n_new / run["decode_s"],
               "flash_by_variant": run["by_variant"],
               "logits_vs_fp32": run["vs"]}
    return summary, {"flash_attention": MOE_ARCHS[arch][1]}


def bf16_prefill_decode(torch, model, params, batch, per_forward,
                        n_new=32):
    """The bf16 hold of phases 14b and 15b: prefill through ``logits_fn``
    over ``batch``, then ``n_new`` greedy decode steps from a fresh cache
    fed the prefill's greedy tokens (Whisper's cross cache from
    :func:`cross_cache`, not timed); finite logits; every flash launch of
    the prefill the ``wgmma`` variant, ``per_forward`` of them; then the
    prefill's logits against the fp32 forward on the same (bf16-rounded)
    weights: their relative L2 distance at most ``LOGITS_RATIO`` times
    that of the same bf16 forward with attention on the flash kernel's
    plain version.  ``params`` end in fp32.  Returns prefill_s, decode_s,
    by_variant and vs (the distances)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = model.cfg
    label = f"{cfg.name} bf16"
    b = batch["tokens"].shape[0]
    with torch.inference_mode():
        cache = model.init_cache(b, n_new + 1, device=DEVICE)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, _ = model.logits_fn(params, batch)
        tok = torch.argmax(logits[:, -1], -1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        finite = bool(torch.isfinite(logits).all())
        by_variant = dict(fa.launches.by_variant)
        prefill = logits
        if cfg.family == "encdec":
            cross_cache(model, params, batch["frames"], cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for t in range(n_new):
            logits, cache = model.decode_step(params, cache, family_step(
                torch, cfg, tok[:, None], t))
            finite = finite and bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del cache
        # the same bf16 forward with attention on the plain version
        kernel = ops.flash_attention
        ops.flash_attention = fa.flash_attention_plain
        try:
            plain_logits, _ = model.logits_fn(params, batch)
        finally:
            ops.flash_attention = kernel
    if not finite:
        raise AssertionError(f"{label}: non-finite logits")
    if not by_variant.get("wgmma", 0) == sum(by_variant.values()) == \
            per_forward:
        raise AssertionError(
            f"{label}: flash launches {by_variant}, want {per_forward} "
            f"wgmma (one per attention call)")
    with torch.no_grad():
        params.float()                   # in place, one tensor at a time
    with torch.inference_mode():
        want, _ = build_model(cfg.replace(dtype="float32")).logits_fn(
            params, batch)
        top1 = want.argmax(-1)
        vs = {"kernel": rel_l2(prefill, want),
              "plain": rel_l2(plain_logits, want),
              "kernel_top1": float((prefill.argmax(-1) == top1).float()
                                   .mean()),
              "plain_top1": float((plain_logits.argmax(-1) == top1).float()
                                  .mean()),
              "ratio_limit": LOGITS_RATIO}
    del prefill, plain_logits, want
    torch.cuda.empty_cache()
    if not vs["kernel"] <= LOGITS_RATIO * vs["plain"]:
        raise AssertionError(
            f"{label}: logits {vs['kernel']:.4g} (relative L2) from the "
            f"fp32 forward, more than {LOGITS_RATIO} x the "
            f"{vs['plain']:.4g} of the same forward with attention on the "
            f"plain version")
    return {"prefill_s": t1 - t0, "decode_s": t3 - t2,
            "by_variant": by_variant, "vs": vs}


# ------------------------------------------------------ phases 15a and 15b

FAMILY_ARCHS = {
    # arch: (config overrides, flash launches per forward)
    # 6 encoder self-attentions, 6 decoder self- and 6 cross-attentions
    "whisper-base": ({}, 18),
    # 80 layers (72 B parameters) do not fit one 80 GB card: 8 layers at
    # published widths, 9.5 B parameters (19 GB in bf16, 38 GB in fp32)
    "qwen2-vl-72b": ({"n_layers": 8}, 8),
}


def family_model(torch, arch, **over):
    """Whisper-base or Qwen2-VL at published widths with seeded weights
    on the card (``FAMILY_ARCHS``' depth cut, then ``over``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).replace(**FAMILY_ARCHS[arch][0], **over)
    model = build_model(cfg)
    return model, model.init(seed=0, device=DEVICE)


def cross_cache(model, params, frames, cache):
    """Each Whisper decoder layer's cross K/V of the port's own encoder
    memory, written into ``cache`` (the reference leaves these entries
    to its callers too)."""
    cfg = model.cfg
    memory = model._encode(params, frames)
    b, s, _ = memory.shape
    for i, blk in enumerate(params.dec_blocks):
        cache["cross_k"][i] = (memory @ blk.cross.wk).reshape(
            b, s, cfg.n_heads, cfg.head_dim)
        cache["cross_v"][i] = (memory @ blk.cross.wv).reshape(
            b, s, cfg.n_heads, cfg.head_dim)
    return cache


def family_inputs(torch, cfg, b, s, seed, n_patches=0):
    """A forward's batch: Whisper enc_seq frames and S tokens; Qwen2-VL S
    tokens, the first ``n_patches`` of them patch embeddings on a square
    grid at t = 0 (M-RoPE (0, h, w)) and the text after them at
    side + i on all three axes.  Frames and patches are made in the
    model's dtype, so an fp32 model reads the same values."""
    rng = np.random.RandomState(seed)
    dt = getattr(torch, cfg.dtype)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (b, s - n_patches))).to(DEVICE)
    if cfg.family == "encdec":
        return {"tokens": tokens, "frames": torch.from_numpy(
            rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
                np.float32)).to(DEVICE, dt)}
    side = math.isqrt(n_patches)
    grid = np.stack([np.zeros(n_patches), np.arange(n_patches) // side,
                     np.arange(n_patches) % side], -1)
    text = np.repeat((side + np.arange(s - n_patches))[:, None], 3, -1)
    thw = np.concatenate([grid, text]).astype(np.int64)
    return {"tokens": tokens,
            "patch_embeds": torch.from_numpy(rng.standard_normal(
                (b, n_patches, cfg.vision_embed_dim)).astype(np.float32))
            .to(DEVICE, dt),
            "positions_thw": torch.from_numpy(thw).to(DEVICE)[None]
            .expand(b, s, 3)}


def family_step(torch, cfg, tokens, t):
    """The decode batch of position ``t`` (Qwen2-VL: t = h = w = t)."""
    b = tokens.shape[0]
    batch = {"tokens": tokens, "cache_len": torch.full(
        (b,), t + 1, dtype=torch.int32, device=DEVICE)}
    if cfg.family == "vlm":
        batch["positions_thw"] = torch.full((b, 1, 3), t, device=DEVICE)
    return batch


def family_fp32(torch, arch, b=2, s=128):
    """Phase 15a: fp32, ``logits_fn`` over B sequences of S tokens
    (Whisper: against B x enc_seq frames; Qwen2-VL: text at t = h = w = i)
    held against token-by-token ``decode_step`` at every position (rtol =
    atol = 2e-3; Whisper's cross cache from :func:`cross_cache`); every
    flash launch of the forward the variant ``kernel_variant`` names for
    fp32 at the config's head dim, 18 (Whisper) and 8 (Qwen2-VL) per
    forward.  Returns (line, launches)."""
    from repro_torch.kernels import flash_attention as fa
    model, params = family_model(torch, arch, dtype="float32")
    cfg = model.cfg
    per_forward = FAMILY_ARCHS[arch][1]
    variant = fa.kernel_variant(torch.float32, cfg.head_dim, DEVICE)
    batch = family_inputs(torch, cfg, b, s, seed=15)
    t0 = time.perf_counter()
    with torch.inference_mode():
        reset_launches()
        full, _ = model.logits_fn(params, batch)
        torch.cuda.synchronize()
        if not fa.launches.count == fa.launches.of(variant) == per_forward:
            raise AssertionError(
                f"{arch} fp32: flash launches per forward "
                f"{fa.launches.by_variant}, want {per_forward} {variant}")
        cache = model.init_cache(b, s, device=DEVICE)
        if cfg.family == "encdec":
            cross_cache(model, params, batch["frames"], cache)
        dec = []
        for t in range(s):
            logits, cache = model.decode_step(params, cache, family_step(
                torch, cfg, batch["tokens"][:, t:t + 1], t))
            dec.append(logits)
        err = close_enough(torch.stack(dec, 1), full, MODEL_TOL)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del params, cache, full, dec
    torch.cuda.empty_cache()
    return (f"{arch} ({cfg.n_layers} layers, d {cfg.d_model}, H "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, D {cfg.head_dim}): logits_fn "
            f"(B={b}, S={s}"
            f"{f', {cfg.enc_seq} frames' if cfg.family == 'encdec' else ''}"
            f") vs decode_step at every position max_abs_err {err:.3g} "
            f"(tol {MODEL_TOL}); flash launches per forward {per_forward} "
            f"{variant}; {wall:.1f} s"), {
                "flash_attention": per_forward,
                f"flash_attention:{variant}": per_forward}


def family_bf16(torch, arch, b, s, n_patches=0, n_new=32):
    """Phase 15b: :func:`bf16_prefill_decode` over Whisper's B x enc_seq
    frames and S tokens, or Qwen2-VL's S positions of which ``n_patches``
    are patch embeddings; 18 and 8 ``wgmma`` flash launches a forward.
    Returns (summary, launches)."""
    model, params = family_model(torch, arch)
    cfg = model.cfg
    per_forward = FAMILY_ARCHS[arch][1]
    batch = family_inputs(torch, cfg, b, s, seed=16, n_patches=n_patches)
    run = bf16_prefill_decode(torch, model, params, batch, per_forward,
                              n_new)
    del params
    torch.cuda.empty_cache()
    summary = {"model": arch, "layers": cfg.n_layers, "batch": b,
               "tokens": s, "patches": n_patches,
               "frames": cfg.enc_seq if cfg.family == "encdec" else 0,
               "prefill_s": run["prefill_s"], "decode_steps": n_new,
               "decode_ms_per_step": run["decode_s"] / n_new * 1e3,
               "flash_by_variant": run["by_variant"],
               "logits_vs_fp32": run["vs"]}
    return summary, {"flash_attention": per_forward}


# ---------------------------------------------------------- phase 16


# 16a's flash cases, (B, Sq, Sk, H, Hkv, causal): the shapes training
# gives the kernel (TinyLlama-1.1B: 16c's global batch 8 x 1024, 16d's
# 4 x 256) and Whisper's cross-attention (Sq 448, Sk 1500, full)
GRAD_FLASH_CASES = {"flash": (8, 1024, 1024, 32, 4, True),
                    "short": (4, 256, 256, 32, 4, True),
                    "cross": (4, 448, 1500, 8, 8, False)}
# 16a: the kernel's forward against the plain version's in relative L2.
# A faulty tile, mask or softmax lands 0.1 or more away; a sound kernel
# stays within rounding: fp32 within the 1e-4 that 16b holds each fp32
# gradient leaf to, bf16 within 1e-2 (five bf16 unit roundoffs, 2^-9).
GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 1e-2}


def grad_inputs(torch, case, dtype, seed=16):
    """(forward, plain, inputs, dout, variant, flops, counter, tol) of one
    16a case: flash at each of :data:`GRAD_FLASH_CASES`, ``ssd`` at phase
    8's shape with d_skip; ``tol`` is the kernel's own phase tolerance
    (7's, 8's) for its forward against the plain version's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    rng = np.random.RandomState(seed)
    dt_ = getattr(torch, dtype)

    def dev(a, to=dt_):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            DEVICE, to).requires_grad_(True)
    if case in GRAD_FLASH_CASES:
        b, s, sk, h, hkv, causal = GRAD_FLASH_CASES[case]
        ins = [dev(rng.standard_normal(shape)) for shape in
               ((b, s, h, 64), (b, sk, hkv, 64), (b, sk, hkv, 64))]
        flops = 4.0 * b * h * 64 * (s * (s + 1) / 2 if causal else s * sk)
        return (lambda *t: fa.flash_attention(*t, causal=causal),
                lambda *t: fa.flash_attention_plain(*t, causal=causal),
                ins, [torch.from_numpy(rng.standard_normal(
                    (b, s, h, 64)).astype(np.float32)).to(DEVICE, dt_)],
                fa.kernel_variant(dt_, 64, DEVICE), flops, fa.launches,
                TOL[dtype])
    b, s, h, p, g, n, chunk = 4, 1024, 64, 64, 1, 128, 128
    ins = [dev(rng.standard_normal((b, s, h, p))),
           dev(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)),
               torch.float32),
           dev(-np.exp(rng.standard_normal((h,)) * 0.5), torch.float32),
           dev(rng.standard_normal((b, s, g, n)) * 0.3),
           dev(rng.standard_normal((b, s, g, n)) * 0.3),
           dev(rng.standard_normal((h,)), torch.float32)]
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32)).to(DEVICE, dt_)
    return (lambda x, dt, a, bm, cm, ds: ss.ssd_scan(
                x, dt, a, bm, cm, chunk=chunk, d_skip=ds)[0],
            lambda x, dt, a, bm, cm, ds: ss.ssd_scan_plain(
                x, dt, a, bm, cm, chunk=chunk, d_skip=ds)[0],
            ins, [dy], ss.kernel_variant(dt_, p, n, chunk, DEVICE),
            ssd_flops(s, chunk, h, p, n, b), ss.launches, SSD_TOL[dtype])


def phase_autograd(torch, timer, case, dtype):
    """16a: a kernel under autograd.  The forward through its
    ``autograd.Function`` equals the kernel call byte for byte and is one
    launch of the expected variant; the kernel's output is held against
    the plain version's on the same inputs (its phase's elementwise
    tolerance; flash also in relative L2, :data:`GRAD_REL_L2`); every
    input gradient equals ``torch.autograd.grad`` of the plain version at
    the same inputs byte for byte (the backward is that code); times of
    the kernel forward, the Function's backward and the plain forward +
    backward, not held."""
    fwd, plain, ins, dout, variant, flops, counter, tol = grad_inputs(
        torch, case, dtype)
    label = f"16a {case} {dtype}"
    with torch.no_grad():
        direct = fwd(*ins)
        want_out = plain(*ins)
    err = close_enough(direct, want_out, tol)
    dist = rel_l2(direct, want_out)
    if case != "ssd" and not dist <= GRAD_REL_L2[dtype]:
        raise AssertionError(f"{label}: the kernel's output at relative L2 "
                             f"{dist:.3g} from the plain version's (limit "
                             f"{GRAD_REL_L2[dtype]})")
    del want_out
    before = dict(counter.by_variant)
    out = fwd(*ins)
    torch.cuda.synchronize()
    after = dict(counter.by_variant)
    launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    if {k: v for k, v in launched.items() if v} != {variant: 1}:
        raise AssertionError(f"{label}: forward launched {launched}, want "
                             f"one {variant}")
    if out.grad_fn is None or "Fn" not in type(out.grad_fn).__name__:
        raise AssertionError(f"{label}: the forward has no autograd.Function "
                             f"({out.grad_fn})")
    if not torch.equal(out, direct):
        raise AssertionError(f"{label}: the Function's output differs from "
                             f"the kernel call's")
    got = torch.autograd.grad(out, ins, dout, retain_graph=True)
    torch.cuda.synchronize()
    if dict(counter.by_variant) != after:
        raise AssertionError(f"{label}: the backward launched a kernel")
    want = torch.autograd.grad(plain(*ins), ins, dout)
    for i, (g, w, t) in enumerate(zip(got, want, ins)):
        if g.dtype != t.dtype or not torch.equal(g, w):
            raise AssertionError(f"{label}: gradient {i} differs from the "
                                 f"plain version's autograd")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label}: gradient {i} not finite")
    del want, direct
    with torch.no_grad():
        fwd_ms = timer.ms(lambda: fwd(*ins), iters=10)
    bwd_ms = timer.ms(lambda: torch.autograd.grad(out, ins, dout,
                                                  retain_graph=True),
                      iters=5, warmup=1)
    plain_ms = timer.ms(lambda: torch.autograd.grad(plain(*ins), ins, dout),
                        iters=5, warmup=1)
    return {"case": case, "dtype": dtype, "variant": variant,
            "max_abs_err": err, "rel_l2": dist, "fwd_ms": fwd_ms,
            "bwd_ms": bwd_ms, "plain_fwd_bwd_ms": plain_ms,
            "bwd_over_fwd": bwd_ms / fwd_ms, "fwd_flops": flops}


def full_grads(torch, model, params, batch):
    """{name: gradient} of ``loss_fn`` over every parameter."""
    from repro_torch.models.params import flatten_params
    flat = flatten_params(params)
    loss = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), dict(zip(flat, grads))


def train_grad(torch, arch, b=2, s=512):
    """16b: one ``loss_fn`` + backward at published widths and depth in
    fp32 through the kernels (remat full: two launches a layer), then
    again with the kernel swapped for its plain version inside this phase
    (a measuring device of this script, not a path of the package).
    Every parameter's gradient present and finite, the attention /
    in_proj leaves non-zero, and each leaf within relative L2 1e-4 of the
    plain path's.  Returns (summary, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import build_model
    cfg = get_config(arch).replace(dtype="float32")
    if cfg.family == "ssm":
        model, params = perturbed_model(torch, arch, "float32")
        name, plain, want = "ssd", ss.ssd_scan_plain, \
            {"ssd_scan": 2 * cfg.n_layers, "flash_attention": 0}
        nonzero = ("in_proj",)
    else:
        model = build_model(cfg)
        params = model.init(seed=0, device=DEVICE)
        name, plain, want = "flash_attention", fa.flash_attention_plain, \
            {"ssd_scan": 0, "flash_attention": 2 * cfg.n_layers}
        nonzero = ("attn/wq", "attn/wk", "attn/wv")
    params.requires_grad_(True)
    rng = np.random.RandomState(17)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (b, s))).to(DEVICE)}
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = full_grads(torch, model, params, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = read_launches()
    if launches != want:
        raise AssertionError(f"16b {arch}: launches {launches}, want {want} "
                             f"(forward and remat recompute)")
    launches.update(variant_launches())
    reset_launches()
    kernel = getattr(ops, name)
    setattr(ops, name, plain)
    try:
        t0 = time.perf_counter()
        plain_loss, plain_grads = full_grads(torch, model, params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        setattr(ops, name, kernel)
    if any(read_launches().values()):
        raise AssertionError(f"16b {arch}: the plain pass launched "
                             f"{read_launches()}")
    worst = (0.0, "")
    for key, g in grads.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"16b {arch}: {key} has no finite "
                                 f"gradient")
        if key.endswith(nonzero) and not bool((g != 0).any()):
            raise AssertionError(f"16b {arch}: {key}'s gradient is zero")
        dist = rel_l2(g, plain_grads[key])
        if not dist <= 1e-4:
            raise AssertionError(f"16b {arch}: {key} at relative L2 "
                                 f"{dist:.3g} from the plain path's "
                                 f"gradient (limit 1e-4)")
        worst = max(worst, (dist, key))
    n = len(grads)
    del grads, plain_grads, params
    torch.cuda.empty_cache()
    return (f"{arch} fp32 B={b} S={s}: loss {loss:.6f} (plain path "
            f"{plain_loss:.6f}); {n} leaves, every gradient finite, "
            f"{', '.join(nonzero)} non-zero; worst leaf relative L2 "
            f"{worst[0]:.3g} ({worst[1]}); launches {launches}; "
            f"loss + backward {kernel_s:.2f} s, plain {plain_s:.2f} s"), \
        launches


def ssd_fp64(x, dt, a, b, c, *, chunk, d_skip=None):
    """Mamba2's SSD in fp64 by its whole-sequence quadratic form
    (``kernels.ref.ssd_quadratic``): a measuring device of
    ``--grad-seeds``, in ``ops.ssd``'s place."""
    from repro_torch.kernels.ref import ssd_quadratic
    x, dt, a, b, c = (t.double() for t in (x, dt, a, b, c))
    return ssd_quadratic(x, dt, a, b, c, chunk=chunk, d_skip=None if
                         d_skip is None else d_skip.double())


def grad_noise(torch, seed, b=2, s=512):
    """``--grad-seeds``: 16b's Mamba2-1.3B hold at another seed (weights
    ``seed``, batch ``17 + seed``; 16b itself is seed 0) beside an fp64
    plain path (the module in fp64, the SSD by :func:`ssd_fp64`; the norms'
    and the loss's fp32 islands stay).  For each leaf the relative L2
    distance kernel to plain (16b's hold), kernel to fp64 and plain to
    fp64, and the norm of its fp64 gradient.  Returns a summary line."""
    import copy
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    model, params = perturbed_model(torch, "mamba2-1.3b", "float32", seed)
    params.requires_grad_(True)
    rng = np.random.RandomState(17 + seed)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, model.cfg.vocab_size, (b, s))).to(DEVICE)}

    def grads_with(ssd, p):
        kernel, ops.ssd = ops.ssd, ssd
        try:
            return full_grads(torch, model, p, batch)[1]
        finally:
            ops.ssd = kernel
    reset_launches()
    kern = full_grads(torch, model, params, batch)[1]
    launched = read_launches()
    reset_launches()
    plain = grads_with(ss.ssd_scan_plain, params)
    p64 = copy.deepcopy(params).double().requires_grad_(True)
    exact = grads_with(ssd_fp64, p64)
    if launched != {"ssd_scan": 2 * model.cfg.n_layers,
                    "flash_attention": 0} or any(read_launches().values()):
        raise AssertionError(f"grad seeds: launches {launched}, then "
                             f"{read_launches()} on the plain paths")
    del p64, params

    def dist(g, w):
        g, w = g.double(), w.double()
        return float((g - w).norm() / w.norm())
    rows = sorted(((dist(kern[k], plain[k]), dist(kern[k], exact[k]),
                    dist(plain[k], exact[k]), float(exact[k].norm()), k)
                   for k in kern), reverse=True)
    med = [float(np.median([r[i] for r in rows])) for i in range(4)]
    del kern, plain, exact
    torch.cuda.empty_cache()
    top = "; ".join(f"{k}: {kp:.3g} / {ke:.3g} / {pe:.3g}, norm {nm:.3g}"
                    for kp, ke, pe, nm, k in rows[:3])
    reading = {"seed": seed, "kernel_median": med[1], "plain_median": med[2],
               "kernel_worst": max(r[1] for r in rows),
               "plain_worst": max(r[2] for r in rows),
               "kernel_worst_leaf": max(rows, key=lambda r: r[1])[4],
               "plain_worst_leaf": max(rows, key=lambda r: r[2])[4]}
    return (f"mamba2-1.3b fp32 B={b} S={s} seed {seed}: relative L2 kernel "
            f"to plain / kernel to fp64 / plain to fp64, worst three leaves "
            f"by the first: {top}; worst over {len(rows)} leaves "
            f"{rows[0][0]:.3g} / {reading['kernel_worst']:.3g} / "
            f"{reading['plain_worst']:.3g}; median {med[0]:.3g} / "
            f"{med[1]:.3g} / {med[2]:.3g}, median norm {med[3]:.3g}"), \
        reading


# 16b-seeds: each fp32 path against the fp64 plain path, per leaf; the
# kernel path's median and worst leaf may be at most this times the plain
# fp32 path's (set before any run, the ratio of section 2's bf16 logits)
GRAD_FP64_RATIO = 2.0
GRAD_SEEDS = (0, 1, 2, 3)


def grad_seed_hold(torch, seed):
    """16b-seeds: Mamba2-1.3B's fp32 gradients at ``seed`` (seed 0 is
    16b's weights and batch) held against the fp64 plain path: the kernel
    path's median and worst per-leaf relative L2 distance each at most
    :data:`GRAD_FP64_RATIO` times the plain fp32 path's.  Returns
    (line, reading)."""
    line, r = grad_noise(torch, seed)
    for what in ("median", "worst"):
        k, p = r[f"kernel_{what}"], r[f"plain_{what}"]
        if not k <= GRAD_FP64_RATIO * p:
            raise AssertionError(
                f"16b-seeds seed {seed}: kernel path's {what} leaf at "
                f"relative L2 {k:.3g} from fp64, above {GRAD_FP64_RATIO} x "
                f"the plain fp32 path's {p:.3g}")
    return (f"{line}; held: kernel / plain to fp64, median "
            f"{r['kernel_median'] / r['plain_median']:.3f}x, worst "
            f"{r['kernel_worst'] / r['plain_worst']:.3f}x (limit "
            f"{GRAD_FP64_RATIO}x)"), r


def train_full_width(torch, steps=20, b=8, s=1024):
    """16c: the ``Trainer`` on TinyLlama-1.1B at published widths and
    depth in bf16 (the config's dtype), ``remat="full"``, AdamW, lr 3e-4,
    warmup 5, no checkpoint directory.  Every loss finite, the mean of
    the last five below the first five's by >= 0.2, and exactly
    22 x 2 x ``steps`` flash launches, all ``wgmma``.  Returns (summary,
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.loop import Trainer
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("tinyllama-1.1b")
    tr = Trainer(cfg, global_batch=b, seq_len=s, lr=3e-4, warmup=5,
                 total_steps=steps, device=DEVICE)
    try:
        state = tr.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        for i in range(steps):
            t0 = time.perf_counter()
            if i == steps // 2:          # one step under the profiler
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state = tr.train(state, 1)
                    torch.cuda.synchronize()
            else:
                state = tr.train(state, 1)
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = read_launches()
        by_variant = dict(fa.launches.by_variant)
        peak = torch.cuda.max_memory_allocated()
    finally:
        tr.close()
    losses = tr.losses
    want = cfg.n_layers * 2 * steps
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"16c: losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - 0.2:
        raise AssertionError(f"16c: loss did not fall by 0.2 ({first:.4f} "
                             f"-> {last:.4f})")
    if by_variant != {"wgmma": want} or launches["ssd_scan"]:
        raise AssertionError(f"16c: flash launches {by_variant}, want "
                             f"{want} wgmma (forward and remat recompute)")
    del state
    torch.cuda.empty_cache()
    med = float(np.median(times))
    device = device_split(prof, times[steps // 2])
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "global_batch": b, "seq_len": s, "steps": steps,
            "loss_first5": first, "loss_last5": last,
            "losses": [round(x, 4) for x in losses],
            "median_step_s": med, "first_step_s": times[0],
            "tokens_per_s": b * s / med, "max_memory_allocated_gb":
                peak / 1e9, "flash_by_variant": by_variant,
            "profiled_step": device}, launches


def device_split(prof, wall_s, top=8):
    """Device time of one profiled step: the kernels' sum, the flash
    kernels' share, and the ``top`` kernels by device time (ms).  The
    profiled step's wall time is the profiler's too, so its idle share is
    an upper bound."""
    rows = []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, evt.key))
    rows.sort(reverse=True)
    busy = sum(t for t, _ in rows)
    flash = sum(t for t, k in rows if any(n in k for n in FLASH_KERNELS))
    return {"device_ms": busy, "wall_ms": wall_s * 1e3,
            "idle_share_at_most": 1 - busy / (wall_s * 1e3),
            "flash_ms": flash,
            "top": [[k[:70], round(t, 3)] for t, k in rows[:top]]}


def train_restart(torch, b=4, s=256):
    """16d: TinyLlama-1.1B at published widths with depth cut to 2
    layers (a 22-layer checkpoint would write about 13 GB), fp32, in a
    temporary directory removed afterwards.  Run 1 trains 20 steps with a
    checkpoint every 10; run 2 restores step 10 and replays 10; its losses
    equal run 1's within rtol = atol = 2e-4 (the embedding's index
    backward sums with atomics on the card, so bit-exact replay is not
    promised) and it reaches step 20.  Then a bf16 Trainer state saved and
    restored equals the saved one byte for byte in every leaf.  Returns
    (summary, launches)."""
    import tempfile
    from repro_torch.checkpoint.manager import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models.params import flatten_params
    from repro_torch.train.loop import Trainer
    cfg = get_config("tinyllama-1.1b").replace(n_layers=2)
    launches = {"ssd_scan": 0, "flash_attention": 0}

    def count():
        for k, v in {**read_launches(), **variant_launches()}.items():
            launches[k] = launches.get(k, 0) + v
        reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(dtype, sub, every):
            return Trainer(cfg.replace(dtype=dtype), global_batch=b,
                           seq_len=s, checkpoint_dir=f"{tmp}/{sub}",
                           checkpoint_every=every, device=DEVICE)
        reset_launches()
        t0 = time.perf_counter()
        tr1 = trainer("float32", "fp32", 10)
        tr1.train(tr1.init_state(), 20)
        tr1.close()
        tr2 = trainer("float32", "fp32", 10)
        st = tr2.restore(10)
        st = tr2.train(st, 10)
        tr2.close()
        count()
        replay_s = time.perf_counter() - t0
        np.testing.assert_allclose(tr2.losses, tr1.losses[10:], rtol=2e-4,
                                   atol=2e-4)
        if st.step != 20:
            raise AssertionError(f"16d: replay reached step {st.step}")
        diff = float(np.max(np.abs(np.subtract(tr2.losses,
                                               tr1.losses[10:]))))
        del st
        tr3 = trainer("bfloat16", "bf16", 100)
        saved = tr3.train(tr3.init_state(), 2)   # the final save blocks
        tr3.close()
        count()
        back = tr3.restore()
        n_leaves = 0
        for got, want in ((flatten_params(back.params),
                           flatten_params(saved.params)),
                          (flatten_tree(back.opt_state),
                           flatten_tree(saved.opt_state))):
            if set(got) != set(want):
                raise AssertionError("16d: restored names differ")
            for key, t in want.items():
                g = got[key]
                if g.dtype != t.dtype or g.shape != t.shape or \
                        g.device != t.device or not torch.equal(
                            g.detach().reshape(-1).view(torch.uint8),
                            t.detach().reshape(-1).view(torch.uint8)):
                    raise AssertionError(f"16d: {key} not restored byte "
                                         f"for byte")
                n_leaves += 1
        nbytes = sum(t.numel() * t.element_size()
                     for t in flatten_params(saved.params).values())
        del saved, back
    torch.cuda.empty_cache()
    return (f"TinyLlama-1.1B widths, 2 layers, fp32 B={b} S={s}: 20 steps "
            f"(checkpoint every 10) then restore step 10 and replay 10: "
            f"max loss difference {diff:.3g} (rtol = atol = 2e-4), step 20 "
            f"reached, {replay_s:.1f} s; bf16 state ({nbytes / 1e9:.2f} GB "
            f"of params) saved and restored: {n_leaves} leaves byte-equal"), \
        launches


# ------------------------------------------------------ phases 17a-17c


def serve_launcher(torch):
    """17a: the serve launcher at TinyLlama-1.1B's published widths in bf16
    (``launch.serve.main``: 8 prompts of 12 tokens, 8 new, chunked, the
    reference's ServingConfig), held against the same requests run
    straight through ``serving.serve`` with the same seeded weights and
    config: 8 completed, 0 failed, identical greedy tokens, and every
    paged launch a decode layer (22 x decode steps), every packed launch
    a prefill layer (22 x prefill chunks).  Returns (summary, launches)."""
    from repro_torch import serving
    from repro_torch.kernels import packed_prefill, paged_attention
    from repro_torch.launch import serve as launcher
    argv = ["--no-reduced", "--dtype", "bfloat16", "--requests", "8"]
    paged_attention.launches.reset()
    packed_prefill.launches.reset()
    t0 = time.perf_counter()
    out = launcher.main(argv)
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches.count,
                "packed_prefill_attention": packed_prefill.launches.count}
    totals = out["totals"]
    if totals["completed"] != 8 or totals["failed"]:
        raise AssertionError(f"17a: completed {totals['completed']}, "
                             f"failed {totals['failed']}, want 8 and 0")
    cfg, model, params, config = launcher.setup(launcher.parse(argv))
    want = {"paged_attention": cfg.n_layers * totals["decode_steps"],
            "packed_prefill_attention":
                cfg.n_layers * totals["prefill_chunks"]}
    if launches != want:
        raise AssertionError(f"17a: launches {launches}, want {want} (22 "
                             f"a decode step, 22 a prefill chunk)")
    with serving.serve(model, params, config, device=DEVICE) as session:
        handles = session.submit_many(launcher.prompts(8), max_new_tokens=8)
        direct = [h.result(timeout=300) for h in handles]
    if out["tokens"] != direct:
        diff = [i for i, (a, b) in enumerate(zip(out["tokens"], direct))
                if a != b]
        raise AssertionError(f"17a: the launcher's tokens differ from the "
                             f"direct session's in requests {diff}")
    del params
    torch.cuda.empty_cache()
    return {"name": out["name"], "completed": totals["completed"],
            "failed": totals["failed"], "new_tokens": sum(
                len(t) for t in out["tokens"]), "wall_s": wall,
            "decode_steps": totals["decode_steps"],
            "prefill_chunks": totals["prefill_chunks"],
            "launches": launches, "tokens_equal_direct_session": True}, \
        launches


def _nccl_group(tmp):
    """A one-rank NCCL process group (a file store in ``tmp``)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)


def sharded_step(torch, b=2, s=512):
    """17b: TinyLlama-1.1B at published widths in fp32 (remat as
    configured) on a 1 x 1 NCCL mesh.  One AdamW step of a ``Trainer`` with
    the mesh (DTensor parameters by ``shard_params``, flash through
    ``local_map``) against the unsharded ``Trainer`` step on the same
    batch: loss rtol 2e-5, parameters rtol = atol 2e-4 (the reference's
    ``test_sharded_train_step_matches_single_device``), exactly 22 x 2
    flash launches in the sharded step; ``compressed_psum`` on that step's
    gradient leaves gives int8 blocks and scales byte-equal to the CPU's
    and ``residual == target - sent`` exactly; ``restore(mesh=...)`` of
    the sharded state byte-equal to what was saved; ``gpipe_forward`` with
    one stage over the 22 blocks in 4 microbatches byte-equal to running
    each microbatch through the blocks in order.  Returns (summary,
    launches)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager, \
        flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import flatten_params
    from repro_torch.models.transformer import block_train
    from repro_torch.models.layers import rope_angles
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.pipeline import gpipe_forward
    from repro_torch.parallel.sharding import resolve
    from repro_torch.train.loop import Trainer
    cfg = get_config("tinyllama-1.1b").replace(dtype="float32")
    out = {"remat": cfg.remat}
    with tempfile.TemporaryDirectory() as tmp:
        _nccl_group(tmp)
        try:
            mesh = make_mesh((1, 1), device_type="cuda")

            def trainer(m):
                return Trainer(cfg, global_batch=b, seq_len=s, lr=3e-4,
                               warmup=0, device=DEVICE, mesh=m)
            plain = trainer(None)
            st = plain.train(plain.init_state(), 1)
            plain.close()
            sh = trainer(mesh)
            grads = {}
            update = sh.optimizer.update

            def keep(g, state, params):     # the step's gradient leaves
                grads.update(g)
                return update(g, state, params)
            sh.optimizer.update = keep
            reset_launches()
            t0 = time.perf_counter()
            st_sh = sh.train(sh.init_state(), 1)
            torch.cuda.synchronize()
            out["sharded_step_s"] = time.perf_counter() - t0
            launches = read_launches()
            sh.close()
            if launches != {"flash_attention": 2 * cfg.n_layers,
                            "ssd_scan": 0}:
                raise AssertionError(f"17b: sharded step launches "
                                     f"{launches}, want 44 flash")
            launches.update(variant_launches())
            np.testing.assert_allclose(sh.losses[0], plain.losses[0],
                                       rtol=2e-5)
            ref = {k: v.detach() for k, v in
                   flatten_params(st.params).items()}
            full = {k: v.detach().full_tensor() for k, v in
                    flatten_params(st_sh.params).items()}
            worst = 0.0
            for k, v in full.items():
                torch.testing.assert_close(v, ref[k], rtol=2e-4, atol=2e-4)
                worst = max(worst, float(((v - ref[k]).abs() / (
                    2e-4 + 2e-4 * ref[k].abs())).max()))
            out.update(loss=sh.losses[0], plain_loss=plain.losses[0],
                       param_worst_share_of_limit=worst)
            del st, ref, full, plain
            # int8 error-feedback all-reduce of the step's gradients
            t0 = time.perf_counter()
            n_blocks = 0
            for k, g in grads.items():
                g = g.to_local().float()
                zero = torch.zeros_like(g)
                reduced, resid = col.compressed_psum(g, None, zero)
                q, sc = col.quantize_int8(g)
                qc, scc = col.quantize_int8(g.cpu())
                sent = col.dequantize_int8(qc, scc, g.shape)
                if not (torch.equal(q.cpu(), qc) and torch.equal(
                        sc.cpu(), scc) and torch.equal(
                        resid.cpu(), g.cpu() - sent) and torch.equal(
                        reduced.cpu(), sent)):
                    raise AssertionError(f"17b: compressed_psum of {k} "
                                         f"differs from the CPU's")
                n_blocks += q.shape[0]
            out["compressed_leaves"] = len(grads)
            out["int8_blocks"] = n_blocks
            out["compress_check_s"] = time.perf_counter() - t0
            del grads
            # elastic restore onto the mesh
            t0 = time.perf_counter()
            ckpt = CheckpointManager(f"{tmp}/ckpt", async_save=False)
            flat = flatten_params(st_sh.params)
            ckpt.save(1, flat, st_sh.opt_state, param_specs=sh.specs)
            opt_specs = sh.optimizer.abstract_state(
                flatten_params(sh.model.abstract_params()[0]),
                sh.specs)[1]
            rp, ro, _ = ckpt.restore(1, mesh=mesh, param_specs=sh.specs,
                                     opt_specs=opt_specs,
                                     resolve_fn=resolve)
            saved = dict(flatten_tree(flat))
            saved.update({f"opt/{k}": v for k, v in
                          flatten_tree(st_sh.opt_state).items()})
            got = dict(flatten_tree(rp))
            got.update({f"opt/{k}": v for k, v in
                        flatten_tree(ro).items()})
            if set(got) != set(saved):
                raise AssertionError("17b: restored keys differ")
            for k, v in saved.items():
                a = v.full_tensor() if hasattr(v, "full_tensor") else v
                r = got[k]
                if not hasattr(r, "full_tensor") or not torch.equal(
                        r.full_tensor(), a):
                    raise AssertionError(f"17b: restored {k} differs or "
                                         f"is not on the mesh")
            out["restored_leaves"] = len(saved)
            out["save_restore_s"] = time.perf_counter() - t0
            del rp, ro, saved, got, flat, st_sh
            # GPipe, one stage: the schedule against the sequential stack
            model = sh.model
            params = model.init(0, DEVICE)
            toks = torch.from_numpy(np.random.RandomState(17).randint(
                0, cfg.vocab_size, (4, s))).to(DEVICE)
            x = params.embed[toks.long()][:, None]          # (M, 1, S, d)
            ang = rope_angles(torch.arange(s, device=DEVICE)[None, :],
                              cfg.head_dim, cfg.rope_theta)

            def block_fn(lp, h):
                return block_train(params.blocks[int(lp["i"])], cfg, h,
                                   ang, "dense")
            reset_launches()
            with torch.no_grad():
                staged = {"i": torch.arange(cfg.n_layers).reshape(1, -1)}
                piped = gpipe_forward(block_fn, None, n_microbatches=4)(
                    staged, x)
                seq = []
                for mb in x:
                    h = mb
                    for i in range(cfg.n_layers):
                        h = block_fn({"i": torch.tensor(i)}, h)
                    seq.append(h)
            pipe_launches = read_launches()
            if not torch.equal(piped, torch.stack(seq)):
                raise AssertionError("17b: gpipe_forward differs from the "
                                     "sequential stack")
            out["gpipe_launches"] = pipe_launches["flash_attention"]
            del params, piped, seq
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["flash_launches"] = launches["flash_attention"]
    out["flash_wgmma"] = fa.launches.of("wgmma")
    return out, launches


DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b",
                                                  "decode_32k"),
                ("olmoe-1b-7b", "train_4k"))


def dryrun_records(torch):
    """17c: the dry run in a subprocess of its own (the fake process group
    cannot share a process with NCCL): TinyLlama-1.1B x train_4k and x
    decode_32k and OLMoE-1B-7B x train_4k on the 16 x 16 fake mesh, then
    the roofline rows with the H100 constants.  Holds positive FLOPs and
    bytes, 256 devices and at least one all-gather on each train cell.
    Returns (records by cell, roofline text)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        code = (
            "import sys\n"
            "from repro_torch.launch import dryrun, roofline\n"
            f"for arch, shape in {DRYRUN_CELLS!r}:\n"
            "    assert dryrun.main(['--arch', arch, '--shape', shape, "
            "'--out', sys.argv[1]]) == 0\n"
            "roofline.main(['--records', sys.argv[1], '--out', "
            "sys.argv[1] + '/roofline.md'])\n")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.run([sys.executable, "-c", code, tmp],
                              capture_output=True, text=True, env=env,
                              timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"17c: the dry run failed:\n"
                                 f"{proc.stderr[-3000:]}")
        recs = {}
        for arch, shape in DRYRUN_CELLS:
            with open(f"{tmp}/{arch}__{shape}__pod1__baseline.json") as f:
                recs[f"{arch} x {shape}"] = json.load(f)
        with open(f"{tmp}/roofline.md") as f:
            table = f.read()
    for cell, r in recs.items():
        if not (r["flops_per_device"] > 0 and
                r["bytes_accessed_per_device"] > 0 and
                r["n_chips"] == 256):
            raise AssertionError(f"17c {cell}: {r}")
        if r["kind"] == "train" and \
                r["collectives"]["all-gather"]["count"] < 1:
            raise AssertionError(f"17c {cell}: no all-gather on train")
    return recs, table


def split_bodies(torch):
    """17d: the per-rank bodies of the mesh's three splits, rank by rank
    on this card at published widths, each against the unsharded call.
    (a) TinyLlama-1.1B attention (B 4, S 1024, H 32, Hkv 4, D 64, causal)
    at 16 ways, fp32 and bf16: 16 ``gqa_local`` launches of 2 q heads and
    1 kv head, reassembled within phase 7's tolerance of one unsharded
    kernel call (bytes equal or not, printed); (b) Mamba2-1.3B's SSD at
    phase 8's shape (B 4, S 1024, H 64, P 64, N 128, chunk 128) at 16
    ways, fp32 and bf16: 16 ``ssd_scan`` launches of 4 heads, y and the
    final state within phase 8's tolerance; (c) one OLMoE-1B-7B MoE FFN
    (64 experts top 8, D 2048, F 1024, fp32) on B 4 x 512 tokens in 2
    stand-in data blocks and 16 stand-in expert blocks of 4:
    ``expert_partial`` keeps exactly the unsharded ``apply_moe_ffn``'s
    (token, choice) set and its partials sum within relative L2 1e-5 of
    its output.  Returns (lines, launches of the per-rank calls)."""
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sharded
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import moe
    ways, lines = 16, []
    launches = {"flash_attention": 0, "ssd_scan": 0}
    gen = torch.Generator(device=DEVICE).manual_seed(20)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE) *
                scale).to(dtype)

    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        b, s, h, hkv, d = 4, 1024, 32, 4, 64
        q, k, v = (randn(b, s, n, d, dtype=dt_) for n in (h, hkv, hkv))
        want = fa.flash_attention(q, k, v, causal=True)
        hl = h // ways
        before = fa.launches.count
        got = torch.cat([sharded.gqa_local(q[:, :, r * hl:(r + 1) * hl], k,
                                           v, r, ways, True)
                         for r in range(ways)], dim=2)
        torch.cuda.synchronize()
        n = fa.launches.count - before
        if n != ways:
            raise AssertionError(f"17d gqa {dtype}: {n} launches, want "
                                 f"{ways}")
        launches["flash_attention"] += n
        key = f"flash_attention:{fa.kernel_variant(dt_, d, DEVICE)}"
        launches[key] = launches.get(key, 0) + n
        err = close_enough(got, want, TOL[dtype])
        lines.append(f"(a) TinyLlama attention {dtype}: {n} gqa_local "
                     f"launches of {hl} q heads and 1 kv head, max_abs_err "
                     f"{err:.3g} against the unsharded kernel (tol "
                     f"{TOL[dtype]}), bytes equal "
                     f"{bool(torch.equal(got, want))}")
        del q, k, v, want, got

        b, s, h, p, n_state, chunk = 4, 1024, 64, 64, 128, 128
        x = randn(b, s, h, p, dtype=dt_)
        dt = torch.nn.functional.softplus(randn(b, s, h) - 1.0)
        a = -torch.exp(randn(h, scale=0.5))
        bm, cm = (randn(b, s, 1, n_state, scale=0.3, dtype=dt_)
                  for _ in range(2))
        ds = randn(h)
        want_y, want_f = ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                     d_skip=ds)
        hl = h // ways
        before = ss.launches.count
        parts = [ss.ssd_scan(
            x[:, :, r * hl:(r + 1) * hl].contiguous(),
            dt[:, :, r * hl:(r + 1) * hl], a[r * hl:(r + 1) * hl], bm, cm,
            chunk=chunk, d_skip=ds[r * hl:(r + 1) * hl])
            for r in range(ways)]
        torch.cuda.synchronize()
        n = ss.launches.count - before
        if n != ways:
            raise AssertionError(f"17d ssd {dtype}: {n} launches, want "
                                 f"{ways}")
        launches["ssd_scan"] += n
        y = torch.cat([t for t, _ in parts], dim=2)
        final = torch.cat([t for _, t in parts], dim=1)
        err = max(close_enough(y, want_y, SSD_TOL[dtype]),
                  close_enough(final, want_f, SSD_TOL[dtype]))
        lines.append(f"(b) Mamba2 SSD {dtype}: {n} ssd_scan launches of "
                     f"{hl} heads, max_abs_err {err:.3g} against the "
                     f"unsharded kernel (tol {SSD_TOL[dtype]}), bytes equal "
                     f"{bool(torch.equal(y, want_y))} / "
                     f"{bool(torch.equal(final, want_f))}")
        del x, y, final, parts, want_y, want_f

    cfg = get_config("olmoe-1b-7b").replace(dtype="float32")
    e, dm, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    w = SimpleNamespace(router=randn(dm, e, scale=dm ** -0.5),
                        wi_gate=randn(e, dm, f, scale=dm ** -0.5),
                        wi_up=randn(e, dm, f, scale=dm ** -0.5),
                        wo=randn(e, f, dm, scale=f ** -0.5), shared=False)
    b, s = 4, 512
    # a shared direction in every token biases the router, so the busiest
    # experts overflow their capacity and choices are dropped
    x = randn(b, s, dm) + randn(dm, scale=0.5)
    with torch.no_grad():
        want = moe.apply_moe_ffn(w, cfg, x).reshape(b * s, dm)
        want_keep = moe.route(w, cfg, x.reshape(b * s, dm))[3]
        cap = moe.capacity(cfg, b * s)
        blocks = x.reshape(b * s, dm).chunk(2)
        routes = [moe.route(w, cfg, xb)[:3] for xb in blocks]
        # the second block's positions follow the first block's choices
        topw, tope, pos = routes[1]
        routes[1] = (topw, tope,
                     pos + moe.expert_counts(routes[0][1], e)[tope])
        e_l = e // ways
        got, same = [], True
        for t, xb in enumerate(blocks):
            y = torch.zeros_like(xb)
            for r in range(ways):
                part = SimpleNamespace(router=w.router, **{
                    k: getattr(w, k)[r * e_l:(r + 1) * e_l]
                    for k in ("wi_gate", "wi_up", "wo")})
                yr, keep = moe.expert_partial(part, cfg, xb, routes[t],
                                              cap=cap, first=r * e_l)
                y += yr
                same &= torch.equal(keep, want_keep.chunk(2)[t])
            got.append(y)
        got = torch.cat(got)
    torch.cuda.synchronize()
    if not same:
        raise AssertionError("17d moe: the kept (token, choice) set differs "
                             "from the unsharded apply_moe_ffn's")
    err = rel_l2(got, want)
    if not (torch.isfinite(got).all() and err <= 1e-5):
        raise AssertionError(f"17d moe: relative L2 {err:.3g} > 1e-5")
    lines.append(f"(c) OLMoE MoE FFN fp32: 2 token blocks x {ways} expert "
                 f"blocks of {e_l} experts, cap {cap}, kept set equal "
                 f"({int((~want_keep).sum())} of {want_keep.numel()} "
                 f"choices dropped), relative L2 {err:.3g} (limit 1e-5)")
    return lines, launches


# ---------------------------------------------------------- phase 18

# the serving example at full width: TinyLlama-1.1B in bf16, 64 new tokens
EXAMPLE_ARGS = ["--no-reduced", "--dtype", "bfloat16", "--max-new", "64"]
# 18b: shard 0 stalls for 3 s after its first completion; 8 clients (more
# than max_batch 4) put five requests on shard 0 in the first wave, so one
# of them is still queued when the stall begins
STALL_ARGS = ["--clients", "8", "--pace-s", "0.2", "--watchdog", "migrate",
              "--fault", "stall:shard=0,after_done=1,duration_s=3"]


def load_example(name):
    """``examples/<name>.py`` of the checkout, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ExampleServing:
    """Phases 18a and 18b: the serving example's model, weights and
    config (``build``), built once, and each prompt's uninterrupted run:
    one request at a time on one shard of the example's config."""

    def __init__(self, torch):
        self.torch = torch
        self.ex = load_example("torch_serve_paged")
        self.args = self.ex.parse(EXAMPLE_ARGS + ["--device", DEVICE])
        self.cfg, self.model, self.params, self.config = \
            self.ex.build(self.args)
        self.refs = {}

    def serve(self, args, config):
        """One run of the example's workload (``run`` through its
        ``Recorder``) on a fresh, warmed session.  Returns (result,
        [(prompt, handle)], launches, pages leaked per shard after close,
        migrations seen by the watchdog as (req_id, status, carried),
        wall seconds)."""
        from repro_torch import serving
        session = serving.serve(self.model, self.params, config,
                                device=DEVICE, start=False)
        moves = []
        watchdog = session.engine.watchdog
        migrate = watchdog._migrate_request

        def observed(source, req, now, seq=None):
            # a decoding sequence arrives with its pages (steal_live set
            # _carried); a queued or prefilling one is re-prefilled
            moves.append((req.req_id, req.status, req._carried is not None))
            return migrate(source, req, now, seq=seq)

        watchdog._migrate_request = observed
        try:
            session.warm()
            session.start()
            reset_launches()
            rec = self.ex.Recorder(session)
            t0 = time.perf_counter()
            res = self.ex.run(rec, args)
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            session.close()
        leaked = [s.config.num_pages - s.pool.free_count()
                  for s in session.engine.shards]
        return res, list(rec.handles), counts, leaked, moves, wall

    def uninterrupted(self, prompts):
        """Each prompt's tokens, one request at a time on one shard."""
        from repro_torch import serving
        todo = [p for p in prompts if tuple(p) not in self.refs]
        if todo:
            with serving.serve(self.model, self.params,
                               self.config.replace(num_shards=1),
                               device=DEVICE) as session:
                for p in todo:
                    self.refs[tuple(p)] = session.submit(
                        p, max_new_tokens=self.args.max_new).result(
                            timeout=600)
        return [self.refs[tuple(p)] for p in prompts]

    def held(self, label, handles):
        """Hold every stream to its uninterrupted run (:func:`hold_streams`,
        section 2's 1e-3 rule)."""
        prompts = [p for p, _ in handles]
        outs = [h.result(timeout=600) for _, h in handles]
        return hold_streams(label, self.torch, self.model, self.params,
                            prompts, outs, self.uninterrupted(prompts),
                            [None] * len(prompts))

    def check(self, label, res, handles, leaked):
        n = len(handles)
        if res.requests != n or res.failed or res.incomplete or \
                res.session_stats["totals"]["completed"] != n:
            raise AssertionError(
                f"{label}: {res.requests} requests, completed "
                f"{res.session_stats['totals']['completed']}, failed "
                f"{res.failed}, incomplete {res.incomplete}")
        if any(leaked):
            raise AssertionError(f"{label}: pages leaked per shard after "
                                 f"close {leaked}")

    def close(self):
        del self.params
        self.torch.cuda.empty_cache()


def check_example_launches(label, cfg, totals, counts):
    """Every attention of the example's bf16 run went through a kernel
    of the main path: one paged ``mma`` launch a layer for each decode
    step and each packed chunk that carried decode riders, one packed
    ``wgmma`` launch a layer for each prefill chunk (a ``chunked``
    chunk is a one-segment packed chunk)."""
    want = {"paged_attention": cfg.n_layers * (totals["decode_steps"] +
                                               totals["rider_chunks"]),
            "packed_prefill_attention":
                cfg.n_layers * totals["prefill_chunks"]}
    got = {k: counts[k] for k in want}
    variants = (counts["paged_by_variant"], counts["packed_by_variant"])
    if got != want or min(got.values()) < 1 or variants != (
            {"mma": want["paged_attention"]},
            {"wgmma": want["packed_prefill_attention"]}):
        raise AssertionError(f"{label}: launches {got} by variant "
                             f"{variants}, want {want}, all paged mma and "
                             f"packed wgmma")


def serve_example(serving_ex, scheduler):
    """18a: the serving example's default mix (12 requests and 2 long
    prompts of 192 tokens, 3 clients, 2 shards under IBR) at TinyLlama-
    1.1B's published widths in bf16, 64 new tokens, under ``scheduler``:
    every request completes, none fails, the prefix cache hits, no page
    outlives the session, and every stream is held to its uninterrupted
    run.  Returns (summary, launches)."""
    ex = serving_ex.ex
    args = ex.parse(EXAMPLE_ARGS + ["--device", DEVICE, "--scheduler",
                                    scheduler])
    label = f"18a {scheduler}"
    res, handles, counts, leaked, moves, wall = serving_ex.serve(
        args, ex.serving_config(args))
    serving_ex.check(label, res, handles, leaked)
    if res.prefix_hits < 1 or moves:
        raise AssertionError(f"{label}: prefix hits {res.prefix_hits}, "
                             f"migrations {len(moves)} (want > 0 and 0)")
    totals = res.session_stats["totals"]
    check_example_launches(label, serving_ex.cfg, totals, counts)
    tokens = serving_ex.held(label, handles)
    launches = {k: counts[k] for k in ("paged_attention",
                                       "packed_prefill_attention")}
    return {"scheduler": scheduler, "requests": res.requests,
            "completed": totals["completed"], "failed": res.failed,
            "new_tokens": res.tokens, "prefix_hits": res.prefix_hits,
            "wall_s": wall, "tok_per_s": res.tok_per_s,
            "ttft_p99_ms": res.ttft_p99_s * 1e3,
            "itl_p99_ms": res.itl_p99_s * 1e3,
            "decode_steps": totals["decode_steps"],
            "prefill_chunks": totals["prefill_chunks"],
            "packed_chunks": totals["packed_chunks"],
            "pages_leaked_after_close": leaked, "tokens": tokens,
            "launches": launches}, launches


def serve_example_stall(serving_ex):
    """18b: the example's mix under a paced stall: ``STALL_ARGS`` (8
    clients, 0.2 s between a client's requests, shard 0 stalled for 3 s
    after its first completion, the watchdog migrating), with the
    heartbeat timeout cut to 1 s in the example's config (its default,
    10 s, would outlast the stall).  At least one migration, at least
    one of them by re-prefill (the watchdog found the request waiting or
    prefilling, with no pages carried), none failed, no page leaked, and
    every stream held to its uninterrupted run.  Returns (summary,
    launches)."""
    ex = serving_ex.ex
    args = ex.parse(EXAMPLE_ARGS + ["--device", DEVICE] + STALL_ARGS)
    config = ex.serving_config(args).replace(heartbeat_timeout_s=1.0,
                                             watchdog_interval_s=0.02)
    res, handles, counts, leaked, moves, wall = serving_ex.serve(args,
                                                                 config)
    serving_ex.check("18b", res, handles, leaked)
    totals = res.session_stats["totals"]
    check_example_launches("18b", serving_ex.cfg, totals, counts)
    reprefilled = [m for m in moves if not m[2]]
    if res.migrations < 1 or not reprefilled:
        raise AssertionError(f"18b: {res.migrations} migrations, moves "
                             f"(req, state, carried) {moves}: want one "
                             f"by re-prefill")
    index = {h.req_id: i for i, (_, h) in enumerate(handles)}
    tokens = serving_ex.held("18b", handles)
    return {"requests": res.requests, "completed": totals["completed"],
            "failed": res.failed, "migrations": res.migrations,
            "heartbeat_misses": res.heartbeat_misses,
            "moves": [{"request": index[rid], "state_at_steal": state,
                       "path": "pages carried" if carried
                       else "re-prefill"} for rid, state, carried in moves],
            "reprefilled": len(reprefilled), "wall_s": wall,
            "pages_leaked_after_close": leaked, "tokens": tokens}, \
        {k: counts[k] for k in ("paged_attention",
                                "packed_prefill_attention")}


def train_example(torch):
    """18c: the training example on the card, reduced fp32 as the
    reference's: ``--steps 20``, then ``--resume --steps 10`` into the
    same fresh directory.  The second run starts at step 20, every loss
    is finite, the first run's last five losses average below its first
    five, and every flash launch is the variant ``kernel_variant`` names
    for fp32 at the reduced config's head dim, one a layer a step (through
    ``FlashAttentionFn``).  Returns (summary, launches)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    ex = load_example("torch_train_lm")
    reduced = get_config("tinyllama-1.1b").reduced()
    n_layers = reduced.n_layers
    variant = flash_attention.kernel_variant(torch.float32, reduced.head_dim,
                                             DEVICE)
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", DEVICE, "--ckpt-dir", tmp]
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            first = ex.main(argv + ["--steps", "20"])
            second = ex.main(argv + ["--resume", "--steps", "10"])
        wall = time.perf_counter() - t0
        launches = read_launches()
        of_variant = flash_attention.launches.of(variant)
    losses = first["losses"] + second["losses"]
    head, tail = np.mean(first["losses"][:5]), np.mean(first["losses"][-5:])
    if (first["start"], first["step"], second["start"], second["step"]) != \
            (0, 20, 20, 30):
        raise AssertionError(f"18c: runs {first['start']}->{first['step']}"
                             f" and {second['start']}->{second['step']}, "
                             f"want 0->20 and 20->30")
    if not all(math.isfinite(x) for x in losses) or not tail < head:
        raise AssertionError(f"18c: losses {losses} (last five of the "
                             f"first run must average below its first "
                             f"five)")
    want = n_layers * 30
    if launches["flash_attention"] != want or of_variant != want:
        raise AssertionError(f"18c: flash launches "
                             f"{launches['flash_attention']} ({of_variant} "
                             f"{variant}), want {want} {variant} (one a "
                             f"layer a step)")
    launches[f"flash_attention:{variant}"] = of_variant
    final = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("final loss")]
    return {"runs": "0->20, resumed 20->30", "first_five": head,
            "last_five": tail, "final_lines": final, "wall_s": wall,
            "flash_launches": launches["flash_attention"],
            "flash_variant": variant, "flash_of_variant": of_variant}, \
        launches

# phase 7's rows at the models' own attention shapes: (Hkv, S, shape)
FLASH_MODEL_CASES = [
    # DeepSeek-V2's MLA prefill (D 192 = nope 128 + rope 64)
    (128, 1024, dict(b=2, h=128, d=192, seed=19)),
    # Whisper-base's encoder (enc_seq 1500 = 23 x 64 + 28) and its
    # cross-attention from the 448-token text context
    (8, 1500, dict(b=4, h=8, causal=False)),
    (8, 448, dict(b=4, h=8, sk=1500, causal=False)),
    # Qwen2-VL-72B's text backbone
    (8, 1024, dict(b=2, h=64, d=128)),
]
# and at head dims outside the tensor-core set, on the ``fma`` variant:
# 18c's training shape (the reduced TinyLlama: B 8, S 64, H 4, Hkv 2,
# D 16; timed, the kernel table's ``fma`` row) and D 96 with GQA and a
# ragged tail
FLASH_FMA_CASES = [
    (2, 64, dict(b=8, h=4, d=16, seed=18, want_variant="fma")),
    (4, 1000, dict(d=96, want_variant="fma")),
]

PHASES = ("3", "4", "4b", "4c", "4d", "5", "6", "6b", "7", "8", "9", "10",
          "11", "12", "13", "13b", "13c", "14a", "14b", "15a", "15b", "16a",
          "16b", "16b-seeds", "16c", "16d", "17a", "17b", "17c", "17d",
          "18a", "18b", "18c")


def parse_only(argv):
    """``--only 7,13c``: run just those phases (to iterate on a few; the
    kernel table then is not printed; ``16``, ``17`` and ``18`` name
    their lettered phases).  No argument
    runs every phase."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--only PHASE,PHASE,...]")
    only = set(argv[1].split(","))
    if "16" in only:
        only = (only - {"16"}) | {"16a", "16b", "16b-seeds", "16c", "16d"}
    if "17" in only:
        only = (only - {"17"}) | {"17a", "17b", "17c", "17d"}
    if "18" in only:
        only = (only - {"18"}) | {"18a", "18b", "18c"}
    if not only <= set(PHASES):
        raise SystemExit(f"unknown phases {sorted(only - set(PHASES))}; "
                         f"known: {', '.join(PHASES)}")
    return only


def main(argv) -> int:
    seeds = None
    if argv[:1] == ["--grad-seeds"]:
        if len(argv) != 2:
            raise SystemExit("usage: chip_smoke.py --grad-seeds SEED,...")
        seeds, only = [int(x) for x in argv[1].split(",")], set()
    else:
        only = parse_only(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ops

    def on(phase):
        return only is None or phase in only

    # fp32 products stay fp32 (the reference is held at 3e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"[1 card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ops.prepare("cuda")
    say(f"[2 build] kernels built in {time.perf_counter() - t0:.1f} s")

    if seeds is not None:
        for seed in seeds:
            t0 = time.perf_counter()
            say(f"[grad seeds] {grad_noise(torch, seed)[0]} [{card}] "
                f"{time.perf_counter() - t0:.1f} s")
        say(card)
        return 0

    timer = Timer(torch)
    kernels, launches = {}, {}

    def add(path_launches):
        for name, count in path_launches.items():
            launches[name] = launches.get(name, 0) + count

    for dtype in ("float32", "bfloat16") if on("3") else ():
        t0 = time.perf_counter()
        row = phase_paged(torch, timer, dtype)
        kernels[("paged", dtype)] = row
        lr = row.get("long_row")
        merge = (f"; every context 0: profiler "
                 f"{fmt_ms(row['no_keys_profiler_ms'])}; B=1 2048 keys "
                 f"({lr['splits']} splits): max_abs_err "
                 f"{lr['max_abs_err']:.3g} ms {lr['ms']:.4f} profiler "
                 f"{fmt_ms(lr['profiler_ms'])} library "
                 f"{lr['library_ms']:.4f} bound {lr['bound_ms']:.5f} "
                 f"({lr['bound_by']})" if lr else "")
        say(f"[3 paged {dtype}] variant {row['variant']} max_abs_err by "
            f"num_splits {row['errs']} (default splits {row['splits']}); "
            f"ms {row['ms']:.4f} profiler {fmt_ms(row['profiler_ms'])} "
            f"plain {row['plain_ms']:.4f} library {row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']}){merge} "
            f"[{card}] {time.perf_counter() - t0:.1f} s")
    for dtype in ("float32", "bfloat16") if on("4") else ():
        for n_segs in (1, 8):
            t0 = time.perf_counter()
            row = phase_packed(torch, timer, dtype, n_segs)
            kernels[("packed", dtype, n_segs)] = row
            say(f"[4 packed {dtype} S={n_segs}] variant {row['variant']} "
                f"max_abs_err {row['max_abs_err']:.3g}; ms {row['ms']:.4f} "
                f"profiler {fmt_ms(row['profiler_ms'])} plain "
                f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']}) [{card}] "
                f"{time.perf_counter() - t0:.1f} s")

    for dtype in ("float32", "bfloat16") if on("4") else ():
        # the 8-segment chunk at a head dim outside the tensor-core set
        t0 = time.perf_counter()
        row = phase_packed(torch, timer, dtype, 8, d=96, want_variant="fma")
        kernels[("packed", dtype, 8, 96)] = row
        say(f"[4 packed {dtype} S=8 D=96] variant {row['variant']} "
            f"max_abs_err {row['max_abs_err']:.3g}, padding exactly 0; ms "
            f"{row['ms']:.4f} profiler {fmt_ms(row['profiler_ms'])} plain "
            f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    for dtype in ("float32", "bfloat16") if on("4b") else ():
        t0 = time.perf_counter()
        row = phase_packed(torch, timer, dtype, 8,
                           case=verify_case(torch, dtype))
        kernels[("verify", dtype)] = row
        say(f"[4b packed verify layout {dtype}] 40 lanes, 8 rows, nd 0-4, "
            f"dead lanes exactly 0; variant {row['variant']} max_abs_err "
            f"{row['max_abs_err']:.3g}; ms {row['ms']:.4f} profiler "
            f"{fmt_ms(row['profiler_ms'])} plain {row['plain_ms']:.4f} "
            f"library {row['library_ms']:.4f} bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}) [{card}] {time.perf_counter() - t0:.1f} s")

    for dtype in ("float32", "bfloat16") if on("4c") else ():
        for op in FUSED_OPS:
            for layout in FUSED_LAYOUTS:
                t0 = time.perf_counter()
                row = phase_fused(torch, timer, dtype, op, layout)
                kernels[("fused", dtype, op, layout)] = row
                say(f"[4c fused {op} {dtype} {layout} "
                    f"{FUSED_LAYOUTS[layout]} lanes] max_abs_err "
                    f"{row['max_abs_err']:.3g}, padding wrote no page; ms "
                    f"{row['ms']:.4f} profiler {fmt_ms(row['profiler_ms'])} "
                    f"plain {row['plain_ms']:.4f} bound "
                    f"{row['bound_ms']:.5f} ({row['bound_by']}) [{card}] "
                    f"{time.perf_counter() - t0:.1f} s")

    for layout in ("decode", "prefill") if on("4d") else ():
        t0 = time.perf_counter()
        row = phase_mla(torch, timer, layout)
        kernels[("mla", layout)] = row
        say(f"[4d mla {layout} {row['rows']} rows, {row['keys']} keys, "
            f"{row['splits']} split(s)] max_abs_err {row['max_abs_err']:.3g}"
            f", unoccupied rows 0; ms {row['ms']:.4f} profiler "
            f"{fmt_ms(row['profiler_ms'])} plain {row['plain_ms']:.4f} "
            f"bound {row['bound_ms']:.5f} ({row['bound_by']}) [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    for layout in ("decode", "prefill") if on("4d") else ():
        t0 = time.perf_counter()
        row = phase_mla_store(torch, timer, layout)
        kernels[("mla", "store", layout)] = row
        say(f"[4d mla_latent_store {layout} {row['rows']} lanes] max_abs_err "
            f"{row['max_abs_err']:.3g}, page -1 wrote nothing; ms "
            f"{row['ms']:.4f} profiler {fmt_ms(row['profiler_ms'])} plain "
            f"{row['plain_ms']:.4f} bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}) [{card}] {time.perf_counter() - t0:.1f} s")

    if on("5"):
        t0 = time.perf_counter()
        for line in serve_fp32(torch):
            say(f"[5 serve fp32] {line}")
        say(f"[5 serve fp32] {time.perf_counter() - t0:.1f} s")

    if on("6"):
        t0 = time.perf_counter()
        summary, path_launches = serve_bf16(torch)
        add(path_launches)
        say(f"[6 serve bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    if on("6b"):
        t0 = time.perf_counter()
        summary, path_launches = serve_deepseek_bf16(torch)
        add(path_launches)
        say(f"[6b serve deepseek-v2 bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    flash_cases = [(dtype, hkv, s, {}) for dtype in ("float32", "bfloat16")
                   for hkv in (32, 4) for s in (1024, 1000)] + [
        (dtype, hkv, s, shape) for dtype in ("float32", "bfloat16")
        for hkv, s, shape in FLASH_MODEL_CASES + FLASH_FMA_CASES]
    for dtype, hkv, s, shape in flash_cases if on("7") else ():
        t0 = time.perf_counter()
        row = phase_flash(torch, timer, dtype, s, hkv,
                          timed=s in (1024, 1500, 448, 64), **shape)
        kernels[("flash", dtype, hkv, s, shape.get("d", 64),
                 shape.get("sk", s))] = row
        shown = " ".join(f"{k}={shape[k]}" for k in ("b", "h", "d", "sk")
                         if k in shape)
        say(f"[7 flash {dtype} S={s} Hkv={hkv}"
            f"{' ' + shown if shown else ''}"
            f"{' full' if not shape.get('causal', True) else ''}] variant "
            f"{row['variant']} max_abs_err {row['max_abs_err']:.3g}" + (
                f"; ms {row['ms']:.4f} profiler "
                f"{fmt_ms(row['profiler_ms'])} plain {row['plain_ms']:.4f} "
                f"library {row['library_ms']:.4f} bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})" + (
                    f"; by query rows a block (query_rows {row['rows']}): "
                    + ", ".join(f"{r} {t:.4f} ms" for r, t in
                                row["ms_by_rows"].items())
                    if "ms_by_rows" in row else "") + f" [{card}]"
                if "ms" in row else "") +
            f" {time.perf_counter() - t0:.1f} s")
    for dtype in ("float32", "bfloat16") if on("8") else ():
        for n in (128, 64):
            for s in (1024, 1000):
                t0 = time.perf_counter()
                row = phase_ssd(torch, timer, dtype, s, n, timed=s == 1024)
                kernels[("ssd", dtype, n, s)] = row
                sh = row["shares"]
                fma = (f"; fma kernel, same inputs: max_abs_err "
                       f"{row['fma']['max_abs_err']:.3g}, share of limit y "
                       f"{row['fma']['y']:.3f} final "
                       f"{row['fma']['final']:.3f}" if "fma" in row else "")
                say(f"[8 ssd {dtype} S={s} N={n}] variant {row['variant']} "
                    f"max_abs_err {row['max_abs_err']:.3g}, share of limit "
                    f"y {sh['y']:.3f} final {sh['final']:.3f}{fma}" + (
                        f"; ms {row['ms']:.4f} profiler "
                        f"{fmt_ms(row['profiler_ms'])} plain "
                        f"{row['plain_ms']:.4f} "
                        f"bound {row['bound_ms']:.4f} ({row['bound_by']}) "
                        f"[{card}]" if "ms" in row else "") +
                    f" {time.perf_counter() - t0:.1f} s")

    for arch in ("mamba2-1.3b", "zamba2-1.2b") if on("9") else ():
        t0 = time.perf_counter()
        line = model_fp32(torch, arch)
        say(f"[9 model fp32] {line} {time.perf_counter() - t0:.1f} s")
    for arch in ("mamba2-1.3b", "zamba2-1.2b") if on("10") else ():
        t0 = time.perf_counter()
        summary, path_launches = model_bf16(torch, arch)
        add(path_launches)
        say(f"[10 model bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    if on("11"):
        t0 = time.perf_counter()
        say(f"[11 sampler] {phase_sampler(torch, timer)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    if on("12"):
        t0 = time.perf_counter()
        lines, path_launches = serve_spec_fp32(torch)
        add(path_launches)
        for line in lines:
            say(f"[12 spec fp32] {line}")
        say(f"[12 spec fp32] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lines, path_launches = serve_spec_bf16(torch)
        add(path_launches)
        for line in lines:
            say(f"[12 spec bf16] {line} [{card}]")
        say(f"[12 spec bf16] {time.perf_counter() - t0:.1f} s")

    for phase, fn in (("13", lambda: serve_swap_bf16(torch)),
                      ("13b", lambda: serve_swap_bf16(torch, spec_k=4)),
                      ("13c", lambda: serve_migrate_bf16(torch))):
        if not on(phase):
            continue
        t0 = time.perf_counter()
        summary, path_launches = fn()
        add(path_launches)
        name = {"13": "swap", "13b": "spec swap", "13c": "migrate"}[phase]
        say(f"[{phase} {name} bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    for arch in MOE_ARCHS if on("14a") else ():
        line, path_launches = moe_fp32(torch, arch)
        add(path_launches)
        say(f"[14a moe fp32] {line}")
    for arch, b in (("olmoe-1b-7b", 4), ("deepseek-v2-236b", 2)) \
            if on("14b") else ():
        t0 = time.perf_counter()
        summary, path_launches = moe_bf16(torch, arch, b)
        add(path_launches)
        say(f"[14b moe bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    for arch in FAMILY_ARCHS if on("15a") else ():
        line, path_launches = family_fp32(torch, arch)
        add(path_launches)
        say(f"[15a family fp32] {line}")
    for arch, b, s, n_patches in (("whisper-base", 4, 448, 0),
                                  ("qwen2-vl-72b", 2, 1024, 256)) \
            if on("15b") else ():
        t0 = time.perf_counter()
        summary, path_launches = family_bf16(torch, arch, b, s, n_patches)
        add(path_launches)
        say(f"[15b family bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    for case in ("flash", "short", "cross", "ssd") if on("16a") else ():
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            row = phase_autograd(torch, timer, case, dtype)
            say(f"[16a autograd {case} {dtype}] variant {row['variant']}: "
                f"kernel vs plain forward max_abs_err "
                f"{row['max_abs_err']:.3g}, relative L2 {row['rel_l2']:.3g}; "
                f"output and every gradient byte-equal (Function vs kernel "
                f"call, backward vs plain autograd), one launch a forward; "
                f"kernel fwd {row['fwd_ms']:.4f} ms, backward "
                f"{row['bwd_ms']:.4f} ms ({row['bwd_over_fwd']:.1f}x), "
                f"plain fwd + bwd {row['plain_fwd_bwd_ms']:.4f} ms [{card}] "
                f"{time.perf_counter() - t0:.1f} s")
    for arch in ("tinyllama-1.1b", "mamba2-1.3b") if on("16b") else ():
        t0 = time.perf_counter()
        line, path_launches = train_grad(torch, arch)
        add(path_launches)
        say(f"[16b full-width gradient] {line} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    for seed in GRAD_SEEDS if on("16b-seeds") else ():
        t0 = time.perf_counter()
        line, _ = grad_seed_hold(torch, seed)
        say(f"[16b-seeds] {line} [{card}] {time.perf_counter() - t0:.1f} s")
    if on("16c"):
        t0 = time.perf_counter()
        summary, path_launches = train_full_width(torch)
        add(path_launches)
        say(f"[16c trainer bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    if on("16d"):
        t0 = time.perf_counter()
        line, path_launches = train_restart(torch)
        add(path_launches)
        say(f"[16d checkpoint restart] {line} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    if on("17a"):
        t0 = time.perf_counter()
        summary, path_launches = serve_launcher(torch)
        add(path_launches)
        say(f"[17a serve launcher] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    if on("17b"):
        t0 = time.perf_counter()
        summary, path_launches = sharded_step(torch)
        add(path_launches)
        say(f"[17b sharded step] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    if on("17c"):
        t0 = time.perf_counter()
        recs, table = dryrun_records(torch)
        for cell, rec in recs.items():
            say(f"[17c dry run {cell}] {json.dumps(rec)}")
        for cell, rec in recs.items():
            if rec["kind"] == "train":
                say(f"[17c per device {cell}] flops "
                    f"{rec['flops_per_device']:.4g} bytes "
                    f"{rec['bytes_accessed_per_device']:.4g} collective "
                    f"bytes {rec['collective_bytes_per_device']:.4g} "
                    f"(torch {torch.__version__})")
        for line in table.splitlines():
            if line.startswith(("| tinyllama", "| olmoe")):
                say(f"[17c roofline H100] {line}")
        say(f"[17c dry run] {time.perf_counter() - t0:.1f} s")
    if on("17d"):
        t0 = time.perf_counter()
        lines, path_launches = split_bodies(torch)
        add(path_launches)
        for line in lines:
            say(f"[17d split bodies] {line} [{card}]")
        say(f"[17d split bodies] {time.perf_counter() - t0:.1f} s")

    serving_ex = ExampleServing(torch) if on("18a") or on("18b") else None
    for scheduler in ("chunked", "packed") if on("18a") else ():
        t0 = time.perf_counter()
        summary, path_launches = serve_example(serving_ex, scheduler)
        add(path_launches)
        say(f"[18a serve example {scheduler}] {json.dumps(summary)} "
            f"[{card}] {time.perf_counter() - t0:.1f} s")
    if on("18b"):
        t0 = time.perf_counter()
        summary, path_launches = serve_example_stall(serving_ex)
        add(path_launches)
        say(f"[18b serve example stall] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    if serving_ex is not None:
        serving_ex.close()
    if on("18c"):
        t0 = time.perf_counter()
        summary, path_launches = train_example(torch)
        add(path_launches)
        say(f"[18c train example] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    if only is None:
        table = []
        # The bf16 variant's launches of flash and packed: all of the
        # kernel's less those of its other variants, which every phase
        # that runs them counts by name (the fp32 paths and 18c).
        for kernel in ("flash_attention", "packed_prefill_attention"):
            launches[f"{kernel}:wgmma"] = launches.get(kernel, 0) - sum(
                launches.get(f"{kernel}:{v}", 0) for v in ("tf32x3", "fma"))
        # (phase row, table name, main-path launch key): one row a kernel,
        # one a variant for flash and packed (each with its own launches;
        # paged and SSD count all of theirs)
        for key, name, count in (
                (("paged", "bfloat16"), "paged_attention", "paged_attention"),
                (("packed", "bfloat16", 8), "packed_prefill_attention",
                 "packed_prefill_attention:wgmma"),
                (("packed", "float32", 8), "packed_prefill_attention_tf32x3",
                 "packed_prefill_attention:tf32x3"),
                (("flash", "bfloat16", 32, 1024, 64, 1024), "flash_attention",
                 "flash_attention:wgmma"),
                (("flash", "float32", 32, 1024, 64, 1024),
                 "flash_attention_tf32x3", "flash_attention:tf32x3"),
                (("flash", "float32", 2, 64, 16, 64), "flash_attention_fma",
                 "flash_attention:fma"),
                (("ssd", "bfloat16", 128, 1024), "ssd_scan", "ssd_scan"),
                *((("fused", "bfloat16", op, "decode"), op,
                   f"fused_block:{op}") for op in FUSED_OPS),
                (("mla", "decode"), "mla_decode", "mla_attention:decode"),
                (("mla", "prefill"), "mla_prefill", "mla_attention:prefill"),
                (("mla", "store", "decode"), "mla_latent_store",
                 "mla_attention:latent_store")):
            row = {k: v for k, v in kernels[key].items()
                   if k not in ("errs", "splits", "no_keys_profiler_ms",
                                "long_row", "shares", "fma", "rows",
                                "ms_by_rows", "keys")}
            row["name"] = name
            row["launches"] = launches.get(count, 0)
            if not row["launches"]:
                raise AssertionError(f"{name}: no launch on the main path")
            table.append(row)
        say(json.dumps({"kernels": table}))
    else:
        # a subset checked: no kernel table and no result line, so a
        # partial run cannot be read as the full pass
        say(f"[partial] phases {sorted(only)} only; no kernel table, no "
            f"result")
        say(card)
        return 0
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
