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
   chunk's shapes (C = 264 lanes, 1 and 8 segments), likewise, each row
   naming the variant that ran (``wgmma`` for bf16, ``fma`` for fp32) and
   the device time of one launch read from ``torch.profiler`` beside the
   CUDA-event mean;
4b. the packed-prefill kernel at the speculative verify
   chunk's layout, built by the engine's ``verify_lanes``: TinyLlama's
   widths, max_batch 8 x (spec_k 4 + 1) = 40 lanes, draft depths 0-4 so
   dead lanes sit between segments, one row unoccupied, two rows whose
   dead lanes lie past their page run; fp32 (``fma``) and bf16
   (``wgmma``); dead lanes must be exactly 0; times as phase 4;
5. serving TinyLlama-1.1B at full width in fp32 (seeded random weights)
   under the ``chunked`` and ``packed`` schedulers, holding the greedy
   tokens against the model's contiguous-cache decode;
6. serving TinyLlama-1.1B in bf16 (its config's dtype) under ``packed``:
   16 requests, every one must complete, both kernels must launch, every
   packed launch must be the tensor-core variant, 22 (one a layer) per
   packed chunk, and every paged launch the ``mma`` variant, 22 per decode
   step;
7. the flash-attention kernel against its plain version at the models'
   full-sequence shapes (B = 4, S = 1024 and 1000, H = 32 with Hkv = 32
   as Zamba2 and Hkv = 4 as TinyLlama, D = 64), fp32 and bf16, with
   kernel, plain, library (one causal GQA ``scaled_dot_product_attention``
   call) and bound times, the variant and the profiler's device time, as
   in phase 4;
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
   packed launch is a prefill or verify layer of the ``fma`` variant and
   no paged launch runs; the accept rate and verify launches are printed,
   and whether the verify chunk's x_last lane rewrites position ctx-1
   with the decode step's bytes.  In bf16, ``spec_k=4`` greedy under
   ``packed``: every request completes and every verify launch is the
   ``wgmma`` variant; agreement with plain bf16 greedy is printed;
13. the swap tier in bf16: four low-priority requests fill the batch and a
   132-page pool, two high-priority arrivals preempt them mid-decode into
   the host arena; every stream equals its uncontended run token for
   token, preemptions >= 1 and resumed == preemptions, and after close no
   arena slot is used and the pool is whole; the page moves' host seconds
   are printed;
14. the kernel table as one JSON line (each row with the variant of the
   main path; the packed row's launches count the verify chunks of phase
   12), the card line, and the result line ``{"ok": true, "device":
   {...}}`` last.

Bounds use the published H100 SXM peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s fp32 outside them.  It imports
nothing of JAX and nothing of the JAX package.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
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
                  "combine_kernel")
FLASH_KERNELS = ("flash_attention_kernel", "flash_tc_kernel")
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


def packed_case(torch, dtype, n_segs, seed=4):
    """Packed-chunk shapes: C = 264 lanes (256-token budget + 8 decode
    riders).  With 8 segments: a padding run in the middle of the chunk,
    three one-lane decode riders, and segment 1 sharing its first eight
    physical pages (a 64-token prefix-cache hit) with segment 0."""
    c, h, hkv, d, page, npg = 264, 32, 4, 64, 8, 128
    n_phys = 2048
    rng = np.random.RandomState(seed + n_segs)
    dt = getattr(torch, dtype)
    seg = np.full((c,), -1, np.int32)
    pos = np.zeros((c,), np.int32)
    if n_segs == 1:
        spans = [(0, 0, 256, 512)]        # (segment, first lane, n, start)
    else:
        spans = [(0, 0, 96, 0), (1, 109, 64, 64), (2, 173, 40, 200),
                 (3, 213, 32, 424), (4, 245, 16, 800), (5, 261, 1, 1000),
                 (6, 262, 1, 700), (7, 263, 1, 37)]   # lanes 96..108: padding
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


def phase_packed(torch, timer, dtype, n_segs, case=None):
    """One packed-prefill row: the packed chunk of ``n_segs`` segments, or
    ``case`` (inputs as :func:`packed_case` returns them)."""
    from repro_torch.kernels import packed_prefill as pp
    (q, kp, vp, rows, seg, pos, ctx), (rows_np, seg_np, pos_np, ctx_np) = \
        case or packed_case(torch, dtype, n_segs)
    want = pp.packed_prefill_plain(q, kp, vp, rows, seg, pos, ctx)
    variant = pp.kernel_variant(q.dtype, q.shape[2], q.shape[1] // kp.shape[2],
                                q.device)
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
    from repro_torch.kernels import packed_prefill, paged_attention
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
        t0 = time.perf_counter()
        handles = session.submit_many(prompts, max_new_tokens=n_new)
        outs = [hnd.result(timeout=600) for hnd in handles]
        wall = time.perf_counter() - t0
        launches = {"paged_attention": paged_attention.launches.count,
                    "packed_prefill_attention":
                        packed_prefill.launches.count}
        packed_tc = packed_prefill.launches.of("wgmma")
        paged_tc = paged_attention.launches.of("mma")
        stats = session.stats()["totals"]
    finally:
        session.close()
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
    if not (paged_tc == launches["paged_attention"] and
            paged_tc % cfg.n_layers == 0):
        raise AssertionError(
            f"bf16: paged launches {launches['paged_attention']} (mma "
            f"variant {paged_tc}), want every one the mma variant, "
            f"{cfg.n_layers} (one a layer) per decode step")
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
        "decode_steps": paged_tc // cfg.n_layers}
    return summary, launches


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


def check_verify_launches(label, cfg, totals, counts, variant):
    """Spec mode replaces the decode step: every packed launch is one
    layer of a prefill chunk or of a verify chunk, all ``variant``; no
    paged launch.  Returns the verify launches."""
    n_l = cfg.n_layers
    rounds, chunks = totals["spec_rounds"], totals["prefill_chunks"]
    total = counts["packed_prefill_attention"]
    if rounds < 1 or total != n_l * (chunks + rounds) or \
            counts["packed_by_variant"].get(variant, 0) != total or \
            counts["paged_attention"]:
        raise AssertionError(
            f"{label}: packed launches {counts['packed_by_variant']} for "
            f"{chunks} prefill chunks and {rounds} verify rounds (want "
            f"{n_l} per chunk, all {variant}), paged "
            f"{counts['paged_attention']} (want 0)")
    return n_l * rounds


def xlast_rewrite(torch, model, params, prompt):
    """The verify chunk's x_last lane rewrites position ctx-1 each round.
    Against what the decode step writes there for the same token (a
    (B, 1, d) product through the paged kernel, where the verify lane is a
    (1, LV, d) product through the packed kernel): are the K/V bytes of
    that slot equal in every layer?  Returns (equal, max |K diff|,
    max |V diff|)."""
    from repro_torch import serving
    session = serving.serve(model, params, serving.ServingConfig(
        spec_k=4, num_pages=256, max_batch=4, max_seq_len=512,
        prefill_chunk_tokens=128), device=DEVICE, start=False)
    shard = session.engine.shards[0]
    try:
        session.submit(prompt, max_new_tokens=8)
        with torch.inference_mode():
            while not shard._active:
                shard.step()                 # prefill; spec mode emits none
            seq = shard._active[0]
            pos = len(seq.tokens) - 1
            page = int(seq.page_row[pos // shard.page_size])
            slot = pos % shard.page_size

            def kv():
                return (shard.k_pages[:, page, slot].clone(),
                        shard.v_pages[:, page, slot].clone())
            shard._decode_batch([seq])       # the decode step's write
            dk, dv = kv()
            shard.step()                     # one round: lane 0 rewrites
            vk, vv = kv()
    finally:
        session.close()
    return (bool(torch.equal(dk, vk) and torch.equal(dv, vv)),
            float((dk.float() - vk.float()).abs().max()),
            float((dv.float() - vv.float()).abs().max()))


def serve_spec_fp32(torch):
    """Phase 12: sampled and speculative serving, fp32, TinyLlama-1.1B at
    published widths (seeded weights).  Returns (lines, launches)."""
    from repro_torch import serving
    from repro_torch.configs import get_config
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

    def add(counts):
        for name in ("paged_attention", "packed_prefill_attention"):
            launches[name] = launches.get(name, 0) + counts[name]

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
                                     "fma")
    lines.append(f"spec_k 4 greedy: 4/4 requests match plain greedy "
                 f"({held('spec greedy', outs, refs_g)}); accept rate "
                 f"{totals['accept_rate']:.3f} ({totals['draft_accepted']}/"
                 f"{totals['draft_proposed']}); {totals['spec_rounds']} "
                 f"rounds, verify launches {n_verify} "
                 f"(packed by variant {counts['packed_by_variant']})")
    spol = serving.TemperatureSampling(temperature=0.8, seed=7)
    runs = []
    for _ in range(2):
        outs, totals, counts = serve_run(torch, model, params, prompts,
                                         n_new, sampling=spol, spec_k=4,
                                         scheduler="packed", **conf)
        add(counts)
        check_verify_launches("spec sampled fp32", cfg, totals, counts,
                              "fma")
        runs.append((outs, totals["accept_rate"]))
    if runs[0][0] != runs[1][0] or any(len(o) != n_new for o in runs[0][0]):
        raise AssertionError("spec sampled: a fresh session gave other "
                             "tokens")
    lines.append(f"spec_k 4 sampled T 0.8 packed: identical in two fresh "
                 f"sessions, accept rate {runs[0][1]:.3f}")
    eq, dk, dv = xlast_rewrite(torch, model, params, prompts[1])
    lines.append(f"x_last rewrite of position ctx-1 (verify lane vs decode "
                 f"step): bytes {'equal' if eq else 'differ'} (max |dK| "
                 f"{dk:.3g}, |dV| {dv:.3g})")
    del params
    torch.cuda.empty_cache()
    return lines, launches


def serve_spec_bf16(torch):
    """Phase 12, bf16: speculative greedy decoding through the wgmma verify
    chunk; every request completes, every verify launch is the wgmma
    variant.  Agreement with plain bf16 greedy is reported, not held:
    two bf16 kernels round differently, and random weights leave many
    near-ties at bf16's resolution."""
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
                prefill_chunk_tokens=256, scheduler="packed")
    t0 = time.perf_counter()
    outs, totals, counts = serve_run(torch, model, params, prompts, n_new,
                                     warm=True, spec_k=4, **conf)
    wall = time.perf_counter() - t0
    if any(len(o) != n_new for o in outs):
        raise AssertionError("spec bf16: a request came back short")
    n_verify = check_verify_launches("spec greedy bf16", cfg, totals, counts,
                                     "wgmma")
    plain, _, _ = serve_run(torch, model, params, prompts, n_new, **conf)
    same = sum(a == b for o, p in zip(outs, plain) for a, b in zip(o, p))
    eq, dk, dv = xlast_rewrite(torch, model, params, prompts[0])
    del params
    torch.cuda.empty_cache()
    line = (f"bf16 spec_k 4 greedy packed: 8/8 requests complete in "
            f"{wall:.2f} s, accept rate {totals['accept_rate']:.3f}, "
            f"{totals['spec_rounds']} rounds, verify launches {n_verify} "
            f"all wgmma (packed by variant {counts['packed_by_variant']}); "
            f"tokens equal to plain bf16 greedy {same}/{8 * n_new}; x_last "
            f"rewrite bytes {'equal' if eq else 'differ'} (max |dK| "
            f"{dk:.3g}, |dV| {dv:.3g})")
    return line, {"packed_prefill_attention":
                  counts["packed_prefill_attention"],
                  "paged_attention": counts["paged_attention"]}


def serve_swap_bf16(torch):
    """Phase 13: the swap tier in bf16, TinyLlama-1.1B at published widths.
    Four low-priority requests fill the batch and the 132-page pool; two
    high-priority arrivals preempt them mid-decode into the host arena.
    Every stream equals its uncontended run (one request at a time on a
    large pool) token for token — a victim gets every written position
    back bit for bit and resumes straight into decode — preemptions >= 1,
    resumed == preemptions, and after close the arena and the pool are
    whole.  Returns (summary, launches)."""
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
                prefill_chunk_tokens=128)
    # uncontended: one request at a time on a pool that never fills
    session = serving.serve(model, params, serving.ServingConfig(
        num_pages=1024, **base), device=DEVICE)
    try:
        refs = [session.submit(p, max_new_tokens=n).result(timeout=600)
                for p, n in [(p, n_lo) for p in lows] +
                [(p, n_hi) for p in highs]]
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
    if totals["failed"] or totals["preemptions"] < 1 or \
            totals["resumed"] != totals["preemptions"]:
        raise AssertionError(f"swap: preemptions {totals['preemptions']}, "
                             f"resumed {totals['resumed']}, failed "
                             f"{totals['failed']}")
    if shard.swap_arena.slots_used() or \
            shard.pool.free_count() != n_pages:
        raise AssertionError(f"swap: leaked {shard.swap_arena.slots_used()}"
                             f" arena slots, pool {shard.pool.free_count()}"
                             f"/{n_pages} free")
    for i, (out, want) in enumerate(zip(outs, refs)):
        if out != want:
            j = next((j for j, (a, b) in enumerate(zip(out, want))
                      if a != b), min(len(out), len(want)))
            raise AssertionError(
                f"swap: request {i} (preempted {preempted[i]}x) differs "
                f"from its uncontended run at token {j} of {len(out)}")
    del params
    torch.cuda.empty_cache()
    summary = {"requests": len(outs), "preemptions": totals["preemptions"],
               "resumed": totals["resumed"],
               "preempted_per_request": preempted,
               "pages_out": totals["swapped_out"],
               "pages_in": totals["swapped_in"],
               "page_bytes": shard.swap_arena.slot_nbytes,
               "swap_out_s": st["swap_out_s"], "swap_in_s": st["swap_in_s"],
               "wall_s": wall,
               "tokens": "all identical to the uncontended runs",
               "arena_slots_used_after": shard.swap_arena.slots_used(),
               "pool_free_after": shard.pool.free_count()}
    return summary, {"packed_prefill_attention":
                     counts["packed_prefill_attention"],
                     "paged_attention": counts["paged_attention"]}


# ----------------------------------------------------------- phase 7


def phase_flash(torch, timer, dtype, s, hkv, timed, seed=7):
    """Causal attention at a model's full-sequence shape: B = 4, H = 32,
    D = 64, S tokens, Hkv kv heads.  Returns a row (times only if
    ``timed``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, h, d = 4, 32, 64
    rng = np.random.RandomState(seed + s + hkv)
    dt = getattr(torch, dtype)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(DEVICE, dt) for shape in
        ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    want = fa.flash_attention_plain(q, k, v, causal=True)
    variant = fa.kernel_variant(q.dtype, d, q.device)
    before = fa.launches.of(variant)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fa.launches.of(variant) != before + 1:
        raise AssertionError(f"flash_attention[S={s}, Hkv={hkv}]: the "
                             f"{variant} variant did not launch")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"flash_attention[S={s}, Hkv={hkv}]: "
                             f"non-finite")
    row = {"name": "flash_attention", "route": "cuda", "variant": variant,
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": FLASH_TPU,
           "max_abs_err": close_enough(out, want, TOL[dtype])}
    del want
    if not timed:
        return row
    elt = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * elt
    flops = 4.0 * b * h * d * s * (s + 1) / 2
    qt, kt, vt = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    row["ms"] = timer.ms(lambda: fa.flash_attention(q, k, v, causal=True))
    row["profiler_ms"] = profiled_ms(
        torch, timer, lambda: fa.flash_attention(q, k, v, causal=True),
        FLASH_KERNELS)
    row["plain_ms"] = timer.ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5)
    row["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ops

    # fp32 products stay fp32 (the reference is held at 3e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"[1 card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ops.prepare("cuda")
    say(f"[2 build] kernels built in {time.perf_counter() - t0:.1f} s")

    timer = Timer(torch)
    kernels = {}
    for dtype in ("float32", "bfloat16"):
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
    for dtype in ("float32", "bfloat16"):
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

    for dtype in ("float32", "bfloat16"):
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

    t0 = time.perf_counter()
    for line in serve_fp32(torch):
        say(f"[5 serve fp32] {line}")
    say(f"[5 serve fp32] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    summary, launches = serve_bf16(torch)
    say(f"[6 serve bf16] {json.dumps(summary)} [{card}] "
        f"{time.perf_counter() - t0:.1f} s")

    for dtype in ("float32", "bfloat16"):
        for hkv in (32, 4):
            for s in (1024, 1000):
                t0 = time.perf_counter()
                row = phase_flash(torch, timer, dtype, s, hkv,
                                  timed=s == 1024)
                kernels[("flash", dtype, hkv, s)] = row
                say(f"[7 flash {dtype} S={s} Hkv={hkv}] variant "
                    f"{row['variant']} max_abs_err "
                    f"{row['max_abs_err']:.3g}" + (
                        f"; ms {row['ms']:.4f} profiler "
                        f"{fmt_ms(row['profiler_ms'])} plain "
                        f"{row['plain_ms']:.4f} "
                        f"library {row['library_ms']:.4f} bound "
                        f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                        f"[{card}]" if "ms" in row else "") +
                    f" {time.perf_counter() - t0:.1f} s")
    for dtype in ("float32", "bfloat16"):
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

    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        t0 = time.perf_counter()
        line = model_fp32(torch, arch)
        say(f"[9 model fp32] {line} {time.perf_counter() - t0:.1f} s")
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        t0 = time.perf_counter()
        summary, path_launches = model_bf16(torch, arch)
        for name, count in path_launches.items():
            launches[name] = launches.get(name, 0) + count
        say(f"[10 model bf16] {json.dumps(summary)} [{card}] "
            f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    say(f"[11 sampler] {phase_sampler(torch, timer)} [{card}] "
        f"{time.perf_counter() - t0:.1f} s")

    def add(path_launches):
        for name, count in path_launches.items():
            launches[name] = launches.get(name, 0) + count

    t0 = time.perf_counter()
    lines, path_launches = serve_spec_fp32(torch)
    add(path_launches)
    for line in lines:
        say(f"[12 spec fp32] {line}")
    say(f"[12 spec fp32] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    line, path_launches = serve_spec_bf16(torch)
    add(path_launches)
    say(f"[12 spec bf16] {line} [{card}] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    summary, path_launches = serve_swap_bf16(torch)
    add(path_launches)
    say(f"[13 swap bf16] {json.dumps(summary)} [{card}] "
        f"{time.perf_counter() - t0:.1f} s")

    table = []
    for key, name in ((("paged", "bfloat16"), "paged_attention"),
                      (("packed", "bfloat16", 8),
                       "packed_prefill_attention"),
                      (("flash", "bfloat16", 32, 1024), "flash_attention"),
                      (("ssd", "bfloat16", 128, 1024), "ssd_scan")):
        row = {k: v for k, v in kernels[key].items()
               if k not in ("errs", "splits", "no_keys_profiler_ms",
                            "long_row", "shares", "fma")}
        row["launches"] = launches[name]
        table.append(row)
    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
