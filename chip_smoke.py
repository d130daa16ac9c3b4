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
   bound times;
4. the packed-prefill kernel against its plain version at the packed
   chunk's shapes (C = 264 lanes, 1 and 8 segments), likewise;
5. serving TinyLlama-1.1B at full width in fp32 (seeded random weights)
   under the ``chunked`` and ``packed`` schedulers, holding the greedy
   tokens against the model's contiguous-cache decode;
6. serving TinyLlama-1.1B in bf16 (its config's dtype) under ``packed``:
   16 requests, every one must complete, both kernels must launch;
7. the kernel table as one JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

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
    errs = {}
    for ns in (None, 3, 8):
        out = pa.paged_attention(q, kp, vp, bt, ctx, occupancy=occ,
                                 num_splits=ns)
        torch.cuda.synchronize()
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
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": PAGED_TPU, "max_abs_err": errs[None],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "errs": {str(k): v for k, v in errs.items()},
            "splits": pa.default_num_splits(b, hkv, n_pages)}


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


def phase_packed(torch, timer, dtype, n_segs):
    from repro_torch.kernels import packed_prefill as pp
    (q, kp, vp, rows, seg, pos, ctx), (rows_np, seg_np, pos_np, ctx_np) = \
        packed_case(torch, dtype, n_segs)
    want = pp.packed_prefill_plain(q, kp, vp, rows, seg, pos, ctx)
    out = pp.packed_prefill_attention(q, kp, vp, rows, seg, pos, ctx)
    torch.cuda.synchronize()
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
            "source": "src/repro_torch/kernels/csrc/packed_prefill.cu",
            "replaces": PACKED_TPU, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


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
        stats = session.stats()["totals"]
    finally:
        session.close()
    if any(len(o) != n_new for o in outs) or stats["failed"]:
        raise AssertionError(f"bf16: not every request completed with "
                             f"{n_new} tokens ({[len(o) for o in outs]})")
    if min(launches.values()) < 1:
        raise AssertionError(f"bf16: a kernel never launched: {launches}")
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
        "launches": launches}
    return summary, launches


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
        say(f"[3 paged {dtype}] max_abs_err by num_splits {row['errs']} "
            f"(default splits {row['splits']}); ms {row['ms']:.4f} plain "
            f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) [{card}] "
            f"{time.perf_counter() - t0:.1f} s")
    for dtype in ("float32", "bfloat16"):
        for n_segs in (1, 8):
            t0 = time.perf_counter()
            row = phase_packed(torch, timer, dtype, n_segs)
            kernels[("packed", dtype, n_segs)] = row
            say(f"[4 packed {dtype} S={n_segs}] max_abs_err "
                f"{row['max_abs_err']:.3g}; ms {row['ms']:.4f} plain "
                f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']}) [{card}] "
                f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for line in serve_fp32(torch):
        say(f"[5 serve fp32] {line}")
    say(f"[5 serve fp32] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    summary, launches = serve_bf16(torch)
    say(f"[6 serve bf16] {json.dumps(summary)} [{card}] "
        f"{time.perf_counter() - t0:.1f} s")

    table = []
    for key, name in ((("paged", "bfloat16"), "paged_attention"),
                      (("packed", "bfloat16", 8),
                       "packed_prefill_attention")):
        row = {k: v for k, v in kernels[key].items()
               if k not in ("errs", "splits")}
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
