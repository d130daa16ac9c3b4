"""The hand-written CUDA kernels held against their plain PyTorch versions
on the card, at small shapes that the models and the serving path do not
reach (GQA groups 1–8, head dims 16–64, pages of 4–16, split counts that
do not divide the page count, ragged lane blocks, sequence lengths that no
tile or chunk divides, several SSD groups).

Every test here needs a CUDA device and skips without one; this module
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Flash attention at D = 192 (DeepSeek-V2's MLA prefill, V padded from
128) is held in both variants, with and without V's zero padding.

The bf16 tensor-core variants (D = 64 and 128) are held at the lengths,
GQA groups and chunk layouts of the models and the serving engine too:
S from 1 to 2048, groups 1, 4 and 8, causal and cross lengths; the
rider-heavy packed chunk, a segment spanning several key ranges, shared
prefix pages, ragged lane blocks and an all-padding chunk.  Each such test
reads the per-variant launch counter, so a call that went through the
wrong variant fails.

The bf16 paged-decode and SSD kernels' ``mma`` variants are held the
same way: paged at D 64 and 128, GQA groups 1, 4 and 8, pages of 8 and
16, contexts 0 to 2048, an unoccupied row aliasing a live row's pages,
split counts 1, 3 and 8 (the most it runs: one thread-block cluster) and
a count above it refused; SSD at N 64 and 128,
S from 1 to 2048, with and without ``d_skip``, one and two groups, the
final state checked beside y.

Flash attention is held at the two last families' own shapes in both
variants: Whisper-base's encoder (1500 = 23 x 64 + 28 frames, full),
its cross-attention (448 queries to 1500 keys, full) and its decoder's
causal self-attention (H = Hkv = 8, D = 64), and Qwen2-VL-72B's text
backbone (H 64, Hkv 8, D 128, causal); a bf16 Whisper-base forward on
the card launches the ``wgmma`` variant once per attention call, 18 in
all.

The packed kernel is also held at the speculative verify chunk's lane
layout (``serving.engine.verify_lanes``: max_batch x (spec_k + 1) lanes,
dead lanes interleaved between segments, some of their positions past the
row's page run), in both variants; dead lanes must come out exactly 0.
The sampler (plain tensor math, no kernel) is held on the card against
its CPU run: PRNG keys and bits bit-equal, tokens equal.

The decoder block's fused elementwise kernels (add + RMSNorm, q/k
RMSNorm + RoPE + the paged K/V store, SiLU * mul) are held at the serving
engine's layouts (the decode step's 32 rows, the packed chunk's 512
lanes, the spec verify's 160) and the widths of Qwen3-32B and
TinyLlama-1.1B, and off their vector path; padding rows and lanes must
leave every page byte as it was.

The serving engine's decode call, replayed from its CUDA graph
(``serving/decode_graph.py``), is held against the eager call on two tiny
dense models (D 16 on the paged ``fma`` variant, D 128 with q/k norms on
``mma``): logits and pools bit-equal over eight calls whose pools are
overwritten in place between calls, and the same launches by kernel.

The input builders are shared with ``tests/test_torch_kernels.py`` and
``tests/test_torch_spec_swap.py``, which hold the plain versions against
the JAX package on the CPU."""

import itertools

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_block as tfb
from repro_torch.kernels import ops
from repro_torch.kernels import packed_prefill as tpp
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import build_model
from repro_torch.serving.engine import verify_lanes

TOLS = {"float32": dict(rtol=3e-5, atol=3e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}

SSD_TOLS = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=4e-2, atol=4e-2)}

FLASH_SHAPES = [
    # (B, Sq, Sk, H, Hkv, D, bq, bk), as tests/test_kernels.py; the JAX
    # kernel's blocks bq and bk only order the sums
    (1, 64, 64, 4, 4, 16, 32, 32),
    (2, 128, 128, 4, 2, 32, 64, 32),
    (1, 128, 128, 8, 1, 64, 128, 128),   # MQA, full-seq blocks
    (2, 96, 96, 2, 2, 16, 32, 32),       # non-pow2 seq
]

SSD_SHAPES = [
    # (B, S, H, P, G, N, chunk), as tests/test_kernels.py
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 2, 16, 1, 32, 32),
    (2, 32, 8, 8, 4, 8, 32),   # single chunk
]

PAGED_SHAPES = [
    # (B, H, Hkv, D, n_phys, page, n_pages), as tests/test_kernels.py
    (2, 4, 2, 32, 16, 8, 4),
    (3, 8, 8, 16, 32, 16, 6),
    (1, 16, 2, 64, 8, 8, 8),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _paged_inputs(shape, seed, occupancy=False):
    b, h, hkv, d, nphys, page, npg = shape
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nphys, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nphys, page, hkv, d)).astype(np.float32)
    bt = rng.randint(0, nphys, size=(b, npg)).astype(np.int32)
    cl = rng.randint(1, npg * page + 1, size=(b,)).astype(np.int32)
    out = [q, kp, vp, bt, cl]
    if occupancy:
        occ = np.arange(b) % 2 == 0
        # padded rows alias the REAL rows' pages — the mask, not the page
        # contents, must keep them inert
        for i in range(1, b, 2):
            bt[i] = bt[i - 1]
        out.append(occ)
    return out


def _packed_inputs(seed, shared_page=False, c=16):
    """3 segments of 5, 6 and 3 lanes at positions page.., then padding
    up to ``c`` lanes."""
    h, hkv, d, nphys, page, npg = 4, 2, 16, 12, 4, 3
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    kp = rng.standard_normal((nphys, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nphys, page, hkv, d)).astype(np.float32)
    rows = rng.randint(0, nphys, size=(3, npg)).astype(np.int32)
    if shared_page:
        rows[1, 0] = rows[0, 0]   # a prefix-cache hit shares a page
    lens = (5, 6, 3)
    pad = c - sum(lens)
    seg = np.asarray(sum(([i] * n for i, n in enumerate(lens)), []) +
                     [-1] * pad, np.int32)
    pos = np.asarray(sum((list(range(page, page + n)) for n in lens), []) +
                     [0] * pad, np.int32)
    ctx = np.asarray([page + n for n in lens], np.int32)
    return [q, kp, vp, rows, seg, pos, ctx]


# the verify chunk: 8 rows of spec_k + 1 = 5 lanes; draft depths nd mixed
# in 0..4, row 6 unoccupied, row 7 at the end of its 1024-key page run (its
# dead lanes sit at positions 1023..1025, past the run)
VERIFY_CTX = (64, 1000, 130, 377, 200, 640, 1, 1022)
VERIFY_ND = (4, 0, 3, 1, 4, 2, 0, 1)


def _verify_chunk(h, hkv, d, seed, page=8, npg=128, spec_k=4):
    """Packed-kernel inputs at the verify layout, numpy: [q, k_pages,
    v_pages, page_rows, seg_ids, positions, seg_ctx]."""
    rng = np.random.RandomState(seed)
    b = len(VERIFY_CTX)
    occ = np.ones((b,), bool)
    occ[6] = False
    _, pos, seg, seg_ctx = verify_lanes(np.asarray(VERIFY_CTX),
                                        np.asarray(VERIFY_ND), occ, spec_k)
    n_phys = b * npg + 64
    rows = rng.permutation(n_phys)[:b * npg].reshape(b, npg).astype(
        np.int32)
    c = len(seg)
    return [rng.standard_normal((c, h, d)).astype(np.float32),
            rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32),
            rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32),
            rows, seg, pos, seg_ctx]


def _flash_inputs(shape, seed):
    b, sq, sk, h, hkv, d = shape[:6]
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32)]


def _ssd_inputs(shape, seed, d_skip=False, decay=1.0):
    """x, dt, a, b, c (+ d_skip) for one SSD shape, as numpy fp32; dt is
    positive (a softplus) and a negative, as in the model.  ``decay``
    scales a: at 8 the log-decay of a 16-position chunk sums far past 88,
    so a kernel that takes exp() above the diagonal overflows."""
    b, s, h, p, g, n = shape[:6]
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal((h,)) * 0.5) * decay).astype(np.float32)
    bb = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    out = [x, dt, a, bb, cc]
    if d_skip:
        out.append(rng.standard_normal((h,)).astype(np.float32))
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(arrays, dtype, device):
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device=device,
                                   dtype=dt if a.dtype == np.float32
                                   else None)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("num_splits", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_kernel_matches_plain(cuda_device, shape, dtype, num_splits):
    arrays = _paged_inputs(shape, seed=11, occupancy=True)
    t = _on(arrays, dtype, cuda_device)
    before = tpa.launches.count
    out = ops.paged_attention(*t[:5], occupancy=t[5], num_splits=num_splits)
    torch.cuda.synchronize()
    assert tpa.launches.count == before + 1
    want = _np(tpa.paged_attention_plain(*t[:5], t[5]))
    out = _np(out)
    assert np.all(out[~arrays[5]] == 0.0) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, want, **TOLS[dtype])


@pytest.mark.cuda
def test_paged_kernel_zero_context_and_empty_batch(cuda_device):
    """ctx = 0 rows and an all-padding batch come out exactly 0."""
    arrays = _paged_inputs((3, 4, 2, 8, 6, 4, 2), seed=10)
    arrays[4][:] = [0, 5, 0]
    t = _on(arrays, "float32", cuda_device)
    out = _np(ops.paged_attention(*t))
    assert np.all(out[[0, 2]] == 0.0) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, _np(tpa.paged_attention_plain(*t)),
                               **TOLS["float32"])
    none = torch.zeros(3, dtype=torch.bool, device=cuda_device)
    assert np.all(_np(ops.paged_attention(*t, occupancy=none)) == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 21, 40])
@pytest.mark.parametrize("shared_page", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_kernel_matches_plain(cuda_device, dtype, shared_page, c):
    """Including ragged last lane blocks (c = 21, 40)."""
    arrays = _packed_inputs(8, shared_page, c)
    t = _on(arrays, dtype, cuda_device)
    before = tpp.launches.count
    out = ops.packed_prefill_attention(*t)
    torch.cuda.synchronize()
    assert tpp.launches.count == before + 1
    out = _np(out)
    assert np.all(out[arrays[4] < 0] == 0.0) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS[dtype])


@pytest.mark.cuda
def test_packed_kernel_interleaved_segments(cuda_device):
    arrays = _packed_inputs(7)
    seg = np.asarray([0, 0, -1, -1, 1, 0, 1, 1, 2, -1, 2, 2, 1, 0, 2, -1],
                     np.int32)
    pos = np.zeros_like(seg)
    for s in range(3):
        idx = np.flatnonzero(seg == s)
        pos[idx] = 4 + np.arange(len(idx))
    arrays[4], arrays[5] = seg, pos
    arrays[6] = np.asarray([4 + (seg == s).sum() for s in range(3)],
                           np.int32)
    t = _on(arrays, "float32", cuda_device)
    out = _np(ops.packed_prefill_attention(*t))
    assert np.all(out[seg < 0] == 0.0)
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS["float32"])


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(cuda_device):
    t = _on(_paged_inputs(PAGED_SHAPES[0], seed=2), "float32", cuda_device)
    t[3] = t[3].cpu()
    with pytest.raises(ValueError, match="one device"):
        ops.paged_attention(*t)
    p = _on(_packed_inputs(6), "float32", cuda_device)
    p[6] = p[6].cpu()
    with pytest.raises(ValueError, match="one device"):
        ops.packed_prefill_attention(*p)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES + [
    (2, 40, 40, 4, 2, 16),        # no tile divides Sq
    (1, 200, 200, 6, 3, 64),      # several tiles, a ragged last one
])
def test_flash_kernel_matches_plain(cuda_device, shape, dtype, causal):
    t = _on(_flash_inputs(shape, seed=13), dtype, cuda_device)
    before = tfa.launches.count
    out = ops.flash_attention(*t, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches.count == before + 1
    out = _np(out)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=causal)),
        **TOLS[dtype])


@pytest.mark.cuda
def test_flash_kernel_cross_lengths_and_refusal(cuda_device):
    """Sq != Sk is computed when not causal and refused when causal."""
    t = _on(_flash_inputs((2, 24, 70, 4, 1, 32), seed=14), "float32",
            cuda_device)
    np.testing.assert_allclose(
        _np(ops.flash_attention(*t, causal=False)),
        _np(tfa.flash_attention_plain(*t, causal=False)), **TOLS["float32"])
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(*t, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES + [
    (2, 40, 4, 8, 2, 16, 16),      # ragged last chunk, two groups
    (1, 300, 4, 64, 1, 128, 128),  # the Mamba2 widths, ragged
])
@pytest.mark.parametrize("d_skip", [False, True])
def test_ssd_kernel_matches_plain(cuda_device, shape, dtype, d_skip):
    chunk = shape[6]
    arrays = _ssd_inputs(shape, seed=15, d_skip=d_skip)
    t = _on(arrays, dtype, cuda_device)
    t[1], t[2] = t[1].float(), t[2].float()          # dt, a in fp32
    ds = t[5].float() if d_skip else None
    before = tss.launches.count
    y, final = ops.ssd(*t[:5], chunk=chunk, d_skip=ds)
    torch.cuda.synchronize()
    assert tss.launches.count == before + 1
    assert y.dtype == t[0].dtype and final.dtype == torch.float32
    want_y, want_f = tss.ssd_scan_plain(*t[:5], chunk=chunk, d_skip=ds)
    assert np.all(np.isfinite(_np(y)))
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS[dtype])
    np.testing.assert_allclose(_np(final), _np(want_f), **SSD_TOLS[dtype])


@pytest.mark.cuda
def test_ssd_kernel_strong_decay_stays_finite(cuda_device):
    """Log-decay summing past 88 inside a chunk: exp() is taken only on
    and below the diagonal, so nothing overflows into inf * 0."""
    arrays = _ssd_inputs((1, 48, 2, 8, 1, 16), seed=16, decay=8.0)
    t = _on(arrays, "float32", cuda_device)
    y, final = ops.ssd(*t, chunk=16)
    assert np.all(np.isfinite(_np(y))) and np.all(np.isfinite(_np(final)))
    want_y, want_f = tss.ssd_scan_plain(*t, chunk=16)
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS["float32"])
    np.testing.assert_allclose(_np(final), _np(want_f),
                               **SSD_TOLS["float32"])


# ------------------------------------------------ tensor-core variants

TC_FLASH_CAUSAL = [
    # (B, S, H, Hkv, D): every S at both head dims and three GQA groups,
    # B alternating between 1 and 4
    ((1, 4)[i % 2], s, 8, 8 // g, d)
    for i, (d, s, g) in enumerate(itertools.product(
        (64, 128), (1, 40, 64, 1000, 1024, 2048), (1, 4, 8)))
]

TC_FLASH_CROSS = [
    # (B, Sq, Sk, H, Hkv, D), not causal
    (2, 24, 70, 4, 1, 64),
    (1, 100, 1000, 8, 2, 64),
    (4, 1000, 37, 8, 8, 128),
    (1, 64, 2048, 8, 1, 128),
]


def _flash_tc(t, causal):
    before = tfa.launches.of("wgmma")
    out = ops.flash_attention(*t, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches.of("wgmma") == before + 1, "not the wgmma variant"
    out = _np(out)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=causal)),
        **TOLS["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_FLASH_CAUSAL)
def test_flash_tc_causal_matches_plain(cuda_device, shape):
    b, s, h, hkv, d = shape
    t = _on(_flash_inputs((b, s, s, h, hkv, d), seed=s + d + hkv),
            "bfloat16", cuda_device)
    _flash_tc(t, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_FLASH_CROSS)
def test_flash_tc_cross_lengths_match_plain(cuda_device, shape):
    t = _on(_flash_inputs(shape, seed=17), "bfloat16", cuda_device)
    _flash_tc(t, causal=False)


FLASH_FAMILIES = [
    # (B, Sq, Sk, H, Hkv, D, causal)
    (2, 1500, 1500, 8, 8, 64, False),    # Whisper-base encoder
    (2, 448, 1500, 8, 8, 64, False),     # Whisper-base cross-attention
    (2, 448, 448, 8, 8, 64, True),       # Whisper-base decoder
    (1, 1024, 1024, 64, 8, 128, True),   # Qwen2-VL-72B
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [("float32", "tf32x3"),
                                           ("bfloat16", "wgmma")])
@pytest.mark.parametrize("shape", FLASH_FAMILIES)
def test_flash_at_the_whisper_and_qwen2_vl_shapes(cuda_device, shape, dtype,
                                                  variant):
    *dims, causal = shape
    t = _on(_flash_inputs(dims, seed=sum(dims)), dtype, cuda_device)
    before = tfa.launches.of(variant)
    out = ops.flash_attention(*t, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches.of(variant) == before + 1
    out = _np(out)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=causal)),
        **TOLS[dtype])


@pytest.mark.cuda
def test_whisper_forward_launches_wgmma_at_every_attention(cuda_device):
    """Whisper-base in bf16 on the card: one ``wgmma`` flash launch per
    attention call of ``logits_fn``: 6 encoder, 6 decoder self and 6
    cross-attentions."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("whisper-base"))
    params = model.init(seed=0, device=cuda_device)
    cfg = model.cfg
    rng = np.random.RandomState(18)
    frames = torch.from_numpy(rng.standard_normal(
        (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 24))).to(
        cuda_device)
    tfa.launches.reset()
    with torch.inference_mode():
        logits, _ = model.logits_fn(params, {"frames": frames,
                                             "tokens": tokens})
    torch.cuda.synchronize()
    assert tfa.launches.count == tfa.launches.of("wgmma") == 18
    assert logits.shape == (1, 24, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


FLASH_192 = [
    # (B, S, H, Hkv): DeepSeek-V2's MLA prefill runs H = Hkv, D = 192
    (1, 1, 4, 4), (2, 40, 4, 4), (1, 64, 8, 8), (2, 200, 4, 2),
    (1, 1000, 8, 8), (2, 1024, 4, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [("float32", "tf32x3"),
                                           ("bfloat16", "wgmma")])
@pytest.mark.parametrize("pad_v", [False, True])
@pytest.mark.parametrize("shape", FLASH_192)
def test_flash_head_dim_192_matches_plain(cuda_device, shape, pad_v, dtype,
                                          variant):
    """D = 192 (MLA: nope 128 + rope 64) in both variants, causal; with
    ``pad_v`` V's last 64 columns are zero, as MLA pads V from 128, and
    those output columns must come out exactly zero."""
    b, s, h, hkv = shape
    arrays = _flash_inputs((b, s, s, h, hkv, 192), seed=s + h + 192)
    if pad_v:
        arrays[2][..., 128:] = 0.0
    t = _on(arrays, dtype, cuda_device)
    assert tfa.kernel_variant(t[0].dtype, 192, t[0].device) == variant
    before = tfa.launches.of(variant)
    out = ops.flash_attention(*t, causal=True)
    torch.cuda.synchronize()
    assert tfa.launches.of(variant) == before + 1
    out = _np(out)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=True)), **TOLS[dtype])
    if pad_v:
        assert np.all(out[..., 128:] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dim_192_cross_lengths(cuda_device, dtype):
    t = _on(_flash_inputs((2, 70, 300, 4, 2, 192), seed=23), dtype,
            cuda_device)
    np.testing.assert_allclose(
        _np(ops.flash_attention(*t, causal=False)),
        _np(tfa.flash_attention_plain(*t, causal=False)), **TOLS[dtype])


def _packed_chunk(spans, c, h, hkv, d, page, npg, seed, share=0):
    """A chunk of ``c`` lanes from (segment, first lane, lanes, first
    position) spans; other lanes are padding.  Segment 1 shares its first
    ``share`` physical pages with segment 0 (a prefix-cache hit)."""
    n_segs = max(s for s, *_ in spans) + 1 if spans else 1
    n_phys = n_segs * npg + 8
    rng = np.random.RandomState(seed)
    seg = np.full((c,), -1, np.int32)
    pos = np.zeros((c,), np.int32)
    ctx = np.zeros((n_segs,), np.int32)
    for si, lane, n, start in spans:
        seg[lane:lane + n] = si
        pos[lane:lane + n] = np.arange(start, start + n)
        ctx[si] = start + n
    rows = rng.permutation(n_phys)[:n_segs * npg].reshape(n_segs, npg) \
        .astype(np.int32)
    if share:
        rows[1, :share] = rows[0, :share]
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    return [q, kp, vp, rows, seg, pos, ctx]


TC_PACKED_CASES = {
    # name: (spans, C, H, Hkv, page, n_pages, shared pages)
    "riders": ([(0, 0, 96, 0), (1, 109, 64, 64), (2, 173, 40, 200),
                (3, 213, 32, 424), (4, 245, 16, 800), (5, 261, 1, 1000),
                (6, 262, 1, 700), (7, 263, 1, 37)], 264, 32, 4, 8, 128, 8),
    "long_segment": ([(0, 0, 40, 1000)], 40, 16, 2, 16, 72, 0),
    "shared_prefix": ([(0, 0, 30, 0), (1, 30, 20, 96), (2, 50, 3, 10)],
                      53, 8, 2, 16, 8, 6),
    "ragged_lanes": ([(0, 0, 13, 5), (1, 13, 8, 300)], 21, 8, 1, 8, 40, 0),
    "all_padding": ([], 24, 8, 2, 8, 4, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(TC_PACKED_CASES))
def test_packed_tc_matches_plain(cuda_device, case, d):
    spans, c, h, hkv, page, npg, share = TC_PACKED_CASES[case]
    arrays = _packed_chunk(spans, c, h, hkv, d, page, npg, seed=19,
                           share=share)
    t = _on(arrays, "bfloat16", cuda_device)
    before = tpp.launches.of("wgmma")
    out = ops.packed_prefill_attention(*t)
    torch.cuda.synchronize()
    assert tpp.launches.of("wgmma") == before + 1, "not the wgmma variant"
    out = _np(out)
    assert np.all(np.isfinite(out))
    assert np.all(out[arrays[4] < 0] == 0.0), "padding lanes leaked output"
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS["bfloat16"])


@pytest.mark.cuda
def test_packed_tc_lane_past_its_pages_is_zero(cuda_device):
    """A lane whose segment context is 0 (nothing live) comes out exactly
    0 through the combine, never NaN."""
    arrays = _packed_chunk([(0, 0, 8, 0), (1, 8, 8, 16)], 16, 8, 1, 64, 8,
                           8, seed=20)
    arrays[6][1] = 0          # segment 1: no live page
    t = _on(arrays, "bfloat16", cuda_device)
    out = _np(ops.packed_prefill_attention(*t))
    assert np.all(out[8:] == 0.0) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out[:8], _np(tpp.packed_prefill_plain(*t))[:8],
                               **TOLS["bfloat16"])


@pytest.mark.cuda
def test_variants_follow_dtype_and_head_dim(cuda_device):
    """bf16 at D = 64 launches the wgmma variants, fp32 there the 3xTF32
    ones, fp32 and bf16 at D = 16 the FMA ones, as ``kernel_variant``
    says."""
    for dtype, d, want in (("bfloat16", 64, "wgmma"),
                           ("float32", 64, "tf32x3"),
                           ("float32", 16, "fma"), ("bfloat16", 16, "fma")):
        t = _on(_flash_inputs((1, 70, 70, 4, 2, d), seed=21), dtype,
                cuda_device)
        assert tfa.kernel_variant(t[0].dtype, d, t[0].device) == want
        before = tfa.launches.of(want)
        ops.flash_attention(*t, causal=True)
        assert tfa.launches.of(want) == before + 1
        p = _on(_packed_chunk([(0, 0, 10, 3)], 12, 4, 2, d, 8, 4, seed=22),
                dtype, cuda_device)
        assert tpp.kernel_variant(p[0].dtype, d, 2, p[0].device) == want
        before = tpp.launches.of(want)
        ops.packed_prefill_attention(*p)
        assert tpp.launches.of(want) == before + 1
    torch.cuda.synchronize()


# ------------------------------- 3xTF32 variants and the 128-row tiles


def _launch_variant(module, want, fn, *args, **kw):
    """``fn(*args, **kw)`` as numpy, after checking that it launched
    ``module``'s ``want`` variant once."""
    before = module.launches.of(want)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert module.launches.of(want) == before + 1, f"not the {want} variant"
    return _np(out)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("shape", TC_FLASH_CAUSAL[::3] + [
    (1, 1, 4, 4, 192), (2, 40, 4, 2, 192), (1, 1000, 8, 8, 192)])
def test_flash_tf32x3_causal_matches_plain(cuda_device, shape, rows,
                                           monkeypatch):
    """fp32 at D 64, 128 and 192 on the 3xTF32 variant, both tiles (4
    warps on 64 query rows, 8 on 128), within fp32's 3e-5."""
    monkeypatch.setattr(tfa, "query_rows", lambda d: rows)
    b, s, h, hkv, d = shape
    t = _on(_flash_inputs((b, s, s, h, hkv, d), seed=s + d + hkv),
            "float32", cuda_device)
    out = _launch_variant(tfa, "tf32x3", tfa.flash_attention_cuda, *t,
                          causal=True)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=True)),
        **TOLS["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("shape", TC_FLASH_CROSS + [(2, 70, 300, 4, 2, 192)])
def test_flash_tf32x3_cross_lengths_match_plain(cuda_device, shape, rows,
                                                 monkeypatch):
    monkeypatch.setattr(tfa, "query_rows", lambda d: rows)
    t = _on(_flash_inputs(shape, seed=17), "float32", cuda_device)
    out = _launch_variant(tfa, "tf32x3", tfa.flash_attention_cuda, *t,
                          causal=False)
    np.testing.assert_allclose(
        out, _np(tfa.flash_attention_plain(*t, causal=False)),
        **TOLS["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 4, 4, 64), (2, 40, 4, 2, 64),
                                   (1, 130, 8, 1, 128), (2, 200, 4, 2, 192),
                                   (1, 1000, 8, 8, 192),
                                   (1, 2048, 8, 1, 128)])
def test_flash_wgmma_two_warpgroups_match_plain(cuda_device, shape,
                                                monkeypatch):
    """bf16 on the 128-row tile (two consumer warpgroups sharing each K/V
    stage) at every tensor-core D, including a last tile whose second
    warpgroup has no row."""
    monkeypatch.setattr(tfa, "query_rows", lambda d: 128)
    b, s, h, hkv, d = shape
    t = _on(_flash_inputs((b, s, s, h, hkv, d), seed=s + d),
            "bfloat16", cuda_device)
    for causal in (True, False):
        out = _launch_variant(tfa, "wgmma", tfa.flash_attention_cuda, *t,
                              causal=causal)
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(
            out, _np(tfa.flash_attention_plain(*t, causal=causal)),
            **TOLS["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(TC_PACKED_CASES))
def test_packed_tf32x3_matches_plain(cuda_device, case, d):
    spans, c, h, hkv, page, npg, share = TC_PACKED_CASES[case]
    arrays = _packed_chunk(spans, c, h, hkv, d, page, npg, seed=19,
                           share=share)
    t = _on(arrays, "float32", cuda_device)
    out = _launch_variant(tpp, "tf32x3", tpp.packed_prefill_cuda, *t)
    assert np.all(np.isfinite(out))
    assert np.all(out[arrays[4] < 0] == 0.0), "padding lanes leaked output"
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS["float32"])


@pytest.mark.cuda
def test_packed_tf32x3_one_segment_matches_plain(cuda_device):
    """The packed chunk of one prompt (C 256 lanes at positions 512-767,
    H 32, Hkv 4, D 64, 128 pages of 8) in fp32: the 3xTF32 variant within
    3e-5, its grid at least one block an SM."""
    arrays = _packed_chunk([(0, 0, 256, 512)], 256, 32, 4, 64, 8, 128,
                           seed=24)
    assert tpp.work_bounds(256, 1, 128, 8, 8, 4)["grid"] >= tpp.N_SMS
    t = _on(arrays, "float32", cuda_device)
    out = _launch_variant(tpp, "tf32x3", tpp.packed_prefill_cuda, *t)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS["float32"])


# ------------------------------------- paged decode and SSD, mma variants

TC_PAGED_CONTEXTS = (0, 1, 63, 64, 65, 1000, 1024, 2048)


def _paged_decode_case(b, g, d, page, contexts, seed, hkv=2):
    """B rows whose contexts are ``contexts`` over pages enough for 2048
    keys, each row on its own permuted physical pages."""
    n_pages = 2048 // page
    n_phys = b * n_pages + 16
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    kp = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    bt = rng.permutation(n_phys)[:b * n_pages].reshape(b, n_pages) \
        .astype(np.int32)
    ctx = np.asarray(contexts, np.int32)
    return [q, kp, vp, bt, ctx, np.ones((b,), bool)]


def _paged_mma(t, num_splits):
    before = tpa.launches.of("mma")
    out = ops.paged_attention(*t[:5], occupancy=t[5], num_splits=num_splits)
    torch.cuda.synchronize()
    assert tpa.launches.of("mma") == before + 1, "not the mma variant"
    return _np(out)


# None (the default), and explicit counts up to 8, the most the mma
# variant runs (``tpa.max_splits("mma")``: one thread-block cluster)
TC_PAGED_SPLITS = [None, 1, 3, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("num_splits", TC_PAGED_SPLITS)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_mma_matches_plain(cuda_device, d, g, page, num_splits):
    """B = 8 rows at contexts 0 .. 2048; then row 4 unoccupied, its block
    table aliasing the 2048-key row's pages: exactly 0, the rest
    unchanged."""
    arrays = _paged_decode_case(8, g, d, page, TC_PAGED_CONTEXTS,
                                seed=d + g + page)
    t = _on(arrays, "bfloat16", cuda_device)
    out = _paged_mma(t, num_splits)
    assert np.all(np.isfinite(out)) and np.all(out[0] == 0.0)
    want = _np(tpa.paged_attention_plain(*t[:5], t[5]))
    np.testing.assert_allclose(out, want, **TOLS["bfloat16"])
    arrays[3][4] = arrays[3][7]
    arrays[5][4] = False
    t = _on(arrays, "bfloat16", cuda_device)
    out2 = _paged_mma(t, num_splits)
    assert np.all(out2[4] == 0.0) and np.all(out2[0] == 0.0)
    np.testing.assert_allclose(np.delete(out2, 4, 0), np.delete(want, 4, 0),
                               **TOLS["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("num_splits", TC_PAGED_SPLITS)
@pytest.mark.parametrize("d", [64, 128])
def test_paged_mma_single_row(cuda_device, d, num_splits):
    t = _on(_paged_decode_case(1, 8, d, 8, (1000,), seed=31), "bfloat16",
            cuda_device)
    out = _paged_mma(t, num_splits)
    np.testing.assert_allclose(
        out, _np(tpa.paged_attention_plain(*t[:5], t[5])),
        **TOLS["bfloat16"])


@pytest.mark.cuda
def test_paged_mma_refuses_splits_above_its_cluster(cuda_device):
    """The mma variant's splits are one thread-block cluster: an explicit
    count above its most is refused before any launch, not cut."""
    t = _on(_paged_decode_case(8, 8, 64, 8, TC_PAGED_CONTEXTS, seed=32),
            "bfloat16", cuda_device)
    before = tpa.launches.count
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        ops.paged_attention(*t[:5], occupancy=t[5],
                            num_splits=tpa.max_splits("mma") + 1)
    assert tpa.launches.count == before


TC_SSD_CASES = [
    # (B, S, H, G, N, d_skip): every S at both states, with and without
    # d_skip; B alternating between 1 and 4, G between 1 and 2
    ((1, 4)[i % 2], s, 8, (1, 2)[(i // 2) % 2], n, skip)
    for i, (n, s, skip) in enumerate(itertools.product(
        (64, 128), (1, 40, 128, 300, 1000, 1024, 2048), (False, True)))
]


def _ssd_mma(t, ds):
    before = tss.launches.of("mma")
    y, final = ops.ssd(*t[:5], chunk=128, d_skip=ds)
    torch.cuda.synchronize()
    assert tss.launches.of("mma") == before + 1, "not the mma variant"
    return y, final


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_SSD_CASES)
def test_ssd_mma_matches_plain(cuda_device, case):
    b, s, h, g, n, skip = case
    arrays = _ssd_inputs((b, s, h, 64, g, n), seed=s + n, d_skip=skip)
    t = _on(arrays, "bfloat16", cuda_device)
    t[1], t[2] = t[1].float(), t[2].float()          # dt, a in fp32
    ds = t[5].float() if skip else None
    y, final = _ssd_mma(t, ds)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    want_y, want_f = tss.ssd_scan_plain(*t[:5], chunk=128, d_skip=ds)
    assert np.all(np.isfinite(_np(y))) and np.all(np.isfinite(_np(final)))
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS["bfloat16"])
    np.testing.assert_allclose(_np(final), _np(want_f),
                               **SSD_TOLS["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_mma_strong_decay_stays_finite(cuda_device, n):
    """Log-decay summing far past 88 inside a chunk (a scaled by 8)."""
    arrays = _ssd_inputs((1, 300, 4, 64, 1, n), seed=33, decay=8.0)
    t = _on(arrays, "bfloat16", cuda_device)
    t[1], t[2] = t[1].float(), t[2].float()
    y, final = _ssd_mma(t, None)
    assert np.all(np.isfinite(_np(y))) and np.all(np.isfinite(_np(final)))
    want_y, want_f = tss.ssd_scan_plain(*t[:5], chunk=128)
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS["bfloat16"])
    np.testing.assert_allclose(_np(final), _np(want_f),
                               **SSD_TOLS["bfloat16"])


@pytest.mark.cuda
def test_paged_and_ssd_variants_follow_dtype_and_shape(cuda_device):
    """bf16 at the main path's shapes launches the mma variants; fp32, and
    bf16 at other shapes, the FMA ones, as ``kernel_variant`` says."""
    for dtype, d, want in (("bfloat16", 64, "mma"), ("float32", 64, "fma"),
                           ("bfloat16", 32, "fma")):
        t = _on(_paged_decode_case(2, 4, d, 8, (70, 300), seed=34), dtype,
                cuda_device)
        assert tpa.kernel_variant(t[0].dtype, d, 4, t[0].device) == want
        before = tpa.launches.of(want)
        ops.paged_attention(*t[:5], occupancy=t[5])
        assert tpa.launches.of(want) == before + 1
    for dtype, n, chunk, want in (("bfloat16", 128, 128, "mma"),
                                  ("float32", 128, 128, "fma"),
                                  ("bfloat16", 128, 64, "fma"),
                                  ("bfloat16", 32, 128, "fma")):
        t = _on(_ssd_inputs((1, 200, 4, 64, 1, n), seed=35), dtype,
                cuda_device)
        t[1], t[2] = t[1].float(), t[2].float()
        assert tss.kernel_variant(t[0].dtype, 64, n, chunk,
                                  t[0].device) == want
        before = tss.launches.of(want)
        ops.ssd(*t[:5], chunk=chunk)
        assert tss.launches.of(want) == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,want", [("float32", 64, "tf32x3"),
                                          ("bfloat16", 64, "wgmma"),
                                          ("bfloat16", 128, "wgmma")])
def test_packed_kernel_at_the_verify_layout(cuda_device, dtype, d, want):
    """The spec verify chunk (40 lanes, dead lanes between segments, a
    row's dead lanes past its page run): live lanes match the plain
    version, dead lanes are exactly 0, and the variant is the one the
    engine's bf16 / fp32 path runs."""
    arrays = _verify_chunk(32 if d == 64 else 16, 4 if d == 64 else 2, d,
                           seed=40)
    t = _on(arrays, dtype, cuda_device)
    before = tpp.launches.of(want)
    out = ops.packed_prefill_attention(*t)
    torch.cuda.synchronize()
    assert tpp.launches.of(want) == before + 1, f"not the {want} variant"
    out = _np(out)
    assert np.all(np.isfinite(out))
    assert np.all(out[arrays[4] < 0] == 0.0), "dead lanes leaked output"
    np.testing.assert_allclose(out, _np(tpp.packed_prefill_plain(*t)),
                               **TOLS[dtype])


@pytest.mark.cuda
def test_sampler_keys_and_bits_on_the_card_equal_the_cpu(cuda_device):
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1])
    pos = torch.tensor([0, 1, 7, 1023, 2**20])
    grid = [t.reshape(-1) for t in torch.meshgrid(
        seeds, pos, torch.arange(4), indexing="ij")]
    cpu = tref.sample_key_ref(*grid)
    card = tref.sample_key_ref(*[t.to(cuda_device) for t in grid],
                               device=cuda_device)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    assert torch.equal(tref.random_bits(cpu, 32000),
                       tref.random_bits(card, 32000).cpu())
    assert torch.equal(tref.uniform(cpu), tref.uniform(card).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,top_p", [(50, 1.0), (0, 0.9), (50, 0.9)])
def test_sampler_tokens_on_the_card_equal_the_cpu(cuda_device, top_k,
                                                  top_p):
    """Tokens of ``sample_tokens`` at (8, 32000), temperature 0.8, equal on
    the card and on the CPU (the float draws may differ in the last bit of
    ``log``; a flip is allowed only where the CPU's top two perturbed
    scores lie within 1e-3)."""
    g = torch.Generator().manual_seed(11)
    logits = torch.randn((8, 32000), generator=g) * 3
    ops_args = ([0.8] * 8, [top_k] * 8, [top_p] * 8, list(range(8)),
                [5, 99, 1023, 2**20, 0, 1, 7, 300])
    cpu_toks, cpu_lps = ops.sample_tokens(logits, *ops_args)
    card_toks, card_lps = ops.sample_tokens(logits.to(cuda_device),
                                            *ops_args)
    dist = tref.filtered_dist_ref(logits, *ops_args[:3])
    score = torch.log(torch.clamp(dist, min=1e-30)) + tref.gumbel(
        tref.sample_key_ref(torch.tensor(ops_args[3]),
                            torch.tensor(ops_args[4]), 0), 32000)
    top2 = torch.topk(score, 2).values
    same = card_toks.cpu() == cpu_toks
    for i in np.flatnonzero(~same.numpy()):
        assert float(top2[i, 0] - top2[i, 1]) < 1e-3, i
    np.testing.assert_allclose(card_lps.cpu()[same].numpy(),
                               cpu_lps[same].numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", [((2, 200, 200, 8, 2, 64), True),
                                          ((2, 70, 300, 8, 8, 64), False)])
def test_flash_under_grad_runs_the_kernel_with_the_plain_backward(
        cuda_device, dtype, shape, causal):
    """Under autograd a CUDA call goes through ``FlashAttentionFn``: one
    kernel launch, the kernel call's bytes, and the plain version's
    gradients byte for byte."""
    q, k, v = [t.requires_grad_(True) for t in _on(
        _flash_inputs(shape, 41), dtype, cuda_device)]
    dout = torch.randn(q.shape, generator=torch.Generator(
        cuda_device).manual_seed(1), device=cuda_device).to(q.dtype)
    variant = tfa.kernel_variant(q.dtype, shape[5], cuda_device)
    before = tfa.launches.of(variant)
    out = ops.flash_attention(q, k, v, causal=causal)
    assert tfa.launches.of(variant) == before + 1
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFn")
    with torch.no_grad():
        assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal))
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(tfa.flash_attention_plain(
        q, k, v, causal=causal), (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_skip", [False, True])
def test_ssd_under_grad_runs_the_kernel_with_the_plain_backward(
        cuda_device, dtype, d_skip):
    """Under autograd a CUDA call goes through ``SSDScanFn`` (P 64, N 128,
    chunk 128: the ``mma`` variant in bf16); the gradients of x, dt, a,
    b, c and d_skip are the plain version's byte for byte, in each input's
    dtype, and stay finite at a decay strong enough to overflow exp()
    above the diagonal."""
    shape = (2, 300, 4, 64, 1, 128)
    arrays = _ssd_inputs(shape, 43, d_skip=d_skip, decay=8.0)
    dt_ = getattr(torch, dtype)
    ins = [torch.from_numpy(a).to(cuda_device, dt_ if i in (0, 3, 4)
                                  else torch.float32).requires_grad_(True)
           for i, a in enumerate(arrays)]
    ds = ins[5] if d_skip else None
    variant = tss.kernel_variant(dt_, 64, 128, 128, cuda_device)
    before = tss.launches.of(variant)
    y, _ = ops.ssd(*ins[:5], chunk=128, d_skip=ds)
    assert tss.launches.of(variant) == before + 1
    assert type(y.grad_fn).__name__.startswith("SSDScanFn")
    dy = torch.randn(y.shape, generator=torch.Generator(
        cuda_device).manual_seed(2), device=cuda_device).to(y.dtype)
    got = torch.autograd.grad(y, ins, dy)
    want = torch.autograd.grad(tss.ssd_scan_plain(
        *ins[:5], chunk=128, d_skip=ds)[0], ins, dy)
    for g, w, t in zip(got, want, ins):
        assert g.dtype == t.dtype and torch.equal(g, w)
        assert torch.isfinite(g.float()).all()


# ---------------------------------------------- the fused block chain

# (d, H, Hkv, D, qk_norm, d_ff, rope_theta) of the published configs
FB_WIDTHS = {"qwen3-32b": (5120, 64, 8, 128, True, 25600, 1e6),
             "tinyllama-1.1b": (2048, 32, 4, 64, False, 5632, 1e4)}
# lanes of the serving engine's three layouts: the decode step's max_batch
# rows, the packed chunk, the spec verify chunk (32 rows x (spec_k 4 + 1))
FB_LAYOUTS = {"decode": 32, "packed": 512, "verify": 160}
FB_PAGE, FB_PAGES = 8, 512


def _fb_targets(layout, n, rng):
    """Distinct (page, slot) targets of n lanes, page -1 on the layout's
    padding: the decode step's last 4 rows, the packed chunk's last 40
    lanes, the verify lanes past each row's draft depth and two whole
    rows."""
    slots = rng.permutation(FB_PAGES * FB_PAGE)[:n]
    lane = np.arange(n)
    if layout == "decode":
        dead = lane >= n - 4
    elif layout == "packed":
        dead = lane >= n - 40
    else:
        nd = rng.randint(0, 5, size=n // 5)
        nd[-2:] = -1
        dead = lane % 5 > nd[lane // 5]
    page = np.where(dead, -1, slots // FB_PAGE).astype(np.int64)
    return page, (slots % FB_PAGE).astype(np.int64)


def _fb_case(op, widths, layout, dtype, device, seed):
    d, h, hkv, hd, qk_norm, d_ff, theta = FB_WIDTHS[widths]
    n = FB_LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dt)
    if op == "add_rms_norm":
        return [randn(n, d), randn(n, d), randn(d)]
    if op == "silu_mul":
        return [randn(n, d_ff), randn(n, d_ff)]
    pos = torch.from_numpy(rng.randint(0, 2048, size=(n,))).to(device)
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, device=device,
                                        dtype=torch.float32) / half))
    angles = pos[:, None].float() * inv
    page, slot = _fb_targets(layout, n, rng)
    return [randn(n, h, hd), randn(n, hkv, hd), randn(n, hkv, hd),
            randn(hd) if qk_norm else None, randn(hd) if qk_norm else None,
            torch.cos(angles), torch.sin(angles),
            randn(FB_PAGES, FB_PAGE, hkv, hd),
            randn(FB_PAGES, FB_PAGE, hkv, hd),
            torch.from_numpy(page).to(device),
            torch.from_numpy(slot).to(device)]


def _fb_hold(op, args, dtype):
    """Run the kernel and the plain version on the same inputs; hold the
    outputs (and the pages) at the dtype's tolerance, the launch counter
    at +1, and every page slot outside a live lane's target at its bytes
    before the call."""
    plain = getattr(tfb, f"{op}_plain")
    if op == "qk_norm_rope_write":
        k0, v0 = args[7].clone(), args[8].clone()
        p_args = args[:7] + [k0.clone(), v0.clone()] + args[9:]
        want = [plain(*p_args), p_args[7], p_args[8]]
    else:
        want = plain(*args)
        want = list(want) if isinstance(want, tuple) else [want]
    before = tfb.launches.of(op)
    got = getattr(ops, op)(*args)
    torch.cuda.synchronize()
    assert tfb.launches.of(op) == before + 1
    if op == "qk_norm_rope_write":
        got = [got, args[7], args[8]]
        live = args[9] >= 0
        keep = torch.ones(args[7].shape[:2], dtype=torch.bool,
                          device=args[7].device)
        keep[args[9][live], args[10][live]] = False
        assert torch.equal(args[7][keep], k0[keep])
        assert torch.equal(args[8][keep], v0[keep])
    elif not isinstance(got, tuple):
        got = [got]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(FB_LAYOUTS))
@pytest.mark.parametrize("widths", sorted(FB_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add_rms_norm", "qk_norm_rope_write",
                                "silu_mul"])
def test_fused_block_kernel_matches_plain(cuda_device, op, dtype, widths,
                                          layout):
    """Each fused kernel at the serving engine's layouts (the decode
    step's 32 rows, the packed chunk's 512 lanes, the spec verify's 160)
    and the widths of Qwen3-32B (q/k norm, D 128) and TinyLlama-1.1B (D
    64): within the repo's tolerance of the plain version, and the
    padding rows and lanes leave their pages exactly as they were."""
    _fb_hold(op, _fb_case(op, widths, layout, dtype, cuda_device, seed=50),
             dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_kernels_off_the_vector_path(cuda_device, dtype):
    """Rows no 16-byte vector divides (d 100, 37 x 99 elements), a row
    without residual, and the reduced configs' D 16: the scalar paths
    against the plain versions; an all-padding call writes no page."""
    rng = np.random.RandomState(51)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=cuda_device, dtype=dt)
    _fb_hold("add_rms_norm", [randn(7, 100), randn(7, 100), randn(100)],
             dtype)
    _fb_hold("add_rms_norm", [randn(3, 64), None, randn(64)], dtype)
    _fb_hold("silu_mul", [randn(37, 99), randn(37, 99)], dtype)
    n, hd = 6, 16
    angles = torch.from_numpy(rng.uniform(0, 50, size=(n, hd // 2)).astype(
        np.float32)).to(cuda_device)
    page = torch.tensor([0, -1, 3, 5, -1, 7], device=cuda_device)
    slot = torch.tensor([1, 1, 2, 3, 0, 7], device=cuda_device)
    args = [randn(n, 4, hd), randn(n, 2, hd), randn(n, 2, hd), randn(hd),
            randn(hd), torch.cos(angles), torch.sin(angles),
            randn(8, 8, 2, hd), randn(8, 8, 2, hd), page, slot]
    _fb_hold("qk_norm_rope_write", args, dtype)
    args[9] = torch.full_like(page, -1)
    kp, vp = args[7].clone(), args[8].clone()
    ops.qk_norm_rope_write(*args)
    torch.cuda.synchronize()
    assert torch.equal(args[7], kp) and torch.equal(args[8], vp)


@pytest.mark.cuda
def test_fused_block_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    x = torch.ones(2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ops.add_rms_norm(x, None, torch.ones(64, device=cuda_device))
    with pytest.raises(ValueError):
        ops.silu_mul(x, torch.ones(2, 32, device=cuda_device,
                                   dtype=torch.bfloat16))
    q = torch.ones(2, 1, 512, device=cuda_device)
    pages = torch.ones(4, 8, 1, 512, device=cuda_device)
    cs = torch.ones(2, 256, device=cuda_device)
    tgt = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):          # D above the kernel's 256
        ops.qk_norm_rope_write(q, q, q, None, None, cs, cs, pages, pages,
                               tgt, tgt)


# tiny dense models for the decode graph: (registry name, overrides)
GRAPH_MODELS = {
    "tinyllama-reduced": ("tinyllama-1.1b", {}),
    "qwen3-d128": ("qwen3-8b", dict(n_layers=4, n_heads=8, n_kv_heads=2,
                                    head_dim=128)),
}
GRAPH_CONFIG = dict(num_pages=96, page_size=8, max_batch=4, max_seq_len=256,
                    prefill_chunk_tokens=32, watchdog="off")


def _decode_host_operands(rng, shard, n_live):
    """One decode call's host operands: ``n_live`` rows at random contexts
    over random page runs, the rest padding (page -1)."""
    b, p, pg = shard.max_batch, shard.max_pages, shard.page_size
    bt = rng.randint(0, GRAPH_CONFIG["num_pages"], size=(b, p)).astype(
        np.int32)
    ctx = np.ones((b,), np.int32)
    ctx[:n_live] = rng.randint(1, p * pg, size=n_live)
    occ = np.arange(b) < n_live
    pos = (ctx - 1).astype(np.int64)
    wr_page = np.where(occ, bt[np.arange(b), pos // pg], -1).astype(np.int64)
    return (bt, ctx, rng.randint(1, 200, size=b).astype(np.int64), occ, pos,
            wr_page, pos % pg)


def _grown(after, before):
    """Launches by variant between two snapshots, the variants that
    launched."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["warm", "lazy"])
@pytest.mark.parametrize("model_name", sorted(GRAPH_MODELS))
def test_decode_graph_replays_the_eager_call(cuda_device, model_name, first):
    """Eight decode calls, 0-3 live rows of 4, through the graph (operands
    staged by ``upload`` on even calls, made by the caller on odd ones)
    and eagerly, on pools overwritten in place before each call: logits
    and pools bit-equal, one capture (at ``session.warm`` or the first
    call), the same launches by kernel and block passes a call."""
    name, over = GRAPH_MODELS[model_name]
    cfg = get_config(name).reduced().replace(dtype="bfloat16", **over)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    sessions = [serving.serve(model, params,
                              serving.ServingConfig(**GRAPH_CONFIG),
                              device=cuda_device, start=False)
                for _ in range(2)]
    eager, graphed = [s.engine.shards[0] for s in sessions]
    graph = graphed._decode_graph
    eager._decode_graph = None
    assert graph is not None
    pools = graphed.k_pages, graphed.v_pages
    variant = "mma" if cfg.head_dim == 128 else "fma"
    rng = np.random.RandomState(9)
    try:
        with torch.inference_mode():
            if first == "warm":
                sessions[1].warm()
                assert graph.out is not None
            for step in range(8):
                gen = torch.Generator(device=cuda_device).manual_seed(step)
                for pool in (eager.k_pages, eager.v_pages):
                    pool.normal_(generator=gen)
                graphed.k_pages.copy_(eager.k_pages)
                graphed.v_pages.copy_(eager.v_pages)
                host = _decode_host_operands(rng, eager, step % 4)
                counts = []
                for shard in (eager, graphed):
                    fused = dict(tfb.launches.by_variant)
                    paged = dict(tpa.launches.by_variant)
                    blocks = shard.stack.fused_blocks
                    if shard is graphed and step % 2 == 0:
                        args = graph.upload(host)
                    else:
                        args = [torch.from_numpy(a).to(cuda_device)
                                for a in host]
                    out = shard._paged_decode_step(*args)
                    torch.cuda.synchronize()
                    counts.append((dict(tfb.launches.by_variant), fused,
                                   dict(tpa.launches.by_variant), paged,
                                   shard.stack.fused_blocks - blocks))
                    if shard is eager:
                        want = out.clone()
                assert out is graph.out
                assert torch.equal(out, want), (model_name, step)
                assert torch.equal(graphed.k_pages, eager.k_pages)
                assert torch.equal(graphed.v_pages, eager.v_pages)
                (fa, fb, pa, pb, na), (ga, gb, qa, qb, nb) = counts
                assert _grown(fa, fb) == _grown(ga, gb)
                assert _grown(pa, pb) == _grown(qa, qb) == \
                    {variant: cfg.n_layers}
                assert na == nb == cfg.n_layers
    finally:
        for s in sessions:
            s.close()
    assert graphed.k_pages is pools[0] is graphed.stack.k_pages
    assert graphed.v_pages is pools[1] is graphed.stack.v_pages
    assert graphed.decode_graph_replays == 8 + (first == "warm")
    assert eager.decode_graph_replays == 0
    assert graph.pool_bytes > 0
