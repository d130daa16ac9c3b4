"""The numerical design of the fp32 tensor-core kernels (3xTF32), emulated
on the CPU.

``csrc/tf32x3.cuh`` splits every fp32 operand x in two TF32 numbers,
hi = rna(x) and lo = rna(x - hi), where rna is ``cvt.rna.tf32.f32``
(round to nearest, ties away from zero, keeping 10 of the 23 mantissa
bits), and forms a b as a_hi b_lo + a_lo b_hi + a_hi b_hi: three TF32
products, each exact in the fp32 accumulator.  Here the same arithmetic
runs in numpy: TF32 rounding on the fp32 bits, the three products as fp32
matrix products of TF32-valued operands, and the kernels' blockwise
online softmax in the log2 domain (flash: key tiles of 64, of 32 at
D = 192; packed: key ranges merged by the combine's rule).  Each result
must lie within the fp32 kernels' tolerance, 3e-5 (rtol = atol, as
``chip_smoke.py`` and the card tests hold them), of attention in fp64.

The same computation with one TF32 product (operands rounded once, the
plain TF32 route) misses that tolerance by far: its worst error here is
3.1e-4 (packed) to 1.3e-3 (flash, D 64), against 4.1e-7 to 1.4e-6 for
3xTF32 (each test prints both).  That is why the kernels split.
"""

import numpy as np
import pytest

TOL = 3e-5
LOG2E = 1.4426950408889634


def rna_tf32(x):
    """``cvt.rna.tf32.f32``: round the fp32 bits to 10 mantissa bits, ties
    away from zero (the sign bit is apart, so adding half an ulp of TF32
    to the magnitude bits rounds half away)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.float32(x) - hi)


def mm3(a, b):
    """a @ b in 3xTF32: the two small products, then the large one, each
    an fp32 product of TF32-valued operands, summed in fp32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi) + (a_hi @ b_lo) + (a_hi @ b_hi)


def mm1(a, b):
    """a @ b with one TF32 product (both operands rounded once)."""
    return rna_tf32(a) @ rna_tf32(b)


def online(q, k, v, visible, mm, tile):
    """The kernels' loop for one head: q (R, D), k/v (T, D) fp32,
    ``visible`` (R, T); returns the unnormalised (o, m, l) in fp32 with m
    in the log2 domain (-inf for a row with nothing visible)."""
    r, d = q.shape
    scale_log2 = np.float32(LOG2E / np.sqrt(d))
    o = np.zeros((r, d), np.float32)
    m = np.full((r,), -np.inf, np.float32)
    l = np.zeros((r,), np.float32)
    for k0 in range(0, k.shape[0], tile):
        s = mm(q, k[k0:k0 + tile].T) * scale_log2
        s = np.where(visible[:, k0:k0 + tile], s, np.float32(-np.inf))
        mx = np.maximum(m, s.max(axis=1))
        base = np.where(np.isneginf(mx), np.float32(0), mx)
        corr = np.exp2(m - base).astype(np.float32)
        p = np.exp2(s - base[:, None]).astype(np.float32)
        l = l * corr + p.sum(axis=1, dtype=np.float32)
        o = o * corr[:, None] + mm(p, v[k0:k0 + tile])
        m = mx
    return o, m, l


def attention64(q, k, v, visible):
    """softmax(q k^T / sqrt(D)) v in fp64, rows with nothing visible 0."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ k.T / np.sqrt(q.shape[1])
    s = np.where(visible, s, -np.inf)
    mx = s.max(axis=1, keepdims=True)
    p = np.exp(s - np.where(np.isneginf(mx), 0.0, mx))
    den = p.sum(axis=1, keepdims=True)
    return np.where(den > 0, p @ v / np.where(den > 0, den, 1.0), 0.0)


def flash(q, k, v, causal, mm):
    """The flash kernels over q (B, S, H, D), k/v (B, S, Hkv, D): head h
    reads kv head h / (H / Hkv), key tiles of 64 (32 at D = 192)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    tile = 32 if d == 192 else 64
    vis = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    out = np.zeros(q.shape, np.float32)
    for bi in range(b):
        for hi in range(h):
            kh = hi // (h // hkv)
            o, _, l = online(q[bi, :, hi], k[bi, :, kh], v[bi, :, kh], vis,
                             mm, tile)
            out[bi, :, hi] = o / l[:, None]
    return out


def flash64(q, k, v, causal):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    vis = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    out = np.zeros(q.shape, np.float64)
    for bi in range(b):
        for hi in range(h):
            kh = hi // (h // hkv)
            out[bi, :, hi] = attention64(q[bi, :, hi], k[bi, :, kh],
                                         v[bi, :, kh], vis)
    return out


def errors(got3, got1, want):
    return (float(np.max(np.abs(got3 - want))),
            float(np.max(np.abs(got1 - want))))


@pytest.mark.parametrize("d,s,h,hkv", [(64, 160, 4, 2), (192, 96, 2, 1)])
def test_flash_3xtf32_within_fp32_tolerance(d, s, h, hkv):
    """Causal, GQA, standard normal inputs: 3xTF32 within 3e-5 of fp64,
    one TF32 product far outside it."""
    rng = np.random.RandomState(d + s)
    q, k, v = (rng.standard_normal((1, s, n, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    want = flash64(q, k, v, causal=True)
    got3 = flash(q, k, v, True, mm3)
    got1 = flash(q, k, v, True, mm1)
    err3, err1 = errors(got3, got1, want)
    msg = f"D {d}: 3xTF32 max err {err3:.3g}, 1xTF32 {err1:.3g}"
    np.testing.assert_allclose(got3, want, rtol=TOL, atol=TOL, err_msg=msg)
    print(msg)
    assert err1 > TOL, msg


def test_packed_one_segment_3xtf32_within_fp32_tolerance():
    """The packed chunk of one prompt, as the fp32 ``tf32x3`` variant runs
    it: lanes at positions 150-213 of one segment (G = 4 heads of a kv
    head, D 64), each lane block's keys cut in ranges of 64 whose (o, m,
    l) partials the combine merges as out = sum o_r 2^(m_r - M) / sum l_r
    2^(m_r - M)."""
    rng = np.random.RandomState(5)
    g, d, start = 4, 64, 150
    n_live = 64
    pos = start + np.arange(n_live)
    t = start + n_live                # the segment's keys 0..t-1
    q = rng.standard_normal((n_live, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((t, d)).astype(np.float32) for _ in "kv")
    vis = np.arange(t)[None, :] <= pos[:, None]
    out3, out1 = (np.zeros((n_live, g, d), np.float32) for _ in "31")
    for out, mm in ((out3, mm3), (out1, mm1)):
        for gi in range(g):
            parts = [online(q[:, gi], k[r0:r0 + 64], v[r0:r0 + 64],
                            vis[:, r0:r0 + 64], mm, 64)
                     for r0 in range(0, t, 64)]
            mx = np.max([m for _, m, _ in parts], axis=0)
            num = sum(o * np.exp2(m - mx)[:, None] for o, m, _ in parts)
            den = sum(l * np.exp2(m - mx) for _, m, l in parts)
            out[:, gi] = num / den[:, None]
    want = np.zeros((n_live, g, d))
    for gi in range(g):
        want[:, gi] = attention64(q[:, gi], k, v, vis)
    err3, err1 = errors(out3, out1, want)
    msg = f"packed: 3xTF32 max err {err3:.3g}, 1xTF32 {err1:.3g}"
    np.testing.assert_allclose(out3, want, rtol=TOL, atol=TOL, err_msg=msg)
    print(msg)
    assert err1 > TOL, msg


def test_split_is_exact_to_fp32_and_rounds_ties_away():
    """hi + lo recovers x to within 2^-22 of it, both halves carry at most
    10 mantissa bits, and a tie rounds away from zero in magnitude."""
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)) \
        .astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert np.all(part.view(np.uint32) & np.uint32(0x1FFF) == 0)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22
    tie = np.asarray([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(rna_tf32(tie), [1.0 + 2.0 ** -10,
                                                  -(1.0 + 2.0 ** -10)])
