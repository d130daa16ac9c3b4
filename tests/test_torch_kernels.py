"""Torch port kernels held against the JAX package on identical inputs.

On the CPU the port's wrappers run their plain PyTorch versions, which are
held against ``repro.kernels.ref`` and ``repro.kernels.ops._packed_xla``
(the JAX package's Pallas kernels do not run here).  Inputs are made with
numpy from a seed and handed to both frameworks.  Tolerances are those of
``tests/test_kernels.py``: 3e-5 for fp32, 2e-2 for bf16 (bf16 rounds the
inputs identically in both frameworks; the gap is accumulation order).

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import packed_prefill as tpp
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from test_torch_kernels_cuda import (
    PAGED_SHAPES,
    TOLS,
    _np,
    _packed_inputs,
    _paged_inputs,
)

def _both(arrays, dtype):
    """numpy arrays → (jax arrays, torch CPU tensors); floating arrays are
    cast to ``dtype`` in each framework from the same fp32 values."""
    jx, tx = [], []
    for a in arrays:
        if a.dtype == np.float32:
            jx.append(jnp.asarray(a).astype(getattr(jnp, dtype)))
            tx.append(torch.from_numpy(a).to(getattr(torch, dtype)))
        else:
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a))
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_ref_and_plain_match_jax_ref(dtype, shape):
    jx, tx = _both(_paged_inputs(shape, seed=1), dtype)
    want = _np(jref.paged_attention_ref(*jx))
    np.testing.assert_allclose(_np(tref.paged_attention_ref(*tx)), want,
                               **TOLS[dtype])
    np.testing.assert_allclose(_np(tpa.paged_attention_plain(*tx)), want,
                               **TOLS[dtype])


@pytest.mark.parametrize("num_splits", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_occupancy_aliased_rows(dtype, num_splits):
    """Padded rows (aliasing live rows' pages) are exactly 0 through the
    CPU dispatch, whatever split count is asked (the plain version has no
    split dimension), and live rows match the JAX oracle."""
    arrays = _paged_inputs((4, 4, 2, 16, 8, 4, 3), seed=12, occupancy=True)
    jx, tx = _both(arrays, dtype)
    before = tpa.launches.count
    out = ops.paged_attention(*tx[:5], occupancy=tx[5],
                              num_splits=num_splits)
    assert tpa.launches.count == before, "a CPU tensor launched a kernel"
    out = _np(out)
    occ = arrays[5]
    assert np.all(out[~occ] == 0.0), "padded rows leaked output"
    assert np.all(np.isfinite(out))
    want = _np(jref.paged_attention_ref(*jx[:5], occupancy=jx[5]))
    np.testing.assert_allclose(out, want, **TOLS[dtype])
    np.testing.assert_allclose(
        _np(tref.paged_attention_ref(*tx[:5], occupancy=tx[5])), want,
        **TOLS[dtype])


def test_paged_dead_rows_are_exactly_zero():
    """ctx = 0 rows and unoccupied rows come out exactly 0 (the JAX
    kernel's contract; the JAX oracle gives NaN for an occupied ctx-0
    row, which the engine never produces)."""
    arrays = _paged_inputs((3, 4, 2, 8, 6, 4, 2), seed=10)
    arrays[4][:] = [0, 5, 0]
    occ = np.asarray([True, True, False])
    tx = [torch.from_numpy(a) for a in arrays]
    out = _np(tpa.paged_attention_plain(*tx, torch.from_numpy(occ)))
    assert np.all(out[[0, 2]] == 0.0) and np.all(np.isfinite(out))
    want = _np(jref.paged_attention_ref(
        *[jnp.asarray(a) for a in arrays[:4]], jnp.asarray([1, 5, 1]),
        occupancy=jnp.asarray([False, True, False])))
    np.testing.assert_allclose(out[1], want[1], **TOLS["float32"])


@pytest.mark.parametrize("shared_page", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_and_ref_match_jax(dtype, shared_page):
    """A mixed chunk (3 segments + padding tail): the port's plain version
    against the JAX production path ``_packed_xla`` and the oracle, and
    the port's oracle against the JAX oracle."""
    arrays = _packed_inputs(6, shared_page)
    jx, tx = _both(arrays, dtype)
    want = _np(jref.packed_prefill_attention_ref(*jx))
    want_xla = _np(jops._packed_xla(*jx[:6]))
    before = tpp.launches.count
    out = _np(ops.packed_prefill_attention(*tx))
    assert tpp.launches.count == before, "a CPU tensor launched a kernel"
    np.testing.assert_allclose(out, want, **TOLS[dtype])
    np.testing.assert_allclose(out, want_xla, **TOLS[dtype])
    np.testing.assert_allclose(_np(tref.packed_prefill_attention_ref(*tx)),
                               want, **TOLS[dtype])
    assert np.all(out[arrays[4] < 0] == 0.0), "padding lanes leaked output"


def test_packed_padding_run_mid_chunk_and_interleaved_segments():
    """The general seg_ids contract: a padding run between segments and a
    segment whose lanes are not contiguous."""
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
    jx, tx = _both(arrays, "float32")
    out = _np(tpp.packed_prefill_plain(*tx))
    np.testing.assert_allclose(out, _np(jref.packed_prefill_attention_ref(
        *jx)), **TOLS["float32"])
    assert np.all(out[seg < 0] == 0.0)


@pytest.mark.parametrize("temps", [[0.0, 0.0, -1.0], [0.0]])
def test_sample_tokens_greedy_rows_match_jax(temps):
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((len(temps), 50)).astype(np.float32)
    logits[0, [7, 9]] = 10.0        # a tie: the first index wins
    b = len(temps)
    toks, lps = jref.sample_tokens_ref(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.zeros((b,), jnp.int32), jnp.ones((b,), jnp.float32),
        jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))
    ttoks, tlps = ops.sample_tokens(torch.from_numpy(logits), temps,
                                    [0] * b, [1.0] * b, [0] * b, [0] * b)
    assert ttoks.tolist() == np.asarray(toks).tolist()
    assert ttoks[0].item() == 7
    assert np.all(tlps.numpy() == 0.0) and np.all(np.asarray(lps) == 0.0)


def test_default_num_splits_for_132_sms():
    # 32 (row, kv head) pairs at the serving batch: ~2 blocks per SM, cut
    # to one cluster of eight for the mma variant
    assert tpa.default_num_splits(8, 4, 128, "fma") == 9
    assert tpa.default_num_splits(8, 4, 128, "mma") == 8
    # never fewer than four pages per split, never more than the variant
    # runs (the fma combine kernel's arrays, the mma variant's cluster)
    for variant in ("fma", "mma"):
        assert tpa.default_num_splits(1, 1, 8, variant) == 2
        assert tpa.default_num_splits(1, 1, 3, variant) == 1
        assert tpa.default_num_splits(1, 1, 10_000, variant) == \
            tpa.max_splits(variant)
    assert tpa.max_splits("fma") == tpa.MAX_SPLITS
    assert tpa.max_splits("mma") == tpa.TC_MAX_SPLITS == 8


@pytest.mark.parametrize("dtype,head_dim,n_heads,want", [
    (torch.bfloat16, 64, 32, "mma"), (torch.float32, 64, 32, "fma"),
    (torch.bfloat16, 96, 32, "fma"), (torch.bfloat16, 64, 128, "fma")])
def test_paged_splits_follow_the_variant(dtype, head_dim, n_heads, want):
    """``paged_splits`` is the split count a call of that many rows runs
    by default on the device (the engine passes the decode step's to the
    spec verify): the variant's default on a CUDA device, None on the
    CPU.  No card is needed to ask."""
    assert tpa.kernel_variant(dtype, head_dim, n_heads // 4, "cuda") == want
    assert tpa.paged_splits(8, n_heads, 4, head_dim, 128, dtype, "cuda") \
        == tpa.default_num_splits(8, 4, 128, want)
    assert tpa.paged_splits(8, n_heads, 4, head_dim, 128, dtype,
                            "cpu") is None


@pytest.mark.parametrize("case", ["dtype", "mixed", "index", "shape",
                                  "contiguous"])
def test_paged_wrapper_validates_inputs(case):
    """The CUDA wrapper's checks run before any launch (and so run here)."""
    q, kp, vp, bt, cl = [torch.from_numpy(a) for a in
                         _paged_inputs(PAGED_SHAPES[0], seed=2)]
    occ = torch.ones(q.shape[0], dtype=torch.bool)
    if case == "dtype":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif case == "mixed":
        q = q.bfloat16()
    elif case == "index":
        bt = bt.long()
    elif case == "shape":
        cl = cl[:1]
    else:
        kp = kp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        tpa._check(q, kp, vp, bt, cl, occ)


@pytest.mark.parametrize("case", ["dtype", "index", "shape"])
def test_packed_wrapper_validates_inputs(case):
    t = [torch.from_numpy(a) for a in _packed_inputs(6)]
    if case == "dtype":
        t[0] = t[0].double()
    elif case == "index":
        t[4] = t[4].long()
    else:
        t[6] = t[6][:2]
    with pytest.raises((TypeError, ValueError)):
        tpp._check(*t)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a missing compiler is an error, never the plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_launch_counter_counts_and_resets():
    c = build.LaunchCounter()
    for variant in ("wgmma", "fma", "wgmma"):
        c.add(variant)
    assert c.count == 3
    assert c.of("wgmma") == 2 and c.of("fma") == 1 and c.of("plain") == 0
    c.reset()
    assert c.count == 0 and c.of("wgmma") == 0 and c.by_variant == {}


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_variant_by_dtype_head_dim_device(dtype, d, device):
    """The route is chosen openly from (dtype, D, device): on a card the
    tensor-core variants at flash's D 64, 128 and 192 and packed's D 64
    and 128 (``wgmma`` for bf16, ``tf32x3`` for fp32), the FMA variant at
    every other D, the plain version on the CPU."""
    def want(tc_dims):
        if device == "cpu":
            return "plain"
        if d in tc_dims:
            return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        return "fma"
    assert tfa.kernel_variant(dtype, d, device) == want((64, 128, 192))
    assert tpp.kernel_variant(dtype, d, 8, device) == want((64, 128))


@pytest.mark.parametrize("dtype,d,rows", [
    (torch.bfloat16, 64, 64), (torch.bfloat16, 128, 128),
    (torch.bfloat16, 192, 128), (torch.float32, 64, 64),
    (torch.float32, 128, 128), (torch.float32, 192, 128)])
def test_flash_query_rows_by_head_dim(dtype, d, rows):
    """The tensor-core variants' tile is a function of the shape: 64 query
    rows a block at D = 64, two warpgroups (bf16) or 8 warps (fp32) on 128
    rows at D = 128 and 192 (DeepSeek-V2's MLA prefill), in either
    dtype's tensor-core variant."""
    assert tfa.kernel_variant(dtype, d, "cuda") in ("wgmma", "tf32x3")
    assert tfa.query_rows(d) == rows


def test_packed_one_segment_fp32_grid_fills_the_card():
    """Phase 4's one-segment chunk (C 256, G 8, Hkv 4, 128 pages of 8):
    the planner's grid is at least one block an SM, where the ``fma``
    variant launched Hkv x C / 16 = 64 blocks."""
    wb = tpp.work_bounds(256, 1, 128, 8, 8, 4)
    assert tpp.kernel_variant(torch.float32, 64, 8, "cuda") == "tf32x3"
    assert wb["grid"] >= tpp.N_SMS > 4 * 256 // 16


def test_kernel_variant_packed_group_and_unknown_device():
    """A group wider than one 64-row tile takes the FMA variant; a device
    with no kernel raises."""
    assert tpp.kernel_variant(torch.bfloat16, 64, 64, "cuda") == "wgmma"
    assert tpp.kernel_variant(torch.bfloat16, 64, 65, "cuda") == "fma"
    assert tpp.kernel_variant(torch.float32, 128, 64, "cuda") == "tf32x3"
    assert tpp.kernel_variant(torch.float32, 128, 65, "cuda") == "fma"
    for fn in (lambda: tfa.kernel_variant(torch.bfloat16, 64, "meta"),
               lambda: tpp.kernel_variant(torch.bfloat16, 64, 8, "meta")):
        with pytest.raises(ValueError, match="no kernel"):
            fn()


@pytest.mark.parametrize("group,lanes", [(1, 64), (4, 16), (6, 10), (8, 8),
                                         (16, 4), (64, 1)])
def test_lanes_per_block_fill_one_tile(group, lanes):
    assert tpp.lanes_per_block(group) == lanes
    assert lanes * group <= tpp.TC_ROWS


@pytest.mark.parametrize("n_pages,page,keys", [
    (128, 8, 256),      # the serving engine: 1024 keys, 4 ranges
    (4, 8, 256),        # short contexts keep 256-key items
    (256, 8, 256),      # 2048 keys: exactly MAX_RANGES ranges of 256
    (257, 8, 320),      # past that, the fewest 64-key tiles for 8 ranges
    (4096, 8, 4096),    # 32768 keys
    (0, 8, 256),
])
def test_item_keys_bounds_ranges(n_pages, page, keys):
    got = tpp.item_keys(n_pages, page)
    assert got == keys and got % 64 == 0
    assert -(-(n_pages * page) // got) <= tpp.MAX_RANGES


def test_work_bounds_at_the_serving_chunk():
    """C = 264 lanes (256-token budget + 8 riders), 8 segments, 128 pages
    of 8, G = 8, Hkv = 4: 33 lane blocks of 8 lanes, 4 key ranges of 256,
    at most 33 * 8 * 4 items, and 4 blocks a SM."""
    wb = tpp.work_bounds(264, 8, 128, 8, 8, 4)
    assert wb == {"lanes": 8, "n_lb": 33, "item_keys": 256,
                  "max_ranges": 4, "item_cap": 1056,
                  "grid": tpp.N_SMS * tpp.TC_BLOCKS_PER_SM}
    one = tpp.work_bounds(264, 1, 128, 8, 8, 4)   # the chunked scheduler
    assert one["item_cap"] == 33 * 4 and one["grid"] == 33 * 4 * 4
    ragged = tpp.work_bounds(21, 3, 40, 8, 4, 2)
    assert ragged["lanes"] == 16 and ragged["n_lb"] == 2
    assert ragged["item_cap"] == 2 * 3 * 2 and ragged["grid"] == 24


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("group", [1, 4, 8, 16, 17])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_variant_by_dtype_shape_device(dtype, d, group, device):
    """Paged decode: the mma variant for bf16 at D = 64 and 128 with at most
    16 query heads a kv head (the mma's M rows) on a card, the FMA variant
    otherwise, the plain version on the CPU."""
    if device == "cpu":
        want = "plain"
    elif dtype == torch.bfloat16 and d in (64, 128) and group <= 16:
        want = "mma"
    else:
        want = "fma"
    assert tpa.kernel_variant(dtype, d, group, device) == want


def test_paged_kernel_variant_unknown_device():
    with pytest.raises(ValueError, match="no kernel"):
        tpa.kernel_variant(torch.bfloat16, 64, 8, "meta")


@pytest.mark.parametrize("b,hkv,g,d,splits", [
    (8, 4, 8, 64, 9),        # the serving batch, default splits
    (1, 8, 4, 128, 1),
    (3, 2, 16, 128, 128),
])
def test_paged_scratch_holds_the_partials(b, hkv, g, d, splits):
    """A global-memory merge's one scratch: acc (splits x B x Hkv x G x D),
    then the (m, l) pairs."""
    n = tpa.scratch_floats(b, hkv, g, d, splits)
    assert n == splits * b * hkv * g * d + 2 * splits * b * hkv * g


@pytest.mark.parametrize("asked,mma,fma", [(1, 1, 1), (3, 3, 3), (8, 8, 8),
                                           (9, 8, 9), (128, 8, 128)])
def test_paged_variant_splits(asked, mma, fma):
    """Each variant runs an explicit split count as asked, up to its most
    (eight for mma, one cluster; 128 for fma); above that it refuses the
    count, naming its most, instead of cutting it.  ``mma`` and ``fma``
    are min(asked, the variant's most)."""
    for variant, runs in (("mma", mma), ("fma", fma)):
        if runs == asked:
            assert tpa.split_count(asked, 8, 4, 128, variant) == asked
        else:
            assert tpa.max_splits(variant) == runs
            with pytest.raises(ValueError, match=rf"\[1, {runs}\]"):
                tpa.split_count(asked, 8, 4, 128, variant)
    for variant in ("mma", "fma"):
        assert tpa.split_count(None, 8, 4, 128, variant) == \
            tpa.default_num_splits(8, 4, 128, variant)
        with pytest.raises(ValueError, match="num_splits"):
            tpa.split_count(0, 8, 4, 128, variant)


@pytest.mark.parametrize("case", ["flash", "packed", "paged", "ssd"])
def test_cpu_dispatch_counts_no_variant(case):
    """On the CPU the wrappers run the plain versions and count nothing,
    whatever the dtype and head dim."""
    if case == "flash":
        rng = np.random.RandomState(5)
        t = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .bfloat16() for shape in ((1, 8, 4, 64), (1, 8, 2, 64),
                                       (1, 8, 2, 64))]
        counter = tfa.launches
        call = lambda: ops.flash_attention(*t, causal=True)  # noqa: E731
    elif case == "packed":
        t = [torch.from_numpy(a) for a in _packed_inputs(6)]
        t[:3] = [x.bfloat16() for x in t[:3]]
        counter = tpp.launches
        call = lambda: ops.packed_prefill_attention(*t)  # noqa: E731
    elif case == "paged":
        t = [torch.from_numpy(a) for a in
             _paged_inputs((2, 16, 2, 64, 8, 8, 4), seed=5)]
        t[:3] = [x.bfloat16() for x in t[:3]]
        counter = tpa.launches
        call = lambda: ops.paged_attention(*t)  # noqa: E731
    else:
        rng = np.random.RandomState(5)
        x, b, c = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16() for shape in
            ((1, 40, 4, 64), (1, 40, 1, 128), (1, 40, 1, 128))]
        dt = torch.rand(1, 40, 4)
        a = -torch.rand(4)
        counter = tss.launches
        call = lambda: ops.ssd(x, dt, a, b, c, chunk=128)[0]  # noqa: E731
    before = dict(counter.by_variant), counter.count
    out = call()
    assert torch.isfinite(out.float()).all()
    assert (dict(counter.by_variant), counter.count) == before
