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
from repro_torch.kernels import packed_prefill as tpp
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
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
    ttoks, tlps = ops.sample_tokens(torch.from_numpy(logits), temps)
    assert ttoks.tolist() == np.asarray(toks).tolist()
    assert ttoks[0].item() == 7
    assert np.all(tlps.numpy() == 0.0) and np.all(np.asarray(lps) == 0.0)


def test_sample_tokens_refuses_temperature():
    with pytest.raises(NotImplementedError, match="A.5"):
        ops.sample_tokens(torch.zeros((2, 8)), [0.0, 0.7])


def test_default_num_splits_for_132_sms():
    # 32 (row, kv head) pairs at the serving batch: ~2 blocks per SM
    assert tpa.default_num_splits(8, 4, 128) == 9
    # never fewer than four pages per split, never more than the combine
    # kernel takes
    assert tpa.default_num_splits(1, 1, 8) == 2
    assert tpa.default_num_splits(1, 1, 3) == 1
    assert tpa.default_num_splits(1, 1, 10_000) == tpa.MAX_SPLITS


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
    for _ in range(3):
        c.add()
    assert c.count == 3
    c.reset()
    assert c.count == 0
