"""The hand-written CUDA kernels held against their plain PyTorch versions
on the card, at small shapes that the serving path does not reach (GQA
groups 1–8, head dims 16–64, pages of 4–16, split counts that do not
divide the page count, ragged lane blocks).

Every test here needs a CUDA device and skips without one; this module
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The input builders are shared with ``tests/test_torch_kernels.py``, which
holds the plain versions against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import packed_prefill as tpp
from repro_torch.kernels import paged_attention as tpa

TOLS = {"float32": dict(rtol=3e-5, atol=3e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}

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
