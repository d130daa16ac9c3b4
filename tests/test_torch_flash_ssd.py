"""The plain versions of the port's flash-attention and SSD kernels held
against the JAX package on identical inputs: against its Pallas kernels
run in interpret mode (as ``tests/test_kernels.py`` runs them on the CPU)
and against its oracles, at the tolerances of ``tests/test_kernels.py``
(attention 3e-5 fp32 / 2e-2 bf16; SSD 2e-4 / 4e-2).  Inputs are made with
numpy from a seed and handed to both frameworks.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import layers
from test_torch_kernels_cuda import (
    FLASH_SHAPES,
    SSD_SHAPES,
    SSD_TOLS,
    TOLS,
    _flash_inputs,
    _np,
    _ssd_inputs,
)


def _both(arrays, dtype):
    """numpy fp32 arrays → (jax arrays, torch CPU tensors), each cast to
    ``dtype`` in its framework from the same values."""
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_jax_kernel(shape, dtype, causal):
    """The port's dispatch on CPU tensors (its plain version) against the
    Pallas kernel in interpret mode and the JAX oracle."""
    bq, bk = shape[6:]
    (jq, jk, jv), (q, k, v) = _both(_flash_inputs(shape, seed=1), dtype)
    before = tfa.launches.count
    out = _np(ops.flash_attention(q, k, v, causal=causal))
    assert tfa.launches.count == before, "a CPU tensor launched a kernel"
    kernel = _np(jflash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                        interpret=True))
    np.testing.assert_allclose(out, kernel, **TOLS[dtype])
    np.testing.assert_allclose(
        out, _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOLS[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_length(causal):
    """Sq = Sk = 40, which neither the JAX dispatch's blocks (it asks for
    Sq % block_q == 0) nor the model's KV chunk of 16 divides: the port
    computes the function anyway, and its ``blockwise_attention`` agrees
    with the JAX one."""
    (jq, jk, jv), (q, k, v) = _both(
        _flash_inputs((2, 40, 40, 4, 2, 16), seed=2), "float32")
    out = _np(layers.blockwise_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(
        out, _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOLS["float32"])
    np.testing.assert_allclose(
        out, _np(jlayers.blockwise_attention(jq, jk, jv, causal=causal,
                                             chunk=16)), **TOLS["float32"])


def test_flash_oracle_cross_lengths_and_causal_contract():
    """The port's oracle keeps the JAX oracle's bottom-right causal mask
    for Sq != Sk; the kernel's contract (top-left) admits causal calls
    with Sq == Sk only, and both its versions refuse the rest."""
    (jq, jk, jv), (q, k, v) = _both(
        _flash_inputs((2, 24, 40, 4, 1, 32), seed=3), "float32")
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(tref.flash_attention_ref(q, k, v, causal=causal)),
            _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
            **TOLS["float32"])
    np.testing.assert_allclose(
        _np(ops.flash_attention(q, k, v, causal=False)),
        _np(jref.flash_attention_ref(jq, jk, jv, causal=False)),
        **TOLS["float32"])
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa._check(q, k, v, True)


@pytest.mark.parametrize("case", ["dtype", "mixed", "gqa", "head_dim",
                                  "contiguous"])
def test_flash_wrapper_validates_inputs(case):
    """The CUDA wrapper's checks run before any launch (and so run here)."""
    q, k, v = [torch.from_numpy(a) for a in
               _flash_inputs((1, 8, 8, 4, 2, 16), seed=4)]
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "gqa":
        q = torch.zeros((1, 8, 3, 16))
    elif case == "head_dim":
        q, k, v = [torch.zeros(t.shape[:3] + (256,)) for t in (q, k, v)]
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tfa._check(q, k, v, False)


# ------------------------------------------------------------------ SSD


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_matches_jax_kernel(shape, dtype):
    """y and the final state of the port's dispatch on CPU tensors against
    the Pallas kernel in interpret mode and the sequential JAX oracle."""
    chunk = shape[6]
    jx, tx = _both(_ssd_inputs(shape, seed=5), dtype)
    jx[2], tx[2] = jx[2].astype(jnp.float32), tx[2].float()   # a in fp32
    before = tss.launches.count
    y, final = ops.ssd(*tx, chunk=chunk)
    assert tss.launches.count == before, "a CPU tensor launched a kernel"
    assert y.dtype == tx[0].dtype and final.dtype == torch.float32
    ky, kf = jssd_scan(*jx, chunk=chunk, interpret=True)
    ry, rf = jref.ssd_ref(*jx)
    for want_y, want_f in ((ky, kf), (ry, rf)):
        np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS[dtype])
        np.testing.assert_allclose(_np(final), _np(want_f),
                                   **SSD_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_ragged_groups_and_skip(dtype):
    """S = 40 against chunk 16 (a ragged last chunk, which the Pallas
    kernel refuses), G = 2 groups over 4 heads and a nonzero d_skip added
    in fp32 before the cast: y and the final state against both JAX
    oracles."""
    arrays = _ssd_inputs((2, 40, 4, 8, 2, 16), seed=6, d_skip=True)
    jx, tx = _both(arrays, dtype)
    for i in (1, 2, 5):                  # dt, a, d_skip in fp32
        jx[i], tx[i] = jnp.asarray(arrays[i]), torch.from_numpy(arrays[i])
    y, final = ops.ssd(*tx[:5], chunk=16, d_skip=tx[5])
    for oracle in (jref.ssd_ref, jref.ssd_chunked_ref):
        want_y, want_f = oracle(*jx[:5], chunk=16, d_skip=jx[5])
        np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS[dtype])
        np.testing.assert_allclose(_np(final), _np(want_f),
                                   **SSD_TOLS[dtype])


@pytest.mark.parametrize("oracle", ["ssd_ref", "ssd_chunked_ref"])
def test_ssd_oracles_match_jax_with_initial_state(oracle):
    arrays = _ssd_inputs((2, 48, 4, 8, 2, 16), seed=7, d_skip=True)
    h0 = np.random.RandomState(8).standard_normal(
        (2, 4, 8, 16)).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    want_y, want_f = getattr(jref, oracle)(
        *jx[:5], chunk=16, d_skip=jx[5], initial_state=jnp.asarray(h0))
    y, final = getattr(tref, oracle)(*tx[:5], chunk=16, d_skip=tx[5],
                                     initial_state=torch.from_numpy(h0))
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS["float32"])
    np.testing.assert_allclose(_np(final), _np(want_f),
                               **SSD_TOLS["float32"])


@pytest.mark.parametrize("d_skip", [True, False])
def test_ssd_quadratic_fp64_matches_jax_oracle(d_skip):
    """``ssd_quadratic`` on fp64 inputs (the fp64 path of the gradient
    holds) against JAX's sequential fp32 oracle on the same values, at
    the fp32 SSD tolerance, over G = 2 groups of 4 heads."""
    arrays = _ssd_inputs((2, 40, 4, 8, 2, 16), seed=10, d_skip=d_skip)
    want_y, _ = jref.ssd_ref(*[jnp.asarray(a) for a in arrays[:5]],
                             d_skip=jnp.asarray(arrays[5]) if d_skip
                             else None)
    t = [torch.from_numpy(a).double() for a in arrays]
    y, final = tref.ssd_quadratic(*t[:5], d_skip=t[5] if d_skip else None)
    assert y.dtype == torch.float64 and final is None
    np.testing.assert_allclose(y.numpy(), _np(want_y), **SSD_TOLS["float32"])


def test_ssd_plain_strong_decay_stays_finite():
    """Log-decay summing past 88 inside a chunk: the decay factor above
    the diagonal is selected away, never multiplied by 0."""
    arrays = _ssd_inputs((1, 48, 2, 8, 1, 16), seed=9, decay=8.0)
    jx, tx = _both(arrays, "float32")
    y, final = ops.ssd(*tx, chunk=16)
    assert np.all(np.isfinite(_np(y))) and np.all(np.isfinite(_np(final)))
    want_y, want_f = jref.ssd_ref(*jx)
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOLS["float32"])
    np.testing.assert_allclose(_np(final), _np(want_f),
                               **SSD_TOLS["float32"])


@pytest.mark.parametrize("case", ["dtype", "mixed", "groups", "dt_shape",
                                  "chunk", "state", "contiguous"])
def test_ssd_wrapper_validates_inputs(case):
    x, dt, a, b, c = [torch.from_numpy(t) for t in
                      _ssd_inputs((1, 8, 4, 8, 2, 16), seed=10)]
    chunk = 16
    if case == "dtype":
        x, b, c = x.half(), b.half(), c.half()
    elif case == "mixed":
        b = b.bfloat16()
    elif case == "groups":
        b = c = torch.zeros((1, 8, 3, 16))
    elif case == "dt_shape":
        dt = dt[:, :4]
    elif case == "chunk":
        chunk = 256
    elif case == "state":
        b = c = torch.zeros((1, 8, 2, 256))
    else:
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        tss._check(x, dt, a, b, c, chunk, None)


@pytest.mark.parametrize("d,want", [(64, "tf32x3"), (128, "tf32x3"),
                                    (192, "tf32x3"), (32, "fma"),
                                    (96, "fma")])
def test_fp32_variants_flash_tf32x3_paged_and_ssd_fma(d, want):
    """fp32 on a card: flash takes the 3xTF32 variant at its tensor-core
    head dims and the FMA one elsewhere; paged decode and the SSD scan
    keep ``fma`` for fp32 (not yet redesigned)."""
    assert tfa.kernel_variant(torch.float32, d, "cuda") == want
    if d in (64, 128):
        assert tpa.kernel_variant(torch.float32, d, 8, "cuda") == "fma"
        assert tss.kernel_variant(torch.float32, d, 128, 128,
                                  "cuda") == "fma"


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("p,n,chunk", [(64, 128, 128), (64, 64, 128),
                                       (64, 32, 128), (32, 128, 128),
                                       (64, 128, 64), (64, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_variant_by_dtype_shape_device(dtype, p, n, chunk,
                                                  device):
    """SSD: the mma variant for bf16 at P = 64, N = 64 or 128 and chunk 128
    on a card (Mamba2-1.3B and Zamba2-1.2B), the FMA variant for fp32 and
    every other shape, the plain version on the CPU; a device with no
    kernel raises."""
    if device == "cpu":
        want = "plain"
    elif dtype == torch.bfloat16 and p == 64 and n in (64, 128) and \
            chunk == 128:
        want = "mma"
    else:
        want = "fma"
    assert tss.kernel_variant(dtype, p, n, chunk, device) == want
    with pytest.raises(ValueError, match="no kernel"):
        tss.kernel_variant(dtype, p, n, chunk, "meta")
