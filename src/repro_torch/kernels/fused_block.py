"""The decoder block's elementwise chain: three hand-written Hopper kernels,
their wrappers and their plain PyTorch versions.

Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it inside ``jit``.  The port runs eagerly, where the same chain took
about 77 launches a decoder block, and the serving engine's host spent its
decode step launching them while the card idled.  The kernels are in
``csrc/fused_block.cu``:

* :func:`add_rms_norm` — ``(x + r, rms_norm(x + r) * scale)`` in one pass,
  one block a row; without ``r`` the plain norm of ``x``.  It takes the
  residual add after attention, the add after the FFN (folded into the next
  block's first norm) and the final norm.
* :func:`qk_norm_rope_write` — the q/k RMSNorm (where the config has one,
  as Qwen3), the rotate-half RoPE from the step's ``cos`` / ``sin`` table,
  q written out, k and v stored straight into the pages at each row's
  ``(wr_page, wr_slot)``.  A negative page writes nothing: padding rows and
  lanes leave every page byte as it was.
* :func:`silu_mul` — ``silu(gate) * up``.

Bound on H100: bytes, and at the decode step's size the latency of one
launch (a tensor of 32 rows x 5120 in bf16 is 320 KB, 0.1 us at
3.35 TB/s).  Each kernel reads its operands once and writes its results
once; intermediate values stay in registers.  The arithmetic is the plain
chain's: fp32 inside, rounded to the storage type where the chain rounds,
no fused multiply-add; only the order of a row's sum of squares differs.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs the plain version, which is the chain the models compute
(``models/layers.py`` ``rms_norm``, ``apply_rope``'s rotation, ``F.silu``
and the product) op for op.  There is no fallback.  The kernels take
float32 and bfloat16 storage and compute in fp32; they take no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6           # models/layers.py rms_norm's default
MAX_HEAD_DIM = 256   # the kernel's lane holds up to 4 rotation pairs

# launches by kernel: "add_rms_norm", "qk_norm_rope_write", "silu_mul"
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, r, scale, sum_out, out; rows, d; eps; dtype; stream
_NORM_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# q, k, v, q_scale, k_scale, cos, sin, k_pages, v_pages, wr_page, wr_slot,
# q_out; rows, H, Hkv, D, page_size; eps; dtype; stream
_QK_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# gate, up, out; n; dtype; stream
_SILU_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p]


def _dtype_code(name, *tensors) -> int:
    dt = tensors[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"{name}: dtype {dt} not supported (float32 or "
                        f"bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name}: every tensor must share one dtype and "
                            f"one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    return _DTYPES[dt]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------- add + RMSNorm


def add_rms_norm_plain(x, r, scale, eps: float = EPS):
    """``(s, rms_norm(s, scale))`` with ``s = x + r`` (``x`` when ``r`` is
    None): the residual add and the norm as the models compute them."""
    from ..models.layers import rms_norm   # models import kernels.ops
    s = x if r is None else x + r
    return s, rms_norm(s, scale, eps)


def add_rms_norm_cuda(x, r, scale, eps: float = EPS):
    """Launch ``add_rms_norm`` of ``csrc/fused_block.cu`` on the current
    stream."""
    tensors = (x, scale) if r is None else (x, scale, r)
    code = _dtype_code("add_rms_norm", *tensors)
    d = x.shape[-1]
    if scale.shape != (d,) or (r is not None and r.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, r "
                         f"{None if r is None else tuple(r.shape)}, scale "
                         f"{tuple(scale.shape)}")
    s = x if r is None else torch.empty_like(x)
    out = torch.empty_like(x)
    fn = build.function("fused_block", "add_rms_norm_launch", _NORM_ARGTYPES)
    build.check("fused_block", build.call_on(
        x.device, fn, x.data_ptr(), _ptr(r), scale.data_ptr(),
        0 if r is None else s.data_ptr(), out.data_ptr(), x.numel() // d, d,
        eps, code))
    launches.add("add_rms_norm")
    return s, out


def add_rms_norm(x, r, scale, eps: float = EPS):
    """x, r (..., d) (``r`` may be None), scale (d,) → (x + r, its RMSNorm
    times ``scale``), both in x's dtype.  CUDA tensors launch the kernel,
    CPU tensors run :func:`add_rms_norm_plain`."""
    if x.is_cuda:
        return add_rms_norm_cuda(x, r, scale, eps)
    if x.device.type != "cpu":
        raise ValueError(f"add_rms_norm: no kernel for device {x.device}")
    return add_rms_norm_plain(x, r, scale, eps)


# --------------------------------------- q/k RMSNorm + RoPE + K/V write


def _rope_plain(x, cos, sin):
    """``apply_rope`` (``models/layers.py``) with the step's table: x
    (..., H, D), cos / sin (..., D/2) = cos / sin of its angles."""
    half = x.shape[-1] // 2
    c, s = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def qk_norm_rope_write_plain(q, k, v, q_scale, k_scale, cos, sin, k_pages,
                             v_pages, wr_page, wr_slot, eps: float = EPS):
    """The q/k norm (``rms_norm``, where ``q_scale`` is given), the
    rotation, and the K/V store of the rows whose page is not negative
    (``index_put_`` on those rows only), as the engine's chain did it;
    returns the rotated q."""
    from ..models.layers import rms_norm   # models import kernels.ops
    if q_scale is not None:
        q = rms_norm(q, q_scale, eps)
        k = rms_norm(k, k_scale, eps)
    q = _rope_plain(q, cos, sin)
    k = _rope_plain(k, cos, sin)
    live = wr_page >= 0
    page, slot = wr_page[live], wr_slot[live]
    kv_shape = (wr_page.shape[0],) + k_pages.shape[2:]
    k_pages[page, slot] = k.reshape(kv_shape)[live]
    v_pages[page, slot] = v.reshape(kv_shape)[live]
    return q


def qk_norm_rope_write_cuda(q, k, v, q_scale, k_scale, cos, sin, k_pages,
                            v_pages, wr_page, wr_slot, eps: float = EPS):
    """Launch ``qk_norm_rope_write`` of ``csrc/fused_block.cu`` on the
    current stream."""
    scales = () if q_scale is None else (q_scale, k_scale)
    code = _dtype_code("qk_norm_rope_write", q, k, v, k_pages, v_pages,
                       *scales)
    h, d = q.shape[-2:]
    hkv = k.shape[-2]
    n = wr_page.shape[0]
    page_size = k_pages.shape[1]
    half = d // 2
    if d % 2 or d > MAX_HEAD_DIM or q.numel() != n * h * d or \
            k.shape != v.shape or k.numel() != n * hkv * d or \
            k_pages.shape[2:] != (hkv, d) or v_pages.shape != k_pages.shape \
            or cos.numel() != n * half or sin.shape != cos.shape or \
            wr_slot.shape != (n,) or \
            (q_scale is not None and (q_scale.shape != (d,) or
                                      k_scale.shape != (d,))):
        raise ValueError(
            f"qk_norm_rope_write: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, cos {tuple(cos.shape)}, pages "
            f"{tuple(k_pages.shape)}, targets {tuple(wr_page.shape)} / "
            f"{tuple(wr_slot.shape)}")
    for t, dt in ((cos, torch.float32), (sin, torch.float32),
                  (wr_page, torch.int64), (wr_slot, torch.int64)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise TypeError("qk_norm_rope_write: cos / sin must be float32, "
                            "wr_page / wr_slot int64, contiguous, on q's "
                            "device")
    q_out = torch.empty_like(q)
    fn = build.function("fused_block", "qk_norm_rope_write_launch",
                        _QK_ARGTYPES)
    build.check("fused_block", build.call_on(
        q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(q_scale), _ptr(k_scale), cos.data_ptr(), sin.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), wr_page.data_ptr(),
        wr_slot.data_ptr(), q_out.data_ptr(), n, h, hkv, d, page_size, eps,
        code))
    launches.add("qk_norm_rope_write")
    return q_out


def qk_norm_rope_write(q, k, v, q_scale, k_scale, cos, sin, k_pages,
                       v_pages, wr_page, wr_slot, eps: float = EPS):
    """q (..., H, D), k / v (..., Hkv, D) over N rows; q_scale / k_scale
    (D,) or both None (no q/k norm); cos / sin (..., D/2) float32 of the
    rows' rope angles; k_pages / v_pages (P, page, Hkv, D) of one layer,
    updated in place; wr_page / wr_slot (N,) int64, a negative page writing
    nothing → the normed, rotated q (..., H, D).  CUDA tensors launch the
    kernel, CPU tensors run :func:`qk_norm_rope_write_plain`."""
    if q.is_cuda:
        return qk_norm_rope_write_cuda(q, k, v, q_scale, k_scale, cos, sin,
                                       k_pages, v_pages, wr_page, wr_slot,
                                       eps)
    if q.device.type != "cpu":
        raise ValueError(f"qk_norm_rope_write: no kernel for device "
                         f"{q.device}")
    return qk_norm_rope_write_plain(q, k, v, q_scale, k_scale, cos, sin,
                                    k_pages, v_pages, wr_page, wr_slot, eps)


# ------------------------------------------------------------ SiLU * mul


def silu_mul_plain(gate, up):
    """``F.silu(gate) * up``, the SwiGLU of ``models/transformer.py``'s
    ``ffn_apply``."""
    return F.silu(gate) * up


def silu_mul_cuda(gate, up):
    """Launch ``silu_mul`` of ``csrc/fused_block.cu`` on the current
    stream."""
    code = _dtype_code("silu_mul", gate, up)
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}")
    out = torch.empty_like(gate)
    fn = build.function("fused_block", "silu_mul_launch", _SILU_ARGTYPES)
    build.check("fused_block", build.call_on(
        gate.device, fn, gate.data_ptr(), up.data_ptr(), out.data_ptr(),
        gate.numel(), code))
    launches.add("silu_mul")
    return out


def silu_mul(gate, up):
    """``silu(gate) * up`` of two tensors of one shape.  CUDA tensors
    launch the kernel, CPU tensors run :func:`silu_mul_plain`."""
    if gate.is_cuda:
        return silu_mul_cuda(gate, up)
    if gate.device.type != "cpu":
        raise ValueError(f"silu_mul: no kernel for device {gate.device}")
    return silu_mul_plain(gate, up)
