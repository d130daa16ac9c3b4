"""The yardstick's peaks and the least time a piece of work can take on
the card.  The operations and bytes of each kernel, and the model FLOPs of
a token, are the architecture's (``archs/<model_type>.py``).

``bound`` and the peaks above it are copies of ``chip_smoke.py``'s,
unchanged in arithmetic, kept here so the yardstick does not move when
the smoke script does.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# fp32 at 165 TFLOP/s: the 3xTF32 kernels do fp32-accurate work on the
# tensor cores at 495 / 3 (three TF32 products a product), above the
# card's 67 TFLOP/s of fp32 FMA, so that is the least time for fp32 work.
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
