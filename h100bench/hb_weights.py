"""Seeded weights on the device, for an architecture's ``make_weights``
(``archs/<model_type>.py``).

Every matrix of one fan-in shares one buffer, filled by a few large
``normal_`` calls of one ``torch.Generator`` on the device in the served
type, so the same seed gives the same bytes and making 61 GiB takes
seconds.  Leaves are views into those buffers, handed out in order by a
:class:`Carver`.
"""

from __future__ import annotations

import math

import torch

FILL_CHUNK = 1 << 28          # elements a normal_ call fills


def _fill(buf: torch.Tensor, std: float, gen: torch.Generator,
          mean: float = 0.0) -> None:
    flat = buf.view(-1)
    for a in range(0, flat.numel(), FILL_CHUNK):
        flat[a:a + FILL_CHUNK].normal_(mean, std, generator=gen)


class Carver:
    """Hands out consecutive views of one flat buffer."""

    def __init__(self, buf: torch.Tensor):
        self.buf, self.at = buf, 0

    def take(self, *shape) -> torch.Tensor:
        n = math.prod(shape)
        out = self.buf[self.at:self.at + n].view(*shape)
        self.at += n
        return out


def buffer(n: int, std: float, gen: torch.Generator, device, dtype,
           mean: float = 0.0) -> Carver:
    """``n`` elements drawn N(mean, std^2) from ``gen``, as a
    :class:`Carver`.  Buffers drawn in the same order from one seeded
    generator repeat byte for byte."""
    buf = torch.empty(n, dtype=dtype, device=device)
    _fill(buf, std, gen, mean)
    return Carver(buf)
