"""End-to-end numbers from the client's records, on the host's clock.

Every request keeps the engine's stamp of each emitted token
(``Request.out_times``).  Tails are taken over every gap, never over
medians of parts.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def p95(values: Sequence[float]):
    """The 95th percentile (linear between ranks); None for no values."""
    return float(np.percentile(values, 95)) if len(values) else None


def itl_values(records, t0: float, t_end: float) -> List[float]:
    """Every gap between consecutive tokens of one request whose closing
    token came in [t0, t_end), and for each request still open at t_end
    (a token out, not finished) the open gap to t_end.  Gaps across a
    preemption or a migration count like any other."""
    out = []
    for r in records:
        ts = list(r.out_times)
        for a, b in zip(ts, ts[1:]):
            if t0 <= b < t_end:
                out.append(b - a)
        inside = [t for t in ts if t < t_end]
        finished = r.done_at_end and len(inside) == len(ts)
        if inside and not finished:
            out.append(t_end - inside[-1])
    return out


def tokens_in(records, t0: float, t_end: float) -> int:
    """Output tokens emitted in [t0, t_end)."""
    return sum(1 for r in records for t in r.out_times if t0 <= t < t_end)
