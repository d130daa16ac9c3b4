"""Tails are taken over every gap; an injected stall raises the gap
tail."""

from dataclasses import dataclass, field

import hb_stats


@dataclass
class Rec:
    due: float
    out_times: list = field(default_factory=list)
    done_at_end: bool = True


def served(stall_every=0, stall_s=0.5, n=200, tokens=8, step=0.05):
    """Requests due every 50 ms, each served one token a step from the
    first step after it is due; with ``stall_every`` the engine stalls
    ``stall_s`` after every ``stall_every``-th step."""
    def t(k):
        return k * step + (stall_s * (k // stall_every) if stall_every else 0)
    recs, k_of = [], lambda due: next(k for k in range(10**6) if t(k) > due)
    for i in range(n):
        due = i * step + 0.01
        k = k_of(due)
        recs.append(Rec(due, [t(k + j) for j in range(tokens)]))
    return recs


def test_stall_raises_the_gap_tail():
    base, stalled = served(), served(stall_every=10)
    end = 10.0
    i_a = hb_stats.p95(hb_stats.itl_values(base, 0.0, end))
    i_b = hb_stats.p95(hb_stats.itl_values(stalled, 0.0, end))
    assert i_b > 5 * i_a
    # a median of the gaps would not have seen it
    gaps = sorted(hb_stats.itl_values(stalled, 0.0, end))
    assert gaps[len(gaps) // 2] < 0.06


def test_open_gap_counts_at_the_end():
    r = Rec(0.0, [0.1, 0.2], done_at_end=False)
    assert hb_stats.itl_values([r], 0.0, 3.0) == [0.1, 3.0 - 0.2]
    done = Rec(0.0, [0.1, 0.2], done_at_end=True)
    assert hb_stats.itl_values([done], 0.0, 3.0) == [0.1]


def test_tokens_in_window_only():
    r = Rec(-1.0, [-0.5, 0.5, 1.5, 2.5])
    assert hb_stats.tokens_in([r], 0.0, 2.0) == 2


def test_p95_of_nothing():
    assert hb_stats.p95([]) is None
