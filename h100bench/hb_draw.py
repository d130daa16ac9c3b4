"""What the traffic generators share: a request's spec, and stratified
draws.

A stratified draw of n values takes the distribution's quantiles at
(i + 0.5) / n and hands them out in an order the seed permutes.  Every
seed then gets the same multiset of lengths in another order, so two
seeds differ in which request is long and in the token ids, not in how
much work the run holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np


@dataclass
class Spec:
    """One request as the client sends it: token ids and how many tokens
    to generate, greedily."""

    prompt: List[int]
    max_new: int


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per (run seed, named stream)."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), tag])


def strata(rng: np.random.Generator, n: int,
           ppf: Callable[[float], float]) -> np.ndarray:
    """n values of the distribution whose inverse CDF is ``ppf``, at the
    quantiles (i + 0.5) / n, in a seeded order."""
    vals = np.array([ppf((i + 0.5) / n) for i in range(n)])
    return vals[rng.permutation(n)]


def uniform_ppf(lo: float, hi: float, multiple: int = 1):
    """Inverse CDF of a uniform on [lo, hi], rounded to a whole multiple
    of ``multiple``."""
    def ppf(u):
        return max(multiple,
                   int(round((lo + u * (hi - lo)) / multiple)) * multiple)
    return ppf


def tokens(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    """n token ids uniform over the vocabulary."""
    return rng.integers(0, vocab, size=int(n)).tolist()


