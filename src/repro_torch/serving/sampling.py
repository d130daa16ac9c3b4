"""Named sampling policies for the serving session — replay-first.

The engine was greedy-argmax-only; migration (§14) and swap resume (§15)
leaned on "greedy determinism ⇒ token-exact continuation".  This registry
introduces stochastic sampling *without* giving that up: every random draw
comes from a **stateless counter-based PRNG** keyed by ``(request_seed,
absolute_token_position, stream)`` — no RNG state object advances, so a
resume path that re-enters decode at position ``t`` reproduces exactly the
draw the uninterrupted run would have made at ``t``.  Replay paths
additionally teacher-force recorded ``out_tokens`` (``Request.fold_emitted``)
and never re-sample an already-emitted position; the PRNG keying is the
second, independent line of defense (DESIGN.md §17).

Policies mirror the admission/eviction/scheduler registries
(:mod:`repro.serving.policies`): named classes, ``SAMPLING_POLICIES``,
``sampling_policies()`` and ``as_sampling_policy()``.

* ``greedy`` — argmax; bit-identical to the pre-sampling engine (the fused
  sampler special-cases ``temperature <= 0`` to a plain ``argmax``).
* ``temperature`` — softmax at ``temperature``; gumbel-max trick on-device.
* ``top_k`` — keep the ``k`` highest logits, then temperature-sample.
* ``top_p`` — smallest nucleus whose mass reaches ``p`` (the first token is
  always kept), then temperature-sample.

Every policy also carries the per-request knobs: ``seed`` (the counter-PRNG
key; defaults to 0 so two submissions with equal params are comparable),
``stop`` (token-id stop sequences, matched host-side against the emitted
suffix; the matched tokens are included in the output), and ``logprobs``
(record the sampled token's log-probability under the *filtered* distribution
on the handle).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

__all__ = [
    "SamplingPolicy",
    "GreedySampling",
    "TemperatureSampling",
    "TopKSampling",
    "TopPSampling",
    "SAMPLING_POLICIES",
    "sampling_policies",
    "as_sampling_policy",
]


def _norm_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    """Normalize stop sequences to a tuple of non-empty int tuples."""
    if not stop:
        return ()
    out = []
    for s in stop:
        if isinstance(s, int):
            s = (s,)
        toks = tuple(int(t) for t in s)
        if not toks:
            raise ValueError("empty stop sequence")
        out.append(toks)
    return tuple(out)


class SamplingPolicy:
    """One request's token-selection rule plus its replay identity.

    Subclasses pin the filter; the base owns the shared knobs and the
    operand view the engine fuses on-device: ``operands()`` returns
    ``(temperature, top_k, top_p, seed)`` with ``temperature == 0.0``
    meaning exact argmax (the greedy fast path the replay tests pin)."""

    name = "base"

    def __init__(self, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 stop: Sequence = (), logprobs: bool = False):
        temperature = float(temperature)
        top_k = int(top_k)
        top_p = float(top_p)
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
        if not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.stop = _norm_stop(stop)
        self.logprobs = bool(logprobs)

    def operands(self) -> Tuple[float, int, float, int]:
        return (self.temperature, self.top_k, self.top_p, self.seed)

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"{type(self).__name__}(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, seed={self.seed})")


class GreedySampling(SamplingPolicy):
    """Argmax — the engine's historical behavior, kept bit-exact."""

    name = "greedy"

    def __init__(self, *, seed: int = 0, stop: Sequence = (),
                 logprobs: bool = False):
        super().__init__(temperature=0.0, seed=seed, stop=stop,
                         logprobs=logprobs)


class TemperatureSampling(SamplingPolicy):
    """Plain softmax sampling at ``temperature`` (> 0)."""

    name = "temperature"

    def __init__(self, *, temperature: float = 1.0, seed: int = 0,
                 stop: Sequence = (), logprobs: bool = False):
        if float(temperature) <= 0.0:
            raise ValueError(
                f"temperature sampling needs temperature > 0, got "
                f"{temperature} (use 'greedy' for argmax)")
        super().__init__(temperature=temperature, seed=seed, stop=stop,
                         logprobs=logprobs)


class TopKSampling(SamplingPolicy):
    """Keep the ``k`` highest logits, then temperature-sample."""

    name = "top_k"

    def __init__(self, *, k: int = 40, temperature: float = 1.0,
                 seed: int = 0, stop: Sequence = (), logprobs: bool = False):
        if int(k) < 1:
            raise ValueError(f"top_k sampling needs k >= 1, got {k}")
        if float(temperature) <= 0.0:
            raise ValueError(
                f"top_k sampling needs temperature > 0, got {temperature}")
        super().__init__(temperature=temperature, top_k=k, seed=seed,
                         stop=stop, logprobs=logprobs)


class TopPSampling(SamplingPolicy):
    """Nucleus sampling: smallest prefix of the sorted distribution whose
    mass reaches ``p`` (the most likely token is always kept)."""

    name = "top_p"

    def __init__(self, *, p: float = 0.9, temperature: float = 1.0,
                 seed: int = 0, stop: Sequence = (), logprobs: bool = False):
        if not (0.0 < float(p) <= 1.0):
            raise ValueError(f"top_p sampling needs p in (0, 1], got {p}")
        if float(temperature) <= 0.0:
            raise ValueError(
                f"top_p sampling needs temperature > 0, got {temperature}")
        super().__init__(temperature=temperature, top_p=p, seed=seed,
                         stop=stop, logprobs=logprobs)


SAMPLING_POLICIES = {
    cls.name: cls for cls in (GreedySampling, TemperatureSampling,
                              TopKSampling, TopPSampling)
}


def sampling_policies() -> List[str]:
    return list(SAMPLING_POLICIES)


def as_sampling_policy(policy: Union[str, SamplingPolicy, None]
                       ) -> SamplingPolicy:
    """Name → fresh policy instance (per-request knobs at defaults);
    instances pass through; ``None`` picks ``greedy``."""
    if policy is None:
        return GreedySampling()
    if isinstance(policy, SamplingPolicy):
        return policy
    try:
        return SAMPLING_POLICIES[policy]()
    except (KeyError, TypeError):
        raise ValueError(f"unknown sampling policy {policy!r}; choose "
                         f"from {sampling_policies()}") from None
