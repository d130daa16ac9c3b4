"""``repro.api`` — the one construction surface for concurrent maps.

The paper's claim is that SCOT keeps SMR schemes *intact* while making
structures compatible; this facade is where that compatibility is
**negotiated** instead of assumed.  Everything the serving engine, the
workload driver, the benchmarks and the examples build goes through::

    from repro import api

    smr = api.scheme("IBR", retire_scan_freq=16)
    ds  = api.build("HList", smr=smr, traversal="waitfree")

``build`` resolves through two registries — schemes declare capabilities
(robustness, cumulative protection, reclaiming, batch-hint legality, slot
count), structures declare requirements (slot budget, supported traversal
policies) — and fails fast with an :class:`IncompatiblePairError`
diagnostic on illegal pairs, e.g. the Figure-1 pair (unvalidated
optimistic traversal under a robust scheme)::

    api.build("HList", smr="HP", traversal="optimistic")
    # IncompatiblePairError: traversal 'optimistic' skips SCOT validation,
    # which is a use-after-free under robust scheme HP (paper Fig. 1); ...

Traversal strategies are named policy objects (``"optimistic"``,
``"scot"``, ``"hm"``, ``"waitfree"`` — see
:mod:`repro.core.structures.traversal` and DESIGN.md §10 for the
wait-free variant), replacing the old ``scot=``/``recovery=`` boolean
soup.  Capability queries (``api.schemes(robust=True)``) replace the
hardcoded scheme lists the benchmarks used to carry.

Direct structure construction (``HarrisList(smr, ...)``) remains available
as the *unguarded* layer — the legacy boolean kwargs still work for one
release (with a ``DeprecationWarning``) and deliberately bypass
negotiation; that is how the Figure-1 demonstrations build the known-unsafe
pair.  Through the facade the same escape hatch is ``allow_unsafe=True``.
"""

from __future__ import annotations

from typing import Optional, Union

from ..core.smr.base import SmrScheme
from ..core.structures.traversal import (
    CarefulHM,
    IncompatiblePairError,
    OptimisticSCOT,
    PlainOptimistic,
    TraversalPolicy,
    WaitFreeSCOT,
    as_policy,
    default_policy,
)
from .registry import (
    SCHEME_REGISTRY,
    STRUCTURE_REGISTRY,
    SchemeInfo,
    StructureInfo,
    _make_scheme,
    capability_matrix,
    check,
    compatible,
    scheme_info,
    schemes,
    structure_info,
    structures,
    traversal_policies,
)

__all__ = [
    "IncompatiblePairError",
    "TraversalPolicy",
    "PlainOptimistic",
    "OptimisticSCOT",
    "CarefulHM",
    "WaitFreeSCOT",
    "SchemeInfo",
    "StructureInfo",
    "build",
    "scheme",
    "schemes",
    "structures",
    "traversal_policies",
    "admission_policies",
    "eviction_policies",
    "scheduler_policies",
    "sampling_policies",
    "fault_kinds",
    "scheme_info",
    "structure_info",
    "check",
    "compatible",
    "capability_matrix",
    "as_policy",
    "default_policy",
]


def admission_policies():
    """Serving admission-policy names (registry query, like
    :func:`traversal_policies`).  Lazy import: the serving layer depends on
    this facade, not the other way round."""
    from ..serving.policies import admission_policies as _q
    return _q()


def eviction_policies():
    """Prefix-cache eviction-policy names (registry query)."""
    from ..runtime.eviction import eviction_policies as _q
    return _q()


def scheduler_policies():
    """Chunked-prefill scheduler-policy names (registry query)."""
    from ..serving.policies import scheduler_policies as _q
    return _q()


def sampling_policies():
    """Serving sampling-policy names (registry query — the replay-exact
    on-device sampling registry, DESIGN.md §17)."""
    from ..serving.sampling import sampling_policies as _q
    return _q()


def fault_kinds():
    """Chaos-injection fault kinds (registry query — the serving fault
    plan, ``ServingConfig.faults`` / ``serve_paged --fault``)."""
    from ..serving.faults import fault_kinds as _q
    return _q()


def scheme(name: Union[str, SmrScheme] = "EBR", **kwargs) -> SmrScheme:
    """Construct (or pass through) an SMR scheme by registry name.

    The only sanctioned string→scheme resolution outside ``repro.core`` —
    consumers use this instead of private ``SCHEMES[...]`` lookups."""
    if isinstance(name, SmrScheme):
        if kwargs:
            raise TypeError("scheme(): kwargs make no sense with an "
                            "already-constructed scheme instance")
        return name
    return _make_scheme(scheme_info(name).name, **kwargs)


def build(structure: str = "HList",
          smr: Union[str, SmrScheme] = "EBR",
          traversal: Union[str, TraversalPolicy, None] = None,
          *,
          smr_kwargs: Optional[dict] = None,
          allow_unsafe: bool = False,
          **structure_kwargs):
    """Negotiate and construct a concurrent map.

    Parameters
    ----------
    structure:  registry name — ``api.structures()`` lists them.
    smr:        scheme name (constructed via ``smr_kwargs``) or a live
                :class:`SmrScheme` instance to share across structures.
    traversal:  policy name or :class:`TraversalPolicy` instance; ``None``
                picks the paper's default (SCOT iff the scheme is robust).
    allow_unsafe:  opt into a combination the negotiation would reject
                (e.g. the Figure-1 unvalidated-optimistic-under-HP pair)
                for demos and safety tests.
    **structure_kwargs:  forwarded to the structure constructor
                (``recycle=``, ``num_buckets=``, ``max_height=``, …).

    Raises :class:`IncompatiblePairError` on an illegal triple and
    ``ValueError`` on unknown names.
    """
    if isinstance(smr, SmrScheme):
        if smr_kwargs:
            raise TypeError("build(): smr_kwargs make no sense with an "
                            "already-constructed scheme instance")
        s = smr
    else:
        s = _make_scheme(scheme_info(smr).name, **(smr_kwargs or {}))
    entry = structure_info(structure)
    policy = check(structure, s, traversal, allow_unsafe=allow_unsafe)
    return entry.cls(s, policy=policy, **structure_kwargs)
