"""Capability-negotiated registries behind :func:`repro.api.build`.

Two registries, one negotiation:

* **Schemes** declare capabilities *on their classes* (``robust``,
  ``cumulative_protection``, ``reclaims``, ``batch_hints``, and the slot
  count an instance reserves) — this module only *reads* them, so adding a
  scheme to ``repro.core.smr.SCHEMES`` automatically updates every
  registry query (and therefore every benchmark grid built from one).
* **Structures** declare requirements: the traversal policies they can run
  (``cls.POLICIES``) and their hazard-slot budget per policy
  (``cls.slots_needed``).

:func:`check` is the single place the two meet.  Illegal combinations fail
fast with :class:`IncompatiblePairError` diagnostics instead of the old
scattered ``if scheme in (...)`` guards (or, worse, a silent Figure-1
use-after-free at runtime).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from ..core.smr import SCHEMES as _SCHEME_CLASSES
from ..core.smr import make_scheme
from ..core.smr.base import SmrScheme
from ..core.structures import (
    HarrisList,
    HarrisMichaelList,
    LockFreeHashMap,
    NMTree,
    SkipList,
)
from ..core.structures.traversal import (
    POLICY_NAMES,
    IncompatiblePairError,
    TraversalPolicy,
    as_policy,
    default_policy,
)

__all__ = [
    "SchemeInfo",
    "StructureInfo",
    "scheme_info",
    "structure_info",
    "schemes",
    "structures",
    "traversal_policies",
    "check",
    "compatible",
    "capability_matrix",
]


@dataclass(frozen=True)
class SchemeInfo:
    """A scheme's registry entry — capabilities read off its class."""

    name: str
    cls: type
    robust: bool
    cumulative_protection: bool
    reclaims: bool
    batch_hints: str
    default_slots: int


@dataclass(frozen=True)
class StructureInfo:
    """A structure's registry entry — requirements read off its class."""

    name: str
    cls: type
    policies: Tuple[str, ...]
    description: str

    def slots_needed(self, policy: TraversalPolicy) -> int:
        return self.cls.slots_needed(policy)


def _default_slots(cls: type) -> int:
    """The slot count an instance constructed with no arguments reserves —
    read off the constructor signature (walking the MRO past ``*args``
    forwarders like Hyaline1S) so name-based negotiation can never drift
    from what ``make_scheme(name)`` actually builds."""
    import inspect
    for klass in cls.__mro__:
        params = inspect.signature(klass.__init__).parameters
        p = params.get("num_slots")
        if p is not None and p.default is not inspect.Parameter.empty:
            return p.default
    raise TypeError(f"{cls.__name__}: no num_slots constructor default")


def _scheme_entry(name: str, cls: type) -> SchemeInfo:
    caps = cls.capabilities()
    return SchemeInfo(
        name=name, cls=cls, robust=caps["robust"],
        cumulative_protection=caps["cumulative_protection"],
        reclaims=caps["reclaims"], batch_hints=caps["batch_hints"],
        default_slots=_default_slots(cls),
    )


SCHEME_REGISTRY: Dict[str, SchemeInfo] = {
    name: _scheme_entry(name, cls) for name, cls in _SCHEME_CLASSES.items()
}

STRUCTURE_REGISTRY: Dict[str, StructureInfo] = {
    "HList": StructureInfo(
        "HList", HarrisList, HarrisList.POLICIES,
        "Harris' lock-free ordered list (optimistic traversals)"),
    "HMList": StructureInfo(
        "HMList", HarrisMichaelList, HarrisMichaelList.POLICIES,
        "Harris-Michael list (careful traversals — the baseline)"),
    "NMTree": StructureInfo(
        "NMTree", NMTree, NMTree.POLICIES,
        "Natarajan-Mittal external BST (optimistic traversals)"),
    "SkipList": StructureInfo(
        "SkipList", SkipList, SkipList.POLICIES,
        "Fraser-style skip list (per-level Harris traversals)"),
    "HashMap": StructureInfo(
        "HashMap", LockFreeHashMap, LockFreeHashMap.POLICIES,
        "bucketed lock-free hash map (delegates to the lists)"),
}


# ----------------------------------------------------------------- lookups
def scheme_info(name: Union[str, SmrScheme]) -> SchemeInfo:
    if isinstance(name, SmrScheme):
        name = name.name
    try:
        return SCHEME_REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(f"unknown SMR scheme {name!r}; choose from "
                         f"{list(SCHEME_REGISTRY)}")


def structure_info(name: str) -> StructureInfo:
    try:
        return STRUCTURE_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown structure {name!r}; choose from "
                         f"{list(STRUCTURE_REGISTRY)}")


# ----------------------------------------------------------------- queries
def schemes(*, robust: Optional[bool] = None,
            cumulative_protection: Optional[bool] = None,
            reclaims: Optional[bool] = None,
            batch_hints: Optional[str] = None) -> List[str]:
    """Scheme names filtered by capability (registration order).

    ``api.schemes(robust=True)`` is the benchmark grids' replacement for
    the hardcoded ``SCOT_SCHEMES`` lists: a newly registered scheme shows
    up in every grid automatically.
    """
    out = []
    for e in SCHEME_REGISTRY.values():
        if robust is not None and e.robust != robust:
            continue
        if cumulative_protection is not None \
                and e.cumulative_protection != cumulative_protection:
            continue
        if reclaims is not None and e.reclaims != reclaims:
            continue
        if batch_hints is not None and e.batch_hints != batch_hints:
            continue
        out.append(e.name)
    return out


def structures(*, policy: Optional[str] = None) -> List[str]:
    """Structure names, optionally filtered by supported traversal policy."""
    return [e.name for e in STRUCTURE_REGISTRY.values()
            if policy is None or policy in e.policies]


def traversal_policies() -> List[str]:
    return list(POLICY_NAMES)


# ------------------------------------------------------------- negotiation
def check(structure: str, smr: Union[str, SmrScheme],
          traversal: Union[str, TraversalPolicy, None] = None,
          *, allow_unsafe: bool = False) -> TraversalPolicy:
    """Negotiate one (structure, scheme, policy) triple.

    Returns the resolved :class:`TraversalPolicy` or raises
    :class:`IncompatiblePairError` with a diagnostic.  ``smr`` may be a
    name (negotiated against the scheme's default slot count) or a live
    instance (negotiated against its actual ``num_slots``).
    """
    s_entry = structure_info(structure)
    sch = scheme_info(smr)
    num_slots = smr.num_slots if isinstance(smr, SmrScheme) \
        else sch.default_slots

    if traversal is None:
        # the paper's default: SCOT iff the scheme is robust — except for
        # structures that ARE one policy (HMList runs 'hm' or nothing)
        policy = as_policy(s_entry.policies[0]) \
            if len(s_entry.policies) == 1 else default_policy(sch.cls)
    else:
        policy = as_policy(traversal)

    if policy.name not in s_entry.policies:
        raise IncompatiblePairError(
            f"{s_entry.name} does not support traversal policy "
            f"{policy.name!r}; supported: {list(s_entry.policies)}",
            structure=s_entry.name, scheme=sch.name, policy=policy.name)

    if not policy.validates and not policy.careful and sch.robust \
            and not allow_unsafe:
        raise IncompatiblePairError(
            f"traversal {policy.name!r} skips SCOT validation, which is a "
            f"use-after-free under robust scheme {sch.name} (paper Fig. 1);"
            f" choose 'scot' or 'waitfree', a non-robust scheme "
            f"({schemes(robust=False)}), or pass allow_unsafe=True to "
            f"reproduce the bug deliberately",
            structure=s_entry.name, scheme=sch.name, policy=policy.name)

    needed = s_entry.slots_needed(policy)
    if num_slots < needed:
        raise IncompatiblePairError(
            f"{s_entry.name} with traversal {policy.name!r} needs {needed} "
            f"reservation slots; scheme {sch.name} reserves only "
            f"{num_slots} (construct it with num_slots>={needed})",
            structure=s_entry.name, scheme=sch.name, policy=policy.name)

    return policy


def compatible(structure: str, smr: Union[str, SmrScheme],
               traversal: Union[str, TraversalPolicy, None] = None
               ) -> Tuple[bool, Optional[str]]:
    """Non-raising :func:`check`: ``(True, None)`` or ``(False, reason)``."""
    try:
        check(structure, smr, traversal)
        return (True, None)
    except IncompatiblePairError as e:
        return (False, e.reason)


def capability_matrix() -> Dict[str, object]:
    """The full negotiated surface, machine-readable (renders API.md §3)."""
    pairs = []
    for s in STRUCTURE_REGISTRY:
        for pol in POLICY_NAMES:
            for sch in SCHEME_REGISTRY:
                ok, reason = compatible(s, sch, pol)
                pairs.append({"structure": s, "traversal": pol,
                              "scheme": sch, "ok": ok, "reason": reason})
    return {
        "schemes": {n: e.cls.capabilities()
                    for n, e in SCHEME_REGISTRY.items()},
        "structures": {n: {"policies": list(e.policies),
                           "description": e.description}
                       for n, e in STRUCTURE_REGISTRY.items()},
        "pairs": pairs,
    }


# re-exported for the facade
_make_scheme = make_scheme
