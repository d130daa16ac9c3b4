"""Pluggable traversal policies (paper §3 + §4) — the knob soup, named.

Before this module, every structure carried its own ``scot=``/``recovery=``
booleans and every call site re-derived which combination was legal for
which SMR scheme.  A :class:`TraversalPolicy` names one coherent strategy:

* :class:`PlainOptimistic` — the pre-paper traversal: optimistic, **no**
  dangerous-zone validation.  Correct under quiescence-style schemes
  (NR/EBR) where an operation's reservation covers everything it observes;
  under robust schemes (HP/HE/IBR/Hyaline-1S) it is exactly the Figure-1
  use-after-free and the facade refuses the pair unless the caller opts
  into the bug (``allow_unsafe=True`` — demos and safety tests do).
* :class:`OptimisticSCOT` — the paper's fix (Fig. 4 + Thm 1): validate the
  last-safe-node → first-unsafe-node edge before each dangerous-zone
  dereference, with the §3.2.1 recovery optimization (one-shot everywhere,
  ring-buffer fallback under cumulative schemes).
* :class:`CarefulHM` — the Harris-Michael baseline (Michael 2002): marked
  nodes are unlinked *immediately* on encounter, so plain per-edge
  validation suffices.  Costs the extra CAS traffic and the read-only
  search that SCOT preserves; it is what ``HMList`` *is*, and what hash-map
  buckets fall back to when asked for the baseline.
* :class:`WaitFreeSCOT` — the paper's §4 "simple modification for
  wait-free traversals", DESIGN.md §10.  Three ingredients on top of SCOT:
  (1) an extra pinned *anchor* slot trailing one safe node behind ``prev``,
  so one-shot schemes (HP/HE) get a second recovery level instead of a
  head restart — a restart now requires TWO successful concurrent unlink
  CASes landing on the reader's exact path; (2) a bounded fast-path restart
  budget, after which a list traversal escalates to a careful (HM-style)
  walk that clears each marked obstruction with its own CAS (restarts then
  only ever charge to successful writer CASes); (3) on the NM tree, the
  restart loop converts
  into *helping*: past the budget the seeker completes the pending flagged
  delete it keeps colliding with (the tree's own ``cleanup``), removing the
  obstruction instead of spinning on it.  The payoff the test suite pins
  down: a stalled writer can never force a reader to restart at all.

Policies are plain descriptor objects — structures read their fields once
at construction; the negotiation logic (which (structure, scheme, policy)
triples are legal) lives in :mod:`repro.api`.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

__all__ = [
    "IncompatiblePairError",
    "TraversalPolicy",
    "PlainOptimistic",
    "OptimisticSCOT",
    "CarefulHM",
    "WaitFreeSCOT",
    "POLICY_NAMES",
    "as_policy",
    "default_policy",
    "resolve_ctor_policy",
    "UNSET",
]

# sentinel for "legacy kwarg not passed" (None is a meaningful value)
UNSET = object()


class IncompatiblePairError(ValueError):
    """An illegal (structure, scheme, traversal-policy) combination.

    Raised by :func:`repro.api.build` (and by direct structure construction
    when the *structure* itself cannot run the policy).  Carries a
    diagnostic naming the offending pair and the legal alternatives, so the
    failure mode is a clear error at construction instead of the silent
    misbehavior (or Figure-1 use-after-free) the old boolean flags allowed.
    """

    def __init__(self, reason: str, *, structure: Optional[str] = None,
                 scheme: Optional[str] = None, policy: Optional[str] = None):
        super().__init__(reason)
        self.reason = reason
        self.structure = structure
        self.scheme = scheme
        self.policy = policy


class TraversalPolicy:
    """Base descriptor.  Subclasses set the class-level strategy bits and
    instances carry the per-policy tuning knobs."""

    name: str = "base"
    validates: bool = False    # SCOT dangerous-zone validation (Thm 1)
    careful: bool = False      # HM-style eager unlink (no dangerous zone)
    wait_free: bool = False    # §4 wait-free traversal modification
    recovery: bool = False     # §3.2.1 escape-the-dangerous-zone recovery
    recovery_depth: int = 0    # predecessor ring (cumulative schemes only)
    extra_list_slots: int = 0  # hazard slots beyond the structure's budget
    # fast-path restart budget before a wait-free traversal escalates to
    # its slow path (0 = escalate on the very first restart); unused by
    # non-wait-free policies
    max_restarts: int = 0

    def describe(self) -> str:
        return self.name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TraversalPolicy {self.describe()!r}>"


class PlainOptimistic(TraversalPolicy):
    """Pre-paper optimistic traversal — no validation.  Safe only where the
    reservation covers whole operations (NR/EBR); the Figure-1 bug under
    robust schemes."""

    name = "optimistic"
    validates = False


class OptimisticSCOT(TraversalPolicy):
    """The paper's SCOT traversal (default under robust schemes)."""

    name = "scot"
    validates = True

    def __init__(self, recovery: bool = True, recovery_depth: int = 8):
        self.recovery = recovery
        # paper §3.2.1: a ring of 8 predecessors is ~optimal
        self.recovery_depth = recovery_depth

    def describe(self) -> str:
        if not self.recovery:
            return f"{self.name}(recovery=False)"
        return self.name


class CarefulHM(TraversalPolicy):
    """Harris-Michael careful traversal — the paper's baseline."""

    name = "hm"
    careful = True


class WaitFreeSCOT(OptimisticSCOT):
    """SCOT + the §4 wait-free traversal modification (DESIGN.md §10)."""

    name = "waitfree"
    wait_free = True
    extra_list_slots = 1  # the anchor slot (HP_ANCHOR)

    def __init__(self, recovery_depth: int = 8, max_restarts: int = 4):
        super().__init__(recovery=True, recovery_depth=recovery_depth)
        self.max_restarts = max_restarts


_BY_NAME = {
    PlainOptimistic.name: PlainOptimistic,
    OptimisticSCOT.name: OptimisticSCOT,
    CarefulHM.name: CarefulHM,
    WaitFreeSCOT.name: WaitFreeSCOT,
}
POLICY_NAMES = tuple(_BY_NAME)  # ("optimistic", "scot", "hm", "waitfree")


def as_policy(policy: Union[str, TraversalPolicy]) -> TraversalPolicy:
    """Resolve a policy name or instance to a :class:`TraversalPolicy`."""
    if isinstance(policy, TraversalPolicy):
        return policy
    try:
        return _BY_NAME[policy]()
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown traversal policy {policy!r}; choose from "
            f"{list(POLICY_NAMES)} or pass a TraversalPolicy instance")


def default_policy(smr) -> TraversalPolicy:
    """The paper's rule (§5): SCOT exactly where the scheme is robust —
    NR/EBR traverse safely without per-pointer validation."""
    return OptimisticSCOT() if smr.robust else PlainOptimistic()


def _legacy_policy(smr, scot, recovery, recovery_depth) -> TraversalPolicy:
    """Map the pre-facade boolean soup onto a policy, bit for bit."""
    validates = smr.robust if scot is None else bool(scot)
    if validates:
        return OptimisticSCOT(recovery=recovery, recovery_depth=recovery_depth)
    return PlainOptimistic()


def resolve_ctor_policy(structure_cls, smr,
                        policy: Union[str, TraversalPolicy, None],
                        **legacy) -> TraversalPolicy:
    """Shared structure-constructor policy resolution.

    Exactly one of {``policy``, legacy flags} may be used.  Legacy flags
    (``scot=``/``recovery=``/``optimistic=``/…, pre-facade API) still work
    for one release but warn; they bypass the *robustness* half of the
    negotiation on purpose — that is how the Figure-1 demonstrations
    construct the known-unsafe pair.  The structure's own requirements
    (supported policy set, hazard-slot budget) are enforced here even on
    direct construction; the scheme-compatibility half lives in
    :func:`repro.api.build`.
    """
    given = {k: v for k, v in legacy.items() if v is not UNSET}
    if given:
        if policy is not None:
            raise TypeError(
                f"{structure_cls.__name__}: pass either policy= or the "
                f"deprecated {sorted(given)} flags, not both")
        warnings.warn(
            f"{structure_cls.__name__}({', '.join(sorted(given))}) is "
            f"deprecated; construct through repro.api.build(..., "
            f"traversal=<policy>) instead",
            DeprecationWarning, stacklevel=3)
        if not given.get("optimistic", True):
            resolved: TraversalPolicy = CarefulHM()  # hash-map baseline flag
        else:
            resolved = _legacy_policy(smr, given.get("scot", None),
                                      given.get("recovery", True),
                                      given.get("recovery_depth", 8))
    elif policy is None:
        resolved = default_policy(smr)
    else:
        resolved = as_policy(policy)
    supported = structure_cls.POLICIES
    if resolved.name not in supported:
        raise IncompatiblePairError(
            f"{structure_cls.__name__} does not support traversal policy "
            f"{resolved.name!r}; supported: {list(supported)}",
            structure=structure_cls.__name__, policy=resolved.name)
    needed = structure_cls.slots_needed(resolved)
    if smr.num_slots < needed:
        raise IncompatiblePairError(
            f"{structure_cls.__name__} with traversal {resolved.name!r} "
            f"needs {needed} reservation slots; scheme {smr.name} reserves "
            f"only {smr.num_slots} (construct it with num_slots>={needed})",
            structure=structure_cls.__name__, scheme=smr.name,
            policy=resolved.name)
    return resolved
