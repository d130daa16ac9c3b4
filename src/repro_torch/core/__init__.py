"""The paper's primary contribution: SCOT — Safe Concurrent Optimistic
Traversals — and the SMR substrate it runs on.

Host-side (pure Python) by design: hazard pointers have no on-device TPU
analogue; the structures here govern the framework's *control plane*
(KV block pool, prefix cache, membership registries) — see DESIGN.md §2.
"""

from .atomics import (
    AtomicFlaggedRef,
    AtomicInt,
    AtomicMarkableRef,
    AtomicRef,
    Recycler,
    SmrNode,
    UseAfterFreeError,
)
from .smr import (
    EBR,
    HE,
    HP,
    IBR,
    NR,
    SCHEMES,
    VBR,
    Hyaline1S,
    SmrScheme,
    make_scheme,
)
from .structures import (
    CarefulHM,
    HarrisList,
    HarrisMichaelList,
    IncompatiblePairError,
    LockFreeHashMap,
    NMTree,
    OptimisticSCOT,
    PlainOptimistic,
    SkipList,
    TraversalPolicy,
    WaitFreeSCOT,
)

__all__ = [
    "AtomicFlaggedRef",
    "AtomicInt",
    "AtomicMarkableRef",
    "AtomicRef",
    "Recycler",
    "SmrNode",
    "UseAfterFreeError",
    "EBR",
    "HE",
    "HP",
    "IBR",
    "VBR",
    "NR",
    "Hyaline1S",
    "SmrScheme",
    "SCHEMES",
    "make_scheme",
    "HarrisList",
    "HarrisMichaelList",
    "NMTree",
    "SkipList",
    "LockFreeHashMap",
    "TraversalPolicy",
    "PlainOptimistic",
    "OptimisticSCOT",
    "CarefulHM",
    "WaitFreeSCOT",
    "IncompatiblePairError",
]
