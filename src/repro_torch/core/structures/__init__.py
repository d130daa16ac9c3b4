"""Non-blocking data structures (paper Table 1) + traversal policies."""

from .harris_list import HarrisList
from .hashmap import LockFreeHashMap
from .hm_list import HarrisMichaelList
from .nm_tree import NMTree
from .node import ListNode, TowerNode, TreeNode
from .skiplist import SkipList
from .traversal import (
    CarefulHM,
    IncompatiblePairError,
    OptimisticSCOT,
    PlainOptimistic,
    TraversalPolicy,
    WaitFreeSCOT,
    as_policy,
    default_policy,
)

__all__ = [
    "HarrisList",
    "HarrisMichaelList",
    "NMTree",
    "SkipList",
    "LockFreeHashMap",
    "ListNode",
    "TowerNode",
    "TreeNode",
    "TraversalPolicy",
    "PlainOptimistic",
    "OptimisticSCOT",
    "CarefulHM",
    "WaitFreeSCOT",
    "IncompatiblePairError",
    "as_policy",
    "default_policy",
]
