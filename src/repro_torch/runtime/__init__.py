"""SMR-managed device-resource control plane (DESIGN.md §2)."""
from .block_pool import BlockPool, OutOfPagesError, PageNode
from .free_list import FreeListEmpty, LockFreeFreeList, LockedFreeList
from .prefix_cache import PrefixCache

__all__ = ["BlockPool", "PageNode", "OutOfPagesError", "PrefixCache",
           "FreeListEmpty", "LockFreeFreeList", "LockedFreeList"]
