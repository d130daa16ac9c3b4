"""Batched entry points for the flat lock-free lists (DESIGN.md §4).

:class:`BatchedListOps` is mixed into :class:`~.harris_list.HarrisList` and
:class:`~.hm_list.HarrisMichaelList`.  It amortizes the two per-operation
costs PR 1 left on the table:

* **one guard across K operations** — a single ``guard_batch(K)`` scope
  replaces K ``begin_op``/``end_op`` round trips (one epoch publish, one
  hazard-slot sweep, one ``ThreadCtx`` resolution);
* **resumed traversals** — keys are processed in ascending order and each
  ``_find`` starts from the *previous* operation's ``prev`` node instead of
  the head, so a K-key batch walks the list roughly once instead of K times.

Why resuming is safe under EVERY scheme for a *flat* list (the full
per-scheme argument is DESIGN.md §4): the hint is exactly one node, and it
is the node the previous ``_find`` pinned in its ``HP_PREV`` hazard slot.
Nothing clears or repurposes that slot between operations of the same batch
— the next ``_find`` only writes ``HP_CURR``/``HP_NEXT`` until its first
``dup`` — so dereferencing ``hint.next`` is protected even under HP/HE's
non-cumulative (one-shot) reservations.  Cumulative schemes (EBR/IBR/HLN/NR)
protect every node observed inside the batch scope anyway.  Staleness is
handled, not assumed away: ``_find`` re-protects the edge out of the hint
and restarts from the head if the hint has been logically deleted (a marked
edge proves nothing about its successor — same rule as the skip list's
carried-over ``start``).

Host classes provide::

    _find(key, srch, ctx=None, start=None) -> (prev, curr, found)
    _insert_from(key, value, ctx, hint=None) -> (inserted, prev)
    _delete_from(key, ctx, hint=None)       -> (deleted, prev, node)

Results are returned aligned with the INPUT order; operations are APPLIED in
ascending key order.  For distinct keys the two orders are indistinguishable
(set semantics); duplicate keys within one batch are applied in an
unspecified relative order, exactly like racing threads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["BatchedListOps"]


def _sorted_order(keys: Sequence) -> List[int]:
    return sorted(range(len(keys)), key=keys.__getitem__)


class BatchedListOps:
    """Mixin: batched/multi-key operations over a sorted resumed traversal."""

    # ------------------------------------------------------------- lookup
    def get_node(self, key, ctx):
        """Public lookup-with-node (read-only).  The caller must be inside a
        ``guard()``/``guard_batch()`` scope and pass its ctx; the returned
        node is protected (dereferenceable) only until that scope exits."""
        _, curr, found = self._find(key, srch=True, ctx=ctx)
        return curr if found else None

    def get_nodes(self, keys: Sequence, ctx) -> List[Optional[object]]:
        """``get_node`` for many keys under the caller's guard: one resumed
        traversal, results aligned with ``keys``.

        CUMULATIVE SCHEMES ONLY for multi-key batches: under HP/HE each
        find recycles the hazard slots, so every returned node except the
        last would be unprotected the moment this returns — dereferencing
        one is the Figure-1 bug.  (The prefix cache's one-shot path probes
        candidates one ``get_node`` at a time for exactly this reason.)"""
        assert self.smr.cumulative_protection or len(keys) <= 1, \
            "get_nodes with >1 key needs cumulative protection (HP/HE " \
            "slots only pin the most recent find) — use get_node per key"
        out: List[Optional[object]] = [None] * len(keys)
        hint = None
        for i in _sorted_order(keys):
            prev, curr, found = self._find(keys[i], srch=True, ctx=ctx,
                                           start=hint)
            if found:
                out[i] = curr
            hint = prev
        return out

    def search_many(self, keys: Sequence, ctx=None) -> List[bool]:
        """Membership for many keys under ONE guard scope."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._search_many(keys, out, c)
        return out

    def _search_many(self, keys, out, ctx) -> None:
        hint = None
        for i in _sorted_order(keys):
            prev, _, found = self._find(keys[i], srch=True, ctx=ctx,
                                        start=hint)
            out[i] = found
            hint = prev

    # ------------------------------------------------------------- update
    def insert_many(self, keys: Sequence, values: Optional[Sequence] = None,
                    ctx=None) -> List[bool]:
        """Insert many keys under ONE guard scope; returns per-key success
        aligned with the input order."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._insert_many(keys, values, out, c)
        return out

    def _insert_many(self, keys, values, out, ctx) -> None:
        hint = None
        for i in _sorted_order(keys):
            value = values[i] if values is not None else None
            out[i], hint = self._insert_from(keys[i], value, ctx, hint)

    def delete_many(self, keys: Sequence, ctx=None) -> List[bool]:
        """Delete many keys under ONE guard scope; per-key success aligned
        with the input order."""
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._delete_many(keys, out, c)
        return out

    def _delete_many(self, keys, out, ctx) -> None:
        hint = None
        for i in _sorted_order(keys):
            ok, hint, _ = self._delete_from(keys[i], ctx, hint)
            out[i] = ok

    def pop(self, key, ctx=None):
        """Delete ``key`` and return its (removed) node, or None if absent.

        Unlike ``delete``, the caller learns WHICH node it removed — the
        prefix cache uses this to unpin exactly the page run the removed
        entry referenced (a lookup-then-delete pair could observe one
        entry and delete a concurrently re-inserted successor).  Pass the
        caller's guard ctx to keep the returned node dereferenceable
        (``node.value``) until that guard exits; with ``ctx=None`` only the
        node's identity may be inspected after return."""
        with self.smr.scope(ctx) as c:
            ok, _, node = self._delete_from(key, c)
        return node if ok else None
