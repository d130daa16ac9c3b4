"""Lock-free hash map (Michael 2002) — an array of lock-free lists.

The paper §3.4: "Hash Maps are based on linked lists directly" — SCOT applies
bucket-wise.  Both flavours are offered so the Harris-vs-HM difference is
visible through the map layer too (benchmarked in the serving prefix cache,
see ``repro/runtime/prefix_cache.py``).
"""

from __future__ import annotations

from ..smr.base import SmrScheme
from .harris_list import HarrisList
from .hm_list import HarrisMichaelList
from .traversal import UNSET, TraversalPolicy, resolve_ctor_policy


class LockFreeHashMap:
    # delegates to the bucket lists: "hm" → Harris-Michael buckets, every
    # other policy → Harris buckets running that policy
    POLICIES = ("optimistic", "scot", "waitfree", "hm")

    @classmethod
    def slots_needed(cls, policy: TraversalPolicy) -> int:
        if policy.careful:
            return HarrisMichaelList.HP_SLOTS
        return HarrisList.HP_SLOTS + policy.extra_list_slots

    def __init__(self, smr: SmrScheme, num_buckets: int = 64,
                 policy=None, *, optimistic=UNSET, scot=UNSET,
                 recovery=UNSET):
        self.smr = smr
        self.num_buckets = num_buckets
        self.policy = p = resolve_ctor_policy(
            type(self), smr, policy,
            optimistic=optimistic, scot=scot, recovery=recovery)
        if p.careful:
            self.buckets = [HarrisMichaelList(smr)
                            for _ in range(num_buckets)]
        else:
            self.buckets = [HarrisList(smr, policy=p)
                            for _ in range(num_buckets)]

    def _bucket(self, key):
        return self.buckets[hash(key) % self.num_buckets]

    def insert(self, key, value=None) -> bool:
        return self._bucket(key).insert(key, value)

    def delete(self, key) -> bool:
        return self._bucket(key).delete(key)

    def search(self, key) -> bool:
        return self._bucket(key).search(key)

    contains = search

    def get_node(self, key, ctx):
        """Public lookup-with-node under the caller's guard scope."""
        return self._bucket(key).get_node(key, ctx)

    def get(self, key):
        """Optimistic read-only lookup returning the stored value."""
        with self.smr.guard() as ctx:
            node = self.get_node(key, ctx)
            return node.value if node is not None else None

    # ------------------------------------------------------------ batched
    # One guard scope for the whole batch; keys grouped per bucket so each
    # bucket list is walked once with the lists' resumed sorted traversal
    # (DESIGN.md §4).
    def _group(self, keys):
        groups: dict = {}
        for i, key in enumerate(keys):
            groups.setdefault(hash(key) % self.num_buckets, []).append(i)
        return groups

    def search_many(self, keys, ctx=None):
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._run_grouped(keys, out, c, "search_many")
        return out

    def insert_many(self, keys, values=None, ctx=None):
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._run_grouped(keys, out, c, "insert_many", values)
        return out

    def delete_many(self, keys, ctx=None):
        out = [False] * len(keys)
        if not len(keys):
            return out
        with self.smr.scope(ctx, len(keys)) as c:
            self._run_grouped(keys, out, c, "delete_many")
        return out

    def _run_grouped(self, keys, out, ctx, op, values=None) -> None:
        for b, idxs in self._group(keys).items():
            bucket_op = getattr(self.buckets[b], op)
            bkeys = [keys[i] for i in idxs]
            if op == "insert_many":
                vals = [values[i] for i in idxs] if values is not None \
                    else None
                res = bucket_op(bkeys, vals, ctx=ctx)
            else:
                res = bucket_op(bkeys, ctx=ctx)
            for j, i in enumerate(idxs):
                out[i] = res[j]

    def snapshot(self):
        out = []
        for b in self.buckets:
            out.extend(b.snapshot())
        return sorted(out)
