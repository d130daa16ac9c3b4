"""Time ``PrefixCache.insert`` of the port at the batch-decode cell's cache
shape, under the copied ``LruEviction`` and the serving engine's
``BatchedLruEviction``.

    PYTHONPATH=src python3 benchmarks/torch_prefix_insert.py \
        [--requests 40] [--warm 100] [--scheme IBR] [--profile]

A host-only simulation of one shard (no model, no device): a
:class:`PrefixCache` over a :class:`BlockPool` of 6,144 pages of 8 tokens
(VBR free list) with LRU over 4,096 entries, under the cell's SMR scheme
and its serving defaults, fed by a closed loop of 32 rows with unique
prompts of 256-1024 tokens and outputs of 128-512.  A step admits, then
gives every row one token.  Each request reserves its pages at admission
as the engine's ``_admit_one`` does; a short pool is answered by
``pressure_evict`` and ``help_reclaim`` and the admission is tried again
at the next step.  A finished request is inserted (every page boundary of
prompt and output) and its pages released.

Prints one JSON line a policy (median and p90 of the timed inserts and of
the pressure evictions, in ms, and the entries held) and one line that says
whether both policies chose the same victims in the same order.  With
``--profile`` the first timed insert of each policy runs under cProfile and
its line adds the seconds under the bucket lists' insert, the recency
touches, the evictions and the page pins.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.runtime.block_pool import BlockPool  # noqa: E402
from repro_torch.runtime.eviction import LruEviction  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.config import ServingConfig  # noqa: E402
from repro_torch.serving.lru_index import BatchedLruEviction  # noqa: E402

POLICIES = {"copied": LruEviction, "batched": BatchedLruEviction}


class Trace:
    """One closed-loop run against a fresh cache; ``victims`` and ``peeks``
    log what the policy handed the cache, ``insert_s`` / ``pressure_s`` the
    host seconds of each insert and pressure eviction once ``timed``."""

    def __init__(self, policy, *, seed: int, scheme: str = "IBR",
                 rows: int = 32, num_pages: int = 6144, page_size: int = 8,
                 max_entries: int = 4096, prompt=(256, 1024),
                 output=(128, 512), reuse: float = 0.0,
                 settle: bool = False):
        self.rng = np.random.default_rng(seed)
        self.smr = ServingConfig(smr=scheme).build_scheme()
        self.pool = BlockPool(self.smr, num_pages)
        self.cache = PrefixCache(self.smr, self.pool, page_size,
                                 max_entries=max_entries, eviction=policy)
        self.page = page_size
        self.prompt, self.output = prompt, output
        # share of prompts that start with whole pages of a finished
        # request's tokens (prefix hits through lookup); 0 in the cell
        self.reuse = reuse
        # complete reclamation before each admission, so a pressure event
        # depends on the pages held and pinned alone, not on when a retire
        # scan ran (policies that retire different numbers of tree nodes
        # then meet the same pressure events)
        self.settle = settle
        self.victims: list = []
        self.peeks: list = []
        self.insert_s: list = []
        self.pressure_s: list = []
        self.held: list = []  # entries before each timed insert
        self.timed = False
        self.profile = None
        self._recent: list = []
        self._pending: list = []
        self._rows: list = []
        self.n_rows = rows
        self.n_inserts = 0
        self._log(self.cache.eviction)
        for _ in range(rows):
            self._pending.append(self._request())

    def _log(self, policy) -> None:
        next_victim, peek = policy.next_victim, policy.peek

        def logged_victim():
            key = next_victim()
            self.victims.append(key)
            return key

        def logged_peek(key):
            token = peek(key)
            self.peeks.append((key, token))
            return token

        policy.next_victim, policy.peek = logged_victim, logged_peek

    def _tokens(self, n: int) -> list:
        return self.rng.integers(1, 150_000, size=n).tolist()

    def _request(self):
        n = int(self.rng.integers(self.prompt[0], self.prompt[1] + 1))
        out = int(self.rng.integers(self.output[0], self.output[1] + 1))
        if self._recent and self.rng.random() < self.reuse:
            src = self._recent[int(self.rng.integers(len(self._recent)))]
            shared = self.page * int(self.rng.integers(
                1, min(n, len(src)) // self.page + 1))
            prompt = src[:shared] + self._tokens(n - shared)
        else:
            prompt = self._tokens(n)
        hits, _ = self.cache.lookup(prompt)
        return {"prompt": prompt, "out": out, "hits": hits}

    def _admit(self) -> None:
        """The engine's admission wave: stop at the first request the pool
        cannot cover, after one pressure event."""
        while self._pending and len(self._rows) < self.n_rows:
            req = self._pending[0]
            if self.settle:
                self.smr.flush()
            need = -(-(len(req["prompt"]) + req["out"]) // self.page)
            pages = list(req["hits"])
            while len(pages) < need:
                pg = self.pool.try_alloc()
                if pg is None:
                    break
                pages.append(pg)
            if len(pages) < need:
                for pg in pages[len(req["hits"]):]:
                    self.pool.release(pg)
                t0 = time.perf_counter()
                self.cache.pressure_evict()
                self.smr.help_reclaim()
                if self.timed:
                    self.pressure_s.append(time.perf_counter() - t0)
                return
            self._pending.pop(0)
            req["pages"] = pages
            req["left"] = req["out"]
            self._rows.append(req)

    def step(self) -> None:
        """One engine step: an admission wave, then a token for every row;
        a row at its budget is inserted and released, and its client sends
        the next request."""
        self._admit()
        if not self._rows:
            raise RuntimeError("no request holds pages and eviction freed "
                               "none: the loop stalled")
        for row in list(self._rows):
            row["left"] -= 1
            if row["left"] <= 0:
                self._rows.remove(row)
                self._finish(row)

    def run(self, inserts: int) -> None:
        """Step until ``inserts`` more requests have finished."""
        goal = self.n_inserts + inserts
        while self.n_inserts < goal:
            self.step()

    def _finish(self, row) -> None:
        tokens = row["prompt"] + self._tokens(row["out"])
        if self.timed:
            self.held.append(self.cache.n_entries.load())
        t0 = time.perf_counter()
        if self.profile is not None:
            self.profile.enable()
        self.cache.insert(tokens, row["pages"])
        if self.profile is not None:
            self.profile.disable()
            self.profile = None
        if self.timed:
            self.insert_s.append(time.perf_counter() - t0)
        self.n_inserts += 1
        owned = len(row["hits"])
        for pg in row["pages"][owned:]:
            self.pool.release(pg)
        for pg in row["pages"][:owned]:
            self.pool.unpin(pg)
        self._recent = (self._recent + [tokens])[-64:]
        self._pending.append(self._request())

    def close(self) -> int:
        """Drain the loop, clear the cache and reclaim; returns the pages
        still not free (0 unless something leaked)."""
        for row in self._rows:
            for pg in row["pages"][len(row["hits"]):]:
                self.pool.release(pg)
            for pg in row["pages"][:len(row["hits"])]:
                self.pool.unpin(pg)
        for req in self._pending:
            for pg in req["hits"]:
                self.pool.unpin(pg)
        self._rows, self._pending = [], []
        self.cache.clear()
        self.smr.flush()
        return self.pool.num_pages - self.pool.free_count()


# where the profiled insert's seconds went: (file, function) of the callee
# whose cumulative time is counted
_PARTS = {
    "bucket_insert": [("harris_list.py", "insert")],
    "recency_touch": [("eviction.py", "record_insert")],
    "evict": [("prefix_cache.py", "_maybe_evict")],
    "pin": [("block_pool.py", "pin")],
}


def _profile_parts(prof: cProfile.Profile) -> dict:
    stats = pstats.Stats(prof).stats
    out = {"total_s": max(ct for (f, _, fn), (_, _, _, ct, _)
                          in stats.items() if fn == "insert"
                          and f.endswith("prefix_cache.py"))}
    for part, names in _PARTS.items():
        out[part + "_s"] = sum(
            ct for (f, _, fn), (_, _, _, ct, _) in stats.items()
            if any(f.endswith(file) and fn == name for file, name in names))
    return out


def run(name: str, args) -> Trace:
    trace = Trace(POLICIES[name](), seed=args.seed, scheme=args.scheme)
    trace.run(args.warm)
    trace.timed = True
    if args.profile:
        trace.profile = prof = cProfile.Profile()
        trace.run(1)
        parts = _profile_parts(prof)
        trace.insert_s.clear()
    trace.run(args.requests)
    ms = [1e3 * s for s in trace.insert_s]
    pressure = [1e3 * s for s in trace.pressure_s]
    line = {"policy": name, "scheme": args.scheme, "inserts": len(ms),
            "insert_median_ms": statistics.median(ms),
            "insert_p90_ms": statistics.quantiles(ms, n=10)[-1],
            "pressure_events": len(pressure),
            "pressure_median_ms": (statistics.median(pressure)
                                   if pressure else None),
            "entries_median": statistics.median(trace.held),
            "victims": len(trace.victims)}
    if args.profile:
        line["profiled_insert"] = parts
    print(json.dumps(line), flush=True)
    return trace


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=40,
                    help="timed inserts a policy (after --warm)")
    ap.add_argument("--warm", type=int, default=100,
                    help="inserts before timing, to reach the steady state")
    ap.add_argument("--scheme", default="IBR")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--policy", choices=["both", *POLICIES], default="both")
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the first timed insert of each policy")
    args = ap.parse_args()
    names = list(POLICIES) if args.policy == "both" else [args.policy]
    traces = [run(name, args) for name in names]
    if len(traces) == 2:
        a, b = traces
        print(json.dumps({"same_victims": a.victims == b.victims,
                          "same_peeks": a.peeks == b.peeks,
                          "victims": len(a.victims)}), flush=True)


if __name__ == "__main__":
    main()
