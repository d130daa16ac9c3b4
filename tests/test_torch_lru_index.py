"""The serving engine's ``lru`` policy (``serving/lru_index.py``): the
copied ``LruEviction`` whose stamps enter the NM-tree in batches.

* Victims: on one seeded trace (inserts, prefix hits through ``lookup``,
  pressure evictions, ``clear``) both policies hand the cache the same
  victims in the same order and the same ``peek`` tokens, under IBR and HP.
* Depth: 30 batches of 120 stamps with 2,400 kept live leave the tree's
  deepest leaf at most 64 edges below the root; the copied policy's lies
  near the number of live stamps.
* Threads: two client threads hit through ``lookup`` while the engine
  thread inserts and evicts and a janitor thread sheds pressure quotas, as
  the watchdog does; the cache stays within ``max_entries``, and after
  ``clear`` every page is free and the index is empty.
* Engine: a shard built with ``eviction="lru"`` runs the batched policy and
  counts its flushes; one built with ``"fifo"`` runs the copied ring.
"""

import importlib.util
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.runtime.eviction import FifoEviction, LruEviction
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.serving.lru_index import BatchedLruEviction, median_first

ROOT = Path(__file__).resolve().parents[1]


def _simulation():
    path = ROOT / "benchmarks" / "torch_prefix_insert.py"
    spec = importlib.util.spec_from_file_location("torch_prefix_insert",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _depth(tree) -> int:
    """Edges from the root to the deepest leaf (iterative: a spine is
    thousands deep)."""
    deepest, todo = 0, [(tree.R, 0)]
    while todo:
        node, d = todo.pop()
        if node.is_leaf:
            deepest = max(deepest, d)
            continue
        for child in (node.left_ref_unsafe().get_ref(),
                      node.right_ref_unsafe().get_ref()):
            todo.append((child, d + 1))
    return deepest


def test_median_first_order():
    assert median_first([1]) == [1]
    assert median_first(list(range(8))) == [7, 3, 1, 5, 0, 2, 4, 6]
    stamps = list(range(10, 130))
    assert sorted(median_first(stamps)) == stamps


@pytest.mark.parametrize("scheme", ["IBR", "HP"])
def test_victims_match_the_copied_policy(scheme):
    sim = _simulation()
    shape = dict(seed=2**31 + 11, scheme=scheme, rows=8, num_pages=512,
                 max_entries=256, prompt=(64, 256), output=(32, 128),
                 reuse=0.5, settle=True)
    traces = []
    for policy in (LruEviction(), BatchedLruEviction()):
        trace = sim.Trace(policy, **shape)
        trace.timed = True
        trace.run(60)
        before_clear = len(trace.victims)
        assert trace.close() == 0
        assert len(trace.victims) > before_clear  # clear drained the index
        traces.append(trace)
    copied, batched = traces
    stats = batched.cache.stats()
    assert stats["hits"] > 0 and batched.pressure_s
    assert copied.cache.stats()["hits"] == stats["hits"]
    assert len(batched.victims) > 1000
    assert batched.victims == copied.victims
    assert batched.peeks == copied.peeks
    assert batched.cache.eviction.n_flushes > 0


def _fill(policy, batches, live, flush=lambda: None):
    """``batches`` batches of 120 fresh keys, each flushed, then the oldest
    evicted down to ``live``; returns the victims."""
    victims, key = [], 0
    for _ in range(batches):
        for _ in range(120):
            key += 1
            policy.record_insert(0, key)
        flush()
        while len(policy._stamp_of) > live:
            victims.append(policy.next_victim())
            assert victims[-1] is not None, "the index lost live stamps"
    return victims


def test_tree_stays_shallow():
    smr = serving.ServingConfig(smr="IBR").build_scheme()
    batched = BatchedLruEviction()
    batched.bind(types.SimpleNamespace(smr=smr))
    victims = _fill(batched, 30, 2400, flush=batched._flush)
    assert victims == list(range(1, 1201))  # oldest first, as the copy
    assert len(batched.index.snapshot()) == 2400
    assert _depth(batched.index) <= 64
    assert batched.n_flushes == 30 and batched.n_flushed_stamps == 3600
    # the copied policy keeps its live stamps on one spine (a short run:
    # each of its touches walks that spine)
    copied = LruEviction()
    copied.bind(types.SimpleNamespace(smr=smr))
    _fill(copied, 3, 240)
    assert _depth(copied.index) >= 240


def test_client_hits_beside_engine_inserts():
    smr = serving.ServingConfig(smr="IBR").build_scheme()
    pool = BlockPool(smr, 256)
    cache = PrefixCache(smr, pool, 8, max_entries=64,
                        eviction=BatchedLruEviction())
    rng = np.random.default_rng(2**31 + 3)
    prompts = [rng.integers(1, 1000, size=int(n)).tolist()
               for n in rng.integers(16, 96, size=24)]
    stop = threading.Event()
    errors, hits = [], [0, 0]

    def client(i):
        try:
            r = np.random.default_rng(i)
            while not stop.is_set():
                prompt = prompts[int(r.integers(len(prompts)))]
                pages, n_tok = cache.lookup(prompt + [1001 + i])
                hits[i] += n_tok > 0
                for pg in pages:
                    pool.unpin(pg)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    def janitor():
        try:
            while not stop.wait(0.001):
                cache.pressure_evict()
                smr.help_reclaim()
        except Exception as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    clients = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    clients.append(threading.Thread(target=janitor))
    try:
        for t in clients:
            t.start()
        for n in range(200):
            prompt = prompts[n % len(prompts)]
            pages = []
            for _ in range(len(prompt) // 8):
                pg = pool.try_alloc()
                if pg is None:
                    cache.pressure_evict()
                    smr.help_reclaim()
                    break
                pages.append(pg)
            else:
                cache.insert(prompt, pages)
            for pg in pages:
                pool.release(pg)
            assert cache.n_entries.load() <= 64
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in clients)
    assert not errors, errors
    assert min(hits) > 0
    policy = cache.eviction
    assert policy.n_flushes > 0
    cache.clear()
    smr.flush()
    assert pool.free_count() == 256
    assert cache.n_entries.load() == 0
    assert policy.index.snapshot() == [] and not policy._queued


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    m = build_model(cfg)
    return m, m.init(0, device="cpu")


@pytest.mark.parametrize("eviction", ["lru", "fifo"])
def test_engine_builds_the_batched_lru(model, eviction):
    m, p = model
    session = serving.serve(m, p, serving.ServingConfig(
        smr="IBR", num_pages=64, page_size=8, max_batch=2, max_seq_len=64,
        prefix_cache_entries=4, eviction=eviction), device="cpu")
    try:
        rng = np.random.RandomState(5)
        for _ in range(3):
            prompt = rng.randint(1, 200, size=24).tolist()
            session.submit(prompt, max_new_tokens=4).result(timeout=120)
        policy = session.engine.shards[0].prefix_cache.eviction
        totals = session.stats()["totals"]
    finally:
        session.close()
    if eviction == "lru":
        assert type(policy) is BatchedLruEviction
        assert totals["lru_flushes"] > 0
        assert totals["lru_flushed_stamps"] >= totals["lru_flushes"]
    else:
        assert type(policy) is FifoEviction
        assert totals["lru_flushes"] == totals["lru_flushed_stamps"] == 0
