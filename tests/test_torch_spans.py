"""The serving loop's spans and counters (``repro_torch.serving.spans``) on
a reduced TinyLlama served on the CPU, and ``ServingSession.profile``.

* A mixed set of runs (chunked with a prefix hit, packed, swap
  preemption, speculative) records every span the loop has, each child's
  total within its parent's.
* The counters equal what they count: the mean admission wait of the
  requests, the prompt tokens less the prefix hits, the rows and context
  lengths the paged kernel saw on its first layer.
* With no capture open the ring stays ``None``; a capture writes a trace
  whose spans lie inside it, reports the load it saw, and refuses to run
  beside another profiler.
* The profiler stops on the caller's thread, with the watchdog's
  heartbeat checks held: a stop longer than the heartbeat timeout
  degrades no shard and migrates or fails no request.
* On the card (``cuda``): the two anchors agree within 50 microseconds,
  the engine thread's launches fall inside its step spans, and its only
  waits for the device are the sampler's reads.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.runtime.swap import page_nbytes
from repro_torch.serving import spans as sp

CONF = dict(smr="IBR", num_pages=64, page_size=8, max_batch=4,
            max_seq_len=128, prefill_chunk_tokens=16)
STEPS = ("step.decode", "step.chunk", "step.spec")
# every span of the serving loop, and the span each one nests in (a step
# span where it is one of STEPS)
PARENT = {
    "admit": STEPS, "chunk": STEPS, "decode.launch": STEPS,
    "sample.launch": STEPS, "sample.wait": STEPS, "emit": STEPS,
    "finish": STEPS, "prefix_cache.insert": ("finish",),
    "pool.release": ("finish",), "swap.out": ("admit",),
    "swap.in": ("admit",), "prefix_cache.lookup": ("submit",),
}
ALL = set(PARENT) | set(STEPS) | {"engine.idle", "submit", "request.queue",
                                  "request.prefill"}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    m = build_model(cfg)
    return m, m.init(0, device="cpu")


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 200, size=length).tolist() for _ in range(n)]


def _shared_prefix_run(m, p, scheduler):
    """One prompt alone, then one that shares its first 24 tokens (a
    three-page hit) beside two others; returns (handles, stats)."""
    session = serving.serve(m, p, serving.ServingConfig(
        scheduler=scheduler, **CONF), device="cpu")
    shared = _prompts(1, 1, 24)[0]
    first = session.submit(shared + [3, 4, 5], max_new_tokens=6)
    first.result(timeout=120)
    rest = [session.submit(q, max_new_tokens=6) for q in
            [shared + [7, 8]] + _prompts(2, 2, 21)]
    for h in rest:
        h.result(timeout=120)
    stats = session.stats()
    session.close()
    return [first] + rest, stats


def _swap_run(m, p):
    """Six low-priority requests fill the batch; two high-priority ones
    preempt them into the host arena, and they resume."""
    cfg = m.cfg
    session = serving.serve(m, p, serving.ServingConfig(
        **dict(CONF, num_pages=32, admission="priority", eviction="swap",
               swap_bytes=64 * page_nbytes(cfg.n_layers, 8, cfg.n_kv_heads,
                                           cfg.head_dim, "float32"),
               priority_classes=("hi:priority=10", "lo:priority=0"))),
        device="cpu")
    lows = [session.submit(q, max_new_tokens=48, priority_class="lo")
            for q in _prompts(42, 6, 16)]
    deadline = time.perf_counter() + 60
    while sum(1 for h in lows if h.out_tokens) < 4 and \
            time.perf_counter() < deadline:
        time.sleep(0.002)
    highs = [session.submit(q, max_new_tokens=32, priority_class="hi")
             for q in _prompts(142, 2, 16)]
    for h in lows + highs:
        h.result(timeout=300)
    stats = session.stats()
    session.close()
    return lows + highs, stats


def _spec_run(m, p):
    session = serving.serve(m, p, serving.ServingConfig(spec_k=2, **CONF),
                            device="cpu")
    hs = [session.submit(q, max_new_tokens=8) for q in _prompts(10, 3, 11)]
    for h in hs:
        h.result(timeout=120)
    stats = session.stats()
    session.close()
    return hs, stats


@pytest.fixture(scope="module")
def runs(model):
    m, p = model
    return {"chunked": _shared_prefix_run(m, p, "chunked"),
            "packed": _shared_prefix_run(m, p, "packed"),
            "swap": _swap_run(m, p), "spec": _spec_run(m, p)}


def _spans_of(totals):
    return {k[len("span_n."):]: (totals[k], totals["span_s." + k[7:]])
            for k in totals if k.startswith("span_n.")}


def test_every_span_appears_after_a_mixed_run(runs):
    seen = set()
    for _, stats in runs.values():
        seen |= set(_spans_of(stats["totals"]))
    assert seen == ALL
    assert runs["swap"][1]["totals"]["preemptions"] >= 1
    # the swap timers are the swap spans' totals
    shard = runs["swap"][1]["shards"][0]
    assert shard["swap_out_s"] == shard["spans"]["swap.out"][1] > 0
    assert shard["swap_in_s"] == shard["spans"]["swap.in"][1] > 0


@pytest.mark.parametrize("kind", ["chunked", "packed", "swap", "spec"])
def test_each_child_within_its_parent(runs, kind):
    spans = _spans_of(runs[kind][1]["totals"])
    for child, parents in PARENT.items():
        if child in spans:
            n, s = spans[child]
            assert n > 0
            assert s <= sum(spans.get(q, (0, 0.0))[1] for q in parents), \
                (child, parents)
    assert set(STEPS) & set(spans)


@pytest.mark.parametrize("kind", ["chunked", "packed", "swap", "spec"])
def test_queue_wait_is_the_mean_admission_wait(runs, kind):
    handles, stats = runs[kind]
    t = stats["totals"]
    waits = [h.req.t_admit - h.req.t_submit for h in handles]
    assert t["span_n.request.queue"] == len(handles)
    assert t["span_n.request.prefill"] == len(handles)
    # the span keeps whole nanoseconds of each stamp
    assert t["span_s.request.queue"] / t["span_n.request.queue"] == \
        pytest.approx(float(np.mean(waits)), rel=0, abs=2e-9)


@pytest.mark.parametrize("kind", ["chunked", "packed"])
def test_prefill_tokens_computed_leaves_out_prefix_hits(runs, kind):
    handles, stats = runs[kind]
    t = stats["totals"]
    hits = [h.req._hit_tokens for h in handles]
    assert t["prefix_hits"] >= 1 and hits[1] == 24
    assert t["prefill_tokens_computed"] == sum(
        len(h.req.prompt) for h in handles) - sum(hits)


@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
def test_decode_counters_match_the_paged_calls(model, monkeypatch,
                                               scheduler):
    """``decode_rows`` / ``decode_kv_tokens`` equal the occupied rows and
    their context lengths that the paged kernel saw on the first layer of
    every decode call."""
    m, p = model
    calls = []
    paged = ops.paged_attention

    def spy(q, k_pages, v_pages, block_tables, ctx_lens, *a, **kw):
        occ = kw.get("occupancy")
        calls.append([c for c, o in zip(ctx_lens.tolist(), occ.tolist())
                      if o])
        return paged(q, k_pages, v_pages, block_tables, ctx_lens, *a, **kw)

    monkeypatch.setattr(ops, "paged_attention", spy)
    handles, stats = _shared_prefix_run(m, p, scheduler)
    first = calls[::m.cfg.n_layers]
    t = stats["totals"]
    assert t["decode_rows"] == sum(len(c) for c in first) > 0
    assert t["decode_kv_tokens"] == sum(sum(c) for c in first)
    assert t["span_n.decode.launch"] == len(first)


def test_span_ring_stays_empty_without_a_capture(model, runs):
    m, p = model
    session = serving.serve(m, p, serving.ServingConfig(**CONF),
                            device="cpu")
    session.submit(_prompts(3, 1, 9)[0], max_new_tokens=4).result(
        timeout=120)
    assert session.engine.shards[0].spans.ring is None
    session.close()


def test_span_totals_survive_their_threads():
    rec = sp.SpanRecorder()

    def client():
        with rec.span("submit"):
            with rec.span("prefix_cache.lookup"):
                pass

    for _ in range(3):
        t = threading.Thread(target=client)
        t.start()
        t.join(10)
        assert not t.is_alive()
    with rec.span(None):            # an unnamed span records nothing
        with rec.span("admit"):
            pass
    got = rec.totals()
    assert got["submit"][0] == 3 and got["prefix_cache.lookup"][0] == 3
    assert got["admit"][0] == 1 and None not in got
    assert got["prefix_cache.lookup"][1] <= got["submit"][1]


def test_innermost_segments_and_idle_by_span():
    spans = [(0, 100, "step.decode"), (10, 40, "decode.launch"),
             (50, 60, "sample.wait"), (120, 150, "engine.idle")]
    segs = sp._innermost(spans)
    assert segs == [(0, 10, "step.decode"), (10, 40, "decode.launch"),
                    (40, 50, "step.decode"), (50, 60, "sample.wait"),
                    (60, 100, "step.decode"), (120, 150, "engine.idle")]
    busy, gaps = sp._busy_gaps([(5, 20, "k"), (15, 45, "k"),
                                (90, 130, "k")], 0, 160)
    assert busy == 40 + 40 and gaps == [(0, 5), (45, 90), (130, 160)]
    idle = sp._overlap_by_name(gaps, segs)
    assert idle == {"step.decode": 5 + 5 + 30, "sample.wait": 10,
                    "engine.idle": 20, "(no span)": 10}
    assert sp._names_at([5, 40, 55, 100, 110], segs) == {
        "step.decode": 2, "sample.wait": 1, "(no span)": 2}


def _client(session, stop, n=6):
    """Submits short requests, a few at a time, until ``stop``."""
    i = 0
    while not stop.is_set():
        hs = [session.submit(q, max_new_tokens=n)
              for q in _prompts(1000 + i, 3, 13)]
        for h in hs:
            h.wait(60)
        i += 1


def _capture(session, seconds, path):
    stop = threading.Event()
    t = threading.Thread(target=_client, args=(session, stop))
    t.start()
    try:
        time.sleep(0.2)
        return session.profile(seconds, path)
    finally:
        stop.set()
        t.join(120)
        assert not t.is_alive()


def test_profile_lays_spans_inside_the_capture(model, tmp_path):
    m, p = model
    session = serving.serve(m, p, serving.ServingConfig(**CONF),
                            device="cpu")
    try:
        out = _capture(session, 1.0, tmp_path / "trace.json")
    finally:
        session.close()
    assert len(out["anchor_offsets_ns"]) == 2
    assert out["drift_ns"] == out["anchor_offsets_ns"][1] - \
        out["anchor_offsets_ns"][0]
    a, b = out["window"]
    assert 1.0 <= b - a < 30
    assert out["spans"] > 0
    assert sum(out["idle_by_span"].values()) == pytest.approx(
        out["window_s"] * out["idle_share"], rel=1e-6)
    # self time: each span less its children, on the engine thread
    assert 0 < sum(out["self_by_span"].values()) <= b - a
    assert set(out["self_by_span"]) <= ALL
    with open(tmp_path / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    mine = [e for e in ev if e["pid"] in ("host", "requests")
            and e["name"] in ALL]
    assert {e["name"] for e in mine} >= {"step.decode", "decode.launch",
                                        "sample.wait", "emit"}
    for e in mine:
        assert a * 1e6 - 1e-3 <= e["ts"] and \
            e["ts"] + e["dur"] <= b * 1e6 + 1e-3, e
    # the profiler's operations of the engine thread share its row
    engine_row = [e for e in ev if e["tid"] == "shard-0-engine"]
    assert any(e["name"].startswith("aten::") for e in engine_row)
    assert session.engine.shards[0].spans.ring is None
    # the load over the capture, from the counters at the anchors
    calls = [e for e in mine if e["name"] == "decode.launch"]
    assert out["decode_calls"] == len(calls) > 0
    assert 1 <= out["rows_per_decode"] <= CONF["max_batch"]
    assert out["context_per_row"] >= 1
    assert out["prefill_tokens_computed"] > 0


def _keep_the_gil(seconds):
    """Spin for ``seconds`` without letting another thread run, as a
    profiler's stop does while it gathers its events."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(100.0)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass
    finally:
        sys.setswitchinterval(old)
        # the threads waiting for the GIL wait out the long interval
        # unless it changes hands: hand it on, as torch's return does
        time.sleep(0.001)


STOP_S = 1.5


@pytest.mark.parametrize("gil", ["kept", "released"])
def test_profile_stop_leaves_the_watchdog_quiet(model, tmp_path,
                                               monkeypatch, gil):
    """The caller's thread stops the profiler, and the watchdog's
    heartbeat checks are held across the stop: a stop three times the
    heartbeat timeout, on two shards under the default watchdog, marks no
    shard degraded and migrates or fails no request.  A stop that lets
    the GIL go leaves the engine stepping through it."""
    m, p = model
    begin = sp.Capture.begin

    def slow_begin(cap):
        begin(cap)
        stop = cap.prof.stop

        def slow_stop():
            stop()
            if gil == "kept":
                _keep_the_gil(STOP_S)
            else:
                time.sleep(STOP_S)
        cap.prof.stop = slow_stop

    monkeypatch.setattr(sp.Capture, "begin", slow_begin)
    session = serving.serve(m, p, serving.ServingConfig(
        num_shards=2, heartbeat_timeout_s=0.5, watchdog_interval_s=0.02,
        **CONF), device="cpu")
    assert session.config.watchdog == "migrate"
    try:
        out = _capture(session, 0.3, tmp_path / "trace.json")
        stats = session.stats()
    finally:
        session.close()
    assert out["stop_s"] >= STOP_S
    if gil == "released":
        assert out["beats_in_stop"] > 0
    t = stats["totals"]
    assert t["heartbeat_misses"] == 0 and t["failed"] == 0
    assert t["completed"] > 0
    for shard in stats["shards"]:
        assert not shard["degraded"]
        assert shard["migrated_in"] == shard["migrated_out"] == 0


def test_profile_refuses_beside_another_profiler(model, tmp_path):
    m, p = model
    session = serving.serve(m, p, serving.ServingConfig(**CONF),
                            device="cpu")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with pytest.raises(RuntimeError, match="another profiler"):
                session.profile(0.1, tmp_path / "t.json")
    finally:
        session.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profile_on_the_card(cuda_device, tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="bfloat16")
    m = build_model(cfg)
    session = serving.serve(m, m.init(0, device="cuda"),
                            serving.ServingConfig(scheduler="packed",
                                                  **CONF))
    session.warm()
    try:
        out = _capture(session, 1.0, tmp_path / "trace.json")
    finally:
        session.close()
    print(json.dumps(out))
    assert abs(out["drift_ns"]) <= 50_000
    assert out["launches"] > 0 and out["launches_in_step"] >= 0.99
    # the step's one wait for the device is the sampler's read
    assert set(out["syncs_by_span"]) == {"sample.wait"}
    assert 0 < out["busy_share"] < 1
    with open(tmp_path / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    assert any(e["pid"] == "device" for e in ev)
