"""The dense decode call's graph runner (``serving/decode_graph.py``) on
the CPU, with a stand-in for CUDA graphs: its "capture" runs the call on
the static buffers, and a "replay" runs it again there, copying the
logits into the captured output and leaving the host counts untouched, as
a replayed graph does.  What is held:

* the staging (one host block, one copy into the static buffers) and the
  replay give the direct ``stack.rows`` path's logits, pools and tokens
  bit for bit over a served run with changing rows, padding rows (page
  -1), contexts and a rider call; and every host count (block passes,
  launches by kernel, here counted by wrappers around the fused ops) as
  that path does, one capture's delta a replay;
* where a graph serves: a stack whose rows can be captured (the dense
  stack, not the latent one) on a CUDA device, for a call of the captured
  row count; a spec verify chunk stays eager;
* the benchmark's reader of ``decode_graph_replays``
  (``h100bench/metrics/engine.decode_graph_share.py``).

The graph itself is held against the eager step on the card in
``tests/test_torch_kernels_cuda.py``."""

import importlib.util
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import fused_block, ops, paged_attention
from repro_torch.models import build_model
from repro_torch.serving import decode_graph
from repro_torch.serving.decode_graph import DecodeGraph, captures
from repro_torch.serving.paged_stack import DenseStack, LatentStack

CONFIG = dict(num_pages=96, page_size=4, max_batch=4, max_seq_len=64,
              prefill_chunk_tokens=8, watchdog="off")
FUSED = ("add_rms_norm", "qk_norm_rope_write", "silu_mul")


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


@pytest.fixture(scope="module")
def tiny_latent():
    cfg = get_config("deepseek-v2-236b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


class Replayed:
    """CUDA graphs' stand-in on the CPU (see the module's docstring)."""

    def __init__(self, stack):
        self.stack = stack
        self.captures = 0

    def warm(self, run):
        run()

    def capture(self, run):
        self.run, self.out = run, run()
        self.captures += 1
        return self.out, 0

    def replay(self):
        with decode_graph.counted(self.stack) as ran:
            self.out.copy_(self.run())
        decode_graph.add_counts(self.stack, ran, -1)


def install(shard):
    """Give a CPU shard a decode graph over the stand-in."""
    graphs = Replayed(shard.stack)
    shard._decode_graph = DecodeGraph(shard.stack, shard._decode_rows,
                                      shard._decode_operands(), "cpu",
                                      graphs=graphs)
    return graphs


@pytest.fixture
def counted_launches(monkeypatch):
    """Count a launch of each fused op and of paged attention on the CPU
    too, through the kernels' own counters."""
    def counting(name, fn, counter, variant):
        def call(*args, **kw):
            counter.add(variant)
            return fn(*args, **kw)
        monkeypatch.setattr(ops, name, call)
    for op in FUSED:
        counting(op, getattr(ops, op), fused_block.launches, op)
    counting("paged_attention", ops.paged_attention,
             paged_attention.launches, "plain")


def _launches():
    return {"fused": dict(fused_block.launches.by_variant),
            "paged": dict(paged_attention.launches.by_variant)}


def _delta(before, after):
    """Launches by kernel and variant between two :func:`_launches`."""
    return {k: {v: n - before[k].get(v, 0) for v, n in after[k].items()
                if n != before[k].get(v, 0)} for k in before}


def serve_run(model, params, graph: bool, **conf):
    """Serve three requests, the third arriving once the first two decode
    (so it rides in as a packed chunk's decode riders), stepping the shard
    by hand.  Returns the logits of every decode call, the pools after
    every step, the tokens, the totals, the launch deltas and the graph's
    stand-in (or None)."""
    config = dict(CONFIG, **conf)
    session = serving.serve(model, params, serving.ServingConfig(**config),
                            device="cpu", start=False)
    shard = session.engine.shards[0]
    graphs = install(shard) if graph else None
    calls = []
    orig = shard._decode_logits

    def recorded(seqs):
        logits, ctx = orig(seqs)
        calls.append((len(seqs), logits.clone(), ctx.copy()))
        return logits, ctx
    shard._decode_logits = recorded
    rng = np.random.RandomState(5)
    pools, before = [], _launches()
    try:
        with torch.inference_mode():
            handles = [session.submit(rng.randint(1, 200, size=n).tolist(),
                                      max_new_tokens=m)
                       for n, m in ((9, 7), (5, 9))]
            for _ in range(4):
                shard.step()
                pools.append((shard.k_pages.clone(), shard.v_pages.clone()))
            handles.append(session.submit(
                rng.randint(1, 200, size=13).tolist(), max_new_tokens=5))
            while shard.step():
                pools.append((shard.k_pages.clone(), shard.v_pages.clone()))
        tokens = [h.result(timeout=60) for h in handles]
        totals = session.stats()["totals"]
    finally:
        session.close()
    return calls, pools, tokens, totals, _delta(before, _launches()), graphs


@pytest.mark.parametrize("scheduler,dtype", [("packed", "float32"),
                                             ("packed", "bfloat16"),
                                             ("chunked", "float32")])
def test_replay_is_the_direct_path(counted_launches, scheduler, dtype):
    """Graph and direct runs agree in every decode call's logits, the
    pools after every step, the tokens, the block passes and the launches
    by kernel; the graph run replays every decode call, capturing once."""
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    want = serve_run(model, params, False, scheduler=scheduler)
    got = serve_run(model, params, True, scheduler=scheduler)
    (w_calls, w_pools, w_toks, w_tot, w_launch, _) = want
    (g_calls, g_pools, g_toks, g_tot, g_launch, graphs) = got
    calls = g_tot["decode_steps"] + g_tot["rider_chunks"]
    assert len(g_calls) == len(w_calls) == calls >= 8
    if scheduler == "packed":
        assert g_tot["rider_chunks"] >= 1
    # rows change, padding rows stay, contexts grow
    assert len({n for n, _, _ in g_calls}) >= 2
    assert all(n < CONFIG["max_batch"] for n, _, _ in g_calls)
    for (wn, wl, wc), (gn, gl, gc) in zip(w_calls, g_calls):
        assert wn == gn and np.array_equal(wc, gc)
        assert torch.equal(wl, gl)
    assert len(g_pools) == len(w_pools)
    for (wk, wv), (gk, gv) in zip(w_pools, g_pools):
        assert torch.equal(wk, gk) and torch.equal(wv, gv)
    assert g_toks == w_toks
    for key in ("fused_blocks", "eager_blocks", "decode_rows",
                "decode_kv_tokens"):
        assert g_tot[key] == w_tot[key], key
    assert g_launch == w_launch
    assert g_launch["fused"]["qk_norm_rope_write"] == w_tot["eager_blocks"]
    assert g_tot["decode_graph_replays"] == calls
    assert w_tot["decode_graph_replays"] == 0
    assert graphs.captures == 1


def test_capture_leaves_one_call_of_counts(tiny, counted_launches):
    """A first call (warm-up, capture, replay) and each later one add
    exactly one decode call's block passes and launches."""
    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu", start=False)
    shard = session.engine.shards[0]
    graphs = install(shard)
    n_l = model.cfg.n_layers
    want = {"fused": {"add_rms_norm": 2 * n_l + 1, "qk_norm_rope_write": n_l,
                      "silu_mul": n_l},
            "paged": {"plain": n_l}}
    try:
        with torch.inference_mode():
            for _ in range(3):
                before, blocks = _launches(), shard.stack.eager_blocks
                shard._decode_logits([])
                assert _delta(before, _launches()) == want
                assert shard.stack.eager_blocks - blocks == n_l
    finally:
        session.close()
    assert graphs.captures == 1
    assert shard._decode_graph.delta == {
        "eager_blocks": n_l,
        **{f"fused_block:{k}": v for k, v in want["fused"].items()},
        "paged_attention:plain": n_l}


def test_capture_counts_its_own_thread(tiny, counted_launches):
    """Launches another thread counts while a shard captures (another
    shard's engine on the same card) stay out of the replay's delta and
    stay counted."""
    class Busy(Replayed):
        def capture(self, run):
            other = threading.Thread(
                target=fused_block.launches.add, args=("other", 5))
            other.start()
            other.join(timeout=30)
            assert not other.is_alive()
            return super().capture(run)

    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu", start=False)
    shard = session.engine.shards[0]
    shard._decode_graph = DecodeGraph(
        shard.stack, shard._decode_rows, shard._decode_operands(), "cpu",
        graphs=Busy(shard.stack))
    before = fused_block.launches.of("other")
    try:
        with torch.inference_mode():
            shard._decode_logits([])
    finally:
        session.close()
    assert fused_block.launches.of("other") == before + 5
    assert "fused_block:other" not in shard._decode_graph.delta
    assert shard._decode_graph.delta["fused_block:silu_mul"] == \
        model.cfg.n_layers


def decode_operands(rng, shard, n_live):
    """Host operands of one decode call: ``n_live`` rows at random
    contexts over random page runs, the rest padding (page -1)."""
    b, p, pg = shard.max_batch, shard.max_pages, shard.page_size
    bt = rng.randint(0, CONFIG["num_pages"], size=(b, p)).astype(np.int32)
    ctx = np.ones((b,), np.int32)
    ctx[:n_live] = rng.randint(1, p * pg, size=n_live)
    occ = np.arange(b) < n_live
    pos = (ctx - 1).astype(np.int64)
    wr_page = np.where(occ, bt[np.arange(b), pos // pg], -1).astype(np.int64)
    return (bt, ctx, rng.randint(1, 200, size=b).astype(np.int64), occ, pos,
            wr_page, pos % pg)


@pytest.mark.parametrize("staged", [False, True])
def test_calls_with_own_operands(tiny, staged):
    """Eight calls of ``_paged_decode_step`` on pools overwritten between
    calls, with operands the caller made (copied into the static buffers)
    or staged through ``upload``: logits and pools as the direct path's."""
    model, params = tiny
    shards, sessions = [], []
    for graph in (False, True):
        session = serving.serve(model, params,
                                serving.ServingConfig(**CONFIG),
                                device="cpu", start=False)
        sessions.append(session)
        shards.append(session.engine.shards[0])
    eager, graphed = shards
    install(graphed)
    rng = np.random.RandomState(3)
    try:
        with torch.inference_mode():
            for step in range(8):
                gen = torch.Generator().manual_seed(step)
                for pool in (eager.k_pages, eager.v_pages):
                    pool.normal_(generator=gen)
                graphed.k_pages.copy_(eager.k_pages)
                graphed.v_pages.copy_(eager.v_pages)
                host = decode_operands(rng, eager, step % 4)
                want = eager._paged_decode_step(
                    *[torch.from_numpy(a) for a in host])
                ops_ = graphed._decode_graph.upload(host) if staged else \
                    [torch.from_numpy(a.copy()) for a in host]
                got = graphed._paged_decode_step(*ops_)
                assert torch.equal(got, want)
                assert torch.equal(graphed.k_pages, eager.k_pages)
                assert torch.equal(graphed.v_pages, eager.v_pages)
    finally:
        for session in sessions:
            session.close()
    assert graphed.decode_graph_replays == 8
    assert eager.decode_graph_replays == 0


def test_upload_is_one_block(tiny):
    """The seven host operands land in the static buffers, each in its
    dtype and shape, from one staging block taken in turn."""
    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu", start=False)
    shard = session.engine.shards[0]
    install(shard)
    graph = shard._decode_graph
    rng = np.random.RandomState(1)
    b, p = shard.max_batch, shard.max_pages
    try:
        for turn in range(3):
            host = (rng.randint(0, 96, size=(b, p)).astype(np.int32),
                    rng.randint(1, 60, size=b).astype(np.int32),
                    rng.randint(0, 200, size=b).astype(np.int64),
                    rng.rand(b) > 0.5,
                    rng.randint(0, 60, size=b).astype(np.int64),
                    rng.randint(-1, 96, size=b).astype(np.int64),
                    rng.randint(0, 4, size=b).astype(np.int64))
            dev = graph.upload(host)
            assert dev is graph.static
            for t, a, (shape, dtype) in zip(dev, host,
                                            shard._decode_operands()):
                assert t.dtype == dtype and tuple(t.shape) == shape
                assert np.array_equal(t.numpy(), a)
                assert t.untyped_storage().data_ptr() == \
                    graph.block.untyped_storage().data_ptr()
            assert graph._turn == (turn + 1) % 2
    finally:
        session.close()


@pytest.mark.parametrize("stack,device,want", [
    (DenseStack, "cuda", True), (DenseStack, "cuda:1", True),
    (DenseStack, "cpu", False), (LatentStack, "cuda", False),
    (LatentStack, "cpu", False)])
def test_graph_serves_a_dense_stack_on_cuda_only(stack, device, want):
    assert captures(stack, device) is want


@pytest.mark.parametrize("latent", [False, True])
def test_cpu_shards_run_eagerly(tiny, tiny_latent, latent):
    model, params = tiny_latent if latent else tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu", start=False)
    try:
        shard = session.engine.shards[0]
        assert shard._decode_graph is None
        with torch.inference_mode():
            session.warm()
            shard._decode_logits([])
        assert session.stats()["totals"]["decode_graph_replays"] == 0
    finally:
        session.close()


@pytest.mark.parametrize("rows,want", [(4, True), (3, False), (20, False)])
def test_graph_takes_the_captured_rows_only(tiny, rows, want):
    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu", start=False)
    try:
        shard = session.engine.shards[0]
        install(shard)
        first = torch.zeros((rows, shard.max_pages), dtype=torch.int32)
        assert shard._decode_graph.takes(first) is want
    finally:
        session.close()


def test_spec_verify_stays_eager(tiny):
    """A speculative round's verify chunk (max_batch x (spec_k + 1)
    lanes) runs the stack's rows directly: no replay."""
    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(
        spec_k=2, **CONFIG), device="cpu", start=False)
    shard = session.engine.shards[0]
    graphs = install(shard)
    try:
        h = session.submit(list(range(3, 14)), max_new_tokens=6)
        with torch.inference_mode():
            while shard.step():
                pass
        assert len(h.result(timeout=60)) == 6
        totals = session.stats()["totals"]
    finally:
        session.close()
    assert totals["spec_rounds"] >= 1
    assert totals["decode_graph_replays"] == 0 and graphs.captures == 0


def _share_reader():
    path = (Path(__file__).resolve().parents[1] / "h100bench" / "metrics"
            / "engine.decode_graph_share.py")
    spec = importlib.util.spec_from_file_location("decode_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("a,b,want", [
    # every decode call of the window replayed
    ({"decode_steps": 10, "rider_chunks": 2, "decode_graph_replays": 13},
     {"decode_steps": 40, "rider_chunks": 6, "decode_graph_replays": 47},
     100.0),
    # none did (an eager stack)
    ({}, {"decode_steps": 8, "rider_chunks": 0, "decode_graph_replays": 0},
     0.0),
    ({}, {"decode_steps": 6, "rider_chunks": 2, "decode_graph_replays": 6},
     75.0),
    # no decode call in the window
    ({"decode_steps": 5, "rider_chunks": 1, "decode_graph_replays": 6},
     {"decode_steps": 5, "rider_chunks": 1, "decode_graph_replays": 6},
     None),
    # a program without the counter
    ({}, {"decode_steps": 5, "rider_chunks": 1}, None)])
def test_decode_graph_share_reader(a, b, want):
    reader = _share_reader()
    assert reader.TRACED and reader.UNIT == "%"
    got = reader.read(SimpleNamespace(stats_a=a, stats_b=b, seconds=50.0))
    assert got == (None if want is None else pytest.approx(want))
