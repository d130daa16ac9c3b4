"""The readers of the serving loop's spans and counters: each on
synthetic window totals (a program without the key reads None), and all
six on one traced run of the cut cell."""

from types import SimpleNamespace

import pytest

import hb_cell
from hb_tiny import tiny_cell, tiny_run

SIX = ("engine.decode_step_ms", "engine.chunk_step_ms",
       "engine.decode_launch_ms", "engine.sync_wait_ms",
       "prefix_cache.insert_share", "engine.queue_wait_ms")

A = {"span_n.step.decode": 10, "span_s.step.decode": 1.0,
     "span_n.step.chunk": 2, "span_s.step.chunk": 0.5,
     "span_n.decode.launch": 12, "span_s.decode.launch": 0.9,
     "span_n.sample.wait": 12, "span_s.sample.wait": 0.1,
     "span_n.prefix_cache.insert": 3, "span_s.prefix_cache.insert": 0.01,
     "span_n.request.queue": 4, "span_s.request.queue": 0.2}
B = {"span_n.step.decode": 30, "span_s.step.decode": 3.0,
     "span_n.step.chunk": 6, "span_s.step.chunk": 1.7,
     "span_n.decode.launch": 36, "span_s.decode.launch": 2.7,
     "span_n.sample.wait": 36, "span_s.sample.wait": 0.58,
     "span_n.prefix_cache.insert": 8, "span_s.prefix_cache.insert": 0.11,
     "span_n.request.queue": 9, "span_s.request.queue": 0.45}
WANT = {"engine.decode_step_ms": 100.0, "engine.chunk_step_ms": 300.0,
        "engine.decode_launch_ms": 75.0, "engine.sync_wait_ms": 20.0,
        "prefix_cache.insert_share": 0.2, "engine.queue_wait_ms": 50.0}


def _run(a, b, seconds=50.0):
    return SimpleNamespace(stats_a=a, stats_b=b, seconds=seconds)


@pytest.mark.parametrize("name", SIX)
def test_reader_on_window_totals(name):
    reader = hb_cell.plugin("metrics", name)
    assert reader.TRACED
    assert reader.read(_run(A, B)) == pytest.approx(WANT[name])
    # no new span or admission in the window, or a program without them
    assert reader.read(_run(A, A)) is None
    assert reader.read(_run({}, {"steps": 5})) is None


def test_traced_cut_cell_reads_all_six():
    out = tiny_run(tiny_cell(), trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in SIX:
        assert got[name]["value"] > 0, name
