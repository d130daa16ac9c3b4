"""One run of a cell: make the weights, open and warm the session, run the
traffic's lead-in, measure the window, then check what it served.

The traffic is sent by one client thread (this one) on the schedule the
generator gives, through ``repro_torch.serving`` sessions'
``submit``; the engine's own thread serves it.  A request's due time is
the schedule's; each run prints how far the client lagged behind it.
Set-up runs from the process's start to the first request of
the lead-in; nothing the window runs is built or compiled after it.
"""

from __future__ import annotations

import gc
import heapq
import itertools
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

import hb_check
from hb_cell import Cell, plugin
from hb_draw import Spec, rng_for
from hb_trace import Tracer


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Record:
    spec: Spec
    due: float
    sent: float
    handle: object
    done_at_end: bool = False

    @property
    def out_times(self):
        return self.handle.req.out_times

    @property
    def out_tokens(self):
        return self.handle.req.out_tokens

    @property
    def status(self) -> str:
        return self.handle.req.status

    @property
    def finished(self) -> bool:
        return self.handle.req.done.is_set()


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    records: List[Record]
    stats_a: dict
    stats_b: dict
    slice: Optional[object] = None


def open_session(cell: Cell, params, device):
    """The served session, warmed: the engine builds and loads the kernels
    when it is made; ``warm`` launches every packed-prefill bucket."""
    from repro_torch import serving
    from repro_torch.models import build_model
    cfg = cell.config
    model = build_model(cell.arch.model_config(cfg, cfg["torch_dtype"]))
    session = serving.serve(model, params,
                            serving.ServingConfig(**cfg["engine"]),
                            device=device)
    session.warm()
    return session


def drive(session, traffic, t0: float, t_end: float,
          marks: List[Tuple[float, Callable[[], None]]],
          records: List[Record], poll_s: float = 0.005) -> None:
    """Send the traffic on its schedule (times relative to ``t0``) until
    ``t_end``, appending a record of each request to ``records`` and
    calling each mark's function once its time has come (those due at or
    after ``t_end`` when the window closes, in order); a mark that returns
    another (time, function) pair schedules it."""
    heap, order = [], itertools.count()

    def push(due_rel, spec):
        heapq.heappush(heap, (t0 + due_rel, next(order), spec))

    for due, spec in traffic.initial():
        push(due, spec)
    marks = [(t, next(order), fn) for t, fn in marks]
    heapq.heapify(marks)
    pending = []
    while True:
        now = time.perf_counter()
        while marks and (marks[0][0] <= now or now >= t_end):
            follow = heapq.heappop(marks)[2]()
            if follow is not None:
                heapq.heappush(marks, (follow[0], next(order), follow[1]))
        if now >= t_end:
            break
        while heap and heap[0][0] <= now:
            due, _, spec = heapq.heappop(heap)
            handle = session.submit(spec.prompt, max_new_tokens=spec.max_new)
            rec = Record(spec, due, time.perf_counter(), handle)
            records.append(rec)
            pending.append(rec)
        still = []
        for rec in pending:
            if rec.finished:
                ts = rec.out_times
                t_done = ts[-1] if ts else time.perf_counter()
                for due, spec in traffic.after(rec.spec, list(rec.out_tokens),
                                               t_done - t0):
                    push(due, spec)
            else:
                still.append(rec)
        pending = still
        nxt = min([t_end] + ([heap[0][0]] if heap else []) +
                  ([marks[0][0]] if marks else []))
        time.sleep(max(0.0, min(poll_s, nxt - time.perf_counter())))


def _launches() -> dict:
    """Launches so far of the paged and packed kernels, by variant (the
    port's own counters)."""
    from repro_torch.kernels import packed_prefill, paged_attention
    out = {}
    for name, mod in (("paged_attention", paged_attention),
                      ("packed_prefill_attention", packed_prefill)):
        out[name] = mod.launches.count
        for v, n in mod.launches.by_variant.items():
            out[f"{name}.{v}"] = n
    return out


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, metrics: List[dict], *,
             control: bool = False) -> dict:
    """One run; returns the result line's fields (and, with ``control``,
    the control's verdict beside the program's)."""
    cfg, mix, arch = cell.config, cell.mix, cell.arch
    device = torch.device(device)
    dtype = getattr(torch, cfg["torch_dtype"])
    weights = arch.make_weights(cfg, seed, device, dtype)
    session = open_session(cell, arch.program_params(weights), device)
    params = mix["params"]
    lead = float(mix["lead_s"])
    traffic = plugin("traffic", mix["kind"]).make(
        params, seed, cfg["vocab_size"], -lead, seconds,
        cfg["engine"]["page_size"])
    tracer = Tracer(session, mix["trace"]["slice_s"]) if trace else None
    if tracer is not None:
        tracer.prepare()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_lead = time.perf_counter()
    setup_s = t_lead - t_start
    t0 = t_lead + lead
    t_end = t0 + seconds
    stats, records = {}, []

    def snapshot(name):
        def take():
            if name == "b":
                for r in records:
                    r.done_at_end = r.finished
            stats[name] = session.stats()["totals"]
            stats["launches_" + name] = _launches()
        return take

    marks = [(t0, snapshot("a")), (t_end, snapshot("b"))]
    if tracer is not None:
        marks.append((t_end - mix["trace"]["slice_s"], tracer.open))
    drive(session, traffic, t0, t_end, marks, records)
    stats_b = stats["b"]
    before, after = stats["launches_a"], stats["launches_b"]
    say("[launches] in the window: " + ", ".join(
        f"{k} {v - before.get(k, 0)}" for k, v in after.items()))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    failed = sum(1 for r in records if r.status in ("failed", "cancelled"))
    attempted = len(records)
    lag = max((r.sent - r.due for r in records), default=0.0)
    due = sum(1 for r in records if t0 <= r.due < t_end)
    say(f"[run] {cell.name} seed={seed}: {attempted} sent, {due} "
        f"due in the window, {failed} failed; client lag at most "
        f"{lag * 1e3:.1f} ms; setup {setup_s:.1f} s")
    pages = cfg["engine"]["num_pages"]
    say(f"[pool] at the window's end: {pages - stats_b['pool_free']} of "
        f"{pages} pages in use, {stats_b['prefix_entries']} prefix-cache "
        f"entries, {stats_b['preemptions']} preemptions")
    ck = mix["check"]
    chosen = hb_check.choose(records, rng_for(seed, "check"),
                             ck["served_tokens"], ck["max_tokens"])
    session.close(drain=True)
    del session
    free_device_memory()
    slice_ = tracer.reduce() if tracer is not None else None
    if tracer is not None:
        say("[trace] profiler seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in tracer.costs.items()))
    run = Run(cell, seconds, setup_s, t0, t_end, records, stats["a"],
              stats_b, slice_)
    values = {}
    for m in metrics:
        v = plugin("metrics", m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    t_check = time.perf_counter()
    readings = hb_check.gap_readings(arch.reference, weights, cfg, chosen,
                                     control)
    say(f"[check] {len(chosen)} requests, {readings['served_tokens']} "
        f"served tokens, reference {time.perf_counter() - t_check:.1f} s")
    correct, checks = hb_check.judge(readings, failed, cell.limits)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": values,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)},
           "readings": readings, "run": run}
    if slice_ is not None:
        out["device"]["busy_s"] = slice_.busy_s
        out["device"]["window_s"] = slice_.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in slice_.device_ops],
                            "idle_gaps": [list(x) for x in slice_.idle_gaps]}
    if control:
        ok, cchecks = hb_check.judge(readings, 0, cell.limits, control=True)
        out["control"] = {"correct": bool(ok), "checks": cchecks}
    out["checks"] = checks
    del weights
    free_device_memory()
    return out

