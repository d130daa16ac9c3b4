"""Spans and their totals inside the serving loop, and the operator's
capture that lays them over the device trace on one clock.

A span is a named interval on ``time.perf_counter_ns()``, the clock of
``Request.out_times`` and of the benchmark's window, with the span that
was open around it on the same thread (its parent), and, where it has
them, the request id and the engine step's index::

    with shard.spans.span("decode.launch"):
        ...

Always on, totals only: on exit a span adds its count and nanoseconds to
the CALLING thread's table for its name.  Tables are summed only when
someone reads them (:meth:`SpanRecorder.totals`), as the SMR schemes keep
their thread-local counters, so the hot path takes no lock.  A span whose
name is still ``None`` at exit records nothing (a step that found no
work).  Each interval also goes into a bounded ring, but only while a
capture has the ring open; with none open the ring is ``None``.

:class:`Capture` is :meth:`ServingSession.profile`'s machinery.  The
caller's thread starts a ``torch.profiler`` (CUDA activity on the card,
which records every thread's CUDA runtime calls; every thread's CPU
operations elsewhere) and stops it: a profiler stops on the thread that
started it, and stopping keeps the GIL for seconds on a busy card.  The
engine thread, between steps, opens every shard's ring and places an
anchor at the capture's start and at its end: a few launches, each
bracketed by two ``perf_counter_ns`` stamps.  The profiler records each
launch on its own clock, so the offset between the two clocks is read
from the launch with the narrowest bracket, not assumed; the two
anchors' offsets differ by the drift, and between them the profiler's
clock maps linearly onto the host's (torch gives the trace's start on
the profiler's clock, but no host stamp of the same instant).  The
capture writes one Chrome trace of the profiler's events on the host
clock beside the program's spans, and returns a summary: busy and idle
share of the device, idle device time by the innermost engine span open
at the time, each engine span's self time (its length less what its
children cover), the runtime calls that wait for the device by span, the
load it saw, and the anchors.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

_now = time.perf_counter_ns

# spans kept by one capture, per shard: about 20 a step at ~10 steps a
# second on the card leave ample room; the CPU tests step faster
RING_SPANS = 1 << 18
# launches an anchor makes; the one with the narrowest bracket of host
# stamps reads the offset (a wide bracket holds a thread switch or the
# profiler's first-call cost)
ANCHOR_LAUNCHES = 5
# the counters a capture reads at its anchors (the load it saw)
WORK = ("decode_rows", "decode_kv_tokens", "prefill_tokens_computed")
# where no span is open
OUTSIDE = "(no span)"


class _Thread:
    """One thread's open span and totals (written by that thread only)."""

    __slots__ = ("top", "totals", "ident", "name", "thread")

    def __init__(self):
        t = threading.current_thread()
        self.top: Optional[Span] = None
        self.totals: Dict[str, Tuple[int, int]] = {}
        self.ident = t.ident
        self.name = t.name
        self.thread = t


class Span:
    """One interval; a context manager made by :meth:`SpanRecorder.span`.
    ``name`` may be set (or left ``None`` to drop the span) before exit."""

    __slots__ = ("rec", "th", "name", "t0", "parent", "req", "step")

    def __init__(self, rec: "SpanRecorder", name: Optional[str], req=None,
                 step=None):
        self.rec = rec
        self.name = name
        self.req = req
        self.step = step

    def __enter__(self, _now=_now) -> "Span":
        rec = self.rec
        th = getattr(rec._local, "th", None) or rec._register()
        self.th = th
        self.parent = th.top
        th.top = self
        self.t0 = _now()
        return self

    def __exit__(self, et, ev, tb, _now=_now) -> bool:
        t1 = _now()
        th = self.th
        th.top = self.parent
        name = self.name
        if name is None:
            return False
        totals = th.totals
        n, ns = totals.get(name, (0, 0))
        # one dict store of a fresh tuple: a reader on another thread sees
        # the count and the nanoseconds of the same moment
        totals[name] = (n + 1, ns + t1 - self.t0)
        ring = self.rec.ring
        if ring is not None:
            p = self.parent
            ring.append((name, self.t0, t1, th.ident,
                         p.name if p is not None else None, self.req,
                         self.step))
        return False


class SpanRecorder:
    """Per-thread span totals of one shard, and the capture ring."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._threads: List[_Thread] = []
        # totals of threads that have exited, folded in when a new thread
        # registers (client threads come and go)
        self._gone: Dict[str, Tuple[int, int]] = {}
        self.ring: Optional[deque] = None

    def _register(self) -> _Thread:
        """The calling thread's table, made on its first span."""
        th = _Thread()
        with self._lock:
            for old in [t for t in self._threads
                        if not t.thread.is_alive()]:
                self._threads.remove(old)
                for name, (n, ns) in old.totals.items():
                    gn, gns = self._gone.get(name, (0, 0))
                    self._gone[name] = (gn + n, gns + ns)
            self._threads.append(th)
        self._local.th = th
        return th

    def span(self, name: Optional[str], req=None, step=None) -> Span:
        return Span(self, name, req, step)

    def record(self, name: str, t0: float, t1: float, req=None) -> None:
        """A request-scoped span from two ``perf_counter`` stamps
        (seconds), kept on the calling thread's table; in the ring its
        thread is ``None``: it belongs to the request, not the thread."""
        a, b = int(t0 * 1e9), int(t1 * 1e9)
        th = getattr(self._local, "th", None) or self._register()
        n, ns = th.totals.get(name, (0, 0))
        th.totals[name] = (n + 1, ns + b - a)
        ring = self.ring
        if ring is not None:
            ring.append((name, a, b, None, None, req, None))

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """``{name: (count, seconds)}`` over every thread."""
        with self._lock:
            out = dict(self._gone)
            tables = [dict(t.totals) for t in self._threads]
        for table in tables:
            for name, (n, ns) in table.items():
                gn, gns = out.get(name, (0, 0))
                out[name] = (gn + n, gns + ns)
        return {k: (n, ns / 1e9) for k, (n, ns) in out.items()}

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return {t.ident: t.name for t in self._threads}


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` records anywhere in the process (the
    module flag torch sets while any profiler records) or on this
    thread."""
    import torch
    import torch.autograd.profiler as ap
    return bool(getattr(ap, "_is_profiler_enabled", False)) or \
        torch.autograd._profiler_enabled()


class Capture:
    """One ``profile()`` capture.  The caller's thread starts and stops
    the profiler (a profiler stops on the thread that started it, and
    stopping takes seconds); :meth:`service` runs on the engine thread
    under its step lock: it opens the rings and places the anchors."""

    ANCHOR = "serving.anchor"

    def __init__(self, shards, seconds: float):
        self.shards = shards
        self.seconds = float(seconds)
        self.device = shards[0].device
        self.opened = False
        # set once the engine has closed the rings (or cannot)
        self.closed = threading.Event()
        self.error: Optional[BaseException] = None
        self.prof = None
        self.engine_ident: Optional[int] = None
        self.t_open = self.t_close = 0
        self.t_due = 0.0
        # (h0, h1) host stamps around each anchor launch, in order
        self.anchors: List[Tuple[int, int]] = []
        self.stop_s = 0.0
        self.beats_in_stop = 0
        self.events = ()
        self.rings: List[list] = []
        self.names: Dict[int, str] = {}
        # the shards' work counters at the anchors
        self.work: List[Dict[str, int]] = []

    # ------------------------------------------------------ caller thread
    def begin(self) -> None:
        """Start the profiler: CUDA activity on the card (CUPTI records
        every thread's runtime calls), else every thread's CPU
        operations."""
        from torch.profiler import ProfilerActivity, profile
        if profiler_active():
            raise RuntimeError("another profiler is recording; "
                               "profile() needs the profiler to itself")
        if self.device.type == "cuda":
            self.prof = profile(activities=[ProfilerActivity.CUDA])
        else:
            from torch._C._profiler import _ExperimentalConfig
            self.prof = profile(
                activities=[ProfilerActivity.CPU],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
        self.prof.start()

    def end(self) -> None:
        """Stop the profiler once the engine has closed the capture, and
        take its events.  Both keep the GIL while torch gathers the
        events, so the engines step only where it lets go
        (``beats_in_stop``)."""
        beat = self.shards[0].beat
        t0 = _now()
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()
        self.stop_s = (_now() - t0) / 1e9
        self.beats_in_stop = self.shards[0].beat - beat

    # ------------------------------------------------------ engine thread
    def service(self) -> Optional["Capture"]:
        """Open the capture, or close it once its seconds are up; returns
        itself while it stays open, ``None`` once it is closed.  A failure
        is kept for the caller and never reaches the engine loop."""
        try:
            if not self.opened:
                self._open()
                return self
            if time.perf_counter() < self.t_due:
                return self
            self._close()
        except Exception as exc:  # noqa: BLE001 — the engine keeps serving
            self.fail(exc)
        self.closed.set()
        return None

    def _anchor(self) -> None:
        import torch
        cuda = self.device.type == "cuda"
        for _ in range(ANCHOR_LAUNCHES):
            h0 = _now()
            with torch.profiler.record_function(self.ANCHOR):
                if cuda:
                    torch.cuda._sleep(1)
            self.anchors.append((h0, _now()))

    def _work(self) -> None:
        self.work.append({k: sum(getattr(s, k) for s in self.shards)
                          for k in WORK})

    def _open(self) -> None:
        self.opened = True
        self.engine_ident = threading.get_ident()
        for shard in self.shards:
            shard.spans.ring = deque(maxlen=RING_SPANS)
        self.t_open = _now()
        self._work()
        self._anchor()
        self.t_due = time.perf_counter() + self.seconds

    def _close(self) -> None:
        self._anchor()
        self.t_close = _now()
        if self.device.type == "cuda":
            # the anchors run before the caller stops the profiler
            import torch
            torch.cuda.synchronize(self.device)
        self._work()
        self._take_rings()

    def _take_rings(self) -> None:
        for shard in self.shards:
            ring, shard.spans.ring = shard.spans.ring, None
            self.rings.append(list(ring or ()))
            self.names.update(shard.spans.thread_names())

    def fail(self, exc: BaseException) -> None:
        """End the capture with ``exc`` (it failed, or its engine
        stopped); the caller still stops the profiler."""
        self.error = exc
        if not self.rings:
            self._take_rings()
        self.closed.set()

    def reduce(self, path) -> dict:
        """Shift the profiler's events onto the host clock, write the
        Chrome trace to ``path`` and return the summary."""
        from torch.autograd import DeviceType
        evs = self.events
        cuda = self.device.type == "cuda"
        dev, host = [], []
        for e in evs:
            a = e.start_ns()
            row = (e.name(), a, a + e.duration_ns(), e.start_thread_id(),
                   e.correlation_id())
            on_device = cuda and e.device_type() == DeviceType.CUDA
            (dev if on_device else host).append(row)
        found = _anchor_events(dev, host, cuda, self.ANCHOR)
        if len(found) != len(self.anchors):
            spin = sum(1 for r in dev if "spin_kernel" in r[0])
            raise RuntimeError(
                f"found {len(found)} of the capture's {len(self.anchors)} "
                f"anchor launches in the profiler's events ({spin} anchor "
                f"kernels among {len(dev)} device and {len(host)} host "
                f"events)")
        k = ANCHOR_LAUNCHES
        marks, hst, width = [], [], []
        for lo in (0, len(found) - k):
            i = min(range(lo, lo + k),
                    key=lambda j: self.anchors[j][1] - self.anchors[j][0])
            h0, h1 = self.anchors[i]
            marks.append(found[i])
            hst.append((h0 + h1) // 2)
            width.append(h1 - h0)
        kin = [(m[1] + m[2]) // 2 for m in marks]
        offsets = [a - h for a, h in zip(kin, hst)]
        # the profiler's clock onto the host's: exact at both anchors,
        # linear between them (any drift spread evenly)
        rate = (hst[1] - hst[0]) / (kin[1] - kin[0])

        def shift(t):
            return hst[0] + round((t - kin[0]) * rate)

        kin_engine = marks[0][3]
        anchor_ids = {m[4] for m in found}
        spans = [s for ring in self.rings for s in ring
                 if s[1] >= self.t_open and s[2] <= self.t_close]
        engine = [(a, b, n) for n, a, b, tid, *_ in spans
                  if tid == self.engine_ident]
        win_a = self.anchors[k - 1][1]
        win_b = self.anchors[-k][0]
        kernels = [(shift(a), shift(b), n) for n, a, b, *_ in dev]
        busy, gaps = _busy_gaps(kernels, win_a, win_b)
        segments = _innermost(engine)
        idle = _overlap_by_name(gaps, segments)
        own: Dict[str, int] = defaultdict(int)
        for a, b, name in segments:
            own[name] += b - a
        steps = _innermost([s for s in engine if s[2].startswith("step.")])
        # the engine thread's runtime calls between the anchors: kernel
        # launches, and the calls that wait for the device
        calls = [(n, t) for n, t, c in (
            (n, shift((a + b) // 2), c) for n, a, b, tid, c in host
            if cuda and tid == kin_engine and c not in anchor_ids)
            if win_a <= t < win_b]
        launches = [t for n, t in calls if "LaunchKernel" in n]
        syncs = [t for n, t in calls
                 if "Synchronize" in n or n == "cudaMemcpy"]
        in_step = _names_at(launches, steps)
        _write_trace(path, spans, kernels, [
            (n, shift(a), shift(b), tid) for n, a, b, tid, _ in host],
            kin_engine, self.engine_ident, self.names)
        window = (win_b - win_a) / 1e9
        w0, w1 = self.work
        work = {k: w1[k] - w0[k] for k in WORK}
        n_decode = sum(1 for s in spans if s[0] == "decode.launch")
        return {
            "path": str(path),
            "window": [self.t_open / 1e9, self.t_close / 1e9],
            "window_s": window,
            "busy_s": busy / 1e9,
            "busy_share": busy / 1e9 / window if window > 0 else 0.0,
            "idle_share": 1.0 - busy / 1e9 / window if window > 0 else 0.0,
            "idle_by_span": {k: v / 1e9 for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])},
            "self_by_span": {k: v / 1e9 for k, v in sorted(
                own.items(), key=lambda kv: -kv[1])},
            "anchor_offsets_ns": offsets,
            "anchor_brackets_ns": width,
            "drift_ns": offsets[1] - offsets[0],
            "stop_s": self.stop_s,
            "beats_in_stop": self.beats_in_stop,
            "spans": len(spans),
            "steps": len(steps),
            "launches": len(launches),
            "launches_in_step": (1.0 - in_step.get(OUTSIDE, 0)
                                 / len(launches) if launches else None),
            "syncs_by_span": _names_at(syncs, segments),
            # the load the capture saw: decode calls, their occupied rows
            # and summed context lengths, prompt tokens computed
            "decode_calls": n_decode,
            **work,
            "rows_per_decode": (work["decode_rows"] / n_decode
                                if n_decode else None),
            "context_per_row": (work["decode_kv_tokens"] /
                                work["decode_rows"]
                                if work["decode_rows"] else None),
        }


def _anchor_events(dev, host, cuda: bool, name: str):
    """The anchor launches as host-side events, in time order: the user
    annotation where the profiler records the CPU, else the call that
    launched each anchor kernel (``spin_kernel``): of the host events
    that share the kernel's correlation id, the earliest launch call."""
    if not cuda:
        return sorted(r for r in host if r[0] == name)
    ids = {r[4] for r in dev if "spin_kernel" in r[0] and r[4]}
    first = {}
    for r in host:
        if r[4] in ids and "LaunchKernel" in r[0] and \
                (r[4] not in first or r[1] < first[r[4]][1]):
            first[r[4]] = r
    return sorted(first.values(), key=lambda r: r[1])


def _busy_gaps(intervals, a: int, b: int):
    """Union length of ``intervals`` (start, end, _) clipped to [a, b),
    and the gaps of [a, b) they leave."""
    busy, end, gaps = 0, a, []
    for s, e, _ in sorted(intervals):
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if b > end:
        gaps.append((end, b))
    return busy, gaps


def _innermost(spans):
    """Properly nested spans (start, end, name) of one thread → disjoint
    segments (start, end, name) of the innermost span open in each."""
    out, stack, cur = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, nm = stack.pop()
            if end > cur:
                out.append((cur, end, nm))
                cur = end
        if stack and a > cur:
            out.append((cur, a, stack[-1][1]))
        cur = a
        stack.append((b, name))
    while stack:
        end, nm = stack.pop()
        if end > cur:
            out.append((cur, end, nm))
            cur = end
    return out


def _overlap_by_name(gaps, segments) -> Dict[str, int]:
    """Nanoseconds of ``gaps`` under each segment's name; what no segment
    covers goes to ``(no span)``."""
    out: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] += d
                covered += d
            k += 1
        if b - a > covered:
            out[OUTSIDE] += b - a - covered
    return dict(out)


def _names_at(points, segments) -> Dict[str, int]:
    """How many of ``points`` lie inside each name's disjoint
    ``segments``; those in none count under ``(no span)``."""
    import bisect
    starts = [s for s, _, _ in segments]
    out: Dict[str, int] = defaultdict(int)
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        out[segments[i][2] if i >= 0 and p < segments[i][1]
            else OUTSIDE] += 1
    return dict(out)


def _write_trace(path, spans, kernels, host, kin_engine, engine_ident,
                 names) -> None:
    """One Chrome trace on the host clock (microseconds of
    ``perf_counter``): the device's kernels, the profiler's host events
    (the engine thread's on the engine's row) and the program's spans on
    their threads' rows; request spans on one row a request."""
    ev = []

    def x(name, a, b, pid, tid, args=None):
        d = {"name": name, "ph": "X", "ts": a / 1e3, "dur": (b - a) / 1e3,
             "pid": pid, "tid": tid}
        if args:
            d["args"] = args
        ev.append(d)

    for a, b, n in kernels:
        x(n, a, b, "device", "kernels")
    engine_row = names.get(engine_ident, "engine")
    for n, a, b, tid in host:
        x(n, a, b, "host", engine_row if tid == kin_engine
          else f"profiler thread {tid}")
    for n, a, b, tid, parent, req, step in spans:
        args = {k: v for k, v in (("parent", parent), ("req", req),
                                  ("step", step)) if v is not None}
        if tid is None:
            x(n, a, b, "requests", f"request {req}", args)
        else:
            x(n, a, b, "host", names.get(tid, f"thread {tid}"), args)
    # one string from the C encoder: json.dump's streaming encoder runs
    # in Python, many times slower, and starves the engine of the GIL
    text = json.dumps({"traceEvents": ev, "displayTimeUnit": "ms"})
    with open(path, "w") as f:
        f.write(text)
