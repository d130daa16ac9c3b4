"""The traced run's slice: a ``torch.profiler`` trace of a steady stretch
of the window, and the engine's counters at the slice's two ends.

The counters (``session.stats()["totals"]``) say how much work the slice
held: ``decode_rows`` and ``decode_kv_tokens`` count each decode call's
occupied rows and their context lengths, whatever kernel the call's
attention runs.  From the trace it takes every kernel's interval (device
busy time, time by kernel); a sampler of the engine thread's stack says
what the host was doing while the device idled.
"""

from __future__ import annotations

import bisect
import os
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import hb_spans


@dataclass
class Slice:
    """What the traced stretch measured."""

    t_a: float = 0.0
    t_b: float = 0.0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: List[Tuple[str, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    stats_a: Optional[dict] = None
    stats_b: Optional[dict] = None

    def kernel_s(self, pattern) -> float:
        """Device seconds of the kernels whose names match ``pattern``."""
        return sum(s for n, s in self.kernels if pattern.search(n))


def _profiler(**kw):
    """A device-only profiler: kernel intervals from CUPTI (on a machine
    with no card, the calling thread's CPU operations, so that the CPU
    tests run the same path).  The host's side comes from
    :class:`HostSampler` instead of the profiler's CPU activity, whose
    callbacks cannot be switched on for another thread's operations
    safely while that thread runs them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    return profile(activities=[act], **kw)


class HostSampler:
    """What the engine's thread is doing, sampled every ``every_s``
    seconds from a thread of its own: the innermost frame of the port's
    code (``file:function``) on the engine thread's stack."""

    def __init__(self, every_s: float = 0.002):
        self.every_s = every_s
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _engine_ident() -> Optional[int]:
        for t in threading.enumerate():
            if t.name.endswith("-engine"):
                return t.ident
        return None

    def start(self) -> None:
        ident = self._engine_ident()
        if ident is None:
            return

        def loop():
            while not self._stop.wait(self.every_s):
                frame = sys._current_frames().get(ident)
                key = "engine thread gone"
                while frame is not None:
                    code = frame.f_code
                    if "repro_torch" in code.co_filename:
                        key = (f"{os.path.basename(code.co_filename)}:"
                               f"{code.co_name}")
                        break
                    frame = frame.f_back
                self.samples.append((time.perf_counter(), key))

        self._thread = threading.Thread(target=loop, name="host-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


PARK_WAIT_S = 30.0   # longer than any step; past it the slice is cut anyway


class _Park:
    """Handed to a shard as its capture (the hook ``profile()`` uses): the
    engine thread services it at the start of its next step, under its
    step lock, and waits there until ``go`` is set.  The hook is set
    without the step lock, which a busy engine takes again before a
    waiting thread can."""

    def __init__(self):
        self.parked = threading.Event()
        self.go = threading.Event()

    def service(self):
        self.parked.set()
        self.go.wait(PARK_WAIT_S)
        return None


class Tracer:
    """``prepare`` (in set-up) starts the profiler in its warm-up state,
    where setting up the device tracing costs what it costs outside the
    window; ``open`` (from the client's loop, ``slice_s`` before the
    window's end) starts recording, and the slice closes ``slice_s``
    seconds later, after the window: stopping the profiler blocks its
    caller for seconds.  Both ends fall between two engine steps, where
    the engine's counters are read, so the client waits up to a step at
    each."""

    def __init__(self, session, slice_s: float):
        from torch.profiler import schedule
        self.session = session
        self.slice_s = slice_s
        self.sampler = HostSampler()
        self.prof = _profiler(schedule=schedule(wait=0, warmup=1, active=1,
                                                repeat=1))
        self.t_a = self.t_b = 0.0
        self.costs: Dict[str, float] = {}
        self.slice = Slice()

    def _timed(self, name, fn):
        t = time.perf_counter()
        fn()
        self.costs[name] = time.perf_counter() - t

    def prepare(self) -> None:
        self._timed("prepare", self.prof.start)

    def _between_steps(self, fn) -> None:
        """``fn()`` while every shard's engine waits between two steps.
        A step that makes a decode call waits for the device before it
        ends, so there the counters and the trace cut the work at the same
        step: no decode call is half launched or still running."""
        parks = []
        for shard in self.session.engine.shards:
            if hasattr(shard, "_capture"):
                park = _Park()
                shard._capture = park
                parks.append(park)
        try:
            for park in parks:
                park.parked.wait(PARK_WAIT_S)
            fn()
        finally:
            for park in parks:
                park.go.set()

    def open(self):
        def start():
            self._timed("open", self.prof.step)
            self.slice.stats_a = self.session.stats()["totals"]
            self.t_a = time.perf_counter()

        self._between_steps(start)
        self.sampler.start()
        return self.t_a + self.slice_s, self.close

    def close(self) -> None:
        def end():
            self.t_b = time.perf_counter()
            self.slice.stats_b = self.session.stats()["totals"]

        self._between_steps(end)
        self.sampler.stop()
        self._timed("close", lambda: (self.prof.step(), self.prof.stop()))

    def reduce(self) -> Slice:
        """Read the trace (after the window)."""
        sl = self.slice
        sl.t_a, sl.t_b = self.t_a, self.t_b
        sl.window_s = self.t_b - self.t_a
        from torch.autograd import DeviceType
        dev = [(e.time_range.start, e.time_range.end, e.name)
               for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        if not dev:
            return sl
        # the slice's start in the trace's clock: its first kernel (the
        # engine launches every few milliseconds)
        lo = min(a for a, _, _ in dev)
        hi = lo + sl.window_s * 1e6
        dev = [(a, min(b, hi), n) for a, b, n in dev if a < hi]
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, n in dev:
            by_name[short(n)] += (b - a) / 1e6
        sl.kernels = list(by_name.items())
        sl.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy, gaps, end = 0.0, [], lo
        for a, b, _ in sorted(dev):
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if hi > end:
            gaps.append((end, hi))
        sl.busy_s = busy / 1e6
        samples = [((t - self.t_a) * 1e6 + lo, k)
                   for t, k in self.sampler.samples]
        sl.idle_gaps = _name_gaps(gaps, samples,
                                  2e6 * self.sampler.every_s)
        return sl


def short(name: str) -> str:
    """A kernel's name without its return type and parameter list, cut to
    120 characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i > 0 and \
                not name.startswith("(anonymous namespace)", i):
            name = name[:i]
            break
    return name[:120]


def _name_gaps(gaps, samples, reach: float) -> List[Tuple[str, float]]:
    """Idle device time by what the host sampler saw the engine thread do
    nearest each gap's middle (most gaps are a launch's few microseconds;
    ``host: not sampled`` where no sample lies within ``reach``
    microseconds), largest ten."""
    out: Dict[str, float] = defaultdict(float)
    times = [t for t, _ in samples]
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_left(times, mid)
        near = [j for j in (i - 1, i) if 0 <= j < len(times)]
        j = min(near, key=lambda j: abs(times[j] - mid), default=None)
        key = samples[j][1] if j is not None and \
            abs(times[j] - mid) <= reach + (b - a) / 2 else \
            "host: not sampled"
        out[key] += (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]


def slice_decode_work(sl: Slice):
    """(decode rows, their attended keys) in the slice: the engine's
    ``decode_rows`` and ``decode_kv_tokens`` at the slice's close less at
    its open.  Each decode call adds its occupied rows and their context
    lengths, each counting the row's new token."""
    return (hb_spans.delta(sl, "decode_rows"),
            hb_spans.delta(sl, "decode_kv_tokens"))
