"""The traced run's slice: a ``torch.profiler`` trace of a steady stretch
of the window, and a record of the paged attention calls made in it.

The recorder wraps the paged attention entry point of the port's kernel
API (``repro_torch.kernels.ops.paged_attention``) and keeps, for each
call made while the slice is open, the tensors that say how much work the
call had: context lengths and occupancy.  It keeps references only, so
it adds no device sync;
they are read after the slice closes.  From the trace it takes every
kernel's interval (device busy time, time by kernel); a sampler of the
engine thread's stack says what the host was doing while the device
idled.
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

import hb_roofline


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
    paged: List[Tuple[list, int]] = field(default_factory=list)
    stats_a: Optional[dict] = None
    stats_b: Optional[dict] = None

    def kernel_s(self, pattern) -> float:
        """Device seconds of the kernels whose names match ``pattern``."""
        return sum(s for n, s in self.kernels if pattern.search(n))


class Recorder:
    """Wraps the port's paged attention entry point while installed."""

    def __init__(self):
        self.on = False
        self.paged_calls: list = []
        self._orig = None

    def install(self) -> None:
        from repro_torch.kernels import ops
        paged = ops.paged_attention
        self._orig = (ops, paged)

        def paged_rec(q, k_pages, v_pages, block_tables, ctx_lens, *a, **kw):
            if self.on:
                self.paged_calls.append((ctx_lens, kw.get("occupancy"),
                                         k_pages.element_size()))
            return paged(q, k_pages, v_pages, block_tables, ctx_lens, *a,
                         **kw)

        ops.paged_attention = paged_rec

    def uninstall(self) -> None:
        if self._orig is not None:
            ops, paged = self._orig
            ops.paged_attention = paged
            self._orig = None

    def calls(self):
        """The paged calls in host form: [(ctx of occupied rows, bytes an
        element)]."""
        paged = []
        for ctx, occ, elt in self.paged_calls:
            c = ctx.cpu().tolist()
            o = occ.cpu().tolist() if occ is not None else [True] * len(c)
            paged.append(([x for x, k in zip(c, o) if k], elt))
        return paged


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


class Tracer:
    """``prepare`` (in set-up) starts the profiler in its warm-up state,
    where setting up the device tracing costs what it costs outside the
    window; ``open`` (from the client's loop, ``slice_s`` before the
    window's end) starts recording, and the slice closes ``slice_s``
    seconds later, after the window: stopping the profiler blocks its
    caller for seconds."""

    def __init__(self, session, slice_s: float):
        from torch.profiler import schedule
        self.session = session
        self.slice_s = slice_s
        self.recorder = Recorder()
        self.recorder.install()
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

    def open(self):
        self.slice.stats_a = self.session.stats()["totals"]
        self._timed("open", self.prof.step)
        self.recorder.on = True
        self.sampler.start()
        self.t_a = time.perf_counter()
        return self.t_a + self.slice_s, self.close

    def close(self) -> None:
        self.t_b = time.perf_counter()
        self.recorder.on = False
        self.sampler.stop()
        self._timed("close", lambda: (self.prof.step(), self.prof.stop()))
        self.slice.stats_b = self.session.stats()["totals"]

    def reduce(self) -> Slice:
        """Read the trace and the recorded calls (after the window)."""
        self.recorder.uninstall()
        sl = self.slice
        sl.t_a, sl.t_b = self.t_a, self.t_b
        sl.window_s = self.t_b - self.t_a
        sl.paged = self.recorder.calls()
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


def slice_decode_work(sl: Slice, cfg: dict):
    """(decode tokens, their attended keys) of the slice's recorded paged
    calls, per layer: the first layer's calls stand for the step (every
    layer makes the same call)."""
    L = cfg["num_hidden_layers"]
    paged = sl.paged[::L] if L else []
    return sum(len(c) for c, _ in paged), sum(sum(c) for c, _ in paged)


def paged_bytes_ops(sl: Slice, cfg: dict):
    """Summed (bytes, operations) of the slice's paged calls."""
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    nb = fl = 0.0
    for ctx, elt in sl.paged:
        b, f = hb_roofline.paged_call(ctx, h, hkv, hd, elt)
        nb, fl = nb + b, fl + f
    return nb, fl
