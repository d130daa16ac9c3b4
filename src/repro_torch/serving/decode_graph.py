"""The dense decode call as one CUDA graph, captured once and replayed.

A decode call of a dense stack has one shape for the life of a shard:
``max_batch`` rows (padding rows carry page -1 and write nothing), block
tables of ``max_pages``, a split count fixed per stack, pools allocated
once and written in place.  Its device work (embedding gather, every
decoder block, the final norm and the head) is about 13 launches a block,
each cheap for the card and each issued from Python.  :class:`DecodeGraph`
captures that body once, at the shard's first decode call, over static
device buffers for its seven operands, and replays it on every later
call; every kernel in it stays the hand-written one.

The host operands of a call go into a pinned staging block and reach the
static buffers in one non-blocking copy (:meth:`DecodeGraph.upload`).  A
replay adds to the host counters what the captured Python added: the
stack's block passes and the kernels' launches by variant.

Where a graph serves: :func:`captures` (a stack whose rows can be
captured, on a CUDA device) and :meth:`DecodeGraph.takes` (a call of the
captured row count on that device).  Everything else runs eagerly.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..kernels import fused_block, paged_attention

ALIGN = 16                      # bytes between operands in the blocks
_BLOCKS = ("fused_blocks", "eager_blocks")
# the launch counters of the kernels a dense decode call runs
_LAUNCHES = {"fused_block": fused_block.launches,
             "paged_attention": paged_attention.launches}


def captures(stack, device) -> bool:
    """Whether a decode graph serves ``stack`` on ``device``: the stack
    declares its rows capturable (:class:`~.paged_stack.DenseStack`) and
    the device is a CUDA device."""
    return stack.capturable and torch.device(device).type == "cuda"


@contextlib.contextmanager
def counted(stack):
    """Yield a dict that, once the block has run, holds the host counts
    the calling thread added in it: the stack's block passes and the
    decode kernels' launches, ``"<kernel>:<variant>"``."""
    out: Dict[str, int] = {}
    blocks = {key: getattr(stack, key) for key in _BLOCKS}
    with contextlib.ExitStack() as tallies:
        launched = {name: tallies.enter_context(counter.tally())
                    for name, counter in _LAUNCHES.items()}
        yield out
    for key, n in blocks.items():
        if getattr(stack, key) != n:
            out[key] = getattr(stack, key) - n
    for name, counts in launched.items():
        out.update({f"{name}:{v}": n for v, n in counts.items() if n})


def add_counts(stack, counts: Dict[str, int], sign: int = 1) -> None:
    """Add ``counts`` (as :func:`counted` yields them) times ``sign``."""
    for key, n in counts.items():
        if key in _BLOCKS:
            setattr(stack, key, getattr(stack, key) + sign * n)
        else:
            name, variant = key.split(":", 1)
            _LAUNCHES[name].add(variant, sign * n)


class CudaGraphs:
    """Warm-up, capture and replay through ``torch.cuda.graphs`` on one
    device."""

    # one capture at a time in the process: entering one synchronizes the
    # device, which a capture in flight on another thread does not allow
    _capturing = threading.Lock()

    def __init__(self, device):
        self.device = device
        self.graph = None

    def warm(self, run: Callable) -> None:
        """One eager call on a side stream, as capture needs (it also sets
        the kernels' attributes that their launchers set)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            run()
        cur.wait_stream(side)

    def capture(self, run: Callable) -> Tuple[torch.Tensor, int]:
        """Capture one call on a stream of this device's own → (its output,
        the bytes the graph's private pool took).  Capture errors are the
        capturing thread's alone: another shard's engine thread may
        allocate on the same card meanwhile."""
        self.graph = torch.cuda.CUDAGraph()
        with self._capturing, torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(self.device),
                capture_error_mode="thread_local"):
            # after the context's own empty_cache: the pool's growth only
            reserved = torch.cuda.memory_reserved(self.device)
            out = run()
        return out, torch.cuda.memory_reserved(self.device) - reserved

    def replay(self) -> None:
        self.graph.replay()


class DecodeGraph:
    """``fn(*operands)`` captured at its first call over static device
    buffers and replayed on every call.

    ``operands``: each operand's (shape, dtype), in ``fn``'s order; the
    first dimension of the first is the row count a call must have.
    ``graphs`` captures and replays (:class:`CudaGraphs` on ``device``
    unless given).  The result is the graph's static output: the next call
    overwrites it."""

    def __init__(self, stack, fn: Callable,
                 operands: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 device, graphs=None):
        self.stack = stack
        self.fn = fn
        self.device = torch.device(device)
        self.rows = operands[0][0][0]
        self.graphs = graphs if graphs is not None else \
            CudaGraphs(self.device)
        spans, size = [], 0
        for shape, dtype in operands:
            nbytes = math.prod(shape) * dtype.itemsize
            spans.append((size, nbytes, shape, dtype))
            size += -(-nbytes // ALIGN) * ALIGN
        self.block = torch.empty(size, dtype=torch.uint8, device=self.device)
        self.static = tuple(self.block[o:o + n].view(dt).view(shape)
                            for o, n, shape, dt in spans)
        # two pinned staging blocks, taken in turn: a block is rewritten
        # only once the copy that last read it has run
        pin = self.device.type == "cuda"
        self._host = [torch.empty(size, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(2)]
        self._host_views = [
            tuple(h.numpy()[o:o + n].view(
                torch.empty((), dtype=dt).numpy().dtype).reshape(shape)
                for o, n, shape, dt in spans)
            for h in self._host]
        self._copied = [None, None]
        self._turn = 0
        self.out = None
        self.delta: Dict[str, int] = {}
        self.pool_bytes = 0

    def takes(self, first: torch.Tensor) -> bool:
        """Whether a call whose first operand is ``first`` replays the
        graph: on its device, with the captured row count."""
        return first.device == self.device and first.shape[0] == self.rows

    def upload(self, arrays) -> Tuple[torch.Tensor, ...]:
        """Host arrays of the operands → the static buffers, through one
        pinned block and one non-blocking copy on the current stream."""
        i, self._turn = self._turn, self._turn ^ 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        for view, a in zip(self._host_views[i], arrays):
            view[...] = a
        self.block.copy_(self._host[i], non_blocking=True)
        if self.device.type == "cuda":
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record()
        return self.static

    def __call__(self, *operands) -> torch.Tensor:
        for buf, t in zip(self.static, operands):
            if t is not buf:
                buf.copy_(t)
        if self.out is None:
            self._capture()
        self.graphs.replay()
        add_counts(self.stack, self.delta)
        return self.out

    def _capture(self) -> None:
        """Warm up, capture, and leave the counts as they were: the
        capture's own counts become the delta each replay adds."""
        def run():
            return self.fn(*self.static)
        with counted(self.stack) as warmed:
            self.graphs.warm(run)
        with counted(self.stack) as self.delta:
            self.out, self.pool_bytes = self.graphs.capture(run)
        add_counts(self.stack, warmed, -1)
        add_counts(self.stack, self.delta, -1)
