"""Fault-tolerance runtime for the train loop.

* **HeartbeatRegistry** — cluster membership as a *SCOT Harris list* (the
  paper's structure as framework infrastructure): health-checker threads do
  read-only optimistic scans; join/leave churn retires descriptor nodes
  through a robust SMR scheme, so a wedged health-checker can't leak
  descriptors (property A at the control plane).
* **StragglerWatchdog** — per-step deadline tracking; steps exceeding
  ``factor × EMA`` are flagged (on real fleets: trigger backup-pod dispatch
  or re-scheduling; here: counted + surfaced in stats).
* **retrying_step** — transient-failure wrapper with bounded retries (the
  injectable-failure tests use it).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .. import api
from ..core.atomics import AtomicInt


class HeartbeatRegistry:
    """node_id → last-heartbeat, on a SCOT list under a robust scheme."""

    def __init__(self, smr_name: str = "IBR", stale_after_s: float = 5.0):
        self.members = api.build(
            "HList", smr=smr_name,
            smr_kwargs={"retire_scan_freq": 16, "epoch_freq": 16})
        self.smr = self.members.smr
        self.stale_after_s = stale_after_s
        self._beats: Dict[int, float] = {}
        self._lock = threading.Lock()

    def join(self, node_id: int) -> bool:
        with self._lock:
            self._beats[node_id] = time.monotonic()
        return self.members.insert(node_id)

    def leave(self, node_id: int) -> bool:
        with self._lock:
            self._beats.pop(node_id, None)
        return self.members.delete(node_id)

    def heartbeat(self, node_id: int) -> None:
        with self._lock:
            self._beats[node_id] = time.monotonic()

    def alive(self, node_id: int) -> bool:
        return self.members.search(node_id)  # optimistic read-only

    def reap_stale(self) -> int:
        """Health-checker pass: evict members whose heartbeat lapsed."""
        now = time.monotonic()
        with self._lock:
            stale = [n for n, t in self._beats.items()
                     if now - t > self.stale_after_s]
        n = 0
        for node_id in stale:
            if self.leave(node_id):
                n += 1
        return n

    def snapshot(self):
        return self.members.snapshot()


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, ema: float = 0.9):
        self.factor = factor
        self.ema_coef = ema
        self.ema: Optional[float] = None
        self.n_stragglers = AtomicInt(0)
        self.n_steps = AtomicInt(0)

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step counts as a straggler."""
        self.n_steps.fetch_add(1)
        if self.ema is None:
            self.ema = step_time_s
            return False
        straggler = step_time_s > self.factor * self.ema
        if straggler:
            self.n_stragglers.fetch_add(1)
        else:  # stragglers don't poison the EMA
            self.ema = self.ema_coef * self.ema + \
                (1 - self.ema_coef) * step_time_s
        return straggler

    def stats(self):
        return {"steps": self.n_steps.load(),
                "stragglers": self.n_stragglers.load(),
                "ema_s": self.ema}


class TransientFailure(RuntimeError):
    """A retryable step failure (preemption signal, link flap, …)."""


def retrying_step(fn: Callable, max_retries: int = 3,
                  backoff_s: float = 0.0, on_retry: Optional[Callable] = None):
    def wrapped(*args, **kwargs):
        last = None
        for attempt in range(max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except TransientFailure as e:
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
                if backoff_s:
                    time.sleep(backoff_s * (2 ** attempt))
        raise last
    return wrapped
