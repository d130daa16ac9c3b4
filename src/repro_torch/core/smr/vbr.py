"""VBR — version-based reclamation (Sheffi, Herlihy & Petrank,
arXiv:2107.13843), adapted to this repo's uniform SMR surface.

VBR's idea: a global *version clock*, a per-object *birth version* stamped
at allocation, and a per-operation *checkpoint* of the clock.  Reads are
optimistic — a reader compares the clock against its checkpoint and, on a
version mismatch, **rolls back** to a consistent point and re-reads,
instead of ever blocking reclamation.

The adaptation (DESIGN.md §16): real VBR lets readers touch *reclaimed*
memory and detect staleness afterwards by version comparison.  This repo's
poisoning shim makes any access to freed memory a hard
:class:`UseAfterFreeError` — deliberately, so ABA/UAF bugs are physically
exercisable — which rules out the read-then-validate-recycled-memory form.
VBR here therefore keeps the version machinery on top of an interval
*reservation* substrate (the same [lower, upper] publication IBR uses, so
"protected ⇒ not freed" still holds for the shim), and expresses the VBR
protocol in the parts that remain meaningful:

* **version clock** — the scheme-global ``era`` counter, advanced on an
  amortized retire tick (``epoch_freq``);
* **per-object versions** — ``birth_era`` stamped by ``alloc_stamp`` and
  ``retire_era`` stamped at retire; a retired object is reclaimable once
  its [birth, retire] version range precedes every active checkpoint;
* **checkpoint / rollback** — ``begin_op`` checkpoints the clock; the
  protect fast path is a *single version compare* against the checkpoint
  (no re-read loop, no closure call — cheaper than IBR's ``_bump``).  On a
  mismatch the operation rolls its checkpoint forward (publish the new
  version, re-read, verify the clock is unchanged) and counts the event in
  ``n_rollbacks``;
* **eager reclamation** — VBR reclaims immediately in the original; here
  the retire-scan countdown defaults to half the base frequency so freed
  versions return to the allocator measurably sooner (visible as a lower
  ``not_yet_reclaimed`` in the fig. 10/11 family).

Capabilities: robust (a stalled thread's frozen checkpoint pins only
objects born before it), cumulative (rolling forward never cancels an
earlier reservation, so SCOT's ring-buffer recovery applies), and legal
for all batch hints — declared as class attributes and read by the
``repro.api`` registry, so the negotiation matrix, snapshot tests and
bench sweeps extend without per-call-site edits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .ibr import IBR
from ..atomics import (
    AtomicFlaggedRef,
    AtomicInt,
    AtomicMarkableRef,
    AtomicRef,
    SmrNode,
)


class VBR(IBR):
    """Version-based reclamation on the shared interval substrate.

    Subclasses :class:`IBR` for the reservation bookkeeping (begin/end
    checkpoint publication, stamped retires, the bisect overlap scan) and
    replaces the per-read protocol: IBR re-checks the clock *after* every
    read inside a loop closure; VBR compares the checkpoint *before* the
    read and only on mismatch enters the rollback slow path.
    """

    name = "VBR"
    robust = True
    cumulative_protection = True
    batch_hints = "all"

    def __init__(
        self,
        num_slots: int = 8,
        retire_scan_freq: int = 64,    # eager: half the base default
        epoch_freq: int = 96,
        free_fn: Optional[Callable[[SmrNode], None]] = None,
    ):
        super().__init__(num_slots=num_slots,
                         retire_scan_freq=retire_scan_freq,
                         epoch_freq=epoch_freq, free_fn=free_fn)
        self.n_rollbacks = AtomicInt(0)

    # ------------------------------------------------------------- protect
    # Fast path: one version compare, zero extra reads.  ``c.upper`` is the
    # thread's published checkpoint; if the clock has not advanced past it,
    # the read is already covered (monotonic clock: any object reachable
    # through the read was born at a version <= upper, and any later retire
    # stamps a version >= lower).  The direct ``_value`` / ``_word``
    # accesses are the same unlocked reads load()/get() perform, minus the
    # calls — on a long traversal protect IS the op, and the budget for the
    # version compare comes out of the dispatch EBR pays per read.

    def _reserve_markable(self, c, src: AtomicMarkableRef, idx: int):
        w = src._word
        if self.era._value == c.upper:
            return w
        return self._rollback(c, src.get)

    def _reserve_plain(self, c, src: AtomicRef, idx: int):
        w = src._value
        if self.era._value == c.upper:
            return w
        return self._rollback(c, src.load)

    def _reserve_flagged(self, c, src: AtomicFlaggedRef, idx: int):
        w = src._word
        if self.era._value == c.upper:
            return w
        return self._rollback(c, src.get)

    def _rollback(self, c, read):
        """Checkpoint roll-forward: publish the current version as the new
        checkpoint, re-read, and verify the clock did not advance across
        the read (publish-then-read-then-verify, so the returned word is
        covered by the published reservation).  Each iteration is one
        rollback event."""
        n = 0
        era = self.era
        while True:
            e = era.load()
            c.upper = e           # roll the checkpoint forward (publish)
            c.n_barriers += 1
            n += 1
            value = read()
            if era._value == e:   # clock unchanged across the read: covered
                self.n_rollbacks.fetch_add(n)
                return value

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        s = super().stats()
        s["rollbacks"] = self.n_rollbacks.load()
        return s
