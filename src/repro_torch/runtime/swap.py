"""Host-memory swap arena for the KV block pool (DESIGN.md §15).

The paper's robustness property is what makes oversubscription *sizable*:
under HP/HE/IBR/Hyaline a stalled reader pins only O(K) pages, so the
engine knows how many device pages are reclaimable-in-principle and can
spill the rest to host memory.  This module is the host tier: a
:class:`SwapArena` holds preallocated ("pinned" in the TPU sense:
device-transfer staging memory allocated once, never grown or moved —
on the CPU backend plain preallocated numpy) per-page staging buffers, a
slot free-list, and per-sequence :class:`SwapManifest`\\ s with content
checksums.

Ordering contract (the mirror image of migration's import-before-export
handoff): the engine copies a preempted sequence's K/V pages device→host
and records the manifest **before** ``BlockPool.release`` retires the
device pages — at no instant does neither tier hold the bytes.  On
resume the inverse holds: the host→device copy completes before
:meth:`SwapArena.release` returns the slots to the free list.

The arena is engine-thread-owned in the serving stack (preempt and
resume both happen under the shard's step lock), but the manifest table
takes the arena lock anyway — the watchdog discards manifests of
requests it migrates away, and stats() may be read from any thread.
Slot allocation itself goes through the same negotiated free-list
engine as the device pool (``scheme=`` mirrors
``ServingConfig.pool_scheme``): under a reclaiming SMR scheme the
alloc/free path is lock-free, and the free list's state table turns a
double-release or slot-accounting bug into an immediate ``ValueError``
instead of silent slot aliasing.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .block_pool import _make_free_list
from .free_list import FreeListEmpty

__all__ = [
    "SwapArena",
    "SwapManifest",
    "SwapArenaFullError",
    "SwapChecksumError",
    "page_nbytes",
]


def page_nbytes(n_layers: int, page_size: int, n_kv_heads: int,
                head_dim: int, dtype="float32") -> int:
    """Host bytes one KV page occupies in the arena (K and V planes)."""
    return 2 * n_layers * page_size * n_kv_heads * head_dim * \
        np.dtype(dtype).itemsize


class SwapArenaFullError(RuntimeError):
    """No free slots: the engine keeps the victim resident instead."""


class SwapChecksumError(RuntimeError):
    """A swapped page's bytes changed between store and load — host
    memory corruption or a slot-accounting bug; resuming would silently
    decode from the wrong KV."""


@dataclass
class SwapManifest:
    """One preempted sequence's claim on arena slots.

    ``n_tokens`` positions of K/V (page-aligned) live in ``slots`` (one
    slot per page, in sequence order); ``checksums[i]`` is the CRC-32 of
    slot ``slots[i]``'s K and V planes at store time, validated on load.
    """

    seq_key: int                        # Request.req_id
    n_tokens: int                       # page-aligned positions covered
    slots: List[int] = field(default_factory=list)
    checksums: List[int] = field(default_factory=list)

    @property
    def n_pages(self) -> int:
        return len(self.slots)


class SwapArena:
    """Slot-granular host staging arena: one slot holds one KV page
    (both K and V planes, all layers)."""

    def __init__(self, swap_bytes: int, *, n_layers: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype="float32",
                 scheme: str = "locked"):
        self.page_size = page_size
        self.slot_nbytes = page_nbytes(n_layers, page_size, n_kv_heads,
                                       head_dim, dtype)
        self.num_slots = int(swap_bytes // self.slot_nbytes)
        if self.num_slots < 1:
            raise ValueError(
                f"swap_bytes={swap_bytes} holds no page: one page needs "
                f"{self.slot_nbytes} bytes "
                f"(2 * {n_layers} layers * {page_size} * {n_kv_heads} * "
                f"{head_dim} * {np.dtype(dtype).itemsize}B)")
        shape = (self.num_slots, n_layers, page_size, n_kv_heads, head_dim)
        # staging buffers: allocated ONCE at construction (never grown or
        # reshaped), so device transfers always stage through stable host
        # memory — the numpy stand-in for pinned host allocations
        self._k = np.zeros(shape, np.dtype(dtype))
        self._v = np.zeros(shape, np.dtype(dtype))
        # slot allocator: the same negotiated free-list engine as the
        # device pool — "locked" keeps a mutex list, any reclaims=True
        # SMR scheme name gives lock-free alloc/free with a per-slot
        # state table that hard-fails double-release
        self._free = _make_free_list(self.num_slots, scheme)
        self.scheme = self._free.kind
        self._manifests: Dict[int, SwapManifest] = {}
        self._lock = threading.Lock()      # manifest table only
        # counters (stats())
        self.n_swapped_out = 0          # pages stored, cumulative
        self.n_swapped_in = 0           # pages loaded back, cumulative
        self.n_checksum_failures = 0

    # ------------------------------------------------------------- store
    @staticmethod
    def _crc(k_page: np.ndarray, v_page: np.ndarray) -> int:
        return zlib.crc32(v_page.tobytes(), zlib.crc32(k_page.tobytes()))

    def store(self, seq_key: int, k_pages: np.ndarray, v_pages: np.ndarray,
              n_tokens: int) -> SwapManifest:
        """Copy one sequence's pages into arena slots and record its
        manifest.  ``k_pages``/``v_pages``: ``(n_pages, L, page_size, kv,
        dh)`` host arrays in sequence order; ``n_tokens`` the page-aligned
        position count they cover.  All-or-nothing: raises
        :class:`SwapArenaFullError` without storing anything when fewer
        than ``n_pages`` slots are free — the caller then keeps the victim
        resident (preempting without the copy would lose the bytes)."""
        n_pages = int(k_pages.shape[0])
        if n_tokens > n_pages * self.page_size or \
                n_tokens % self.page_size:
            raise ValueError(f"n_tokens={n_tokens} is not a page-aligned "
                             f"fit for {n_pages} pages of "
                             f"{self.page_size} tokens")
        with self._lock:
            if seq_key in self._manifests:
                raise ValueError(f"sequence {seq_key} already has a "
                                 f"manifest (resume must load or discard "
                                 f"it first)")
        # slot claims go through the free list (lock-free under an SMR
        # scheme); all-or-nothing is kept by rolling back partial claims
        slots: List[int] = []
        try:
            for _ in range(n_pages):
                slots.append(self._free.alloc())
        except FreeListEmpty:
            for slot in slots:
                self._free.free(slot)
            raise SwapArenaFullError(
                f"arena full: {n_pages} slots needed, "
                f"{self._free.free_count()}/{self.num_slots} free") \
                from None
        man = SwapManifest(seq_key=seq_key, n_tokens=n_tokens,
                           slots=slots)
        with self._lock:
            if seq_key in self._manifests:
                for slot in slots:
                    self._free.free(slot)
                raise ValueError(f"sequence {seq_key} already has a "
                                 f"manifest (resume must load or discard "
                                 f"it first)")
            self._manifests[seq_key] = man
        for i, slot in enumerate(slots):
            self._k[slot] = k_pages[i]
            self._v[slot] = v_pages[i]
            man.checksums.append(self._crc(self._k[slot], self._v[slot]))
        self.n_swapped_out += n_pages
        return man

    # -------------------------------------------------------------- load
    def manifest(self, seq_key: int) -> Optional[SwapManifest]:
        with self._lock:
            return self._manifests.get(seq_key)

    def load(self, seq_key: int, from_page: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Checksum-validated views of the sequence's pages from
        ``from_page`` on (pages before it were re-covered by a fresh
        prefix-cache hit): ``(n, L, page_size, kv, dh)`` K and V arrays.
        The slots stay allocated — the caller copies host→device and only
        then calls :meth:`release` (copy-before-free, the swap-in half of
        the ordering contract)."""
        man = self.manifest(seq_key)
        if man is None:
            raise KeyError(f"no swap manifest for sequence {seq_key}")
        for i in range(from_page, man.n_pages):
            slot = man.slots[i]
            crc = self._crc(self._k[slot], self._v[slot])
            if crc != man.checksums[i]:
                self.n_checksum_failures += 1
                raise SwapChecksumError(
                    f"sequence {seq_key} page {i} (slot {slot}): stored "
                    f"checksum {man.checksums[i]:#010x} != current "
                    f"{crc:#010x}")
        idx = man.slots[from_page:]
        self.n_swapped_in += len(idx)
        return self._k[idx], self._v[idx]

    # ----------------------------------------------------------- release
    def release(self, seq_key: int) -> bool:
        """Drop the sequence's manifest and free its slots (after a
        completed swap-in, or when the request is cancelled/migrated and
        the bytes are no longer needed).  Idempotent: False when no
        manifest exists."""
        with self._lock:
            man = self._manifests.pop(seq_key, None)
        if man is None:
            return False
        for slot in man.slots:
            # the free list's state table raises on double-free, so a
            # slot-accounting bug surfaces here instead of aliasing a
            # later sequence's bytes into a still-mapped slot
            self._free.free(slot)
        return True

    # ------------------------------------------------------------- stats
    def slots_used(self) -> int:
        return self.num_slots - self._free.free_count()

    def bytes_used(self) -> int:
        return self.slots_used() * self.slot_nbytes

    def stats(self) -> Dict[str, int]:
        used = self.num_slots - self._free.free_count()
        with self._lock:
            seqs = len(self._manifests)
        out = {
            "slots": self.num_slots,
            "slots_used": used,
            "bytes_used": used * self.slot_nbytes,
            "sequences": seqs,
            "swapped_out": self.n_swapped_out,
            "swapped_in": self.n_swapped_in,
            "checksum_failures": self.n_checksum_failures,
        }
        # lock-free engines expose CAS-contention counters; "locked" has none
        for k, v in self._free.stats().items():
            out[k.replace("pool_", "arena_")] = v
        return out
