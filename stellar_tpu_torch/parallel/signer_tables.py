"""Per-pubkey hot-signer tables — the port's own copy of
``stellar_tpu/parallel/signer_tables.py``.

A node's signatures come mostly from a small signer set (validators sign
the SCP envelopes, catchup replays the same accounts). For each 32-byte
pubkey this module caches the 128-entry affine cached table of multiples
of ``-A`` that the hot kernel K2 (:func:`stellar_tpu_torch.ops.verify.
verify_kernel_hot`) takes as an operand, so a repeat signer skips
decompression and the table build and runs radix-256 windows.

* Keys are content fingerprints (SHA-256 of the encoding, truncated): no
  clocks, no randomness, so two replicas fed the same traffic cache the
  same signers. The encoding, not the point, is the key: a non-canonical
  alias of a cached key misses and rides the cold path, whose host gate
  vetoes it.
* A byte budget (:data:`DEFAULT_CACHE_BYTES`, 64 MiB) bounds retention
  with LRU eviction; the cache is on by default, as in the reference, and
  off every row rides cold. Both knobs are module constants, set at run
  time through :meth:`SignerTableCache.configure`: no environment option
  is read (the reference's ``VERIFY_SIGNER_TABLE_*`` are its node's
  Config knobs).
* :meth:`SignerTableCache.evict` is the audit hook: a conviction over a
  hot-served part drops the tables that served it.

An entry is installed only after ``point_decompress`` succeeded and the
rows were derived from that point by the pure-Python oracle, so cache
membership is the decompression proof the hot kernel relies on. The
values are host numpy arrays, ``(128, 3, 20)`` int16 canonical 13-bit
limbs, read-only once cached. Lookups, installs and evictions mark the
reference's registry counters ``crypto.verify.signer_table.{hits,misses,
installs,evictions,audit_evictions}`` and keep the same tallies in
:meth:`SignerTableCache.snapshot`. The counters are fetched from the
registry once, at import (the registry never drops a metric), so a mark
is one increment; :meth:`BatchVerifier.submit
<stellar_tpu_torch.crypto.batch_verifier.BatchVerifier.submit>`'s partition
marks a batch's hits and misses once (``lookup(mark=False)``, then
:meth:`SignerTableCache.flush_marks`), so after every call the counters
equal the tallies.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.utils.metrics import registry

__all__ = ["SignerTableCache", "signer_table_cache", "build_signer_table",
           "signer_fingerprint", "TABLE_ENTRIES", "TABLE_BYTES",
           "DEFAULT_CACHE_BYTES", "ENABLED"]

_NS = "crypto.verify.signer_table"

# Table geometry: the hot kernel's operand contract (ops/edwards.py
# TABLE_ENTRIES256, AFFINE_COORDS and field25519.NLIMBS).
TABLE_ENTRIES = 128   # multiples 1..128 of -A (radix-256 windows)
_COORDS = 3           # (Y+X, Y-X, 2d*T), Z == 1 implied
_NLIMBS = 20          # 13-bit limbs of GF(2^255-19)
_LIMB_BITS = 13
_LIMB_MASK = (1 << _LIMB_BITS) - 1
TABLE_BYTES = TABLE_ENTRIES * _COORDS * _NLIMBS * 2  # int16

# The knobs' defaults, the reference's (set at run time through
# SignerTableCache.configure). 64 MiB holds about 4.3k signers at 15 KiB
# a table.
DEFAULT_CACHE_BYTES = 64 << 20
ENABLED = True

# The registry's counters, fetched once: the registry never drops a metric,
# so these stay the objects that its snapshots and exports read.
_MISSES, _HITS, _INSTALLS, _EVICTIONS, _AUDIT_EVICTIONS = (
    registry.counter(f"{_NS}.{k}") for k in (
        "misses", "hits", "installs", "evictions", "audit_evictions"))


def signer_fingerprint(pk: bytes) -> bytes:
    """Content key of one signer: SHA-256 of the pubkey encoding, 16
    bytes."""
    return hashlib.sha256(pk).digest()[:16]


def _limbs(x: int) -> list:
    """13-bit little-endian limbs of one canonical field element."""
    x %= ref.P
    return [(x >> (_LIMB_BITS * i)) & _LIMB_MASK for i in range(_NLIMBS)]


def build_signer_table(pk: bytes) -> Optional[np.ndarray]:
    """The hot-path table of one pubkey: decompress, negate (the kernel
    computes s*B + h*(-A)), the 128 affine cached rows by the oracle (an
    incremental chain and one batched inversion), packed as
    ``(TABLE_ENTRIES, 3, 20)`` int16 canonical limbs. None when the
    pubkey has the wrong length or does not decompress: such a signer is
    never cached and never rides hot."""
    if len(pk) != 32:
        return None
    pt = ref.point_decompress(pk)
    if pt is None:
        return None
    neg = (ref.P - pt[0], pt[1], pt[2], (ref.P - pt[3]) % ref.P)
    rows = ref.affine_table_rows(neg, TABLE_ENTRIES)
    out = np.empty((TABLE_ENTRIES, _COORDS, _NLIMBS), dtype=np.int16)
    for i, row in enumerate(rows):
        for j, c in enumerate(row):
            out[i, j] = _limbs(c)
    return out


class SignerTableCache:
    """Process-wide LRU of per-pubkey hot-path tables, byte-bounded, with
    an explicit :meth:`evict` for audit convictions. All state changes
    under the instance lock."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES,
                 enabled: bool = ENABLED):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # fingerprint -> table
        self._max_bytes = max(0, int(max_bytes))
        self._enabled = bool(enabled)
        self._hits = 0
        self._misses = 0
        self._installs = 0
        self._evictions = 0
        self._audit_evictions = 0
        self._unmarked_hits = 0     # lookups not yet marked in the registry
        self._unmarked_misses = 0

    def configure(self, max_bytes: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        """Set the knobs; None keeps the current value. Shrinking the
        budget evicts at once; disabling clears the cache (the next batch
        runs all cold, verdicts unchanged)."""
        with self._lock:
            if max_bytes is not None:
                self._max_bytes = max(0, int(max_bytes))
            if enabled is not None:
                self._enabled = bool(enabled)
                if not self._enabled:
                    self._entries.clear()
            self._evict_locked()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def lookup(self, pk: bytes, mark: bool = True) -> Optional[np.ndarray]:
        """The cached table of this signer, or None (a miss, or the cache
        is off). A hit refreshes its recency. The tallies move at once;
        ``mark=False`` leaves the registry's hit or miss mark to
        :meth:`flush_marks`, so a batch's partition marks its lookups
        once a batch and not once a row."""
        if not self._enabled:
            return None
        fp = signer_fingerprint(pk)
        with self._lock:
            hit = self._entries.get(fp)
            if hit is None:
                self._misses += 1
                if not mark:
                    self._unmarked_misses += 1
            else:
                self._entries.move_to_end(fp)
                self._hits += 1
                if not mark:
                    self._unmarked_hits += 1
        if mark:
            (_MISSES if hit is None else _HITS).inc()
        return hit

    def flush_marks(self) -> None:
        """Mark the registry's hit and miss counters with the lookups made
        with ``mark=False`` since the last flush."""
        with self._lock:
            hits, misses = self._unmarked_hits, self._unmarked_misses
            self._unmarked_hits = self._unmarked_misses = 0
        if hits:
            _HITS.inc(hits)
        if misses:
            _MISSES.inc(misses)

    def install(self, pk: bytes, table: np.ndarray) -> bool:
        """Keep one freshly built table; True when cached. The table is
        read-only from here on: the same array goes into every later hot
        batch."""
        if not self._enabled or self._max_bytes < TABLE_BYTES:
            return False
        table.setflags(write=False)
        fp = signer_fingerprint(pk)
        with self._lock:
            self._entries.pop(fp, None)
            self._entries[fp] = table
            self._installs += 1
            self._evict_locked()
        _INSTALLS.inc()
        return True

    def evict(self, pk: bytes) -> bool:
        """Drop one signer's entry (an audit conviction over a batch its
        table served); the next sight rebuilds it from the pubkey. True
        when an entry was there."""
        fp = signer_fingerprint(pk)
        with self._lock:
            present = self._entries.pop(fp, None) is not None
            if present:
                self._audit_evictions += 1
        if present:
            _AUDIT_EVICTIONS.inc()
        return present

    def _evict_locked(self) -> None:
        while len(self._entries) * TABLE_BYTES > self._max_bytes \
                and self._entries:
            self._entries.popitem(last=False)
            self._evictions += 1
            _EVICTIONS.inc()

    def snapshot(self) -> dict:
        """The knobs, the size and the tallies since the last reset."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "entries": len(self._entries),
                "bytes": len(self._entries) * TABLE_BYTES,
                "max_bytes": self._max_bytes,
                "table_bytes": TABLE_BYTES,
                "hits": self._hits,
                "misses": self._misses,
                "installs": self._installs,
                "evictions": self._evictions,
                "audit_evictions": self._audit_evictions,
            }

    def _reset_for_testing(self) -> None:
        """Drop every table and tally and restore the knobs' defaults, as
        at process start. Lookups not yet marked are marked first: the
        registry's counters never lose one."""
        self.flush_marks()
        with self._lock:
            self._entries.clear()
            self._max_bytes = max(0, int(DEFAULT_CACHE_BYTES))
            self._enabled = bool(ENABLED)
            self._hits = 0
            self._misses = 0
            self._installs = 0
            self._evictions = 0
            self._audit_evictions = 0


# One cache a process: signer hotness belongs to the node's traffic and is
# shared by every verifier instance.
signer_table_cache = SignerTableCache()
