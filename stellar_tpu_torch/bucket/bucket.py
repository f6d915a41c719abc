"""Content-addressed buckets: sorted, immutable runs of ledger-entry
changes, named by the SHA-256 of their serialized stream (reference
``src/bucket/BucketBase.h`` / ``LiveBucket.cpp``).

Entry kinds (``BucketEntry`` XDR): METAENTRY (protocol version header),
INITENTRY (entry created since the previous spill of this level),
LIVEENTRY (entry updated), DEADENTRY (key deleted). Entries are sorted
by the XDR encoding of their ledger key, which orders by entry type
first then key fields — internally consistent everywhere (hashes,
merges, lookups, history files); byte-parity with the C++ comparator is
not claimed for var-length fields.

Serialization uses RFC 5531 record marking (4-byte BE length with the
high bit set, then the XDR body) — the same on-disk format the
reference's XDR file streams produce, so bucket files are
hash-addressable and history-publishable.

Merge semantics follow the current-protocol rules
(``LiveBucket::mergeCasesWithEqualKeys``, shadows removed since
protocol 12): newer wins; INIT+DEAD annihilates; DEAD+INIT fuses to
LIVE; INIT absorbs later LIVEs keeping INIT-ness; tombstones drop when
merging into the bottom level.

The port's copy of ``stellar_tpu/bucket/bucket.py``, with the port's
imports."""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Iterable, List, Optional, Tuple

from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
from stellar_tpu_torch.xdr.ledger import (
    BucketEntry, BucketEntryType, BucketMetadata,
)
from stellar_tpu_torch.xdr.runtime import Unpacker, from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import LedgerEntry, LedgerKey

__all__ = ["Bucket", "fresh_bucket", "merge_buckets"]

BET = BucketEntryType


def _entry_sort_key(entry) -> bytes:
    """Sort key: METAENTRY first, then XDR-encoded ledger key."""
    t = entry.arm
    if t == BET.METAENTRY:
        return b"\x00"
    if t == BET.DEADENTRY:
        return b"\x01" + to_bytes(LedgerKey, entry.value)
    return b"\x01" + key_bytes(entry_to_key(entry.value))


def _record_frame(xdr: bytes) -> bytes:
    return struct.pack(">I", 0x80000000 | len(xdr)) + xdr


class Bucket:
    """Immutable sorted bucket. Empty bucket hash is the zero hash
    (reference: an empty bucket has no file and hash 0)."""

    __slots__ = ("entries", "_hash", "_index", "_size")

    def __init__(self, entries: List):
        self.entries = entries
        self._hash: Optional[bytes] = None
        self._index: Optional[Dict[bytes, object]] = None

    def is_empty(self) -> bool:
        return not self.entries

    @property
    def hash(self) -> bytes:
        if self._hash is None:
            if not self.entries:
                self._hash = b"\x00" * 32
            else:
                from stellar_tpu_torch.utils import native
                self._hash = native.hash_frames(
                    [to_bytes(BucketEntry, e) for e in self.entries])
        return self._hash

    def serialize(self) -> bytes:
        from stellar_tpu_torch.utils import native
        raw = native.join_frames(
            [to_bytes(BucketEntry, e) for e in self.entries])
        self._size = len(raw)
        return raw

    @property
    def size_bytes(self) -> int:
        """Serialized size (cached; an immutable bucket never changes)."""
        size = getattr(self, "_size", None)
        if size is None:
            size = sum(4 + len(to_bytes(BucketEntry, e))
                       for e in self.entries)
            self._size = size
        return size

    @classmethod
    def deserialize(cls, raw: bytes) -> "Bucket":
        from stellar_tpu_torch.utils import native
        return cls([from_bytes(BucketEntry, f)
                    for f in native.split_frames(raw)])

    # ---------------- lookups ----------------

    def _ensure_index(self):
        if self._index is None:
            idx = {}
            for e in self.entries:
                if e.arm == BET.METAENTRY:
                    continue
                kb = (to_bytes(LedgerKey, e.value)
                      if e.arm == BET.DEADENTRY
                      else key_bytes(entry_to_key(e.value)))
                idx[kb] = e
            self._index = idx

    def get(self, kb: bytes):
        """BucketEntry for a ledger-key encoding, or None (the
        BucketIndex role, reference ``bucket/BucketIndexImpl``)."""
        self._ensure_index()
        return self._index.get(kb)

    def count_entries(self) -> Tuple[int, int, int]:
        """(init+live, dead, meta) counts."""
        live = dead = meta = 0
        for e in self.entries:
            if e.arm == BET.METAENTRY:
                meta += 1
            elif e.arm == BET.DEADENTRY:
                dead += 1
            else:
                live += 1
        return live, dead, meta


EMPTY = Bucket([])


def fresh_bucket(protocol_version: int, init_entries: Iterable[LedgerEntry],
                 live_entries: Iterable[LedgerEntry],
                 dead_keys: Iterable) -> Bucket:
    """Level-0 bucket for one ledger's changes (reference
    ``LiveBucket::fresh``): meta entry + sorted changes."""
    items = []
    for le in init_entries:
        items.append(BucketEntry.make(BET.INITENTRY, le))
    for le in live_entries:
        items.append(BucketEntry.make(BET.LIVEENTRY, le))
    for k in dead_keys:
        items.append(BucketEntry.make(BET.DEADENTRY, k))
    if not items:
        return EMPTY
    meta = BucketEntry.make(BET.METAENTRY, BucketMetadata(
        ledgerVersion=protocol_version,
        ext=BucketMetadata._types[1].make(0)))
    items.sort(key=_entry_sort_key)
    return Bucket([meta] + items)


def _merge_equal_keys(old, new):
    """Newer entry wins with INIT/DEAD fusion (reference
    ``LiveBucket::mergeCasesWithEqualKeys``). Returns the surviving
    entry or None (annihilation)."""
    ot, nt = old.arm, new.arm
    if ot == BET.INITENTRY:
        if nt == BET.LIVEENTRY:
            # INIT + LIVE -> INIT with the newer value
            return BucketEntry.make(BET.INITENTRY, new.value)
        if nt == BET.DEADENTRY:
            return None  # INIT + DEAD annihilate
        return new  # INIT + INIT: shouldn't occur; newer wins
    if ot == BET.DEADENTRY and nt == BET.INITENTRY:
        # DEAD + INIT -> LIVE (recreation across a tombstone)
        return BucketEntry.make(BET.LIVEENTRY, new.value)
    return new


def merge_buckets(old: Bucket, new: Bucket, protocol_version: int,
                  keep_tombstones: bool = True) -> Bucket:
    """Two-way sorted merge, new over old (reference
    ``BucketBase::merge``; shadows are gone in current protocol). The
    merge plan runs in the native runtime; only equal-key pairs (rare)
    come back to Python for INIT/LIVE/DEAD fusion."""
    from stellar_tpu_torch.utils import native
    out = []
    oe = [e for e in old.entries if e.arm != BET.METAENTRY]
    ne = [e for e in new.entries if e.arm != BET.METAENTRY]

    def put(e):
        if e.arm == BET.DEADENTRY and not keep_tombstones:
            return
        out.append(e)

    plan = native.merge_plan([_entry_sort_key(e) for e in oe],
                             [_entry_sort_key(e) for e in ne])
    for side, i, j in plan:
        if side == 0:
            put(oe[i])
        elif side == 1:
            put(ne[j])
        else:
            merged = _merge_equal_keys(oe[i], ne[j])
            if merged is not None:
                put(merged)

    if not out:
        return EMPTY
    meta = BucketEntry.make(BET.METAENTRY, BucketMetadata(
        ledgerVersion=protocol_version,
        ext=BucketMetadata._types[1].make(0)))
    return Bucket([meta] + out)
