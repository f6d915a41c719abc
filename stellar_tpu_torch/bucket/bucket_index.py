"""BucketIndex: point reads into bucket *files* without materializing
their contents (reference ``src/bucket/BucketIndexImpl.cpp`` +
``bucket/readme.md:33-83`` — the "BucketListDB" read path).

Design is vectorized rather than per-key (the TPU-first habit applied to
host I/O): an index is three parallel numpy arrays — sorted 64-bit key
hashes, file offsets, record lengths — plus a bloom filter over the
hashes. A lookup is filter-reject → ``np.searchsorted`` → one
seek+read of the record frame; batch lookups amortize to a single
vectorized searchsorted over the whole query set. 64-bit collisions are
handled by verifying the decoded entry's key (reference uses per-page
binary search under a binary fuse filter; same contract).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from stellar_tpu_torch.crypto.shorthash import compute_hash
from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
from stellar_tpu_torch.xdr.ledger import BucketEntry, BucketEntryType
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import LedgerKey

__all__ = ["BucketIndex", "DiskBucket"]

BET = BucketEntryType

_BLOOM_K = 4

# files below the cutoff skip index+seek and serve from memory; the
# index of larger files persists as a sidecar so restarts don't rescan
# (reference BUCKETLIST_DB_INDEX_CUTOFF / BUCKETLIST_DB_PERSIST_INDEX;
# set by Application from Config)
INDEX_CUTOFF_BYTES = 20 * 1024 * 1024
PERSIST_INDEX = True
_INDEX_SIDECAR_VERSION = 1


def _iter_frames(raw: bytes):
    """Yield (offset, length, body) for each RFC 5531 record frame."""
    pos = 0
    n = len(raw)
    while pos + 4 <= n:
        (marker,) = struct.unpack_from(">I", raw, pos)
        length = marker & 0x7FFFFFFF
        body = raw[pos + 4:pos + 4 + length]
        yield pos, length, body
        pos += 4 + length


def _entry_key_bytes(e) -> Optional[bytes]:
    if e.arm == BET.METAENTRY:
        return None
    if e.arm == BET.DEADENTRY:
        return to_bytes(LedgerKey, e.value)
    return key_bytes(entry_to_key(e.value))


class BucketIndex:
    """Sorted-hash index over one serialized bucket."""

    __slots__ = ("hashes", "offsets", "lengths", "_bloom", "_bloom_mask")

    def __init__(self, hashes: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray):
        order = np.argsort(hashes, kind="stable")
        self.hashes = hashes[order]
        self.offsets = offsets[order]
        self.lengths = lengths[order]
        # bloom filter: ~16 bits/key, 4 probes derived from the 64-bit
        # hash (the binary-fuse-filter role, same false-positive duty)
        n = max(1, len(hashes))
        m = 1 << max(6, (n * 16).bit_length())
        self._bloom_mask = m - 1
        bits = np.zeros(m // 8, dtype=np.uint8)
        h = self.hashes
        for k in range(_BLOOM_K):
            probe = ((h >> np.uint64(16 * k)) ^ h) & \
                np.uint64(self._bloom_mask)
            np.bitwise_or.at(bits, (probe >> np.uint64(3)).astype(np.int64),
                             (1 << (probe & np.uint64(7))).astype(np.uint8))
        self._bloom = bits

    @classmethod
    def build(cls, raw: bytes) -> "BucketIndex":
        hashes: List[int] = []
        offsets: List[int] = []
        lengths: List[int] = []
        for off, length, body in _iter_frames(raw):
            e = from_bytes(BucketEntry, body)
            kb = _entry_key_bytes(e)
            if kb is None:
                continue
            hashes.append(compute_hash(kb))
            offsets.append(off)
            lengths.append(length)
        return cls(np.asarray(hashes, dtype=np.uint64),
                   np.asarray(offsets, dtype=np.int64),
                   np.asarray(lengths, dtype=np.int64))

    def _maybe_contains(self, h: int) -> bool:
        hh = np.uint64(h)
        for k in range(_BLOOM_K):
            probe = int(((hh >> np.uint64(16 * k)) ^ hh)) & self._bloom_mask
            if not (self._bloom[probe >> 3] >> (probe & 7)) & 1:
                return False
        return True

    def candidates(self, kb: bytes) -> List[Tuple[int, int]]:
        """(offset, length) records whose key hash matches ``kb``'s."""
        h = compute_hash(kb)
        if len(self.hashes) == 0 or not self._maybe_contains(h):
            return []
        h64 = np.uint64(h)
        lo = int(np.searchsorted(self.hashes, h64, side="left"))
        hi = int(np.searchsorted(self.hashes, h64, side="right"))
        return [(int(self.offsets[i]), int(self.lengths[i]))
                for i in range(lo, hi)]


class DiskBucket:
    """A bucket served from its file through a BucketIndex: only the
    records a lookup touches are ever read or decoded. Files below
    ``INDEX_CUTOFF_BYTES`` are materialized in memory instead (small
    buckets: the decode is cheaper than per-lookup seeks), and large
    files persist their index as a ``.idx.npz`` sidecar."""

    __slots__ = ("path", "hash", "_index", "_mem", "_small")

    def __init__(self, path: str, bucket_hash: bytes,
                 index: Optional[BucketIndex] = None):
        self.path = path
        self.hash = bucket_hash
        self._index = index
        self._mem = None  # in-memory Bucket for below-cutoff files
        self._small = None  # cached cutoff decision (file is immutable)

    def _memory_bucket(self):
        if self._mem is None:
            from stellar_tpu_torch.bucket.bucket import Bucket
            with open(self.path, "rb") as f:
                self._mem = Bucket.deserialize(f.read())
        return self._mem

    def _below_cutoff(self) -> bool:
        # content-addressed files never change: stat exactly once
        if self._small is None:
            import os
            try:
                self._small = INDEX_CUTOFF_BYTES > 0 and \
                    os.path.getsize(self.path) < INDEX_CUTOFF_BYTES
            except OSError:
                self._small = False
        return self._small

    @property
    def index(self) -> BucketIndex:
        if self._index is None:
            sidecar = self.path + ".idx.npz"
            import os
            if PERSIST_INDEX and os.path.exists(sidecar):
                try:
                    with np.load(sidecar) as d:
                        if int(d["version"]) == _INDEX_SIDECAR_VERSION:
                            self._index = BucketIndex.__new__(BucketIndex)
                            BucketIndex.__init__(
                                self._index, d["hashes"], d["offsets"],
                                d["lengths"])
                            return self._index
                except Exception:
                    pass  # corrupt sidecar: rebuild below
            with open(self.path, "rb") as f:
                self._index = BucketIndex.build(f.read())
            if PERSIST_INDEX:
                try:
                    np.savez(sidecar,
                             version=_INDEX_SIDECAR_VERSION,
                             hashes=self._index.hashes,
                             offsets=self._index.offsets,
                             lengths=self._index.lengths)
                except Exception:
                    pass  # best effort; the index itself is in memory
        return self._index

    def get(self, kb: bytes):
        """BucketEntry for a ledger-key encoding, or None — same
        contract as in-memory ``Bucket.get``."""
        if self._mem is not None or self._below_cutoff():
            return self._memory_bucket().get(kb)
        cands = self.index.candidates(kb)
        if not cands:
            return None
        with open(self.path, "rb") as f:
            for off, length in cands:
                f.seek(off + 4)
                e = from_bytes(BucketEntry, f.read(length))
                if _entry_key_bytes(e) == kb:
                    return e
        return None

    def get_batch(self, kbs) -> dict:
        """{kb -> BucketEntry} for every hit among ``kbs``: ONE file
        open, candidate records read in offset order (reference bulk
        prefetch amortizing per-lookup seeks,
        ``LedgerTxn.h:815`` prefetch + ``LedgerTxnRoot``'s bulk
        loaders)."""
        if self._mem is not None or self._below_cutoff():
            b = self._memory_bucket()
            out = {}
            for kb in kbs:
                e = b.get(kb)
                if e is not None:
                    out[kb] = e
            return out
        wanted = []  # (offset, length, kb)
        for kb in kbs:
            for off, length in self.index.candidates(kb):
                wanted.append((off, length, kb))
        if not wanted:
            return {}
        wanted.sort()
        out = {}
        with open(self.path, "rb") as f:
            for off, length, kb in wanted:
                if kb in out:
                    continue
                f.seek(off + 4)
                e = from_bytes(BucketEntry, f.read(length))
                if _entry_key_bytes(e) == kb:
                    out[kb] = e
        return out

    def iter_entries(self):
        """Stream-decode every entry (for scans/rebuilds)."""
        with open(self.path, "rb") as f:
            raw = f.read()
        for _, _, body in _iter_frames(raw):
            yield from_bytes(BucketEntry, body)
