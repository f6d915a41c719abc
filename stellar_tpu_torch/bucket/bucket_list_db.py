"""BucketListDB: live ledger state served from bucket files (reference
``src/bucket/BucketSnapshotManager.h`` / ``SearchableBucketListSnapshot``
+ the ``LedgerTxnRoot`` BucketListDB backend, ``bucket/readme.md:35-50``).

``BucketListStore`` plugs in behind the same store interface
``LedgerTxnRoot`` already uses, so the rest of the framework is unaware
whether state lives in a dict (tests) or in indexed files (real nodes):

* reads: small overlay of not-yet-spilled writes, then newest-first
  point lookups through per-bucket indexes (``bucket_index.DiskBucket``);
* writes: accumulate in the overlay; at every ledger close the delta is
  folded into the bucket list (``add_batch``) and ``rebase`` clears the
  overlay — the bucket list is then the only copy of the state;
* iteration (order book, invariants): an in-memory key-set per entry
  type — keys only, never values — kept incrementally; the reference
  keeps whole offers in memory for the same reason.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Set

from stellar_tpu_torch.bucket.bucket import EMPTY, Bucket
from stellar_tpu_torch.bucket.bucket_index import DiskBucket
from stellar_tpu_torch.xdr.ledger import BucketEntryType
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import LedgerEntry

__all__ = ["SearchableBucketListSnapshot", "BucketListStore"]

BET = BucketEntryType


class SearchableBucketListSnapshot:
    """Newest-first point lookups over a bucket list whose buckets may
    be disk-backed (reference ``SearchableBucketListSnapshot``)."""

    def __init__(self, buckets: List):
        self.buckets = buckets  # newest first; Bucket or DiskBucket

    @classmethod
    def from_bucket_list(cls, bucket_list, bucket_manager=None
                         ) -> "SearchableBucketListSnapshot":
        """Prefer file-backed access (index + seek) when the manager has
        a bucket dir; fall back to the in-memory bucket."""
        out = []
        for lev in bucket_list.levels:
            for b in (lev.curr, lev.snap):
                if b.is_empty():
                    continue
                if bucket_manager is not None and \
                        bucket_manager.bucket_dir is not None:
                    bucket_manager.adopt(b)
                    out.append(DiskBucket(bucket_manager._path_for(b.hash),
                                          b.hash))
                else:
                    out.append(b)
        return cls(out)

    def load(self, kb: bytes):
        """Live LedgerEntry or None (dead/absent)."""
        for b in self.buckets:
            e = b.get(kb)
            if e is not None:
                if e.arm == BET.DEADENTRY:
                    return None
                return e.value
        return None

    def load_batch(self, kbs) -> dict:
        """{kb -> live LedgerEntry | None} for every requested key in
        ONE newest-first sweep: per disk bucket a single file open
        serves all outstanding keys in offset order (the bulk-prefetch
        path; reference ``LedgerManagerImpl.cpp:929-933``
        prefetchTxSourceIds -> LedgerTxnRoot prefetch)."""
        remaining = set(kbs)
        out = {}
        for b in self.buckets:
            if not remaining:
                break
            if isinstance(b, DiskBucket):
                hits = b.get_batch(remaining)
            else:
                hits = {}
                for kb in remaining:
                    e = b.get(kb)
                    if e is not None:
                        hits[kb] = e
            for kb, e in hits.items():
                out[kb] = None if e.arm == BET.DEADENTRY else e.value
            remaining -= hits.keys()
        for kb in remaining:
            out[kb] = None
        return out

    def iter_live_entries(self):
        """(kb, LedgerEntry) for every live entry, newest version wins
        (full scan; used for key-map builds and integrity checks)."""
        from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
        from stellar_tpu_torch.xdr.types import LedgerKey
        seen: Set[bytes] = set()
        for b in self.buckets:
            it = b.iter_entries() if isinstance(b, DiskBucket) \
                else iter(b.entries)
            for e in it:
                if e.arm == BET.METAENTRY:
                    continue
                if e.arm == BET.DEADENTRY:
                    kb = to_bytes(LedgerKey, e.value)
                    seen.add(kb)
                    continue
                kb = key_bytes(entry_to_key(e.value))
                if kb in seen:
                    continue
                seen.add(kb)
                yield kb, e.value


_PREFETCH_CACHE_CAP = 100_000
_PREFETCH_BATCH_MAX = 100_000


def set_prefetch_limits(entry_cache_size: int,
                        prefetch_batch_size: int) -> None:
    """Tune the prefetch cache (reference ENTRY_CACHE_SIZE /
    PREFETCH_BATCH_SIZE; called by Application from Config)."""
    global _PREFETCH_CACHE_CAP, _PREFETCH_BATCH_MAX
    _PREFETCH_CACHE_CAP = max(1, entry_cache_size)
    _PREFETCH_BATCH_MAX = max(1, prefetch_batch_size)


class BucketListStore:
    """LedgerTxnRoot store backed by the bucket list (the BucketListDB
    role). Live entries are NOT held in RAM — point reads go through
    bucket files; only the per-type key sets, the pre-close overlay,
    and a bounded prefetch cache are resident."""

    is_bucket_backed = True

    def __init__(self, bucket_list, bucket_manager=None):
        self.bucket_list = bucket_list
        self.bucket_manager = bucket_manager
        self._snapshot = SearchableBucketListSnapshot.from_bucket_list(
            bucket_list, bucket_manager)
        # kb -> encoded entry (written) | None (deleted) since last rebase
        self.overlay: Dict[bytes, Optional[bytes]] = {}
        # prefetched snapshot reads (kb -> LedgerEntry | None); valid
        # until the next rebase, bounded by _PREFETCH_CACHE_CAP
        self._read_cache: Dict[bytes, Optional[LedgerEntry]] = {}
        # entry-type discriminant -> set of kb (keys only)
        self._keys_by_type: Dict[int, Set[bytes]] = {}
        for kb, _ in self._snapshot.iter_live_entries():
            self._type_set(kb).add(kb)

    @staticmethod
    def _type_of(kb: bytes) -> int:
        return int.from_bytes(kb[:4], "big")

    def _type_set(self, kb: bytes) -> Set[bytes]:
        return self._keys_by_type.setdefault(self._type_of(kb), set())

    # ---------------- the store interface ----------------

    def get(self, kb: bytes) -> Optional[LedgerEntry]:
        if kb in self.overlay:
            raw = self.overlay[kb]
            return None if raw is None else from_bytes(LedgerEntry, raw)
        if kb in self._read_cache:
            return self._read_cache[kb]
        return self._snapshot.load(kb)

    def prefetch(self, kbs) -> int:
        """Warm the read cache with one batched newest-first sweep over
        the bucket files (reference prefetch,
        ``LedgerManagerImpl.cpp:929-933`` + ``LedgerTxn.h:815``).
        Returns how many keys were newly fetched."""
        todo = [kb for kb in set(kbs)
                if kb not in self.overlay and kb not in self._read_cache]
        if not todo:
            return 0
        # keep the bound without dumping warm entries: evict only as
        # many (oldest-inserted) entries as the new batch needs, and
        # never admit a single batch larger than the caps
        todo = todo[:min(_PREFETCH_CACHE_CAP, _PREFETCH_BATCH_MAX)]
        overflow = len(self._read_cache) + len(todo) - _PREFETCH_CACHE_CAP
        if overflow > 0:
            for kb in list(itertools.islice(self._read_cache, overflow)):
                del self._read_cache[kb]
        self._read_cache.update(self._snapshot.load_batch(todo))
        return len(todo)

    def put(self, kb: bytes, entry: LedgerEntry):
        self.overlay[kb] = to_bytes(LedgerEntry, entry)
        self._type_set(kb).add(kb)

    def delete(self, kb: bytes):
        self.overlay[kb] = None
        self._type_set(kb).discard(kb)

    def keys_of_type(self, t) -> List[bytes]:
        return list(self._keys_by_type.get(t, ()))

    # ---------------- close integration ----------------

    def rebase(self):
        """Called after ``add_batch`` folded the overlay's changes into
        the bucket list: refresh the snapshot, drop the overlay."""
        self.overlay.clear()
        self._read_cache.clear()
        self._snapshot = SearchableBucketListSnapshot.from_bucket_list(
            self.bucket_list, self.bucket_manager)
