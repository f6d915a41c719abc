"""Hot archive for evicted persistent Soroban state (reference
``src/bucket/HotArchiveBucket*``: a second 11-level bucket list that
receives ARCHIVED full entries when the eviction scan removes expired
PERSISTENT contract data/code from the live state, and LIVE key markers
when a RestoreFootprint brings an entry back).

Active from STATE_ARCHIVAL_PROTOCOL_VERSION (= 23, the protocol where
persistent eviction begins — reference
``FIRST_PROTOCOL_SUPPORTING_PERSISTENT_EVICTION``). From that version
the archive is CONSENSUS STATE: its hash folds into the header's
bucketListHash (``LedgerManager``; the reference snapshot leaves this
as a TODO in ``BucketManager::snapshotLedger`` — committing it is
required for restores to be consensus-safe, so this framework does),
its buckets publish through the HistoryArchiveState
("hotArchiveBuckets" levels), and MINIMAL catchup reconstructs it
before verifying the combined hash. Below p23 the live list keeps
expired persistent entries and the archive stays empty.

Merge semantics (reference ``HotArchiveBucket::mergeCasesWithEqualKeys``):
newest wins per key; at the bottom level LIVE markers annihilate (a
restored entry needs no tombstone below it).

The port's copy of ``stellar_tpu/bucket/hot_archive.py``, with the port's
imports."""

from __future__ import annotations

from typing import Dict, List, Optional

from stellar_tpu_torch.bucket.bucket_list import (
    NUM_LEVELS, level_should_spill, should_merge_with_empty_curr,
)
from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
from stellar_tpu_torch.xdr.ledger import (
    HotArchiveBucketEntry, HotArchiveBucketEntryType as HBET,
)
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import LedgerKey

__all__ = ["HotArchiveBucket", "HotArchiveBucketList",
           "STATE_ARCHIVAL_PROTOCOL_VERSION"]

STATE_ARCHIVAL_PROTOCOL_VERSION = 23


def combined_bucket_list_hash(live_hash: bytes,
                              hot_archive_hash: bytes) -> bytes:
    """The p23+ header commitment: the header's bucketListHash covers
    BOTH lists, so a MINIMAL-catchup node proves its reconstructed
    archive against consensus before trusting RestoreFootprint reads."""
    from stellar_tpu_torch.crypto.sha import sha256
    return sha256(live_hash + hot_archive_hash)


def header_bucket_list_hash(live_hash: bytes, hot_archive,
                            ledger_version: int) -> bytes:
    """What a header at ``ledger_version`` commits to, given the live
    list hash and the node's hot archive (None = empty archive): the
    ONE implementation of the protocol-gated combine used by close,
    self-check, restore, and catchup alike."""
    if ledger_version < STATE_ARCHIVAL_PROTOCOL_VERSION:
        return live_hash
    hot_hash = (hot_archive.hash() if hot_archive is not None
                else HotArchiveBucketList().hash())
    return combined_bucket_list_hash(live_hash, hot_hash)


def _entry_key_bytes(e) -> bytes:
    if e.arm == HBET.HOT_ARCHIVE_LIVE:
        return to_bytes(LedgerKey, e.value)
    return key_bytes(entry_to_key(e.value))


class HotArchiveBucket:
    """Immutable sorted hot-archive bucket; same content-addressed
    framed-SHA256 identity scheme as the live buckets."""

    __slots__ = ("entries", "_hash", "_index")

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
                    [to_bytes(HotArchiveBucketEntry, e)
                     for e in self.entries])
        return self._hash

    def serialize(self) -> bytes:
        from stellar_tpu_torch.utils import native
        return native.join_frames(
            [to_bytes(HotArchiveBucketEntry, e) for e in self.entries])

    @classmethod
    def deserialize(cls, raw: bytes) -> "HotArchiveBucket":
        from stellar_tpu_torch.utils import native
        return cls([from_bytes(HotArchiveBucketEntry, f)
                    for f in native.split_frames(raw)])

    @classmethod
    def fresh(cls, archived: List, restored_keys: List
              ) -> "HotArchiveBucket":
        """One ledger's hot-archive delta: full ARCHIVED entries for
        newly evicted state, LIVE markers for restored keys."""
        ents = [HotArchiveBucketEntry.make(HBET.HOT_ARCHIVE_ARCHIVED, e)
                for e in archived]
        ents += [HotArchiveBucketEntry.make(HBET.HOT_ARCHIVE_LIVE, k)
                 for k in restored_keys]
        ents.sort(key=_entry_key_bytes)
        return cls(ents)

    def get(self, kb: bytes):
        """The entry under ledger-key bytes ``kb`` or None."""
        if self._index is None:
            self._index = {_entry_key_bytes(e): e for e in self.entries}
        return self._index.get(kb)


def merge_hot_buckets(old: HotArchiveBucket, new: HotArchiveBucket,
                      keep_live_markers: bool) -> HotArchiveBucket:
    """Sorted-merge: per equal key the NEW entry wins outright
    (archived-over-live, live-over-archived — last write is truth);
    at the bottom level LIVE markers drop (nothing below to shadow)."""
    out: List = []
    i = j = 0
    oe, ne = old.entries, new.entries

    def put(e):
        if e.arm == HBET.HOT_ARCHIVE_LIVE and not keep_live_markers:
            return
        out.append(e)
    while i < len(oe) and j < len(ne):
        ko, kn = _entry_key_bytes(oe[i]), _entry_key_bytes(ne[j])
        if ko < kn:
            put(oe[i])
            i += 1
        elif kn < ko:
            put(ne[j])
            j += 1
        else:
            put(ne[j])  # newest wins
            i += 1
            j += 1
    while i < len(oe):
        put(oe[i])
        i += 1
    while j < len(ne):
        put(ne[j])
        j += 1
    return HotArchiveBucket(out)


class _HotLevel:
    def __init__(self, level: int):
        self.level = level
        self.curr = HotArchiveBucket([])
        self.snap = HotArchiveBucket([])
        self._next = None  # FutureBucket | HotArchiveBucket | None

    @property
    def next(self) -> Optional[HotArchiveBucket]:
        """Prepared merge output; resolves a pending background merge
        (same FutureBucket semantics as the live list)."""
        from stellar_tpu_torch.bucket.bucket_list import FutureBucket
        if isinstance(self._next, FutureBucket):
            self._next = self._next.resolve()
        return self._next

    @next.setter
    def next(self, bucket: Optional[HotArchiveBucket]):
        self._next = bucket

    def hash_preimage(self) -> bytes:
        """curr ‖ snap — shared by :meth:`hash` and the list-level
        batched hashing (``HotArchiveBucketList.hash``)."""
        return self.curr.hash + self.snap.hash

    def hash(self) -> bytes:
        from stellar_tpu_torch.crypto.sha import sha256
        return sha256(self.hash_preimage())

    def take_snap(self) -> HotArchiveBucket:
        self.snap = self.curr
        self.curr = HotArchiveBucket([])
        return self.snap

    def commit(self):
        if self._next is not None:
            self.curr = self.next  # resolves if still in flight
            self._next = None

    def merge_in_flight(self) -> bool:
        from stellar_tpu_torch.bucket.bucket_list import FutureBucket
        return isinstance(self._next, FutureBucket) and \
            not self._next.done

    def pending_merge(self):
        from stellar_tpu_torch.bucket.bucket_list import FutureBucket
        return self._next if isinstance(self._next, FutureBucket) \
            else None

    def prepare(self, incoming: HotArchiveBucket, keep_live: bool,
                merge_with_empty_curr: bool):
        from stellar_tpu_torch.bucket.bucket_list import FutureBucket
        base = HotArchiveBucket([]) if merge_with_empty_curr else self.curr
        self._next = FutureBucket.start(
            lambda: merge_hot_buckets(base, incoming, keep_live),
            inputs=(base, incoming, keep_live))


class HotArchiveBucketList:
    """Same 11-level spill cadence as the live list (reference shares
    ``BucketListBase``), holding hot-archive buckets."""

    def __init__(self):
        self.levels = [_HotLevel(i) for i in range(NUM_LEVELS)]

    def hash(self) -> bytes:
        # independent per-level digests batch through the hash
        # workload (bit-identical; hashlib below the device
        # threshold), then chain — same shape as LiveBucketList.hash
        from stellar_tpu_torch.crypto.batch_hasher import hash_many
        from stellar_tpu_torch.crypto.sha import sha256
        level_hashes = hash_many(
            [lev.hash_preimage() for lev in self.levels])
        return sha256(b"".join(level_hashes))

    def is_empty(self) -> bool:
        return all(lev.curr.is_empty() and lev.snap.is_empty() and
                   lev.next is None for lev in self.levels)

    def add_batch(self, current_ledger: int, archived: List,
                  restored_keys: List):
        assert current_ledger > 0
        for i in range(NUM_LEVELS - 1, 0, -1):
            if level_should_spill(current_ledger, i - 1):
                spilled = self.levels[i - 1].take_snap()
                self.levels[i].commit()
                self.levels[i].prepare(
                    spilled,
                    keep_live=(i < NUM_LEVELS - 1),
                    merge_with_empty_curr=should_merge_with_empty_curr(
                        current_ledger, i))
        # level 0 is needed this close: merge inline, no worker hop
        self.levels[0].curr = merge_hot_buckets(
            self.levels[0].curr,
            HotArchiveBucket.fresh(archived, restored_keys),
            keep_live_markers=True)
        self.levels[0]._next = None

    def get_archived(self, kb: bytes):
        """Newest-first lookup: the ARCHIVED LedgerEntry for key bytes
        ``kb``, or None when absent or restored (LIVE marker)."""
        for lev in self.levels:
            for bucket in (lev.curr, lev.snap):
                e = bucket.get(kb)
                if e is None:
                    continue
                if e.arm == HBET.HOT_ARCHIVE_ARCHIVED:
                    return e.value
                return None  # LIVE marker: restored since archival
        return None

    def total_entry_count(self) -> int:
        return sum(len(lev.curr.entries) + len(lev.snap.entries)
                   for lev in self.levels)
