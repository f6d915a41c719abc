"""The 11-level LiveBucketList: the hashed canonical ledger state
(reference ``src/bucket/BucketListBase.h:445`` / ``.cpp``).

Geometry: level i holds ~4^(i+1) ledgers of changes as two buckets,
``curr`` and ``snap``; half-full currs snap and spill downward on the
cadence ``levelShouldSpill(ledger, i) = ledger % levelHalf(i) == 0 or
ledger % levelSize(i) == 0`` with ``levelSize(i) = 4^(i+1)``. The merge
of a spilled snap into the next level's curr is *prepared* at spill
time on the shared worker pool and only becomes visible (``commit``)
at that level's next spill — the reference's FutureBucket semantics
(``bucket/FutureBucket.h:37-127``): ``BucketLevel.next`` transparently
resolves the pending merge the first time anything touches it (the
next spill, persistence, the HAS), so a deep-level merge no longer
stalls the close that spilled it. Merges are pure functions of
immutable buckets, so backgrounding changes only WHEN the work runs,
never the result; ``utils.workers.set_background(False)`` forces the
old eager mode and tests pin result identity between the two.

The list hash is SHA-256 over each level's SHA-256(curr.hash ‖
snap.hash) (reference ``BucketListBase::getHash``), and chains into the
ledger header, making every checkpoint verifiable.

The port's copy of ``stellar_tpu/bucket/bucket_list.py``, with the port's
imports."""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional

from stellar_tpu_torch.bucket.bucket import (
    EMPTY, Bucket, fresh_bucket, merge_buckets,
)
from stellar_tpu_torch.xdr.ledger import BucketEntryType

__all__ = ["BucketLevel", "LiveBucketList", "NUM_LEVELS"]

NUM_LEVELS = 11

# test knob (reference ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING,
# pushed from Config): halves every level's size so spills reach deep
# levels within a short test chain
REDUCE_MERGE_COUNTS = False


def level_size(level: int) -> int:
    shift = 1 if REDUCE_MERGE_COUNTS else 0
    return max(2, 1 << (2 * (level + 1) - shift))


def level_half(level: int) -> int:
    return level_size(level) >> 1


def round_down(v: int, m: int) -> int:
    return v - (v % m)


def level_should_spill(ledger: int, level: int) -> bool:
    if level == NUM_LEVELS - 1:
        return False  # the bottom level never spills
    return (ledger == round_down(ledger, level_half(level)) or
            ledger == round_down(ledger, level_size(level)))


def should_merge_with_empty_curr(ledger: int, level: int) -> bool:
    """True when level's curr will itself be snapped before the merge
    being prepared now commits (reference
    ``shouldMergeWithEmptyCurr``)."""
    if level == 0:
        return False
    merge_start = round_down(ledger, level_half(level - 1))
    next_change = merge_start + level_half(level - 1)
    return level_should_spill(next_change, level)


class FutureBucket:
    """Handle to an in-flight (or finished) merge (reference
    ``FutureBucket``): resolves exactly once; the merge is a pure
    function of two immutable buckets, so resolution order can never
    change the result, only where the latency lands.

    ``inputs`` carries (base, incoming, *params) for persistence: an
    unresolved merge is saved as its inputs and RESTARTED at restore
    (reference ``FutureBucket::makeLive`` from the HAS state=2 form) —
    determinism makes the restarted output bit-identical, so a crash
    mid-merge never blocks the close that persisted it."""

    __slots__ = ("_bucket", "_future", "inputs")

    def __init__(self, bucket: Optional[Bucket] = None, future=None,
                 inputs: Optional[tuple] = None):
        self._bucket = bucket
        self._future = future
        self.inputs = inputs

    @classmethod
    def start(cls, fn, inputs: Optional[tuple] = None) -> "FutureBucket":
        from stellar_tpu_torch.utils.workers import run_async
        return cls(future=run_async(fn), inputs=inputs)

    def resolve(self) -> Bucket:
        if self._bucket is None:
            self._bucket = self._future.result()
            self._future = None
        return self._bucket

    @property
    def done(self) -> bool:
        return self._bucket is not None or self._future.done()


class BucketLevel:
    __slots__ = ("level", "curr", "snap", "_next")

    def __init__(self, level: int):
        self.level = level
        self.curr: Bucket = EMPTY
        self.snap: Bucket = EMPTY
        self._next = None  # FutureBucket | Bucket | None

    @property
    def next(self) -> Optional[Bucket]:
        """The prepared merge output; touching it resolves a pending
        background merge (blocking until it lands)."""
        if isinstance(self._next, FutureBucket):
            self._next = self._next.resolve()
        return self._next

    @next.setter
    def next(self, bucket: Optional[Bucket]):
        self._next = bucket

    def merge_in_flight(self) -> bool:
        """True while a prepared merge is still computing (metrics /
        close-latency instrumentation)."""
        return isinstance(self._next, FutureBucket) and \
            not self._next.done

    def pending_merge(self) -> Optional["FutureBucket"]:
        """The unresolved FutureBucket, or None once resolved/absent
        (persistence stores its inputs instead of blocking on it)."""
        return self._next if isinstance(self._next, FutureBucket) \
            else None

    def hash_preimage(self) -> bytes:
        """curr ‖ snap — the single definition of the level-hash
        preimage, shared by :meth:`hash` and the list-level batched
        hashing (``LiveBucketList.hash``)."""
        return self.curr.hash + self.snap.hash

    def hash(self) -> bytes:
        return hashlib.sha256(self.hash_preimage()).digest()

    def take_snap(self) -> Bucket:
        """curr -> snap, fresh curr (reference ``BucketLevel::snap``)."""
        self.snap = self.curr
        self.curr = EMPTY
        return self.snap

    def commit(self):
        """Make the prepared merge visible (reference
        ``BucketLevel::commit`` resolving the FutureBucket)."""
        if self._next is not None:
            self.curr = self.next  # resolves if still in flight
            self._next = None

    def prepare(self, incoming_snap: Bucket, protocol_version: int,
                keep_tombstones: bool, merge_with_empty_curr: bool):
        """Start the merge of the level above's snap into this level's
        curr on the worker pool; visible at the next commit. When this
        level's own curr will be snapped away before that commit, merge
        into an empty curr instead (reference
        ``shouldMergeWithEmptyCurr`` — otherwise the same contents would
        live at two levels)."""
        base = EMPTY if merge_with_empty_curr else self.curr
        self._next = FutureBucket.start(
            lambda: merge_buckets(base, incoming_snap, protocol_version,
                                  keep_tombstones=keep_tombstones),
            inputs=(base, incoming_snap, protocol_version,
                    keep_tombstones))


class LiveBucketList:
    def __init__(self):
        self.levels: List[BucketLevel] = [BucketLevel(i)
                                          for i in range(NUM_LEVELS)]

    # ---------------- hashing ----------------

    def hash(self) -> bytes:
        # the level hashes are independent digests (each is
        # SHA-256(curr || snap)) — batch them through the hash
        # workload (bit-identical to the serial form: hashlib below
        # the device threshold / without an accelerator), then chain
        # the level digests exactly as before
        from stellar_tpu_torch.crypto.batch_hasher import hash_many
        level_hashes = hash_many(
            [lev.hash_preimage() for lev in self.levels])
        h = hashlib.sha256()
        for lh in level_hashes:
            h.update(lh)
        return h.digest()

    # ---------------- the spill cascade ----------------

    def add_batch(self, current_ledger: int, protocol_version: int,
                  init_entries: Iterable, live_entries: Iterable,
                  dead_keys: Iterable):
        """Apply one ledger's changes (reference
        ``BucketListBase::addBatch`` / ``addBatchInternal`` — shadows
        omitted, removed since protocol 12)."""
        assert current_ledger > 0
        from stellar_tpu_torch.utils.tracing import zone
        with zone("bucket.addBatch"):
            self._add_batch_inner(current_ledger, protocol_version,
                                  init_entries, live_entries, dead_keys)

    def _add_batch_inner(self, current_ledger, protocol_version,
                         init_entries, live_entries, dead_keys):
        for i in range(NUM_LEVELS - 1, 0, -1):
            if level_should_spill(current_ledger, i - 1):
                spilled = self.levels[i - 1].take_snap()
                self.levels[i].commit()
                self.levels[i].prepare(
                    spilled, protocol_version,
                    keep_tombstones=(i < NUM_LEVELS - 1),
                    merge_with_empty_curr=should_merge_with_empty_curr(
                        current_ledger, i))
        # level 0 accumulates each ledger's batch into curr immediately
        # (reference: prepare(fresh) then commit in the same call) —
        # merged inline: the result is needed this very close, so a
        # worker round-trip would only add latency
        self.levels[0].curr = merge_buckets(
            self.levels[0].curr,
            fresh_bucket(protocol_version, init_entries, live_entries,
                         dead_keys),
            protocol_version, keep_tombstones=True)
        self.levels[0]._next = None

    # ---------------- lookups (the BucketListDB role) ----------------

    def get(self, kb: bytes):
        """Newest-first point lookup across levels; returns the live
        LedgerEntry or None (dead/absent) (reference
        ``SearchableBucketListSnapshot::load``)."""
        for lev in self.levels:
            for bucket in (lev.curr, lev.snap):
                e = bucket.get(kb)
                if e is not None:
                    if e.arm == BucketEntryType.DEADENTRY:
                        return None
                    return e.value
        return None

    def all_buckets(self) -> List[Bucket]:
        out = []
        for lev in self.levels:
            out.append(lev.curr)
            out.append(lev.snap)
            if lev.next is not None:
                out.append(lev.next)
        return out

    def total_entry_count(self) -> int:
        return sum(len(b.entries) for lev in self.levels
                   for b in (lev.curr, lev.snap))
