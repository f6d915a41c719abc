"""Eviction scan (reference ``BucketManager.h:299-308`` + the
background eviction thread): every close scans a bounded window of
Soroban state and evicts expired TEMPORARY entries — the entry and its
TTL row become DEADENTRYs in that ledger's bucket batch. From the
state-archival protocol, expired PERSISTENT entries are evicted too,
with their full entries handed back for the hot archive (reference
HotArchiveBucket); below it they stay behind their expired TTL until
restored.

The scan cursor rotates through the key space so large states amortize
across closes. The expensive part — enumerating every CONTRACT_DATA
key in the committed state (O(state) over bucket indexes) — runs OFF
the crank (reference ``startBackgroundEvictionScan``): after close N
the sorted key list is computed on the worker pool from the immutable
committed store, and at close N+1 the scan reconciles it with the
ltx's own delta, yielding BIT-IDENTICAL results to a synchronous
enumeration — backgrounding moves the work, never the outcome. The
bounded window (TTL checks, erases) stays synchronous because it is
consensus state mutation.

The port's copy of ``stellar_tpu/bucket/eviction.py``, with the port's
imports."""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["EvictionScanner"]


class EvictionScanner:
    def __init__(self, max_entries_per_scan: int = 100,
                 max_archive_entries: int = 0,
                 start_level: int = 0):
        self.max_entries = max_entries_per_scan
        # cap on PERSISTENT entries archived per close; 0 = unlimited
        # (reference TESTING_MAX_ENTRIES_TO_ARCHIVE under
        # OVERRIDE_EVICTION_PARAMS_FOR_TESTING)
        self.max_archive_entries = max_archive_entries
        # reference TESTING_STARTING_EVICTION_SCAN_LEVEL: the scan
        # begins at bucket level N, i.e. entries too recently modified
        # to have spilled that deep are not yet scan candidates.
        # 0 = scan everything (this implementation's flat default)
        self.start_level = start_level
        self._cursor: bytes = b""
        self._pending = None  # Future[List[bytes]] from prepare_async
        self._pending_store = None  # identity guard
        self._last_candidates = 0  # size of the latest enumeration

    # ---------------- consensus iterator persistence ----------------
    # this implementation scans one flat sorted enumeration, so the
    # persisted EVICTION_ITERATOR shape is (level 0, curr, offset) with
    # ``offset`` = the cursor's rank within it — deterministic for
    # every node and every replay of the same state (reference
    # persists its bucket-file scan position the same way so restarts
    # resume instead of rescanning from the top). ``scan`` records it
    # as ``last_iterator_state`` from the enumeration it already holds;
    # no second O(state) pass happens on the close path.

    last_iterator_state: tuple = (0, True, 0)

    def seed_from_iterator(self, store, offset: int) -> None:
        """Resume the scan at a persisted iterator offset (restart
        path): the cursor becomes the offset-th key of the current
        enumeration — the same quantization ``scan`` itself persists,
        so a restarted node and a continuously-running one hold the
        IDENTICAL cursor. Offset 0 resets without paying the O(state)
        enumeration (every fresh node passes through here)."""
        if offset <= 0:
            self._cursor = b""
            self.last_iterator_state = (0, True, 0)
            return
        from stellar_tpu_torch.xdr.types import LedgerEntryType
        keys = sorted(store.keys_of_type(LedgerEntryType.CONTRACT_DATA))
        if not keys:
            self._cursor = b""
            self.last_iterator_state = (0, True, 0)
        else:
            self._cursor = keys[min(offset, len(keys)) - 1]
            self.last_iterator_state = (0, True, min(offset, len(keys)))

    # ---------------- background enumeration ----------------

    def prepare_async(self, store) -> None:
        """Kick the CONTRACT_DATA key enumeration for the NEXT close on
        the worker pool. ``store`` must be the committed root store —
        immutable until that close's ltx commits, which happens after
        the scan consumes this result."""
        from stellar_tpu_torch.utils.workers import run_async
        from stellar_tpu_torch.xdr.types import LedgerEntryType

        def enumerate_keys():
            return sorted(store.keys_of_type(
                LedgerEntryType.CONTRACT_DATA))
        self._pending = run_async(enumerate_keys)
        self._pending_store = store

    def _candidate_keys(self, ltx) -> List[bytes]:
        """Sorted CONTRACT_DATA keys of the ltx's current state —
        from the precomputed enumeration + the ltx delta when
        available, else synchronously (first close, catchup)."""
        from stellar_tpu_torch.xdr.types import LedgerEntryType
        root = ltx
        while hasattr(root, "_parent"):
            root = root._parent
        if self._pending is not None and \
                self._pending_store is getattr(root, "store", None):
            base = self._pending.result()  # usually already done
            self._pending = None
            self._pending_store = None
            keys = set(base)
            t = LedgerEntryType.CONTRACT_DATA
            type_be = int(t).to_bytes(4, "big")
            for kb, (prev, cur) in ltx.get_delta().items():
                if kb[:4] != type_be:
                    continue
                if cur is None:
                    keys.discard(kb)
                else:
                    keys.add(kb)
            return sorted(keys)
        self._pending = None
        self._pending_store = None
        return sorted(ltx._all_keys_of_type(
            LedgerEntryType.CONTRACT_DATA))

    # ---------------- the (consensus) scan ----------------

    def scan(self, ltx, ledger_seq: int,
             archive_persistent: bool = False) -> Tuple[List, List]:
        """Erase expired Soroban entries via ``ltx``. Returns
        (evicted LedgerKeys, archived LedgerEntries) — the second list
        holds full PERSISTENT entries bound for the hot archive and is
        empty unless ``archive_persistent``."""
        from stellar_tpu_torch.soroban.host import ttl_key_for
        from stellar_tpu_torch.xdr.contract import ContractDataDurability
        from stellar_tpu_torch.xdr.runtime import from_bytes
        from stellar_tpu_torch.xdr.types import LedgerKey

        data_keys = self._candidate_keys(ltx)
        self._last_candidates = len(data_keys)
        if not data_keys:
            # empty enumeration: the persisted iterator resets to 0, so
            # the in-memory cursor must reset WITH it or a restarted
            # node (seeded to b"") and this one would later rotate
            # their scan windows from different start points
            self._cursor = b""
            self.last_iterator_state = (0, True, 0)
            return [], []
        # rotate: start after the cursor, wrap around
        start = 0
        for i, kb in enumerate(data_keys):
            if kb > self._cursor:
                start = i
                break
        window = (data_keys[start:] + data_keys[:start])[:self.max_entries]
        evicted = []
        archived = []
        min_age = 0
        if self.start_level > 0:
            from stellar_tpu_torch.bucket.bucket_list import level_half
            min_age = level_half(self.start_level - 1)
        for kb in window:
            data_key = from_bytes(LedgerKey, kb)
            entry = ltx.load_without_record(data_key)
            if entry is None:
                self._cursor = kb
                continue
            if min_age and \
                    ledger_seq - entry.lastModifiedLedgerSeq < min_age:
                # not old enough to have spilled to the starting level
                self._cursor = kb
                continue
            persistent = entry.data.value.durability != \
                ContractDataDurability.TEMPORARY
            if persistent and not archive_persistent:
                self._cursor = kb
                continue
            tk = ttl_key_for(data_key)
            ttl_entry = ltx.load_without_record(tk)
            if ttl_entry is not None and \
                    ttl_entry.data.value.liveUntilLedgerSeq >= ledger_seq:
                self._cursor = kb
                continue
            if persistent:
                if self.max_archive_entries and \
                        len(archived) >= self.max_archive_entries:
                    # archive cap reached: stop BEFORE advancing the
                    # cursor so the capped entry leads the next scan
                    break
                archived.append(entry)
            self._cursor = kb
            ltx.erase(data_key)
            if ttl_entry is not None:
                ltx.erase(tk)
            evicted.append(data_key)
        # iterator offset over the POST-eviction enumeration, derived
        # from the list already in hand (sorted; removals keep order)
        import bisect
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes as _kb
        gone = {_kb(k) for k in evicted}
        post = [k for k in data_keys if k not in gone]
        if not post:
            self._cursor = b""
            self.last_iterator_state = (0, True, 0)
        else:
            off = bisect.bisect_right(post, self._cursor)
            # snap the cursor to the persisted quantization: the raw
            # cursor may be a key this scan just ERASED, and a restarted
            # node seeded from the offset would otherwise hold a
            # slightly earlier cursor and scan a different window when
            # new keys land between the two
            self._cursor = post[off - 1] if off > 0 else b""
            self.last_iterator_state = (0, True, off)
        return evicted, archived
