"""Nested ledger-entry transaction trees (the LedgerTxn layer).

Re-design of the reference's ``src/ledger/LedgerTxn.h`` (the spec is the
comment block at ``LedgerTxn.h:40-140``): a hierarchy of in-memory
transactions over ledger entries where each level can create/load/erase
entries and either *commit* its net effect into its parent or *rollback*
to leave the parent untouched. The root of every hierarchy is a
:class:`LedgerTxnRoot` backed by a store (in-memory dict here; the
BucketList-backed store plugs in behind the same interface).

Semantics preserved from the reference:

* **Single child**: a transaction with an open child is *sealed* — any
  access through it raises (``LedgerTxn.h:67-75``).
* **Active-entry exclusivity**: a key can be loaded at most once at a time
  per transaction; handles must be deactivated (or the txn committed /
  rolled back) before reloading (``LedgerTxn.h:77-96``).
* **Commit/rollback**: commit folds the child's entry map and header into
  the parent; rollback discards it and reactivates the parent.
* **Deltas**: ``get_delta`` exposes (previous, current) pairs for
  invariant checks; ``get_changes`` produces ``LedgerEntryChanges`` meta
  (STATE+UPDATED / CREATED / REMOVED) like ``LedgerTxn::getChanges``.

Not carried over: C++ RAII handle lifetimes (Python handles deactivate
explicitly or via ``with``), and the multi-tier entry cache (the dict
store *is* the cache).

The port's copy of ``stellar_tpu/ledger/ledger_txn.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from stellar_tpu_torch.xdr.ledger import (
    LedgerEntryChange, LedgerEntryChangeType, LedgerHeader,
)
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import (
    LedgerEntry, LedgerEntryType, LedgerKey, LedgerKeyAccount,
    LedgerKeyClaimableBalance, LedgerKeyData, LedgerKeyLiquidityPool,
    LedgerKeyOffer, LedgerKeyTrustLine, LedgerKeyTtl,
)

__all__ = [
    "LedgerTxnError", "entry_to_key", "key_bytes", "copy_entry",
    "copy_header", "EntryHandle", "HeaderHandle", "LedgerTxn",
    "LedgerTxnRoot", "InMemoryLedgerStore",
]


class LedgerTxnError(Exception):
    """Misuse of the transaction protocol (sealed access, double-load,
    create-existing, load-missing-for-erase...)."""


def entry_to_key(entry: LedgerEntry):
    """LedgerKey for a LedgerEntry (reference ``LedgerEntryKey`` in
    ``src/ledger/LedgerHashUtils.h`` / ``InternalLedgerEntry``)."""
    d = entry.data
    t = d.arm
    v = d.value
    if t == LedgerEntryType.ACCOUNT:
        body = LedgerKeyAccount(accountID=v.accountID)
    elif t == LedgerEntryType.TRUSTLINE:
        body = LedgerKeyTrustLine(accountID=v.accountID, asset=v.asset)
    elif t == LedgerEntryType.OFFER:
        body = LedgerKeyOffer(sellerID=v.sellerID, offerID=v.offerID)
    elif t == LedgerEntryType.DATA:
        body = LedgerKeyData(accountID=v.accountID, dataName=v.dataName)
    elif t == LedgerEntryType.CLAIMABLE_BALANCE:
        body = LedgerKeyClaimableBalance(balanceID=v.balanceID)
    elif t == LedgerEntryType.LIQUIDITY_POOL:
        body = LedgerKeyLiquidityPool(liquidityPoolID=v.liquidityPoolID)
    elif t == LedgerEntryType.CONTRACT_DATA:
        from stellar_tpu_torch.xdr.contract import LedgerKeyContractData
        body = LedgerKeyContractData(contract=v.contract, key=v.key,
                                     durability=v.durability)
    elif t == LedgerEntryType.CONTRACT_CODE:
        from stellar_tpu_torch.xdr.contract import LedgerKeyContractCode
        body = LedgerKeyContractCode(hash=v.hash)
    elif t == LedgerEntryType.CONFIG_SETTING:
        from stellar_tpu_torch.xdr.types import LedgerKeyConfigSetting
        body = LedgerKeyConfigSetting(configSettingID=v.arm)
    elif t == LedgerEntryType.TTL:
        body = LedgerKeyTtl(keyHash=v.keyHash)
    else:
        raise LedgerTxnError(f"no key form for entry type {t}")
    return LedgerKey.make(t, body)


def key_bytes(key) -> bytes:
    """Canonical identity of a LedgerKey: its XDR encoding. Memoized
    on the key object (keys are build-then-use; mutating one after
    the first serialization would already corrupt any map keyed by
    it, so the memo introduces no new hazard)."""
    try:
        return key._xdr_cache
    except AttributeError:
        kb = to_bytes(LedgerKey, key)
        key._xdr_cache = kb
        return kb


def root_of(ltx):
    """The LedgerTxnRoot at the bottom of a transaction chain — the
    node-scoped anchor carrying e.g. the soroban network config."""
    node = ltx
    while isinstance(node, LedgerTxn):
        node = node._parent
    return node


def soroban_config_of(ltx):
    """The node's SorobanNetworkConfig via the root, or the process
    defaults when the chain isn't anchored to a LedgerManager (unit
    tests building bare roots)."""
    cfg = getattr(root_of(ltx), "soroban_config", None)
    if cfg is None:
        from stellar_tpu_torch.tx.ops.soroban_ops import default_soroban_config
        cfg = default_soroban_config()
    return cfg


def copy_entry(entry: LedgerEntry) -> LedgerEntry:
    """Deep copy via the compiled per-type copy plan (immutable leaves
    share identity; containers re-materialize) — every ltx load pays
    this, so it must not run the wire-format roundtrip."""
    return LedgerEntry.copy(entry)


def copy_header(header: LedgerHeader) -> LedgerHeader:
    return LedgerHeader.copy(header)


class EntryHandle:
    """Live reference to an entry inside a transaction.

    ``handle.entry`` is the mutable current state; mutations become part
    of the transaction's effect. ``erase()`` deletes the entry. The handle
    holds the key active until :meth:`deactivate` (or txn commit/rollback).
    Usable as a context manager.
    """

    __slots__ = ("_ltx", "_kb", "entry")

    def __init__(self, ltx: "LedgerTxn", kb: bytes, entry: LedgerEntry):
        self._ltx = ltx
        self._kb = kb
        self.entry = entry

    @property
    def data(self):
        """The type-specific body (AccountEntry, TrustLineEntry, ...)."""
        return self.entry.data.value

    def erase(self):
        if self._ltx is None:
            raise LedgerTxnError("handle is deactivated")
        self._ltx._check_open()
        self._ltx._erase_active(self._kb)
        self._ltx._active.discard(self._kb)
        self._ltx = None

    def deactivate(self):
        if self._ltx is not None:
            self._ltx._active.discard(self._kb)
            self._ltx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deactivate()
        return False


class HeaderHandle:
    __slots__ = ("_ltx", "header")

    def __init__(self, ltx: "LedgerTxn", header: LedgerHeader):
        self._ltx = ltx
        self.header = header

    def deactivate(self):
        self._ltx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deactivate()
        return False


class _Base:
    """Operations shared by LedgerTxn and LedgerTxnRoot (the reference's
    AbstractLedgerTxnParent role)."""

    def _get(self, kb: bytes) -> Optional[LedgerEntry]:
        raise NotImplementedError

    def _get_internal(self, ik: bytes):
        raise NotImplementedError

    def _internal_keys(self) -> Iterable[bytes]:
        raise NotImplementedError

    def _header(self) -> LedgerHeader:
        raise NotImplementedError

    def _all_keys_of_type(self, t) -> Iterable[bytes]:
        raise NotImplementedError

    # -- child bookkeeping --

    def _attach_child(self, child: "LedgerTxn"):
        if getattr(self, "_child", None) is not None:
            raise LedgerTxnError("transaction already has an open child")
        if not getattr(self, "_open", True):
            raise LedgerTxnError("parent transaction is closed")
        self._child = child

    def _detach_child(self):
        self._child = None

    def _check_not_sealed(self):
        if getattr(self, "_child", None) is not None:
            raise LedgerTxnError("sealed: open child transaction")


class LedgerTxn(_Base):
    """One level of the nested transaction tree."""

    def __init__(self, parent: _Base):
        parent._check_not_sealed()
        self._parent = parent
        parent._attach_child(self)
        self._child = None
        # kb -> LedgerEntry (current) | None (erased at this level)
        self._entries: Dict[bytes, Optional[LedgerEntry]] = {}
        # internal (non-XDR) entries: tx-scoped sponsorship bookkeeping
        # (reference InternalLedgerEntry SPONSORSHIP / SPONSORSHIP_COUNTER,
        # src/ledger/InternalLedgerEntry.h). Values are immutable scalars
        # (bytes / int) or None (erased); replace-on-write, same
        # commit/rollback lifecycle as ``_entries``.
        self._internal: Dict[bytes, object] = {}
        self._active: set = set()
        self._header_copy: Optional[LedgerHeader] = None
        self._open = True

    # ---------------- internals ----------------

    def _check_open(self):
        if not self._open:
            raise LedgerTxnError("transaction is closed")
        self._check_not_sealed()

    def _get(self, kb: bytes) -> Optional[LedgerEntry]:
        if kb in self._entries:
            return self._entries[kb]
        return self._parent._get(kb)

    def _header(self) -> LedgerHeader:
        if self._header_copy is not None:
            return self._header_copy
        return self._parent._header()

    def _all_keys_of_type(self, t) -> Iterable[bytes]:
        seen = set(self._entries)
        for kb in self._parent._all_keys_of_type(t):
            if kb not in seen:
                yield kb
        for kb, e in self._entries.items():
            if e is not None and e.data.arm == t:
                yield kb

    def _activate(self, kb: bytes):
        if kb in self._active:
            raise LedgerTxnError("entry already active (exclusivity)")
        self._active.add(kb)

    def _erase_active(self, kb: bytes):
        self._entries[kb] = None

    # ---------------- entry API ----------------

    def create(self, entry: LedgerEntry) -> EntryHandle:
        """Record a new entry; raises if it already exists
        (``LedgerTxn::create``)."""
        self._check_open()
        entry = copy_entry(entry)
        kb = key_bytes(entry_to_key(entry))
        if self._get(kb) is not None:
            raise LedgerTxnError("create: entry already exists")
        self._activate(kb)
        self._entries[kb] = entry
        return EntryHandle(self, kb, entry)

    def load(self, key) -> Optional[EntryHandle]:
        """Load an entry for update; None if absent (``LedgerTxn::load``)."""
        self._check_open()
        kb = key_bytes(key)
        cur = self._get(kb)
        if cur is None:
            return None
        self._activate(kb)
        if kb not in self._entries or self._entries[kb] is not cur:
            cur = copy_entry(cur)
        self._entries[kb] = cur
        return EntryHandle(self, kb, cur)

    def load_without_record(self, key) -> Optional[LedgerEntry]:
        """Read-only snapshot that does NOT become part of the delta
        (``loadWithoutRecord``). Always a copy, so stray mutation can
        never leak into the recorded delta."""
        self._check_open()
        cur = self._get(key_bytes(key))
        return None if cur is None else copy_entry(cur)

    def exists(self, key) -> bool:
        self._check_open()
        return self._get(key_bytes(key)) is not None

    def erase(self, key):
        """Erase an existing entry (``LedgerTxn::erase``)."""
        self._check_open()
        kb = key_bytes(key)
        if kb in self._active:
            raise LedgerTxnError("erase: entry is active")
        if self._get(kb) is None:
            raise LedgerTxnError("erase: entry does not exist")
        self._entries[kb] = None

    def all_entries_of_type(self, t) -> List[LedgerEntry]:
        """Snapshot of all live entries of a type, child shadowing parent
        (reference ``getAllOffers`` generalized)."""
        self._check_open()
        return [self._get(kb) for kb in self._all_keys_of_type(t)]

    # ---------------- internal (non-XDR) entry API ----------------

    def _get_internal(self, ik: bytes):
        if ik in self._internal:
            return self._internal[ik]
        return self._parent._get_internal(ik)

    def get_internal(self, ik: bytes):
        """Current value of an internal entry (None if absent/erased)."""
        self._check_open()
        return self._get_internal(ik)

    def set_internal(self, ik: bytes, value):
        """Set (or erase with None) an internal entry at this level."""
        self._check_open()
        self._internal[ik] = value

    def _internal_keys(self) -> Iterable[bytes]:
        yield from self._internal
        yield from self._parent._internal_keys()

    def has_live_internal(self, prefix: bytes) -> bool:
        """Any internal entry with this key prefix live in the current
        view? (reference ``LedgerTxn::hasSponsorshipEntry``)."""
        self._check_open()
        seen = set()
        for ik in self._internal_keys():
            if ik in seen:
                continue
            seen.add(ik)
            if ik.startswith(prefix) and self._get_internal(ik) is not None:
                return True
        return False

    # ---------------- header API ----------------

    def header(self) -> LedgerHeader:
        """Read-only view of the current header."""
        self._check_open()
        return self._header()

    def load_header(self) -> HeaderHandle:
        """Mutable header handle; changes commit with the txn."""
        self._check_open()
        if self._header_copy is None:
            self._header_copy = copy_header(self._parent._header())
        return HeaderHandle(self, self._header_copy)

    # ---------------- lifecycle ----------------

    def commit(self):
        """Fold effects into parent and close (``LedgerTxn::commit``)."""
        self._check_open()
        self._active.clear()
        self._parent._absorb(self._entries, self._header_copy,
                             self._internal)
        self._parent._detach_child()
        self._open = False

    def rollback(self):
        """Discard effects and close. An open child is rolled back first
        (the reference does the same, ``LedgerTxn.cpp`` rollback)."""
        if not self._open:
            raise LedgerTxnError("transaction is closed")
        if self._child is not None:
            self._child.rollback()
        self._active.clear()
        self._entries.clear()
        self._internal.clear()
        self._header_copy = None
        self._parent._detach_child()
        self._open = False

    def _absorb(self, entries: Dict[bytes, Optional[LedgerEntry]],
                header: Optional[LedgerHeader],
                internal: Optional[Dict[bytes, object]] = None):
        """Receive a committing child's effects."""
        self._entries.update(entries)
        if internal:
            self._internal.update(internal)
        if header is not None:
            self._header_copy = header

    # ---------------- deltas ----------------

    def get_delta(self) -> Dict[bytes, Tuple[Optional[LedgerEntry],
                                             Optional[LedgerEntry]]]:
        """kb -> (previous, current); previous is the parent's view
        (``LedgerTxn::getDelta`` → LedgerTxnDelta)."""
        self._check_open()
        out = {}
        for kb, cur in self._entries.items():
            prev = self._parent._get(kb)
            out[kb] = (prev, cur)
        return out

    def get_changes(self) -> list:
        """LedgerEntryChanges meta: STATE+UPDATED for modified entries,
        CREATED for new, REMOVED for erased (``LedgerTxn::getChanges``)."""
        changes = []
        for kb, (prev, cur) in sorted(self.get_delta().items()):
            if prev is None and cur is None:
                continue
            if prev is None:
                changes.append(LedgerEntryChange.make(
                    LedgerEntryChangeType.LEDGER_ENTRY_CREATED, cur))
            elif cur is None:
                changes.append(LedgerEntryChange.make(
                    LedgerEntryChangeType.LEDGER_ENTRY_REMOVED,
                    from_bytes(LedgerKey, kb)))
            else:
                changes.append(LedgerEntryChange.make(
                    LedgerEntryChangeType.LEDGER_ENTRY_STATE, prev))
                changes.append(LedgerEntryChange.make(
                    LedgerEntryChangeType.LEDGER_ENTRY_UPDATED, cur))
        return changes

    # context-manager sugar: rollback if still open
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._open:
            self.rollback()
        return False


class InMemoryLedgerStore:
    """Flat committed-state store: kb -> encoded LedgerEntry bytes.

    Keeping values encoded makes the store the natural feed for bucket
    hashing and keeps committed state immune to aliasing bugs.
    """

    def __init__(self):
        self.entries: Dict[bytes, bytes] = {}

    def get(self, kb: bytes) -> Optional[LedgerEntry]:
        raw = self.entries.get(kb)
        return None if raw is None else from_bytes(LedgerEntry, raw)

    def put(self, kb: bytes, entry: LedgerEntry):
        self.entries[kb] = to_bytes(LedgerEntry, entry)

    def delete(self, kb: bytes):
        self.entries.pop(kb, None)

    def keys_of_type(self, t) -> List[bytes]:
        # LedgerKey XDR starts with the int32 entry-type discriminant.
        return [kb for kb in self.entries
                if int.from_bytes(kb[:4], "big") == t]


class LedgerTxnRoot(_Base):
    """Root of a transaction hierarchy, backed by a committed store and
    the last-closed header (reference ``LedgerTxnRoot``)."""

    def __init__(self, store: Optional[InMemoryLedgerStore] = None,
                 header: Optional[LedgerHeader] = None):
        self.store = store if store is not None else InMemoryLedgerStore()
        self._hdr = header if header is not None else _genesis_header()
        self._child = None

    def _get(self, kb: bytes) -> Optional[LedgerEntry]:
        return self.store.get(kb)

    def _get_internal(self, ik: bytes):
        return None

    def _internal_keys(self) -> Iterable[bytes]:
        return ()

    def _header(self) -> LedgerHeader:
        return self._hdr

    def _all_keys_of_type(self, t) -> Iterable[bytes]:
        return self.store.keys_of_type(t)

    def _absorb(self, entries: Dict[bytes, Optional[LedgerEntry]],
                header: Optional[LedgerHeader],
                internal: Optional[Dict[bytes, object]] = None):
        # Internal entries are tx-scoped: TransactionFrame fails any tx
        # that leaves one live (txBAD_SPONSORSHIP), so only erasure
        # markers may ever reach the root.
        if internal:
            for ik, v in internal.items():
                if v is not None:
                    raise LedgerTxnError(
                        "internal entry leaked to committed state")
        for kb, e in entries.items():
            if e is None:
                self.store.delete(kb)
            else:
                self.store.put(kb, e)
        if header is not None:
            self._hdr = header

    def header(self) -> LedgerHeader:
        self._check_not_sealed()
        return self._hdr

    def set_header(self, header: LedgerHeader):
        self._check_not_sealed()
        self._hdr = header


def _genesis_header() -> LedgerHeader:
    """Genesis ledger header (reference ``LedgerManager::genesisLedger``,
    ``src/ledger/LedgerManagerImpl.cpp``): ledger 1, 100B lumens,
    baseFee 100, baseReserve 100000000 (GENESIS_LEDGER_BASE_RESERVE),
    maxTxSetSize 100."""
    from stellar_tpu_torch.xdr.ledger import basic_stellar_value
    return LedgerHeader(
        ledgerVersion=0,
        previousLedgerHash=b"\x00" * 32,
        scpValue=basic_stellar_value(b"\x00" * 32, 0),
        txSetResultHash=b"\x00" * 32,
        bucketListHash=b"\x00" * 32,
        ledgerSeq=1,
        totalCoins=100_000_000_000 * 10_000_000,  # 100B XLM in stroops
        feePool=0,
        inflationSeq=0,
        idPool=0,
        baseFee=100,
        baseReserve=100_000_000,
        maxTxSetSize=100,
        skipList=[b"\x00" * 32] * 4,
        ext=LedgerHeader._types[-1].make(0),
    )
