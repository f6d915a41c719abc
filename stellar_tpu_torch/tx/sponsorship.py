"""Sponsorship accounting (reference ``src/transactions/SponsorshipUtils.cpp``).

Protocol-14+ sponsored reserves, under this framework's >=19 floor so every
reference version gate is unconditionally on:

* Every ledger entry may carry a ``sponsoringID`` (LedgerEntryExtensionV1):
  that account pays the entry's base-reserve multiple instead of the owner.
* Accounts track ``numSponsoring`` / ``numSponsored`` (+ per-signer
  ``signerSponsoringIDs``) in AccountEntryExtensionV2; these feed
  ``get_min_balance``.
* While a transaction runs, active BeginSponsoringFutureReserves directives
  live as *internal* (non-XDR) LedgerTxn entries — reference
  ``InternalLedgerEntry`` SPONSORSHIP (sponsored -> sponsoring) and
  SPONSORSHIP_COUNTER (sponsoring -> count). They are tx-scoped:
  ``TransactionFrame`` fails the tx (txBAD_SPONSORSHIP) if any survive the
  last operation.

Key layout for internal entries: ``b"S" + ed25519`` maps a sponsored
account to its sponsor's raw key; ``b"C" + ed25519`` holds a sponsor's
active-directive count.

The port's copy of ``stellar_tpu/tx/sponsorship.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import Optional

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxnError
from stellar_tpu_torch.tx.account_utils import (
    account_ext_v2, get_available_balance, get_min_balance,
)
from stellar_tpu_torch.tx.op_frame import account_key
from stellar_tpu_torch.xdr.types import (
    AccountEntry, AccountEntryExtensionV1, AccountEntryExtensionV2,
    AssetType, LedgerEntry, LedgerEntryExtensionV1, LedgerEntryType,
    Liabilities, _AccountEntryExt, _AEV1Ext, _AEV2Ext, account_ed25519,
    account_id,
)

__all__ = [
    "SponsorshipResult", "ACCOUNT_SUBENTRY_LIMIT",
    "sponsorship_key", "sponsorship_counter_key",
    "load_sponsorship", "load_sponsorship_counter",
    "has_sponsorship_entries",
    "get_num_sponsored", "get_num_sponsoring", "get_sponsoring_id",
    "prepare_account_ext_v2", "prepare_entry_ext_v1",
    "compute_multiplier", "is_subentry",
    "can_establish_entry_sponsorship", "can_remove_entry_sponsorship",
    "can_transfer_entry_sponsorship",
    "establish_entry_sponsorship", "remove_entry_sponsorship",
    "transfer_entry_sponsorship",
    "can_establish_signer_sponsorship", "can_remove_signer_sponsorship",
    "can_transfer_signer_sponsorship",
    "establish_signer_sponsorship", "remove_signer_sponsorship",
    "transfer_signer_sponsorship",
    "create_entry_with_possible_sponsorship",
    "remove_entry_with_possible_sponsorship",
    "create_signer_with_possible_sponsorship",
    "remove_signer_with_possible_sponsorship",
]

UINT32_MAX = 0xFFFFFFFF
ACCOUNT_SUBENTRY_LIMIT = 1000  # reference TransactionUtils.cpp:30


class SponsorshipResult:
    SUCCESS = 0
    LOW_RESERVE = 1
    TOO_MANY_SUBENTRIES = 2
    TOO_MANY_SPONSORING = 3
    TOO_MANY_SPONSORED = 4


# ---------------------------------------------------------------------------
# Internal (tx-scoped) sponsorship entries
# ---------------------------------------------------------------------------

def sponsorship_key(aid) -> bytes:
    """Internal key for the SPONSORSHIP entry of a sponsored account."""
    return b"S" + account_ed25519(aid)


def sponsorship_counter_key(aid) -> bytes:
    return b"C" + account_ed25519(aid)


def load_sponsorship(ltx, aid) -> Optional[bytes]:
    """Raw 32-byte key of the account sponsoring ``aid``'s future
    reserves, or None (reference ``loadSponsorship``)."""
    return ltx.get_internal(sponsorship_key(aid))


def load_sponsorship_counter(ltx, aid) -> Optional[int]:
    return ltx.get_internal(sponsorship_counter_key(aid))


def has_sponsorship_entries(ltx) -> bool:
    """Any sponsorship directive still active in this tx view?
    (reference ``LedgerTxn::hasSponsorshipEntry``)."""
    return ltx.has_live_internal(b"S")


# ---------------------------------------------------------------------------
# Extension plumbing
# ---------------------------------------------------------------------------

def _account_of(le: LedgerEntry) -> AccountEntry:
    if le.data.arm != LedgerEntryType.ACCOUNT:
        raise LedgerTxnError("expected an ACCOUNT entry")
    return le.data.value


def prepare_account_ext_v2(acc: AccountEntry) -> AccountEntryExtensionV2:
    """Upgrade the account ext chain to v2 in place (reference
    ``prepareAccountEntryExtensionV2``): v1 gets zero liabilities, v2 gets
    zero counters and one null signerSponsoringID per existing signer."""
    if acc.ext.arm == 0:
        acc.ext = _AccountEntryExt.make(1, AccountEntryExtensionV1(
            liabilities=Liabilities(buying=0, selling=0),
            ext=_AEV1Ext.make(0)))
    v1 = acc.ext.value
    if v1.ext.arm == 0:
        v1.ext = _AEV1Ext.make(2, AccountEntryExtensionV2(
            numSponsored=0, numSponsoring=0,
            signerSponsoringIDs=[None] * len(acc.signers),
            ext=_AEV2Ext.make(0)))
    return v1.ext.value


def _require_ext_v2(acc: AccountEntry) -> AccountEntryExtensionV2:
    v2 = account_ext_v2(acc)
    if v2 is None:
        raise LedgerTxnError("account ext v2 missing")
    return v2


def prepare_entry_ext_v1(le: LedgerEntry) -> LedgerEntryExtensionV1:
    """Upgrade a LedgerEntry to ext v1 in place (reference
    ``prepareLedgerEntryExtensionV1``)."""
    if le.ext.arm == 0:
        le.ext = LedgerEntry._types[2].make(1, LedgerEntryExtensionV1(
            sponsoringID=None,
            ext=LedgerEntryExtensionV1._types[1].make(0)))
    return le.ext.value


def get_sponsoring_id(le: LedgerEntry):
    """The entry's sponsoringID (AccountID value) or None."""
    if le.ext.arm == 1:
        return le.ext.value.sponsoringID
    return None


def get_num_sponsored(le: LedgerEntry) -> int:
    v2 = account_ext_v2(_account_of(le))
    return v2.numSponsored if v2 else 0


def get_num_sponsoring(le: LedgerEntry) -> int:
    v2 = account_ext_v2(_account_of(le))
    return v2.numSponsoring if v2 else 0


def _account_is_sponsor(sponsoring_id, sponsoring_le: LedgerEntry):
    if sponsoring_id is None or \
            sponsoring_id != _account_of(sponsoring_le).accountID:
        raise LedgerTxnError("sponsorship doesn't match")


# ---------------------------------------------------------------------------
# Multipliers and limits
# ---------------------------------------------------------------------------

def compute_multiplier(le: LedgerEntry) -> int:
    """Base-reserve multiples an entry costs (reference
    ``computeMultiplier``)."""
    t = le.data.arm
    if t == LedgerEntryType.ACCOUNT:
        return 2
    if t == LedgerEntryType.TRUSTLINE:
        is_pool = le.data.value.asset.arm == AssetType.ASSET_TYPE_POOL_SHARE
        return 2 if is_pool else 1
    if t in (LedgerEntryType.OFFER, LedgerEntryType.DATA):
        return 1
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        return len(le.data.value.claimants)
    raise LedgerTxnError("invalid entry type for sponsorship")


def is_subentry(le: LedgerEntry) -> bool:
    t = le.data.arm
    if t in (LedgerEntryType.ACCOUNT, LedgerEntryType.CLAIMABLE_BALANCE):
        return False
    if t in (LedgerEntryType.TRUSTLINE, LedgerEntryType.OFFER,
             LedgerEntryType.DATA):
        return True
    raise LedgerTxnError("invalid entry type for sponsorship")


def _sponsoring_subentry_sum_ok(acc_le: LedgerEntry, mult: int) -> bool:
    """numSponsoring + numSubEntries + mult must fit in uint32 (protocol
    >= 18 rule, ``isSponsoringSubentrySumIncreaseValid``)."""
    return (get_num_sponsoring(acc_le) + _account_of(acc_le).numSubEntries
            + mult) <= UINT32_MAX


def _too_many_sponsoring(acc_le: LedgerEntry, mult: int) -> bool:
    if get_num_sponsoring(acc_le) > UINT32_MAX - mult:
        return True
    return not _sponsoring_subentry_sum_ok(acc_le, mult)


def _too_many_subentries(acc_le: LedgerEntry, mult: int) -> bool:
    if _account_of(acc_le).numSubEntries > ACCOUNT_SUBENTRY_LIMIT - mult:
        return True
    return not _sponsoring_subentry_sum_ok(acc_le, mult)


# ---------------------------------------------------------------------------
# can-establish / can-remove / can-transfer helpers
# ---------------------------------------------------------------------------

def _can_establish_helper(header, sponsoring_le: LedgerEntry,
                          sponsored_le: Optional[LedgerEntry],
                          mult: int) -> int:
    reserve = mult * header.baseReserve
    if get_available_balance(header, sponsoring_le) < reserve:
        return SponsorshipResult.LOW_RESERVE
    if _too_many_sponsoring(sponsoring_le, mult):
        return SponsorshipResult.TOO_MANY_SPONSORING
    if sponsored_le is not None and \
            get_num_sponsored(sponsored_le) > UINT32_MAX - mult:
        return SponsorshipResult.TOO_MANY_SPONSORED
    return SponsorshipResult.SUCCESS


def _can_remove_helper(header, sponsoring_le: LedgerEntry,
                       sponsored_le: Optional[LedgerEntry],
                       mult: int) -> int:
    if get_num_sponsoring(sponsoring_le) < mult:
        raise LedgerTxnError("insufficient numSponsoring")
    if sponsored_le is not None and get_num_sponsored(sponsored_le) < mult:
        raise LedgerTxnError("insufficient numSponsored")
    reserve = mult * header.baseReserve
    if sponsored_le is not None and \
            get_available_balance(header, sponsored_le) < reserve:
        return SponsorshipResult.LOW_RESERVE
    return SponsorshipResult.SUCCESS


def can_establish_entry_sponsorship(header, le, sponsoring_le,
                                    sponsored_le) -> int:
    if le.ext.arm == 1 and le.ext.value.sponsoringID is not None:
        raise LedgerTxnError("sponsoring sponsored entry")
    return _can_establish_helper(header, sponsoring_le, sponsored_le,
                                 compute_multiplier(le))


def can_remove_entry_sponsorship(header, le, sponsoring_le,
                                 sponsored_le) -> int:
    if get_sponsoring_id(le) is None:
        raise LedgerTxnError("removing sponsorship on unsponsored entry")
    _account_is_sponsor(get_sponsoring_id(le), sponsoring_le)
    return _can_remove_helper(header, sponsoring_le, sponsored_le,
                              compute_multiplier(le))


def can_transfer_entry_sponsorship(header, le, old_sponsoring_le,
                                   new_sponsoring_le) -> int:
    if get_sponsoring_id(le) is None:
        raise LedgerTxnError("transferring sponsorship on unsponsored entry")
    _account_is_sponsor(get_sponsoring_id(le), old_sponsoring_le)
    mult = compute_multiplier(le)
    res = _can_remove_helper(header, old_sponsoring_le, None, mult)
    if res != SponsorshipResult.SUCCESS:
        return res
    return _can_establish_helper(header, new_sponsoring_le, None, mult)


def establish_entry_sponsorship(le, sponsoring_le, sponsored_le):
    mult = compute_multiplier(le)
    prepare_entry_ext_v1(le).sponsoringID = \
        _account_of(sponsoring_le).accountID
    prepare_account_ext_v2(_account_of(sponsoring_le)).numSponsoring += mult
    if sponsored_le is not None:
        prepare_account_ext_v2(_account_of(sponsored_le)).numSponsored += mult


def remove_entry_sponsorship(le, sponsoring_le, sponsored_le):
    ext = le.ext.value
    _account_is_sponsor(ext.sponsoringID, sponsoring_le)
    ext.sponsoringID = None
    mult = compute_multiplier(le)
    _require_ext_v2(_account_of(sponsoring_le)).numSponsoring -= mult
    if sponsored_le is not None:
        _require_ext_v2(_account_of(sponsored_le)).numSponsored -= mult


def transfer_entry_sponsorship(le, old_sponsoring_le, new_sponsoring_le):
    ext = le.ext.value
    _account_is_sponsor(ext.sponsoringID, old_sponsoring_le)
    mult = compute_multiplier(le)
    ext.sponsoringID = _account_of(new_sponsoring_le).accountID
    prepare_account_ext_v2(
        _account_of(new_sponsoring_le)).numSponsoring += mult
    _require_ext_v2(_account_of(old_sponsoring_le)).numSponsoring -= mult


# ---------------------------------------------------------------------------
# Signer sponsorship
# ---------------------------------------------------------------------------

def _signer_sponsoring_id(acc: AccountEntry, index: int):
    v2 = account_ext_v2(acc)
    if v2 is None:
        return None
    if index >= len(v2.signerSponsoringIDs):
        raise LedgerTxnError("bad signer sponsorships")
    return v2.signerSponsoringIDs[index]


def _is_signer_sponsored(index: int, sponsoring_le, sponsored_le) -> bool:
    sid = _signer_sponsoring_id(_account_of(sponsored_le), index)
    if sid is not None:
        _account_is_sponsor(sid, sponsoring_le)
        return True
    return False


def can_establish_signer_sponsorship(header, index, sponsoring_le,
                                     sponsored_le) -> int:
    if _is_signer_sponsored(index, sponsoring_le, sponsored_le):
        raise LedgerTxnError("bad signer sponsorship")
    return _can_establish_helper(header, sponsoring_le, sponsored_le, 1)


def can_remove_signer_sponsorship(header, index, sponsoring_le,
                                  sponsored_le) -> int:
    if not _is_signer_sponsored(index, sponsoring_le, sponsored_le):
        raise LedgerTxnError("bad signer sponsorship")
    return _can_remove_helper(header, sponsoring_le, sponsored_le, 1)


def can_transfer_signer_sponsorship(header, index, old_sponsoring_le,
                                    new_sponsoring_le, sponsored_le) -> int:
    if not _is_signer_sponsored(index, old_sponsoring_le, sponsored_le):
        raise LedgerTxnError("bad signer sponsorship")
    res = _can_remove_helper(header, old_sponsoring_le, None, 1)
    if res != SponsorshipResult.SUCCESS:
        return res
    return _can_establish_helper(header, new_sponsoring_le, None, 1)


def establish_signer_sponsorship(index, sponsoring_le, sponsored_le):
    v2 = prepare_account_ext_v2(_account_of(sponsored_le))
    v2.signerSponsoringIDs[index] = _account_of(sponsoring_le).accountID
    v2.numSponsored += 1
    prepare_account_ext_v2(_account_of(sponsoring_le)).numSponsoring += 1


def remove_signer_sponsorship(index, sponsoring_le, sponsored_le):
    v2 = _require_ext_v2(_account_of(sponsored_le))
    _account_is_sponsor(v2.signerSponsoringIDs[index], sponsoring_le)
    v2.signerSponsoringIDs[index] = None
    v2.numSponsored -= 1
    _require_ext_v2(_account_of(sponsoring_le)).numSponsoring -= 1


def transfer_signer_sponsorship(index, old_sponsoring_le, new_sponsoring_le,
                                sponsored_le):
    v2 = _require_ext_v2(_account_of(sponsored_le))
    _account_is_sponsor(v2.signerSponsoringIDs[index], old_sponsoring_le)
    v2.signerSponsoringIDs[index] = _account_of(new_sponsoring_le).accountID
    prepare_account_ext_v2(_account_of(new_sponsoring_le)).numSponsoring += 1
    _require_ext_v2(_account_of(old_sponsoring_le)).numSponsoring -= 1


# ---------------------------------------------------------------------------
# create/remove entry with or without sponsorship (the op-facing layer)
# ---------------------------------------------------------------------------

def _can_create_entry_without_sponsorship(header, le, acc_le) -> int:
    if le.data.arm != LedgerEntryType.ACCOUNT:
        mult = compute_multiplier(le)
        if _too_many_subentries(acc_le, mult):
            return SponsorshipResult.TOO_MANY_SUBENTRIES
        if get_available_balance(header, acc_le) < mult * header.baseReserve:
            return SponsorshipResult.LOW_RESERVE
    else:
        if _account_of(le).balance < get_min_balance(header,
                                                     _account_of(acc_le)):
            return SponsorshipResult.LOW_RESERVE
    return SponsorshipResult.SUCCESS


def _can_create_entry_with_sponsorship(header, le, sponsoring_le,
                                       sponsored_le) -> int:
    if sponsored_le is not None and is_subentry(le):
        if _too_many_subentries(sponsored_le, compute_multiplier(le)):
            return SponsorshipResult.TOO_MANY_SUBENTRIES
    return can_establish_entry_sponsorship(header, le, sponsoring_le,
                                           sponsored_le)


def _create_entry_without_sponsorship(le, acc_le):
    if is_subentry(le):
        _account_of(acc_le).numSubEntries += compute_multiplier(le)


def _create_entry_with_sponsorship(le, sponsoring_le, sponsored_le):
    if sponsored_le is not None:
        _create_entry_without_sponsorship(le, sponsored_le)
    establish_entry_sponsorship(le, sponsoring_le, sponsored_le)


def _load_account(ltx, aid):
    h = ltx.load(account_key(aid))
    if h is None:
        raise LedgerTxnError("sponsoring account does not exist")
    return h


def create_entry_with_possible_sponsorship(ltx, header, le: LedgerEntry,
                                           acc_le: Optional[LedgerEntry]
                                           ) -> int:
    """Charge the reserve for creating ``le`` to whoever owes it
    (reference ``createEntryWithPossibleSponsorship``).

    ``le`` is the about-to-be-created entry (mutated in place when a
    sponsoringID is recorded). ``acc_le`` is the owning account's mutable
    LedgerEntry — the op source for CLAIMABLE_BALANCE, the owner for
    subentries, ignored (may be None) when ``le`` is itself an ACCOUNT.
    The caller must not hold the *sponsoring* account's handle active.
    """
    is_account = le.data.arm == LedgerEntryType.ACCOUNT
    sponsored_le = le if is_account else acc_le
    owner_aid = _account_of(sponsored_le).accountID
    # Claimable balances are not subentries: no sponsored account, and the
    # creator self-sponsors when no directive is active.
    if le.data.arm == LedgerEntryType.CLAIMABLE_BALANCE:
        sponsored_param = None
    else:
        sponsored_param = sponsored_le

    sponsoring_raw = load_sponsorship(ltx, owner_aid)
    if sponsoring_raw is not None:
        with _load_account(ltx, account_id(sponsoring_raw)) as sp:
            res = _can_create_entry_with_sponsorship(
                header, le, sp.entry, sponsored_param)
            if res == SponsorshipResult.SUCCESS:
                _create_entry_with_sponsorship(le, sp.entry, sponsored_param)
        return res
    if sponsored_param is None:
        res = _can_create_entry_with_sponsorship(header, le, acc_le, None)
        if res == SponsorshipResult.SUCCESS:
            _create_entry_with_sponsorship(le, acc_le, None)
        return res
    res = _can_create_entry_without_sponsorship(header, le, sponsored_le)
    if res == SponsorshipResult.SUCCESS:
        _create_entry_without_sponsorship(le, sponsored_le)
    return res


def _can_remove_entry_without_sponsorship(le, acc_le):
    if le.data.arm != LedgerEntryType.ACCOUNT:
        if _account_of(acc_le).numSubEntries < compute_multiplier(le):
            raise LedgerTxnError("invalid account state")


def _can_remove_entry_with_sponsorship(le, sponsoring_le, sponsored_le):
    mult = compute_multiplier(le)
    if get_num_sponsoring(sponsoring_le) < mult:
        raise LedgerTxnError("invalid sponsoring account state")
    if le.data.arm == LedgerEntryType.ACCOUNT and \
            (sponsored_le is None or le is not sponsored_le):
        raise LedgerTxnError("invalid sponsored account")
    if sponsored_le is not None:
        if (le.data.arm != LedgerEntryType.ACCOUNT and
                _account_of(sponsored_le).numSubEntries < mult) or \
                get_num_sponsored(sponsored_le) < mult:
            raise LedgerTxnError("invalid sponsored account state")


def _remove_entry_without_sponsorship(le, acc_le):
    if le.data.arm != LedgerEntryType.ACCOUNT:
        _account_of(acc_le).numSubEntries -= compute_multiplier(le)


def _remove_entry_with_sponsorship(le, sponsoring_le, sponsored_le):
    if sponsored_le is not None:
        _remove_entry_without_sponsorship(le, sponsored_le)
    remove_entry_sponsorship(le, sponsoring_le, sponsored_le)


def remove_entry_with_possible_sponsorship(ltx, header, le: LedgerEntry,
                                           acc_le: Optional[LedgerEntry]):
    """Release the reserve for erasing ``le`` (reference
    ``removeEntryWithPossibleSponsorship``). Same conventions as the
    create counterpart; raises on inconsistent sponsorship state."""
    sid = get_sponsoring_id(le)
    if sid is not None:
        is_cb = le.data.arm == LedgerEntryType.CLAIMABLE_BALANCE
        sponsored_le = None if is_cb else \
            (le if le.data.arm == LedgerEntryType.ACCOUNT else acc_le)
        if acc_le is not None and _account_of(acc_le).accountID == sid:
            if not is_cb:
                raise LedgerTxnError(
                    "sponsoringID == source for non-claimable-balance entry")
            _can_remove_entry_with_sponsorship(le, acc_le, sponsored_le)
            _remove_entry_with_sponsorship(le, acc_le, sponsored_le)
        else:
            with _load_account(ltx, sid) as sp:
                _can_remove_entry_with_sponsorship(le, sp.entry, sponsored_le)
                _remove_entry_with_sponsorship(le, sp.entry, sponsored_le)
    else:
        owner_le = le if le.data.arm == LedgerEntryType.ACCOUNT else acc_le
        _can_remove_entry_without_sponsorship(le, owner_le)
        _remove_entry_without_sponsorship(le, owner_le)


# ---------------------------------------------------------------------------
# create/remove signer with or without sponsorship
# ---------------------------------------------------------------------------

def create_signer_with_possible_sponsorship(ltx, header,
                                            acc_le: LedgerEntry,
                                            index: int) -> int:
    """Charge the reserve for the signer already inserted at
    ``acc.signers[index]`` (reference
    ``createSignerWithPossibleSponsorship``). If the account has ext v2,
    the caller must have inserted a null signerSponsoringID at ``index``
    alongside the signer."""
    acc = _account_of(acc_le)
    sponsoring_raw = load_sponsorship(ltx, acc.accountID)
    if sponsoring_raw is not None:
        with _load_account(ltx, account_id(sponsoring_raw)) as sp:
            if _too_many_subentries(acc_le, 1):
                return SponsorshipResult.TOO_MANY_SUBENTRIES
            res = can_establish_signer_sponsorship(
                header, index, sp.entry, acc_le)
            if res == SponsorshipResult.SUCCESS:
                acc.numSubEntries += 1
                establish_signer_sponsorship(index, sp.entry, acc_le)
        return res
    if _too_many_subentries(acc_le, 1):
        return SponsorshipResult.TOO_MANY_SUBENTRIES
    if get_available_balance(header, acc_le) < header.baseReserve:
        return SponsorshipResult.LOW_RESERVE
    acc.numSubEntries += 1
    return SponsorshipResult.SUCCESS


def remove_signer_with_possible_sponsorship(ltx, header,
                                            acc_le: LedgerEntry,
                                            index: int):
    """Release the reserve for ``acc.signers[index]`` and erase the signer
    (+ its sponsoringID slot) in place (reference
    ``removeSignerWithPossibleSponsorship``)."""
    acc = _account_of(acc_le)
    sid = _signer_sponsoring_id(acc, index)
    if sid is not None:
        with _load_account(ltx, sid) as sp:
            if get_num_sponsoring(sp.entry) < 1:
                raise LedgerTxnError("invalid sponsoring account state")
            if acc.numSubEntries < 1 or get_num_sponsored(acc_le) < 1:
                raise LedgerTxnError("invalid sponsored account state")
            remove_signer_sponsorship(index, sp.entry, acc_le)
    else:
        if acc.numSubEntries < 1:
            raise LedgerTxnError("invalid account state")
    acc.numSubEntries -= 1
    v2 = account_ext_v2(acc)
    if v2 is not None:
        del v2.signerSponsoringIDs[index]
    del acc.signers[index]
