"""Account/trustline balance arithmetic (reference
``src/transactions/TransactionUtils.cpp``): reserves, liabilities,
available balance, and checked balance mutation.

All functions operate on XDR values (AccountEntry / TrustLineEntry inside
LedgerEntry) under current-protocol semantics (>= 19: liabilities,
sponsorship extensions always consulted when present).

The port's copy of ``stellar_tpu/tx/account_utils.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import Optional

from stellar_tpu_torch.xdr.types import (
    AUTHORIZED_FLAG, AccountEntry, AssetType, LedgerEntry, LedgerEntryType,
    THRESHOLD_HIGH, THRESHOLD_LOW, THRESHOLD_MASTER_WEIGHT, THRESHOLD_MED,
    TrustLineEntry,
)

INT64_MAX = 0x7FFFFFFFFFFFFFFF

__all__ = [
    "INT64_MAX", "account_ext_v2", "get_min_balance",
    "get_selling_liabilities", "get_buying_liabilities",
    "get_available_balance", "get_max_amount_receive", "add_balance",
    "is_authorized", "is_authorized_to_maintain_liabilities",
    "get_starting_sequence_number", "threshold", "add_num_entries",
    "has_account_entry_ext_v2",
]


def _account_ext_v1(acc: AccountEntry):
    return acc.ext.value if acc.ext.arm == 1 else None


def account_ext_v2(acc: AccountEntry):
    v1 = _account_ext_v1(acc)
    if v1 is not None and v1.ext.arm == 2:
        return v1.ext.value
    return None


def has_account_entry_ext_v2(acc: AccountEntry) -> bool:
    return account_ext_v2(acc) is not None


def get_min_balance(header, acc: AccountEntry) -> int:
    """(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve
    (reference ``getMinBalance``, TransactionUtils.cpp)."""
    v2 = account_ext_v2(acc)
    num_sponsoring = v2.numSponsoring if v2 else 0
    num_sponsored = v2.numSponsored if v2 else 0
    eff = 2 + acc.numSubEntries + num_sponsoring - num_sponsored
    if eff < 0:
        raise ValueError("unexpected account state")
    return eff * header.baseReserve


def _entry_liabilities(le: LedgerEntry):
    d = le.data
    if d.arm == LedgerEntryType.ACCOUNT:
        v1 = _account_ext_v1(d.value)
        return v1.liabilities if v1 is not None else None
    if d.arm == LedgerEntryType.TRUSTLINE:
        tl: TrustLineEntry = d.value
        return tl.ext.value.liabilities if tl.ext.arm == 1 else None
    raise ValueError("liabilities only on account/trustline")


def get_selling_liabilities(le: LedgerEntry) -> int:
    liab = _entry_liabilities(le)
    return liab.selling if liab is not None else 0


def get_buying_liabilities(le: LedgerEntry) -> int:
    liab = _entry_liabilities(le)
    return liab.buying if liab is not None else 0


def is_authorized(tl: TrustLineEntry) -> bool:
    return bool(tl.flags & AUTHORIZED_FLAG)


def is_authorized_to_maintain_liabilities(tl: TrustLineEntry) -> bool:
    from stellar_tpu_torch.xdr.types import (
        AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG,
    )
    # pool-share trustlines carry no auth flags and are always considered
    # authorized (reference TransactionUtils.cpp:1027-1034)
    if tl.asset.arm == AssetType.ASSET_TYPE_POOL_SHARE:
        return True
    return bool(tl.flags & (AUTHORIZED_FLAG |
                            AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG))


def get_available_balance(header, le: LedgerEntry) -> int:
    """Spendable balance over reserve+selling liabilities (reference
    ``getAvailableBalance``)."""
    d = le.data
    if d.arm == LedgerEntryType.ACCOUNT:
        avail = d.value.balance - get_min_balance(header, d.value)
    elif d.arm == LedgerEntryType.TRUSTLINE:
        avail = d.value.balance
    else:
        raise ValueError("unknown entry type for balance")
    return avail - get_selling_liabilities(le)


def get_max_amount_receive(header, le: LedgerEntry) -> int:
    """Headroom to the limit (trustline) / INT64_MAX (account), minus
    buying liabilities (reference ``getMaxAmountReceive``)."""
    d = le.data
    if d.arm == LedgerEntryType.ACCOUNT:
        return INT64_MAX - d.value.balance - get_buying_liabilities(le)
    if d.arm == LedgerEntryType.TRUSTLINE:
        tl = d.value
        # Maintain-liabilities suffices (reference checkAuthorization,
        # TransactionUtils.cpp, protocol >= 10): offers held by an account
        # whose trustline was downgraded to AUTHORIZED_TO_MAINTAIN_
        # LIABILITIES must still cross. Full-authorization checks are the
        # op frames' job.
        if not is_authorized_to_maintain_liabilities(tl):
            return 0
        return tl.limit - tl.balance - get_buying_liabilities(le)
    raise ValueError("unknown entry type for receive headroom")


def add_balance(header, le: LedgerEntry, delta: int) -> bool:
    """Checked balance mutation honoring reserve, limit, and liabilities
    (reference ``addBalance(LedgerTxnHeader&, LedgerTxnEntry&, int64_t)``).
    Returns False (entry untouched) if the mutation is not allowed."""
    d = le.data
    if d.arm == LedgerEntryType.ACCOUNT:
        acc = d.value
        new_balance = acc.balance + delta
        if not (0 <= new_balance <= INT64_MAX):
            return False
        if delta < 0:
            min_balance = get_min_balance(header, acc)
            if new_balance - min_balance < get_selling_liabilities(le):
                return False
        else:
            if new_balance > INT64_MAX - get_buying_liabilities(le):
                return False
        acc.balance = new_balance
        return True
    if d.arm == LedgerEntryType.TRUSTLINE:
        tl = d.value
        if delta == 0:
            return True
        # Same gating as get_max_amount_receive: maintain-liabilities
        # authorization is enough to move balance during offer crossing;
        # ops that require full authorization check it themselves.
        if not is_authorized_to_maintain_liabilities(tl):
            return False
        new_balance = tl.balance + delta
        if not (0 <= new_balance <= tl.limit):
            return False
        if delta < 0:
            if new_balance < get_selling_liabilities(le):
                return False
        else:
            if new_balance > tl.limit - get_buying_liabilities(le):
                return False
        tl.balance = new_balance
        return True
    raise ValueError("cannot add balance to this entry type")


def get_starting_sequence_number(ledger_seq: int) -> int:
    """Seq num for accounts created in ``ledger_seq``: seq << 32
    (reference ``getStartingSequenceNumber``)."""
    if ledger_seq > 0x7FFFFFFF:
        raise OverflowError("ledger seq out of range")
    return ledger_seq << 32


def threshold(acc: AccountEntry, idx: int) -> int:
    """thresholds[idx] as unsigned byte; idx 0 is master weight."""
    return acc.thresholds[idx]


def add_num_entries(header, acc: AccountEntry, delta: int) -> bool:
    """Adjust numSubEntries, enforcing the reserve when adding
    (reference ``addNumEntries``). Returns False on low reserve."""
    new_count = acc.numSubEntries + delta
    if new_count < 0:
        raise ValueError("negative numSubEntries")
    if delta > 0:
        v2 = account_ext_v2(acc)
        num_sponsoring = v2.numSponsoring if v2 else 0
        num_sponsored = v2.numSponsored if v2 else 0
        eff = 2 + new_count + num_sponsoring - num_sponsored
        if acc.balance < eff * header.baseReserve:
            return False
    acc.numSubEntries = new_count
    return True
