"""Invariant checks (reference ``src/invariant/`` — pluggable
post-conditions run after each operation apply with the entry delta;
violation raises and halts the node).

Implemented: ConservationOfLumens, LedgerEntryIsValid,
AccountSubEntriesCountIsValid, LiabilitiesMatchOffers (subset),
SponsorshipCountIsValid. Enabled by config regex like the reference's
``INVARIANT_CHECKS``.

The port's copy of ``stellar_tpu/invariant/invariants.py``, with the
port's imports."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from stellar_tpu_torch.xdr.types import LedgerEntryType

__all__ = ["InvariantDoesNotHold", "Invariant", "InvariantManager",
           "ConservationOfLumens", "LedgerEntryIsValid",
           "AccountSubEntriesCountIsValid", "SponsorshipCountIsValid"]


class InvariantDoesNotHold(Exception):
    pass


class Invariant:
    name = "Invariant"

    def check_on_operation_apply(self, operation, result, delta,
                                 header) -> Optional[str]:
        """Return an error string on violation, None when fine."""
        return None


class ConservationOfLumens(Invariant):
    """Total native coins change only via fees (header feePool) —
    op deltas must conserve XLM (reference
    ``ConservationOfLumens.cpp``)."""
    name = "ConservationOfLumens"

    def check_on_operation_apply(self, operation, result, delta, header):
        total = 0
        for kb, (prev, cur) in delta.items():
            for entry, sign in ((prev, -1), (cur, +1)):
                if entry is None:
                    continue
                from stellar_tpu_torch.tx.asset_utils import is_native
                if entry.data.arm == LedgerEntryType.ACCOUNT:
                    total += sign * entry.data.value.balance
                elif entry.data.arm == LedgerEntryType.CLAIMABLE_BALANCE:
                    cb = entry.data.value
                    if is_native(cb.asset):
                        total += sign * cb.amount
                elif entry.data.arm == LedgerEntryType.LIQUIDITY_POOL:
                    # XLM parked in pool reserves still exists
                    # (reference calculateDeltaBalance LIQUIDITY_POOL arm)
                    cp = entry.data.value.body.value
                    if is_native(cp.params.assetA):
                        total += sign * cp.reserveA
                    if is_native(cp.params.assetB):
                        total += sign * cp.reserveB
        if total != 0:
            return (f"operation changed total lumens by {total}")
        return None


class LedgerEntryIsValid(Invariant):
    """Structural bounds on changed entries (reference
    ``LedgerEntryIsValid.cpp``)."""
    name = "LedgerEntryIsValid"

    INT64_MAX = 0x7FFFFFFFFFFFFFFF

    def check_on_operation_apply(self, operation, result, delta, header):
        for kb, (prev, cur) in delta.items():
            if cur is None:
                continue
            t = cur.data.arm
            v = cur.data.value
            if cur.lastModifiedLedgerSeq > header.ledgerSeq:
                return "entry lastModified in the future"
            if t == LedgerEntryType.ACCOUNT:
                if not (0 <= v.balance <= self.INT64_MAX):
                    return f"account balance out of range: {v.balance}"
                if v.seqNum < 0:
                    return "negative seqNum"
                if len(v.signers) > 20:
                    return "too many signers"
                weights_ok = all(0 < s.weight <= 255 for s in v.signers)
                if not weights_ok:
                    return "signer weight out of range"
            elif t == LedgerEntryType.TRUSTLINE:
                if not (0 <= v.balance <= v.limit):
                    return (f"trustline balance {v.balance} outside "
                            f"[0, {v.limit}]")
            elif t == LedgerEntryType.OFFER:
                if v.amount <= 0:
                    return "non-positive offer amount"
                if v.price.n <= 0 or v.price.d <= 0:
                    return "invalid offer price"
        return None


class AccountSubEntriesCountIsValid(Invariant):
    """numSubEntries deltas match created/erased subentries (reference
    ``AccountSubEntriesCountIsValid.cpp``)."""
    name = "AccountSubEntriesCountIsValid"

    SUBENTRY_TYPES = (LedgerEntryType.TRUSTLINE, LedgerEntryType.OFFER,
                      LedgerEntryType.DATA)

    def check_on_operation_apply(self, operation, result, delta, header):
        count_change: Dict[bytes, int] = {}
        declared_change: Dict[bytes, int] = {}
        for kb, (prev, cur) in delta.items():
            for entry, sign in ((prev, -1), (cur, +1)):
                if entry is None:
                    continue
                t = entry.data.arm
                v = entry.data.value
                if t in self.SUBENTRY_TYPES:
                    acc = v.accountID.value if t != LedgerEntryType.OFFER \
                        else v.sellerID.value
                    # pool-share trustlines cost 2 subentries
                    # (reference computeMultiplier)
                    weight = 2 if (t == LedgerEntryType.TRUSTLINE and
                                   v.asset.arm == 3) else 1
                    count_change[acc] = count_change.get(acc, 0) + \
                        sign * weight
                elif t == LedgerEntryType.ACCOUNT:
                    own = v.accountID.value
                    signer_count = len(v.signers)
                    declared = v.numSubEntries - signer_count
                    declared_change[own] = declared_change.get(own, 0) + \
                        sign * declared
        for acc, declared in declared_change.items():
            actual = count_change.get(acc, 0)
            if declared != actual:
                return (f"numSubEntries declared {declared} but entries "
                        f"changed by {actual}")
        return None


class SponsorshipCountIsValid(Invariant):
    """numSponsoring/numSponsored stay consistent (reference
    ``SponsorshipCountIsValid.cpp``, aggregate form)."""
    name = "SponsorshipCountIsValid"

    def check_on_operation_apply(self, operation, result, delta, header):
        from stellar_tpu_torch.tx.account_utils import account_ext_v2
        total = 0
        for kb, (prev, cur) in delta.items():
            for entry, sign in ((prev, -1), (cur, +1)):
                if entry is None or \
                        entry.data.arm != LedgerEntryType.ACCOUNT:
                    continue
                v2 = account_ext_v2(entry.data.value)
                if v2 is not None:
                    total += sign * (v2.numSponsoring - v2.numSponsored)
        # sponsoring - sponsored must be conserved except for claimable
        # balance create/claim (which sponsor entry reserves)
        cb_claimants = 0
        for kb, (prev, cur) in delta.items():
            for entry, sign in ((prev, -1), (cur, +1)):
                if entry is not None and entry.data.arm == \
                        LedgerEntryType.CLAIMABLE_BALANCE:
                    cb_claimants += sign * len(entry.data.value.claimants)
        if total != cb_claimants:
            return (f"sponsorship counts changed by {total}, entries "
                    f"account for {cb_claimants}")
        return None


class LiabilitiesMatchOffers(Invariant):
    """Changes in account/trustline liabilities must equal the change
    in liabilities implied by the account's offers (reference
    ``LiabilitiesMatchOffers.cpp``, delta form)."""
    name = "LiabilitiesMatchOffers"

    @staticmethod
    def _entry_liab(entry):
        """{(owner, asset_bytes): (selling, buying)} for one entry."""
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.types import Asset, NATIVE_ASSET
        t = entry.data.arm
        v = entry.data.value
        if t == LedgerEntryType.ACCOUNT:
            liab = v.ext.value.liabilities if v.ext.arm == 1 else None
            if liab is None:
                return {}
            key = (v.accountID.value, to_bytes(Asset, NATIVE_ASSET))
            return {key: (liab.selling, liab.buying)}
        if t == LedgerEntryType.TRUSTLINE:
            if v.asset.arm == 3:  # pool share: no liabilities
                return {}
            liab = (v.ext.value.liabilities
                    if v.ext.arm == 1 else None)
            if liab is None:
                return {}
            key = (v.accountID.value,
                   to_bytes(Asset, Asset.make(v.asset.arm, v.asset.value)))
            return {key: (liab.selling, liab.buying)}
        return {}

    @staticmethod
    def _offer_liab(entry):
        from stellar_tpu_torch.tx.asset_utils import get_issuer, is_native
        from stellar_tpu_torch.tx.offer_exchange import offer_liabilities
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.types import Asset
        o = entry.data.value
        selling, buying = offer_liabilities(o.price, o.amount)
        out = {}
        # an issuer's offers in its own asset carry no tracked
        # liabilities (no trustline exists; reference
        # addSellingLiabilities/addBuyingLiabilities issuer arm)
        for asset, pair in ((o.selling, (selling, 0)),
                            (o.buying, (0, buying))):
            if not is_native(asset) and \
                    get_issuer(asset) == o.sellerID:
                continue
            out[(o.sellerID.value, to_bytes(Asset, asset))] = pair
        return out

    def check_on_operation_apply(self, operation, result, delta, header):
        declared: Dict = {}
        implied: Dict = {}

        def add(acc, m, sign):
            for key, (s, b) in m.items():
                cs, cb = acc.get(key, (0, 0))
                acc[key] = (cs + sign * s, cb + sign * b)

        for kb, (prev, cur) in delta.items():
            for entry, sign in ((prev, -1), (cur, +1)):
                if entry is None:
                    continue
                t = entry.data.arm
                if t in (LedgerEntryType.ACCOUNT,
                         LedgerEntryType.TRUSTLINE):
                    add(declared, self._entry_liab(entry), sign)
                elif t == LedgerEntryType.OFFER:
                    add(implied, self._offer_liab(entry), sign)
        for key in set(declared) | set(implied):
            if declared.get(key, (0, 0)) != implied.get(key, (0, 0)):
                return (f"liability delta {declared.get(key, (0, 0))} != "
                        f"offer-implied {implied.get(key, (0, 0))}")
        return None


class OrderBookIsNotCrossed(Invariant):
    """No two live offers cross after an operation (reference
    ``OrderBookIsNotCrossed.cpp`` — stateful: keeps its own order-book
    mirror fed by deltas)."""
    name = "OrderBookIsNotCrossed"

    def __init__(self):
        from stellar_tpu_torch.xdr.runtime import to_bytes  # noqa: F401
        # (selling_bytes, buying_bytes) -> {offer_kb: (n, d)}
        self.book: Dict[Tuple[bytes, bytes], Dict[bytes, Tuple[int, int]]] \
            = {}

    def _pair(self, o):
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.types import Asset
        return (to_bytes(Asset, o.selling), to_bytes(Asset, o.buying))

    def check_on_operation_apply(self, operation, result, delta, header):
        touched = set()
        for kb, (prev, cur) in delta.items():
            for entry, present in ((prev, False), (cur, True)):
                if entry is None or \
                        entry.data.arm != LedgerEntryType.OFFER:
                    continue
                o = entry.data.value
                pair = self._pair(o)
                touched.add(pair)
                side = self.book.setdefault(pair, {})
                if present:
                    side[kb] = (o.price.n, o.price.d)
                elif not present and cur is None and kb in side:
                    del side[kb]
        # two sides cross when bestA.price * bestB.price < 1
        for selling, buying in touched:
            side_a = self.book.get((selling, buying), {})
            side_b = self.book.get((buying, selling), {})
            if not side_a or not side_b:
                continue
            an, ad = min(side_a.values(), key=lambda p: p[0] / p[1])
            bn, bd = min(side_b.values(), key=lambda p: p[0] / p[1])
            # a sells X for Y at an/ad; b sells Y for X at bn/bd;
            # crossed iff (an/ad) * (bn/bd) < 1
            if an * bn < ad * bd:
                return (f"order book crossed: {an}/{ad} vs {bn}/{bd}")
        return None


class ConstantProductInvariant(Invariant):
    """Pool trades may never decrease reserveA*reserveB (reference
    ``ConstantProductInvariant.cpp``); deposits/withdrawals (share
    count changes) are exempt."""
    name = "ConstantProductInvariant"

    def check_on_operation_apply(self, operation, result, delta, header):
        for kb, (prev, cur) in delta.items():
            if prev is None or cur is None:
                continue
            if cur.data.arm != LedgerEntryType.LIQUIDITY_POOL:
                continue
            old = prev.data.value.body.value
            new = cur.data.value.body.value
            if old.totalPoolShares != new.totalPoolShares:
                continue  # deposit/withdraw path
            if new.reserveA * new.reserveB < old.reserveA * old.reserveB:
                return ("pool constant product decreased: "
                        f"{old.reserveA}*{old.reserveB} -> "
                        f"{new.reserveA}*{new.reserveB}")
        return None


class BucketListIsConsistentWithDatabase(Invariant):
    """During catchup bucket-apply, the committed store must end up
    byte-identical to the bucket contents (reference
    ``BucketListIsConsistentWithDatabase.cpp`` via
    ``checkOnBucketApply``)."""
    name = "BucketListIsConsistentWithDatabase"

    def check_on_bucket_apply(self, bucket, store) -> Optional[str]:
        from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
        from stellar_tpu_torch.xdr.ledger import BucketEntryType
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.types import LedgerEntry, LedgerKey
        for e in bucket.entries:
            if e.arm == BucketEntryType.METAENTRY:
                continue
            if e.arm == BucketEntryType.DEADENTRY:
                kb = to_bytes(LedgerKey, e.value)
                if store.get(kb) is not None:
                    return "dead key still present after bucket apply"
                continue
            kb = key_bytes(entry_to_key(e.value))
            got = store.get(kb)
            if got is None:
                return "bucket entry missing from store"
            if to_bytes(LedgerEntry, got) != to_bytes(LedgerEntry, e.value):
                return "store entry differs from bucket entry"
        return None


ALL_INVARIANTS = [ConservationOfLumens, LedgerEntryIsValid,
                  AccountSubEntriesCountIsValid, SponsorshipCountIsValid,
                  LiabilitiesMatchOffers, OrderBookIsNotCrossed,
                  ConstantProductInvariant,
                  BucketListIsConsistentWithDatabase]


class InvariantManager:
    """Registry + dispatcher (reference ``InvariantManagerImpl``)."""

    def __init__(self, enabled_patterns: List[str] = ("#.*",)):
        self.invariants: List[Invariant] = []
        for cls in ALL_INVARIANTS:
            for pat in enabled_patterns:
                pat = pat.lstrip("#")
                if re.fullmatch(pat, cls.name) or pat == ".*":
                    self.invariants.append(cls())
                    break

    def check_on_operation_apply(self, operation, result, delta, header):
        for inv in self.invariants:
            err = inv.check_on_operation_apply(operation, result, delta,
                                               header)
            if err is not None:
                raise InvariantDoesNotHold(f"{inv.name}: {err}")

    def check_on_bucket_apply(self, bucket, store):
        """Catchup-side hook (reference ``checkOnBucketApply``,
        ``catchup/ApplyBucketsWork.cpp:224``): run after each bucket is
        folded into the store, oldest to newest."""
        for inv in self.invariants:
            fn = getattr(inv, "check_on_bucket_apply", None)
            if fn is None:
                continue
            err = fn(bucket, store)
            if err is not None:
                raise InvariantDoesNotHold(f"{inv.name}: {err}")
