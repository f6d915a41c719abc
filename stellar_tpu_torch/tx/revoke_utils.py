"""Authorization-revocation side effects (reference
``src/transactions/TransactionUtils.cpp``
``removeOffersAndPoolShareTrustLines``): when a trustline drops below
AUTHORIZED_TO_MAINTAIN_LIABILITIES, the trustor's offers in that asset
are deleted and every pool-share trustline using the asset is redeemed —
its pro-rata pool balances become unconditional claimable balances for
the trustor, reserves going to whoever backed the trustline.

The port's copy of ``stellar_tpu/tx/revoke_utils.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import Optional

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, LedgerTxnError
from stellar_tpu_torch.tx import sponsorship as sp
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_native, liquidity_pool_key, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import account_key
from stellar_tpu_torch.xdr.runtime import Packer, to_bytes
from stellar_tpu_torch.xdr.types import (
    Asset, AssetType, CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG,
    ClaimPredicate, ClaimPredicateType, Claimant, ClaimantV0,
    ClaimableBalanceEntry, ClaimableBalanceID, ClaimableBalanceIDType,
    EnvelopeType, LedgerEntry, LedgerEntryType, PublicKey,
    TRUSTLINE_CLAWBACK_ENABLED_FLAG,
)

__all__ = ["remove_offers_and_pool_share_trust_lines", "revoke_balance_id"]

LOW_RESERVE = "LOW_RESERVE"
TOO_MANY_SPONSORING = "TOO_MANY_SPONSORING"


def revoke_balance_id(tx_source_id, tx_seq: int, op_index: int,
                      pool_id: bytes, asset) -> "ClaimableBalanceID.Value":
    """SHA-256 of HashIDPreimage{ENVELOPE_TYPE_POOL_REVOKE_OP_ID,
    revokeID} (reference ``getRevokeID``)."""
    p = Packer()
    p.pack_int(EnvelopeType.ENVELOPE_TYPE_POOL_REVOKE_OP_ID)
    PublicKey.pack(p, tx_source_id)
    p.pack_hyper(tx_seq)
    p.pack_uint(op_index)
    p.pack_fopaque(32, pool_id)
    Asset.pack(p, asset)
    return ClaimableBalanceID.make(
        ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
        sha256(p.bytes()))


def _remove_offers_by_account_and_asset(outer, trustor_id, asset):
    """Delete the trustor's offers buying or selling the asset
    (reference ``removeOffersByAccountAndAsset``)."""
    from stellar_tpu_torch.tx import offer_exchange as ox
    asset_b = to_bytes(Asset, asset)
    with LedgerTxn(outer) as ltx:
        header = ltx.header()
        doomed = []
        for le in ltx.all_entries_of_type(LedgerEntryType.OFFER):
            o = le.data.value
            if o.sellerID != trustor_id:
                continue
            if to_bytes(Asset, o.selling) != asset_b and \
                    to_bytes(Asset, o.buying) != asset_b:
                continue
            doomed.append(o.offerID)
        for offer_id in doomed:
            key = ox.offer_key(trustor_id, offer_id)
            le = ltx.load_without_record(key)
            ox.release_offer_liabilities(ltx, le.data.value)
            ltx.erase(key)
            with ltx.load(account_key(trustor_id)) as acc:
                sp.remove_entry_with_possible_sponsorship(
                    ltx, header, le, acc.entry)
        ltx.commit()


def _trustline_backer(tl_le):
    """Who holds the reserve for a trustline: its sponsor, else its
    owner (reference ``getTrustLineBacker``)."""
    sid = sp.get_sponsoring_id(tl_le)
    return sid if sid is not None else tl_le.data.value.accountID


def _redeem_into_claimable_balance(ltx, header, trustor_id, backer_id,
                                   tx_source_id, tx_seq, op_index,
                                   pool_id, asset, amount) -> Optional[str]:
    """One redeemed pool constituent -> unconditional claimable balance
    (reference lambda in removeOffersAndPoolShareTrustLines)."""
    if amount == 0 or (not is_native(asset) and
                       get_issuer(asset) == trustor_id):
        return None
    pred = ClaimPredicate.make(
        ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL)
    flags = 0
    if not is_native(asset):
        tl = ltx.load_without_record(trustline_key(trustor_id, asset))
        if tl is not None and \
                tl.data.value.flags & TRUSTLINE_CLAWBACK_ENABLED_FLAG:
            flags = CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG
    from stellar_tpu_torch.tx.ops.claimable_balances import _cb_ext
    cb = ClaimableBalanceEntry(
        balanceID=revoke_balance_id(tx_source_id, tx_seq, op_index,
                                    pool_id, asset),
        claimants=[Claimant.make(0, ClaimantV0(
            destination=trustor_id, predicate=pred))],
        asset=asset, amount=amount, ext=_cb_ext(flags))
    cb_le = LedgerEntry(
        lastModifiedLedgerSeq=header.ledgerSeq,
        data=LedgerEntry._types[1].make(
            LedgerEntryType.CLAIMABLE_BALANCE, cb),
        ext=LedgerEntry._types[2].make(0))

    if sp.load_sponsorship(ltx, backer_id) is not None:
        # the backer is inside a sponsorship sandwich: its sponsor takes
        # the claimable balance, with full reserve checks
        with ltx.load(account_key(backer_id)) as backer:
            res = sp.create_entry_with_possible_sponsorship(
                ltx, header, cb_le, backer.entry)
        if res == sp.SponsorshipResult.LOW_RESERVE:
            return LOW_RESERVE
        if res == sp.SponsorshipResult.TOO_MANY_SPONSORING:
            return TOO_MANY_SPONSORING
        if res != sp.SponsorshipResult.SUCCESS:
            raise LedgerTxnError("unexpected sponsorship result on revoke")
    else:
        # the claimable balance inherits the reserve the trustline held —
        # no LOW_RESERVE even if base reserve has risen since
        with ltx.load(account_key(backer_id)) as backer:
            mult = sp.compute_multiplier(cb_le)
            if sp.get_num_sponsoring(backer.entry) > sp.UINT32_MAX - mult:
                raise LedgerTxnError("no numSponsoring available for revoke")
            sp.establish_entry_sponsorship(cb_le, backer.entry, None)
    ltx.create(cb_le).deactivate()
    return None


def remove_offers_and_pool_share_trust_lines(
        outer, trustor_id, asset, tx_source_id, tx_seq: int,
        op_index: int) -> Optional[str]:
    """Returns None on success, else LOW_RESERVE / TOO_MANY_SPONSORING
    (reference ``removeOffersAndPoolShareTrustLines``)."""
    _remove_offers_by_account_and_asset(outer, trustor_id, asset)

    asset_b = to_bytes(Asset, asset)
    with LedgerTxn(outer) as ltx:
        header = ltx.header()
        # pool-share trustlines of the trustor whose pool uses the asset
        doomed = []
        for le in ltx.all_entries_of_type(LedgerEntryType.TRUSTLINE):
            tl = le.data.value
            if tl.accountID != trustor_id or \
                    tl.asset.arm != AssetType.ASSET_TYPE_POOL_SHARE:
                continue
            pool = ltx.load_without_record(
                liquidity_pool_key(tl.asset.value))
            if pool is None:
                raise LedgerTxnError("pool share trustline without pool")
            params = pool.data.value.body.value.params
            if to_bytes(Asset, params.assetA) == asset_b or \
                    to_bytes(Asset, params.assetB) == asset_b:
                doomed.append((tl.asset.value, tl.balance))
        for pool_id, balance in doomed:
            from stellar_tpu_torch.tx.asset_utils import (
                pool_share_trustline_key,
            )
            tlk = pool_share_trustline_key(trustor_id, pool_id)
            tl_le = ltx.load_without_record(tlk)
            backer_id = _trustline_backer(tl_le)
            # release reserves + delete the pool share trustline
            with ltx.load(account_key(trustor_id)) as acc:
                sp.remove_entry_with_possible_sponsorship(
                    ltx, header, tl_le, acc.entry)
            ltx.erase(tlk)

            pk = liquidity_pool_key(pool_id)
            pool_h = ltx.load(pk)
            cp = pool_h.data.body.value
            params = cp.params
            if balance != 0:
                from stellar_tpu_torch.tx.ops.liquidity_pool_ops import (
                    pool_withdrawal_amount,
                )
                amount_a = pool_withdrawal_amount(
                    balance, cp.totalPoolShares, cp.reserveA)
                amount_b = pool_withdrawal_amount(
                    balance, cp.totalPoolShares, cp.reserveB)
                pool_h.deactivate()
                for a, amt in ((params.assetA, amount_a),
                               (params.assetB, amount_b)):
                    fail = _redeem_into_claimable_balance(
                        ltx, header, trustor_id, backer_id, tx_source_id,
                        tx_seq, op_index, pool_id, a, amt)
                    if fail is not None:
                        return fail
                pool_h = ltx.load(pk)
                cp = pool_h.data.body.value
                cp.totalPoolShares -= balance
                cp.reserveA -= amount_a
                cp.reserveB -= amount_b
            # unpin the constituent trustlines + drop the share reference
            from stellar_tpu_torch.tx.ops.trust_ops import (
                decrement_liquidity_pool_use_count,
                decrement_pool_shares_trust_line_count,
            )
            pool_h.deactivate()
            for a in (params.assetA, params.assetB):
                decrement_liquidity_pool_use_count(ltx, a, trustor_id)
            decrement_pool_shares_trust_line_count(ltx, pool_id)
        ltx.commit()
    return None
