"""ManageSellOffer / ManageBuyOffer / CreatePassiveSellOffer (reference
``ManageOfferOpFrameBase.cpp``, ``ManageSellOfferOpFrame.cpp``,
``ManageBuyOfferOpFrame.cpp``, ``CreatePassiveSellOfferOpFrame.cpp``).

A buy offer is the sell offer at the inverse price whose wheat-receive
limit is the buy amount — exactly how the reference folds both into one
base. Current-protocol (>= 14) apply sequence: release old liabilities,
account the subentry up front, cross the opposing book at no worse than
the reciprocal price (passive offers refuse equality), re-adjust the
remainder to the owner's limits, then book it and acquire liabilities.

The port's copy of ``stellar_tpu/tx/ops/offers.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx import offer_exchange as ox
from stellar_tpu_torch.tx.account_utils import INT64_MAX
from stellar_tpu_torch.tx.sponsorship import (
    SponsorshipResult, create_entry_with_possible_sponsorship,
    remove_entry_with_possible_sponsorship,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_asset_valid, is_native, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, account_key, register_op,
)
from stellar_tpu_torch.tx.ops.trust_ops import TRUST_AUTH_FLAGS
from stellar_tpu_torch.xdr.results import (
    ManageBuyOfferResultCode, ManageOfferEffect, ManageOfferSuccessResult,
    ManageSellOfferResultCode, OperationResultCode,
)
from stellar_tpu_torch.xdr.tx import OperationType
from stellar_tpu_torch.xdr.types import (
    AUTHORIZED_FLAG, LedgerEntry, LedgerEntryType, OfferEntry, PASSIVE_FLAG,
    Price,
)




def _inverse(price: Price) -> Price:
    return Price(n=price.d, d=price.n)


def _price_valid(p: Price) -> bool:
    return p.n > 0 and p.d > 0


def new_offer_entry(seller_id, offer_id, selling, buying, amount, price,
                    flags, last_modified) -> LedgerEntry:
    oe = OfferEntry(sellerID=seller_id, offerID=offer_id, selling=selling,
                    buying=buying, amount=amount, price=price, flags=flags,
                    ext=OfferEntry._types[7].make(0))
    return LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=LedgerEntry._types[1].make(LedgerEntryType.OFFER, oe),
        ext=LedgerEntry._types[2].make(0))


class _ManageOfferBase(OperationFrame):
    """The shared engine. Subclasses define the (sheep, wheat, price,
    limits) view and result-code mapping."""

    CODES = None
    PREFIX = ""

    # -- per-subclass views --

    def sheep(self):      # what we sell
        return self.body.selling

    def wheat(self):      # what we buy
        return self.body.buying

    def offer_id(self) -> int:
        return self.body.offerID

    def price(self) -> Price:
        """Price of sheep in terms of wheat (the booked offer's price)."""
        raise NotImplementedError

    def is_delete(self) -> bool:
        raise NotImplementedError

    def passive_on_create(self) -> bool:
        return False

    def apply_specific_limits(self, sheep_send_limit, sheep_sent,
                              wheat_receive_limit, wheat_received):
        """Clamp limits to the op's amount semantics; returns the pair
        (reference ``applyOperationSpecificLimits``)."""
        raise NotImplementedError

    def _fail(self, name):
        return False, self.make_result(getattr(self.CODES,
                                               self.PREFIX + name))

    # -- validation --

    def do_check_valid(self, ledger_version: int):
        if not is_asset_valid(self.sheep(), ledger_version) or \
                not is_asset_valid(self.wheat(), ledger_version):
            return self._fail("MALFORMED")
        if self.sheep() == self.wheat():
            return self._fail("MALFORMED")
        if not _price_valid(self.body.price):
            return self._fail("MALFORMED")
        if not self._amount_valid() or self.offer_id() < 0:
            return self._fail("MALFORMED")
        if self.is_delete() and self.offer_id() == 0:
            return self._fail("NOT_FOUND")
        return True, None

    def _amount_valid(self) -> bool:
        raise NotImplementedError

    def _check_trust_and_auth(self, ltx):
        """Trustline existence/authorization for both assets (reference
        ``checkOfferValid``)."""
        src = self.source_account_id()
        for asset, side in ((self.sheep(), "SELL"), (self.wheat(), "BUY")):
            if is_native(asset) or get_issuer(asset) == src:
                continue
            tl = ltx.load_without_record(trustline_key(src, asset))
            if tl is None:
                return self._fail(f"{side}_NO_TRUST")
            if side == "SELL" and not (tl.data.value.flags & AUTHORIZED_FLAG):
                return self._fail("SELL_NOT_AUTHORIZED")
            if side == "BUY" and not (tl.data.value.flags & AUTHORIZED_FLAG):
                return self._fail("BUY_NOT_AUTHORIZED")
            if side == "SELL" and tl.data.value.balance == 0 and \
                    not self.is_delete():
                return self._fail("UNDERFUNDED")
        return True, None

    # -- apply --

    def do_apply(self, outer):
        src = self.source_account_id()
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            if not self.is_delete():
                ok, fail = self._check_trust_and_auth(ltx)
                if not ok:
                    return False, fail

            creating = self.offer_id() == 0
            passive = False
            # sponsorship extension carried from the modified offer, or
            # established up front for a new one (reference apply start:
            # "establishing the numSubEntries and sponsorship changes")
            ext = None
            if not creating:
                key = ox.offer_key(src, self.offer_id())
                h = ltx.load(key)
                if h is None:
                    ltx.rollback()
                    return self._fail("NOT_FOUND")
                old = h.data
                passive = bool(old.flags & PASSIVE_FLAG)
                ext = h.entry.ext
                h.deactivate()
                with ltx.load(key) as h2:
                    ox.release_offer_liabilities(ltx, h2.data)
                ltx.erase(key)
                # numSubEntries/sponsorship retained: the slot carries
                # over (or is released below on delete)
            else:
                passive = self.passive_on_create()
                template = new_offer_entry(src, 0, self.sheep(),
                                           self.wheat(), 0, self.price(),
                                           0, header.ledgerSeq)
                with ltx.load(account_key(src)) as acc_h:
                    res = create_entry_with_possible_sponsorship(
                        ltx, header, template, acc_h.entry)
                if res != SponsorshipResult.SUCCESS:
                    ltx.rollback()
                    return False, self.sponsorship_failure(
                        res, getattr(self.CODES,
                                     self.PREFIX + "LOW_RESERVE"))
                ext = template.ext

            atoms = []
            amount = 0
            if not self.is_delete():
                ok, fail, outcome, sheep_sent, wheat_received, atoms = \
                    self._cross(ltx, passive)
                if not ok:
                    ltx.rollback()
                    return False, fail
                # settle our own side of the crossings (reference doApply:
                # credit wheat received, debit sheep sent)
                if wheat_received > 0:
                    ox._transfer(ltx, src, self.wheat(), wheat_received)
                if sheep_sent > 0:
                    ox._transfer(ltx, src, self.sheep(), -sheep_sent)
                # a remainder is booked only when OUR side stayed hungry
                # (book dry or price wall); on eOK the taker side was
                # exhausted and nothing is re-booked (reference
                # sheepStays gating)
                sheep_stays = outcome in (ox.CROSS_PARTIAL,
                                          ox.CROSS_STOPPED_BAD_PRICE)
                if sheep_stays:
                    sheep_limit = ox._can_sell_at_most(
                        ltx, src, self.sheep())
                    wheat_limit = ox._can_buy_at_most(
                        ltx, src, self.wheat())
                    sheep_limit, wheat_limit = self.apply_specific_limits(
                        sheep_limit, sheep_sent, wheat_limit,
                        wheat_received)
                    amount = ox.adjust_offer_amount(
                        self.price(), sheep_limit, wheat_limit)

            success = ManageOfferSuccessResult(offersClaimed=atoms,
                                               offer=None)
            if amount > 0:
                if creating:
                    with ltx.load_header() as hh:
                        hh.header.idPool += 1
                        new_id = hh.header.idPool
                else:
                    new_id = self.offer_id()
                flags = PASSIVE_FLAG if passive else 0
                le = new_offer_entry(src, new_id, self.sheep(),
                                     self.wheat(), amount, self.price(),
                                     flags, header.ledgerSeq)
                if ext is not None:
                    le.ext = ext
                ltx.create(le).deactivate()
                with ltx.load(ox.offer_key(src, new_id)) as h:
                    if not ox.acquire_offer_liabilities(ltx, h.data):
                        ltx.rollback()
                        return self._fail("LINE_FULL")
                    booked = h.data
                    effect = ManageOfferEffect.MANAGE_OFFER_CREATED \
                        if creating else ManageOfferEffect.MANAGE_OFFER_UPDATED
                    success.offer = ManageOfferSuccessResult._types[1].make(
                        effect, _copy_offer(booked))
            else:
                # nothing booked: release the subentry slot + sponsorship
                le = new_offer_entry(src, 0, self.sheep(), self.wheat(),
                                     0, self.price(), 0, header.ledgerSeq)
                if ext is not None:
                    le.ext = ext
                with ltx.load(account_key(src)) as acc_h:
                    remove_entry_with_possible_sponsorship(
                        ltx, header, le, acc_h.entry)
                success.offer = ManageOfferSuccessResult._types[1].make(
                    ManageOfferEffect.MANAGE_OFFER_DELETED)
            ltx.commit()
        return True, self.make_result(
            getattr(self.CODES, self.PREFIX + "SUCCESS"), success)

    def _cross(self, ltx, passive):
        """Cross against the opposing book (reference doApply mid)."""
        src = self.source_account_id()
        sheep_limit = ox._can_sell_at_most(ltx, src, self.sheep())
        wheat_limit = ox._can_buy_at_most(ltx, src, self.wheat())
        # reserve room: our bid's liabilities must fit
        selling_liab, buying_liab = self._own_liabilities()
        if wheat_limit < buying_liab:
            f = self._fail("LINE_FULL")
            return False, f[1], None, 0, 0, []
        if sheep_limit < selling_liab:
            f = self._fail("UNDERFUNDED")
            return False, f[1], None, 0, 0, []
        max_sheep, max_wheat = self.apply_specific_limits(
            sheep_limit, 0, wheat_limit, 0)
        if max_wheat == 0:
            f = self._fail("LINE_FULL")
            return False, f[1], None, 0, 0, []

        max_wheat_price = _inverse(self.price())

        def offer_filter(offer):
            if (passive and _price_ge(offer.price, max_wheat_price)) or \
                    _price_gt(offer.price, max_wheat_price):
                return ox.CROSS_STOPPED_BAD_PRICE
            if offer.sellerID == src:
                return ox.CROSS_STOPPED_SELF
            return None

        outcome, sheep_sent, wheat_received, atoms = \
            ox.convert_with_offers(ltx, self.sheep(), max_sheep,
                                   self.wheat(), max_wheat,
                                   ox.ROUND_NORMAL, offer_filter)
        if outcome == ox.CROSS_STOPPED_SELF:
            f = self._fail("CROSS_SELF")
            return False, f[1], None, 0, 0, []
        if outcome == ox.CROSS_TOO_MANY:
            return False, OperationFrame.make_top_result(
                OperationResultCode.opEXCEEDED_WORK_LIMIT), None, 0, 0, []
        return True, None, outcome, sheep_sent, wheat_received, atoms

    def _own_liabilities(self):
        raise NotImplementedError


def _copy_offer(oe: OfferEntry) -> OfferEntry:
    from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
    return from_bytes(OfferEntry, to_bytes(OfferEntry, oe))


def _price_gt(a: Price, b: Price) -> bool:
    return a.n * b.d > b.n * a.d


def _price_ge(a: Price, b: Price) -> bool:
    return a.n * b.d >= b.n * a.d


@register_op(OperationType.MANAGE_SELL_OFFER)
class ManageSellOfferOpFrame(_ManageOfferBase):
    CODES = ManageSellOfferResultCode
    PREFIX = "MANAGE_SELL_OFFER_"

    def price(self) -> Price:
        return self.body.price

    def is_delete(self) -> bool:
        return self.body.amount == 0

    def _amount_valid(self) -> bool:
        return self.body.amount >= 0

    def apply_specific_limits(self, sheep_send_limit, sheep_sent,
                              wheat_receive_limit, wheat_received):
        return (min(self.body.amount - sheep_sent, sheep_send_limit),
                wheat_receive_limit)

    def _own_liabilities(self):
        return ox.offer_liabilities(self.body.price, self.body.amount)


@register_op(OperationType.CREATE_PASSIVE_SELL_OFFER)
class CreatePassiveSellOfferOpFrame(ManageSellOfferOpFrame):
    def offer_id(self) -> int:
        return 0

    def passive_on_create(self) -> bool:
        return True


@register_op(OperationType.MANAGE_BUY_OFFER)
class ManageBuyOfferOpFrame(_ManageOfferBase):
    CODES = ManageBuyOfferResultCode
    PREFIX = "MANAGE_BUY_OFFER_"

    def price(self) -> Price:
        return _inverse(self.body.price)

    def is_delete(self) -> bool:
        return self.body.buyAmount == 0

    def _amount_valid(self) -> bool:
        return self.body.buyAmount >= 0

    def apply_specific_limits(self, sheep_send_limit, sheep_sent,
                              wheat_receive_limit, wheat_received):
        return (sheep_send_limit,
                min(self.body.buyAmount - wheat_received,
                    wheat_receive_limit))

    def _own_liabilities(self):
        wheat_receive, sheep_send, _ = ox._exchange_v10_core(
            self.price(), INT64_MAX, INT64_MAX, INT64_MAX,
            self.body.buyAmount, ox.ROUND_NORMAL)
        return wheat_receive, sheep_send
