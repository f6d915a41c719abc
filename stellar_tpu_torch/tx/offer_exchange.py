"""Order-book matching engine (reference
``src/transactions/OfferExchange.cpp``).

Terminology follows the reference: the maker's offer sells "wheat" and
buys "sheep"; the taker sends sheep to receive wheat. ``exchange_v10``
reproduces the reference's rounding system exactly (value comparison to
decide which side stays in the book, rounding that favors the staying
side, 1% price-error bound for NORMAL rounding) — Python integers stand
in for the uint128 arithmetic, bit-exact by construction.

``convert_with_offers_and_pools`` adds the liquidity-pool arm for path
payments: the pool quote is computed first, the order book is crossed in
a child transaction, and the book wins only when it gives a strictly
better price (reference ``maybeConvertWithOffers`` /
``shouldConvertWithOffers``).

The port's copy of ``stellar_tpu/tx/offer_exchange.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from stellar_tpu_torch.tx.account_utils import (
    INT64_MAX, get_available_balance, get_max_amount_receive,
    get_min_balance,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_native, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import account_key
from stellar_tpu_torch.xdr.results import (
    ClaimAtom, ClaimAtomType, ClaimLiquidityAtom, ClaimOfferAtom,
)
from stellar_tpu_torch.xdr.types import (
    LedgerEntryType, LedgerKey, LedgerKeyOffer, Price,
)

__all__ = [
    "ROUND_NORMAL", "ROUND_PP_STRICT_RECEIVE", "ROUND_PP_STRICT_SEND",
    "exchange_v10", "adjust_offer_amount", "offer_liabilities",
    "convert", "convert_send", "convert_with_offers",
    "convert_with_offers_and_pools", "exchange_with_pool_amounts",
    "load_best_offer", "release_offer_liabilities",
    "acquire_offer_liabilities", "offer_key",
]

ROUND_NORMAL = 0
ROUND_PP_STRICT_RECEIVE = 1
ROUND_PP_STRICT_SEND = 2

MAX_OFFERS_TO_CROSS = 1000  # reference Config::MAX_OFFERS_TO_CROSS


def _div(a: int, b: int, round_up: bool) -> int:
    return -((-a) // b) if round_up else a // b


def _offer_value(price_n: int, price_d: int, max_send: int,
                 max_receive: int) -> int:
    """min(maxSend*priceN, maxReceive*priceD) (reference
    ``calculateOfferValue``)."""
    return min(max_send * price_n, max_receive * price_d)


def _check_price_error_bound(n: int, d: int, wheat_receive: int,
                             sheep_send: int, can_favor_wheat: bool) -> bool:
    lhs = 100 * n * wheat_receive
    rhs = 100 * d * sheep_send
    if can_favor_wheat and rhs > lhs:
        return True
    return abs(lhs - rhs) <= n * wheat_receive


def exchange_v10(price: Price, max_wheat_send: int, max_wheat_receive: int,
                 max_sheep_send: int, max_sheep_receive: int,
                 rounding: int) -> Tuple[int, int, bool]:
    """(wheat_received, sheep_sent, wheat_stays) — reference
    ``exchangeV10`` incl. price-error thresholds."""
    wheat_receive, sheep_send, wheat_stays = _exchange_v10_core(
        price, max_wheat_send, max_wheat_receive, max_sheep_send,
        max_sheep_receive, rounding)
    n, d = price.n, price.d
    if wheat_receive > 0 and sheep_send > 0:
        if wheat_stays and sheep_send * d < wheat_receive * n:
            raise RuntimeError("favored sheep when wheat stays")
        if not wheat_stays and sheep_send * d > wheat_receive * n:
            raise RuntimeError("favored wheat when sheep stays")
        if rounding == ROUND_NORMAL:
            if not _check_price_error_bound(n, d, wheat_receive,
                                            sheep_send, False):
                wheat_receive = sheep_send = 0
        else:
            if not _check_price_error_bound(n, d, wheat_receive,
                                            sheep_send, True):
                raise RuntimeError("exceeded price error bound")
    else:
        if rounding == ROUND_PP_STRICT_SEND:
            if sheep_send == 0:
                raise RuntimeError("invalid amount of sheep sent")
        else:
            wheat_receive = sheep_send = 0
    return wheat_receive, sheep_send, wheat_stays


def _exchange_v10_core(price, max_wheat_send, max_wheat_receive,
                       max_sheep_send, max_sheep_receive, rounding):
    n, d = price.n, price.d
    wheat_value = _offer_value(n, d, max_wheat_send, max_sheep_receive)
    sheep_value = _offer_value(d, n, max_sheep_send, max_wheat_receive)
    wheat_stays = wheat_value > sheep_value

    if wheat_stays:
        if rounding == ROUND_PP_STRICT_SEND:
            wheat_receive = _div(sheep_value, n, False)
            sheep_send = min(max_sheep_send, max_sheep_receive)
        elif n > d or rounding == ROUND_PP_STRICT_RECEIVE:
            wheat_receive = _div(sheep_value, n, False)
            sheep_send = _div(wheat_receive * n, d, True)
        else:
            sheep_send = _div(sheep_value, d, False)
            wheat_receive = _div(sheep_send * d, n, False)
    else:
        if n > d:
            wheat_receive = _div(wheat_value, n, False)
            sheep_send = _div(wheat_receive * n, d, False)
        else:
            sheep_send = _div(wheat_value, d, False)
            wheat_receive = _div(sheep_send * d, n, True)

    if not (0 <= wheat_receive <= min(max_wheat_receive, max_wheat_send)):
        raise RuntimeError("wheatReceive out of bounds")
    if not (0 <= sheep_send <= min(max_sheep_receive, max_sheep_send)):
        raise RuntimeError("sheepSend out of bounds")
    return wheat_receive, sheep_send, wheat_stays


def adjust_offer_amount(price: Price, max_wheat_send: int,
                        max_sheep_receive: int) -> int:
    """Largest executable amount of an offer given its owner's limits
    (reference ``adjustOffer``)."""
    wheat_receive, _, _ = exchange_v10(
        price, max_wheat_send, INT64_MAX, INT64_MAX, max_sheep_receive,
        ROUND_NORMAL)
    return wheat_receive


def offer_liabilities(price: Price, amount: int) -> Tuple[int, int]:
    """(selling, buying) liabilities an offer of ``amount`` at ``price``
    imposes (reference ``getOfferSellingLiabilities`` /
    ``getOfferBuyingLiabilities``)."""
    wheat_receive, sheep_send, _ = _exchange_v10_core(
        price, amount, INT64_MAX, INT64_MAX, INT64_MAX, ROUND_NORMAL)
    return wheat_receive, sheep_send


def buy_offer_selling_amount(inverse_price: Price, buy_amount: int) -> int:
    """Selling-asset amount equivalent of a buy offer (reference
    ManageBuyOfferOpFrame's liabilities shape)."""
    _, sheep_send, _ = _exchange_v10_core(
        inverse_price, INT64_MAX, INT64_MAX, INT64_MAX, buy_amount,
        ROUND_NORMAL)
    return sheep_send


# ---------------- account/trustline liability plumbing ----------------


def _ensure_account_liabilities(acc):
    from stellar_tpu_torch.xdr.types import (
        AccountEntryExtensionV1, Liabilities, _AccountEntryExt, _AEV1Ext,
    )
    if acc.ext.arm == 0:
        acc.ext = _AccountEntryExt.make(1, AccountEntryExtensionV1(
            liabilities=Liabilities(buying=0, selling=0),
            ext=_AEV1Ext.make(0)))
    return acc.ext.value.liabilities


def _ensure_trustline_liabilities(tl):
    from stellar_tpu_torch.xdr.types import (
        Liabilities, TrustLineEntry, TrustLineEntryV1,
    )
    if tl.ext.arm == 0:
        tl.ext = TrustLineEntry._types[5].make(1, TrustLineEntryV1(
            liabilities=Liabilities(buying=0, selling=0),
            ext=TrustLineEntryV1._types[1].make(0)))
    return tl.ext.value.liabilities


def _add_liabilities(ltx, account_id_v, asset, d_selling: int,
                     d_buying: int) -> bool:
    """Adjust (selling, buying) liabilities on the right entry; the
    issuer's own asset carries none (reference
    ``addSellingLiabilities``/``addBuyingLiabilities``)."""
    header = ltx.header()
    if is_native(asset):
        with ltx.load(account_key(account_id_v)) as h:
            acc = h.data
            liab = _ensure_account_liabilities(acc)
            new_selling = liab.selling + d_selling
            new_buying = liab.buying + d_buying
            if new_selling < 0 or new_buying < 0:
                return False
            if d_selling > 0 and \
                    acc.balance - get_min_balance(header, acc) < new_selling:
                return False
            if d_buying > 0 and new_buying > INT64_MAX - acc.balance:
                return False
            liab.selling = new_selling
            liab.buying = new_buying
        return True
    if get_issuer(asset) == account_id_v:
        return True  # issuer: infinite line, no liabilities tracked
    h = ltx.load(trustline_key(account_id_v, asset))
    if h is None:
        return False
    with h:
        tl = h.data
        liab = _ensure_trustline_liabilities(tl)
        new_selling = liab.selling + d_selling
        new_buying = liab.buying + d_buying
        if new_selling < 0 or new_buying < 0:
            return False
        if d_selling > 0 and tl.balance < new_selling:
            return False
        if d_buying > 0 and new_buying > tl.limit - tl.balance:
            return False
        liab.selling = new_selling
        liab.buying = new_buying
    return True


def release_offer_liabilities(ltx, offer) -> None:
    selling, buying = offer_liabilities(offer.price, offer.amount)
    _add_liabilities(ltx, offer.sellerID, offer.selling, -selling, 0)
    _add_liabilities(ltx, offer.sellerID, offer.buying, 0, -buying)


def acquire_offer_liabilities(ltx, offer) -> bool:
    selling, buying = offer_liabilities(offer.price, offer.amount)
    if not _add_liabilities(ltx, offer.sellerID, offer.selling, selling, 0):
        return False
    return _add_liabilities(ltx, offer.sellerID, offer.buying, 0, buying)


# ---------------- the book ----------------


def offer_key(seller_id, offer_id: int):
    return LedgerKey.make(LedgerEntryType.OFFER,
                          LedgerKeyOffer(sellerID=seller_id,
                                         offerID=offer_id))


# cross-check every best-offer selection against an independent
# re-scan (reference BEST_OFFER_DEBUGGING_ENABLED, pushed from Config;
# expensive — test runs only)
BEST_OFFER_DEBUGGING = False


def load_best_offer(ltx, selling, buying, skip_ids=()):
    """Best (lowest price, oldest id) live offer selling ``selling`` for
    ``buying`` (the order-book index role of ``getBestOffer``)."""
    best = None
    for le in ltx.all_entries_of_type(LedgerEntryType.OFFER):
        o = le.data.value
        if o.selling != selling or o.buying != buying:
            continue
        if o.offerID in skip_ids:
            continue
        # exact rational comparison: n1*d2 < n2*d1
        if best is None or \
                (o.price.n * best.price.d, o.offerID) < \
                (best.price.n * o.price.d, best.offerID):
            best = o
    if BEST_OFFER_DEBUGGING and best is not None:
        # no surviving candidate may beat the selection (guards the
        # comparison logic and iteration-order independence)
        for le in ltx.all_entries_of_type(LedgerEntryType.OFFER):
            o = le.data.value
            if o.selling != selling or o.buying != buying or \
                    o.offerID in skip_ids:
                continue
            assert (best.price.n * o.price.d, best.offerID) <= \
                (o.price.n * best.price.d, o.offerID), \
                "best-offer selection beaten by a surviving candidate"
    return best


def _can_sell_at_most(ltx, account_id_v, asset) -> int:
    header = ltx.header()
    if is_native(asset):
        e = ltx.load_without_record(account_key(account_id_v))
        return max(0, get_available_balance(header, e))
    if get_issuer(asset) == account_id_v:
        return INT64_MAX
    e = ltx.load_without_record(trustline_key(account_id_v, asset))
    if e is None:
        return 0
    from stellar_tpu_torch.tx.account_utils import (
        is_authorized_to_maintain_liabilities,
    )
    if not is_authorized_to_maintain_liabilities(e.data.value):
        return 0
    return max(0, get_available_balance(header, e))


def _can_buy_at_most(ltx, account_id_v, asset) -> int:
    header = ltx.header()
    if is_native(asset):
        e = ltx.load_without_record(account_key(account_id_v))
        return max(0, get_max_amount_receive(header, e))
    if get_issuer(asset) == account_id_v:
        return INT64_MAX
    e = ltx.load_without_record(trustline_key(account_id_v, asset))
    if e is None:
        return 0
    return max(0, get_max_amount_receive(header, e))


def _transfer(ltx, account_id_v, asset, delta: int):
    """Unchecked-by-liabilities transfer used during crossing (limits
    were pre-validated by exchange_v10 bounds)."""
    from stellar_tpu_torch.tx.account_utils import add_balance
    if is_native(asset):
        with ltx.load(account_key(account_id_v)) as h:
            ok = add_balance(ltx.header(), h.entry, delta)
    elif get_issuer(asset) == account_id_v:
        ok = True  # issuer mints/burns its own asset
    else:
        with ltx.load(trustline_key(account_id_v, asset)) as h:
            ok = add_balance(ltx.header(), h.entry, delta)
    if not ok:
        raise RuntimeError("offer crossing exceeded validated limits")


# crossing outcomes
CROSS_STOPPED_SELF = "cross-self"
CROSS_STOPPED_BAD_PRICE = "bad-price"
CROSS_OK = "ok"          # taker side exhausted (or limits filled)
CROSS_PARTIAL = "partial"  # book ran dry with taker limits unfilled
CROSS_TOO_MANY = "too-many"


def _cross_one(ltx, offer, max_wheat_receive: int, max_sheep_send: int,
               rounding: int):
    """Cross the taker against one book offer (reference
    ``crossOfferV10``). Returns (atom, taken, wheat_received,
    sheep_sent); ``offer`` is the OfferEntry body."""
    seller = offer.sellerID
    wheat = offer.selling
    sheep = offer.buying

    release_offer_liabilities(ltx, offer)

    max_wheat_send = min(offer.amount,
                         _can_sell_at_most(ltx, seller, wheat))
    max_sheep_receive = _can_buy_at_most(ltx, seller, sheep)
    adjusted = adjust_offer_amount(offer.price, max_wheat_send,
                                   max_sheep_receive)

    wheat_received, sheep_sent, wheat_stays = exchange_v10(
        offer.price, adjusted, max_wheat_receive, max_sheep_send,
        max_sheep_receive, rounding)

    # the two legs settle independently — strict-send can legally move
    # sheep while wheat rounds to zero (reference crossOfferV10)
    if wheat_received > 0:
        _transfer(ltx, seller, wheat, -wheat_received)
    if sheep_sent > 0:
        _transfer(ltx, seller, sheep, sheep_sent)

    key = offer_key(seller, offer.offerID)
    if wheat_stays:
        with ltx.load(key) as h:
            o = h.data
            o.amount = adjust_offer_amount(
                offer.price,
                min(adjusted - wheat_received,
                    _can_sell_at_most(ltx, seller, wheat)),
                _can_buy_at_most(ltx, seller, sheep))
            new_amount = o.amount
        if new_amount > 0:
            with ltx.load(key) as h:
                acquire_offer_liabilities(ltx, h.data)
            offer_taken = False
        else:
            _erase_offer(ltx, key, seller)
            offer_taken = True
    else:
        _erase_offer(ltx, key, seller)
        offer_taken = True

    # every crossed offer produces an atom, even zero-amount crossings
    # (reference appends unconditionally)
    atom = ClaimAtom.make(
        ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK,
        ClaimOfferAtom(sellerID=seller, offerID=offer.offerID,
                       assetSold=wheat, amountSold=wheat_received,
                       assetBought=sheep, amountBought=sheep_sent))
    return atom, offer_taken, wheat_received, sheep_sent, wheat_stays


def _erase_offer(ltx, key, seller_id):
    """Erase a fully-crossed offer, returning its reserve to the seller
    or sponsor (reference ``OfferExchange.cpp`` crossOfferV10 →
    ``removeEntryWithPossibleSponsorship``)."""
    from stellar_tpu_torch.tx.sponsorship import (
        remove_entry_with_possible_sponsorship,
    )
    le = ltx.load_without_record(key)
    ltx.erase(key)
    with ltx.load(account_key(seller_id)) as h:
        remove_entry_with_possible_sponsorship(ltx, ltx.header(), le,
                                               h.entry)


def convert_with_offers(ltx, sheep, max_sheep_send: int, wheat,
                        max_wheat_receive: int, rounding: int,
                        offer_filter: Callable,
                        max_offers: int = MAX_OFFERS_TO_CROSS):
    """Cross the book until a limit fills (reference
    ``convertWithOffers``). Returns
    (outcome, sheep_sent, wheat_received, claim_atoms)."""
    sheep_sent = 0
    wheat_received = 0
    atoms: List = []
    crossed = 0
    while True:
        if wheat_received >= max_wheat_receive or \
                sheep_sent >= max_sheep_send:
            return CROSS_OK, sheep_sent, wheat_received, atoms
        if crossed >= max_offers:
            return CROSS_TOO_MANY, sheep_sent, wheat_received, atoms
        offer = load_best_offer(ltx, wheat, sheep)
        if offer is None:
            return CROSS_PARTIAL, sheep_sent, wheat_received, atoms
        verdict = offer_filter(offer)
        if verdict == CROSS_STOPPED_SELF:
            return CROSS_STOPPED_SELF, sheep_sent, wheat_received, atoms
        if verdict == CROSS_STOPPED_BAD_PRICE:
            return CROSS_STOPPED_BAD_PRICE, sheep_sent, wheat_received, \
                atoms
        atom, taken, wr, ss, wheat_stays = _cross_one(
            ltx, offer, max_wheat_receive - wheat_received,
            max_sheep_send - sheep_sent, rounding)
        crossed += 1
        atoms.append(atom)
        wheat_received += wr
        sheep_sent += ss
        if wheat_stays:
            # the book offer stays: the taker side is exhausted
            # (reference: needMore = !wheatStays -> eOK)
            return CROSS_OK, sheep_sent, wheat_received, atoms


# ---------------- liquidity-pool arm ----------------


LIQUIDITY_POOL_MAX_BPS = 10000


def exchange_with_pool_amounts(reserves_to: int, max_send_to: int,
                               reserves_from: int, max_receive_from: int,
                               fee_bps: int, rounding: int):
    """Constant-product quote (reference ``exchangeWithPool`` math arm,
    OfferExchange.cpp:1243). Returns (ok, to_pool, from_pool) without
    touching state."""
    max_bps = LIQUIDITY_POOL_MAX_BPS
    if not (0 <= fee_bps < max_bps):
        raise ValueError("liquidity pool fee out of range")
    if reserves_to <= 0 or reserves_from <= 0:
        raise ValueError("non-positive reserve in exchange_with_pool")
    if rounding == ROUND_PP_STRICT_SEND:
        if max_receive_from != INT64_MAX:
            raise ValueError("strict send with bounded receive")
        if max_send_to > INT64_MAX - reserves_to:
            return False, 0, 0
        to_pool = max_send_to
        num = (max_bps - fee_bps) * reserves_from * to_pool
        den = max_bps * reserves_to + (max_bps - fee_bps) * to_pool
        from_pool = num // den
        if from_pool > INT64_MAX:
            return False, 0, 0
        if from_pool > reserves_from:
            raise RuntimeError("received too much from pool")
        return from_pool != 0, to_pool, from_pool
    if rounding == ROUND_PP_STRICT_RECEIVE:
        if max_send_to != INT64_MAX:
            raise ValueError("strict receive with bounded send")
        if max_receive_from >= reserves_from:
            return False, 0, 0
        from_pool = max_receive_from
        num = max_bps * reserves_to * from_pool
        den = (reserves_from - from_pool) * (max_bps - fee_bps)
        to_pool = -((-num) // den)  # ceil
        if to_pool > INT64_MAX - reserves_to:
            return False, 0, 0
        return True, to_pool, from_pool
    raise ValueError("invalid rounding type for pool exchange")


def _pool_id_for_pair(a, b) -> bytes:
    from stellar_tpu_torch.tx.asset_utils import (
        LIQUIDITY_POOL_FEE_V18, asset_lt, pool_id_from_params,
    )
    from stellar_tpu_torch.xdr.types import (
        LiquidityPoolConstantProductParameters, LiquidityPoolParameters,
        LiquidityPoolType,
    )
    lo, hi = (a, b) if asset_lt(a, b) else (b, a)
    params = LiquidityPoolParameters.make(
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
        LiquidityPoolConstantProductParameters(
            assetA=lo, assetB=hi, fee=LIQUIDITY_POOL_FEE_V18))
    return pool_id_from_params(params)


def _load_pool_cp(ltx, pool_id: bytes):
    from stellar_tpu_torch.tx.asset_utils import liquidity_pool_key
    h = ltx.load(liquidity_pool_key(pool_id))
    return h


def _quote_pool_exchange(ltx, sheep, max_sheep_send, wheat,
                         max_wheat_receive, rounding, max_offers):
    """(pool_id, to_pool, from_pool) or None — a no-side-effect pool
    quote (reference computes it in an always-rolled-back child)."""
    if rounding == ROUND_NORMAL or max_offers == 0:
        return None
    # a FLAGS upgrade can disable pool trading network-wide
    hdr = ltx.header()
    if hdr.ext.arm == 1:
        from stellar_tpu_torch.xdr.ledger import LedgerHeaderFlags
        if hdr.ext.value.flags & \
                LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_TRADING_FLAG:
            return None
    pool_id = _pool_id_for_pair(sheep, wheat)
    from stellar_tpu_torch.tx.asset_utils import liquidity_pool_key
    pe = ltx.load_without_record(liquidity_pool_key(pool_id))
    if pe is None:
        return None
    cp = pe.data.value.body.value
    if cp.reserveA <= 0 or cp.reserveB <= 0:
        return None
    from stellar_tpu_torch.tx.asset_utils import LIQUIDITY_POOL_FEE_V18
    from stellar_tpu_torch.xdr.runtime import to_bytes as _tb
    from stellar_tpu_torch.xdr.types import Asset as _Asset
    if _tb(_Asset, sheep) == _tb(_Asset, cp.params.assetA):
        reserves_to, reserves_from = cp.reserveA, cp.reserveB
    else:
        reserves_to, reserves_from = cp.reserveB, cp.reserveA
    ok, to_pool, from_pool = exchange_with_pool_amounts(
        reserves_to, max_sheep_send, reserves_from, max_wheat_receive,
        LIQUIDITY_POOL_FEE_V18, rounding)
    if not ok:
        return None
    return pool_id, to_pool, from_pool


def _apply_pool_exchange(ltx, sheep, pool_id: bytes, to_pool: int,
                         from_pool: int):
    """Move the quoted amounts into/out of the pool reserves."""
    h = _load_pool_cp(ltx, pool_id)
    if h is None:
        raise RuntimeError("pool vanished between quote and apply")
    with h:
        cp = h.data.body.value
        from stellar_tpu_torch.xdr.runtime import to_bytes as _tb
        from stellar_tpu_torch.xdr.types import Asset as _Asset
        if _tb(_Asset, sheep) == _tb(_Asset, cp.params.assetA):
            cp.reserveA += to_pool
            cp.reserveB -= from_pool
        else:
            cp.reserveB += to_pool
            cp.reserveA -= from_pool
        if cp.reserveA < 0 or cp.reserveB < 0:
            raise RuntimeError("could not update reserves")


def convert_with_offers_and_pools(ltx, sheep, max_sheep_send: int, wheat,
                                  max_wheat_receive: int, rounding: int,
                                  offer_filter: Callable,
                                  max_offers: int = MAX_OFFERS_TO_CROSS):
    """Cross against the better of the order book and the liquidity pool
    (reference ``convertWithOffersAndPools``). Same return shape as
    :func:`convert_with_offers`."""
    from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn

    quote = _quote_pool_exchange(ltx, sheep, max_sheep_send, wheat,
                                 max_wheat_receive, rounding, max_offers)

    book_ltx = LedgerTxn(ltx)
    outcome, sheep_sent, wheat_received, atoms = convert_with_offers(
        book_ltx, sheep, max_sheep_send, wheat, max_wheat_receive,
        rounding, offer_filter, max_offers)
    use_book = True
    if quote is not None:
        _, to_pool, from_pool = quote
        if outcome != CROSS_OK:
            use_book = False
        else:
            # book wins only on a strictly better price
            use_book = to_pool * wheat_received > from_pool * sheep_sent
    if use_book:
        book_ltx.commit()
        return outcome, sheep_sent, wheat_received, atoms
    book_ltx.rollback()

    pool_id, to_pool, from_pool = quote
    _apply_pool_exchange(ltx, sheep, pool_id, to_pool, from_pool)
    atom = ClaimAtom.make(
        ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL,
        ClaimLiquidityAtom(liquidityPoolID=pool_id,
                           assetSold=wheat, amountSold=from_pool,
                           assetBought=sheep, amountBought=to_pool))
    return CROSS_OK, to_pool, from_pool, [atom]


# ---------------- path-payment hooks ----------------


# Sentinel fail name for the op-level opEXCEEDED_WORK_LIMIT result (the
# reference fails the whole op with that top-level code when the
# cumulative cross budget runs out, PathPaymentOpFrameBase::convert).
EXCEEDED_WORK_LIMIT = "EXCEEDED_WORK_LIMIT"


def convert(op, ltx, send_asset, recv_asset, max_recv: int,
            max_offers: int = MAX_OFFERS_TO_CROSS
            ) -> Tuple[bool, int, List, str]:
    """Strict-receive hop: acquire exactly ``max_recv`` of recv_asset.
    ``max_offers`` is the *remaining* cumulative cross budget for the
    whole path (reference threads maxOffersToCross across hops).
    Returns (ok, amount_sent, claim_atoms, fail_name)."""
    src = op.source_account_id()

    def offer_filter(offer):
        if offer.sellerID == src:
            return CROSS_STOPPED_SELF
        return None

    outcome, sheep_sent, wheat_received, atoms = \
        convert_with_offers_and_pools(
            ltx, send_asset, INT64_MAX, recv_asset, max_recv,
            ROUND_PP_STRICT_RECEIVE, offer_filter, max_offers)
    if outcome == CROSS_STOPPED_SELF:
        return False, 0, [], "OFFER_CROSS_SELF"
    if outcome == CROSS_TOO_MANY:
        return False, 0, [], EXCEEDED_WORK_LIMIT
    if outcome != CROSS_OK or wheat_received != max_recv:
        return False, 0, [], "TOO_FEW_OFFERS"
    return True, sheep_sent, atoms, ""


def convert_send(op, ltx, send_asset, recv_asset, amount_send: int,
                 max_offers: int = MAX_OFFERS_TO_CROSS
                 ) -> Tuple[bool, int, List, str]:
    """Strict-send hop: spend exactly ``amount_send`` of send_asset.
    ``max_offers`` as in :func:`convert`.
    Returns (ok, amount_received, claim_atoms, fail_name)."""
    src = op.source_account_id()

    def offer_filter(offer):
        if offer.sellerID == src:
            return CROSS_STOPPED_SELF
        return None

    outcome, sheep_sent, wheat_received, atoms = \
        convert_with_offers_and_pools(
            ltx, send_asset, amount_send, recv_asset, INT64_MAX,
            ROUND_PP_STRICT_SEND, offer_filter, max_offers)
    if outcome == CROSS_STOPPED_SELF:
        return False, 0, [], "OFFER_CROSS_SELF"
    if outcome == CROSS_TOO_MANY:
        return False, 0, [], EXCEEDED_WORK_LIMIT
    if outcome != CROSS_OK or sheep_sent != amount_send:
        return False, 0, [], "TOO_FEW_OFFERS"
    return True, wheat_received, atoms, ""
