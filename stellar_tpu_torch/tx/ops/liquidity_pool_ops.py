"""LiquidityPoolDeposit / LiquidityPoolWithdraw (reference
``src/transactions/LiquidityPoolDepositOpFrame.cpp``,
``LiquidityPoolWithdrawOpFrame.cpp``).

Constant-product pools: deposit moves both constituents in proportion to
reserves (geometric mean seeds an empty pool) and mints shares on the
source's pool-share trustline; withdraw burns shares pro rata. All the
128-bit ``bigDivide``/``bigSquareRoot`` arithmetic collapses to Python
integers.

The port's copy of ``stellar_tpu/tx/ops/liquidity_pool_ops.py``, with
the port's imports.
"""

from __future__ import annotations

import math

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, LedgerTxnError
from stellar_tpu_torch.tx.account_utils import (
    INT64_MAX, add_balance, get_available_balance, get_max_amount_receive,
    is_authorized,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_native, liquidity_pool_key, pool_share_trustline_key,
    trustline_key,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, account_key, register_op,
)
from stellar_tpu_torch.xdr.results import (
    LiquidityPoolDepositResultCode as DepCode,
    LiquidityPoolWithdrawResultCode as WdCode,
)
from stellar_tpu_torch.xdr.tx import OperationType


def big_square_root(a: int, b: int) -> int:
    """floor(sqrt(a*b)) (reference ``bigSquareRoot``, util/numeric128)."""
    return math.isqrt(a * b)


def pool_withdrawal_amount(shares: int, total: int, reserve: int) -> int:
    """floor(shares * reserve / total) (reference
    ``getPoolWithdrawalAmount``)."""
    return shares * reserve // total


def _div_floor(a: int, b: int, c: int):
    """(ok, floor(a*b/c)) clamped to int64 validity like bigDivide."""
    v = a * b // c
    return (v <= INT64_MAX, v)


def _div_ceil(a: int, b: int, c: int):
    v = -((-a * b) // c)
    return (v <= INT64_MAX, v)


def _is_bad_price(amount_a, amount_b, min_price, max_price) -> bool:
    if amount_a == 0 or amount_b == 0:
        return True
    if amount_a * min_price.d < amount_b * min_price.n:
        return True
    if amount_a * max_price.d > amount_b * max_price.n:
        return True
    return False


def header_flags(header) -> int:
    return header.ext.value.flags if header.ext.arm == 1 else 0


class _PoolOpBase(OperationFrame):
    """Shared loading for both pool ops."""

    DISABLE_FLAG = 0

    def apply(self, checker, ltx):
        # a FLAGS upgrade can switch pool ops off network-wide
        # (reference isPoolDepositDisabled / isPoolWithdrawalDisabled
        # gating isOpSupported -> opNOT_SUPPORTED)
        from stellar_tpu_torch.xdr.results import OperationResultCode
        if header_flags(ltx.header()) & self.DISABLE_FLAG:
            return False, self.make_top_result(
                OperationResultCode.opNOT_SUPPORTED)
        return super().apply(checker, ltx)

    def _load_pool_context(self, ltx, pool_id: bytes, no_trust_result):
        """(fail_result | None, pool_tl_handle, pool_handle)."""
        tl_key = pool_share_trustline_key(self.source_account_id(), pool_id)
        tl_h = ltx.load(tl_key)
        if tl_h is None:
            return no_trust_result, None, None
        pool_h = ltx.load(liquidity_pool_key(pool_id))
        if pool_h is None:
            raise LedgerTxnError("pool trustline without pool entry")
        return None, tl_h, pool_h

    def _update_asset_balance(self, ltx, header, asset, delta: int) -> bool:
        """Move `delta` of an underlying asset on the source's trustline
        (or account for native / issuer self-balance). True on success."""
        src_id = self.source_account_id()
        if is_native(asset):
            with ltx.load(account_key(src_id)) as h:
                return add_balance(header, h.entry, delta)
        if get_issuer(asset) == src_id:
            return True  # issuers mint/burn freely
        h = ltx.load(trustline_key(src_id, asset))
        if h is None:
            raise LedgerTxnError("missing underlying trustline")
        with h:
            return add_balance(header, h.entry, delta)


@register_op(OperationType.LIQUIDITY_POOL_DEPOSIT)
class LiquidityPoolDepositOpFrame(_PoolOpBase):
    """Reference ``LiquidityPoolDepositOpFrame.cpp``."""

    from stellar_tpu_torch.xdr.ledger import LedgerHeaderFlags as _LHF
    DISABLE_FLAG = _LHF.DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG

    def do_check_valid(self, ledger_version: int):
        b = self.body
        bad = (b.maxAmountA <= 0 or b.maxAmountB <= 0 or
               b.minPrice.n <= 0 or b.minPrice.d <= 0 or
               b.maxPrice.n <= 0 or b.maxPrice.d <= 0 or
               b.minPrice.n * b.maxPrice.d > b.minPrice.d * b.maxPrice.n)
        if bad:
            return False, self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
        return True, None

    def _amounts_for_empty_pool(self, available_a, available_b,
                                available_limit):
        b = self.body
        amount_a, amount_b = b.maxAmountA, b.maxAmountB
        if available_a < amount_a or available_b < amount_b:
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED), None
        if _is_bad_price(amount_a, amount_b, b.minPrice, b.maxPrice):
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE), None
        shares = big_square_root(amount_a, amount_b)
        if available_limit < shares:
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_LINE_FULL), None
        return None, (amount_a, amount_b, shares)

    def _amounts_for_pool(self, cp, available_a, available_b,
                          available_limit):
        b = self.body
        ok_a, shares_a = _div_floor(cp.totalPoolShares, b.maxAmountA,
                                    cp.reserveA)
        ok_b, shares_b = _div_floor(cp.totalPoolShares, b.maxAmountB,
                                    cp.reserveB)
        if ok_a and ok_b:
            shares = min(shares_a, shares_b)
        elif ok_a:
            shares = shares_a
        elif ok_b:
            shares = shares_b
        else:
            raise LedgerTxnError("both share calculations overflowed")
        ok_a, amount_a = _div_ceil(shares, cp.reserveA, cp.totalPoolShares)
        ok_b, amount_b = _div_ceil(shares, cp.reserveB, cp.totalPoolShares)
        if not (ok_a and ok_b):
            raise LedgerTxnError("deposit amount overflowed")
        if available_a < amount_a or available_b < amount_b:
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED), None
        if _is_bad_price(amount_a, amount_b, b.minPrice, b.maxPrice):
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE), None
        if available_limit < shares:
            return self.make_result(
                DepCode.LIQUIDITY_POOL_DEPOSIT_LINE_FULL), None
        return None, (amount_a, amount_b, shares)

    def do_apply(self, outer):
        src_id = self.source_account_id()
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            fail, tl_h, pool_h = self._load_pool_context(
                ltx, self.body.liquidityPoolID,
                self.make_result(DepCode.LIQUIDITY_POOL_DEPOSIT_NO_TRUST))
            if fail is not None:
                return False, fail
            cp = pool_h.data.body.value

            # underlying trustlines must exist + be fully authorized
            avail = []
            for asset in (cp.params.assetA, cp.params.assetB):
                if is_native(asset):
                    acc = ltx.load_without_record(account_key(src_id))
                    avail.append(get_available_balance(header, acc))
                elif get_issuer(asset) == src_id:
                    avail.append(INT64_MAX)
                else:
                    tl = ltx.load_without_record(
                        trustline_key(src_id, asset))
                    if tl is None:
                        raise LedgerTxnError("invalid ledger state")
                    if not is_authorized(tl.data.value):
                        return False, self.make_result(
                            DepCode.LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED)
                    avail.append(get_available_balance(header, tl))
            available_limit = get_max_amount_receive(header, tl_h.entry)

            if cp.totalPoolShares != 0:
                fail, amounts = self._amounts_for_pool(
                    cp, avail[0], avail[1], available_limit)
            else:
                fail, amounts = self._amounts_for_empty_pool(
                    avail[0], avail[1], available_limit)
            if fail is not None:
                return False, fail
            amount_a, amount_b, shares = amounts

            if INT64_MAX - amount_a < cp.reserveA or \
                    INT64_MAX - amount_b < cp.reserveB or \
                    INT64_MAX - shares < cp.totalPoolShares:
                return False, self.make_result(
                    DepCode.LIQUIDITY_POOL_DEPOSIT_POOL_FULL)
            if amount_a <= 0 or amount_b <= 0 or shares <= 0:
                raise LedgerTxnError("non-positive deposit")

            if not self._update_asset_balance(ltx, header, cp.params.assetA,
                                              -amount_a):
                raise LedgerTxnError("insufficient balance for deposit")
            cp.reserveA += amount_a
            if not self._update_asset_balance(ltx, header, cp.params.assetB,
                                              -amount_b):
                raise LedgerTxnError("insufficient balance for deposit")
            cp.reserveB += amount_b
            if not add_balance(header, tl_h.entry, shares):
                raise LedgerTxnError("insufficient pool share limit")
            cp.totalPoolShares += shares
            tl_h.deactivate()
            pool_h.deactivate()
            ltx.commit()
        return True, self.make_result(DepCode.LIQUIDITY_POOL_DEPOSIT_SUCCESS)


@register_op(OperationType.LIQUIDITY_POOL_WITHDRAW)
class LiquidityPoolWithdrawOpFrame(_PoolOpBase):
    """Reference ``LiquidityPoolWithdrawOpFrame.cpp``."""

    from stellar_tpu_torch.xdr.ledger import LedgerHeaderFlags as _LHF
    DISABLE_FLAG = _LHF.DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG

    def do_check_valid(self, ledger_version: int):
        b = self.body
        if b.amount <= 0 or b.minAmountA < 0 or b.minAmountB < 0:
            return False, self.make_result(
                WdCode.LIQUIDITY_POOL_WITHDRAW_MALFORMED)
        return True, None

    def do_apply(self, outer):
        b = self.body
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            fail, tl_h, pool_h = self._load_pool_context(
                ltx, b.liquidityPoolID,
                self.make_result(WdCode.LIQUIDITY_POOL_WITHDRAW_NO_TRUST))
            if fail is not None:
                return False, fail
            if get_available_balance(header, tl_h.entry) < b.amount:
                return False, self.make_result(
                    WdCode.LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED)
            cp = pool_h.data.body.value

            amount_a = pool_withdrawal_amount(
                b.amount, cp.totalPoolShares, cp.reserveA)
            amount_b = pool_withdrawal_amount(
                b.amount, cp.totalPoolShares, cp.reserveB)
            for amount, minimum, asset, code in (
                    (amount_a, b.minAmountA, cp.params.assetA, "A"),
                    (amount_b, b.minAmountB, cp.params.assetB, "B")):
                if amount < minimum:
                    return False, self.make_result(
                        WdCode.LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM)
                if not self._update_asset_balance(ltx, header, asset,
                                                  amount):
                    return False, self.make_result(
                        WdCode.LIQUIDITY_POOL_WITHDRAW_LINE_FULL)
            if not add_balance(header, tl_h.entry, -b.amount):
                raise LedgerTxnError("pool withdrawal invalid")
            cp.totalPoolShares -= b.amount
            cp.reserveA -= amount_a
            cp.reserveB -= amount_b
            if cp.totalPoolShares < 0 or cp.reserveA < 0 or cp.reserveB < 0:
                raise LedgerTxnError("pool reserves underflow")
            tl_h.deactivate()
            pool_h.deactivate()
            ltx.commit()
        return True, self.make_result(
            WdCode.LIQUIDITY_POOL_WITHDRAW_SUCCESS)
