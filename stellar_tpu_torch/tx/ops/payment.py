"""Payment + path payments (reference ``PaymentOpFrame.cpp``,
``PathPaymentOpFrameBase.cpp``, ``PathPaymentStrictReceiveOpFrame.cpp``,
``PathPaymentStrictSendOpFrame.cpp``).

Payment is sugar over PathPaymentStrictReceive with sendAsset ==
destAsset (the reference literally builds a path-payment op). Same-asset
transfers never touch the order book; cross-asset conversion goes
through ``stellar_tpu_torch.tx.offer_exchange.convert`` once the matching
engine lands — until then crossing reports TOO_FEW_OFFERS (an empty
order book behaves identically).

The port's copy of ``stellar_tpu/tx/ops/payment.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.account_utils import (
    add_balance, get_available_balance, is_authorized,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_asset_valid, is_native, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, account_key, register_op,
)
from stellar_tpu_torch.xdr.results import (
    OperationResultCode,
    PathPaymentStrictReceiveResultCode, PathPaymentStrictSendResultCode,
    PathPaymentStrictReceiveResultSuccess, PathPaymentStrictSendResultSuccess,
    PaymentResultCode, SimplePaymentResult,
)
from stellar_tpu_torch.xdr.tx import OperationType, muxed_to_account_id

RecvCode = PathPaymentStrictReceiveResultCode
SendCode = PathPaymentStrictSendResultCode


class _PathPaymentBase(OperationFrame):
    """Shared balance-update logic (reference PathPaymentOpFrameBase)."""

    # per-subclass result code name prefix mapping
    CODES = None

    def dest_muxed(self):
        return self.body.destination

    def dest_id(self):
        return muxed_to_account_id(self.dest_muxed())

    def source_asset(self):
        return self.body.sendAsset

    def dest_asset(self):
        return self.body.destAsset

    def _code(self, name: str):
        return getattr(self.CODES, self.PREFIX + name)

    def fail(self, name: str):
        return False, self.make_result(self._code(name))

    def should_bypass_issuer_check(self) -> bool:
        """Sending an asset back to its issuer skips the destination
        existence check (reference ``shouldBypassIssuerCheck``)."""
        return (not is_native(self.dest_asset())
                and len(self.body.path) == 0
                and self.source_asset() == self.dest_asset()
                and get_issuer(self.dest_asset()) == self.dest_id())

    def update_dest_balance(self, ltx, amount: int):
        """(ok, failure_result_or_None) — credit the destination."""
        if is_native(self.dest_asset()):
            with ltx.load(account_key(self.dest_id())) as dest:
                if not add_balance(ltx.header(), dest.entry, amount):
                    return self.fail("LINE_FULL")
            return True, None
        if get_issuer(self.dest_asset()) == self.dest_id():
            # issuer receiving its own asset: credits vanish (the
            # reference models this as the infinite issuer
            # TrustLineWrapper, ledger/TrustLineWrapper.cpp)
            return True, None
        h = ltx.load(trustline_key(self.dest_id(), self.dest_asset()))
        if h is None:
            return self.fail("NO_TRUST")
        with h:
            if not is_authorized(h.data):
                return self.fail("NOT_AUTHORIZED")
            if not add_balance(ltx.header(), h.entry, amount):
                return self.fail("LINE_FULL")
        return True, None

    def update_source_balance(self, ltx, amount: int):
        """(ok, failure_result_or_None) — debit the op source."""
        src_id = self.source_account_id()
        if is_native(self.source_asset()):
            with ltx.load(account_key(src_id)) as src:
                if amount > get_available_balance(ltx.header(), src.entry):
                    return self.fail("UNDERFUNDED")
                ok = add_balance(ltx.header(), src.entry, -amount)
                assert ok
            return True, None
        if get_issuer(self.source_asset()) == src_id:
            # issuer sending its own asset: mints
            return True, None
        h = ltx.load(trustline_key(src_id, self.source_asset()))
        if h is None:
            return self.fail("SRC_NO_TRUST")
        with h:
            if not is_authorized(h.data):
                return self.fail("SRC_NOT_AUTHORIZED")
            if not add_balance(ltx.header(), h.entry, -amount):
                return self.fail("UNDERFUNDED")
        return True, None

    def _check_assets_valid(self, ledger_version):
        if not is_asset_valid(self.source_asset(), ledger_version) or \
                not is_asset_valid(self.dest_asset(), ledger_version):
            return False
        return all(is_asset_valid(p, ledger_version)
                   for p in self.body.path)


@register_op(OperationType.PATH_PAYMENT_STRICT_RECEIVE)
class PathPaymentStrictReceiveOpFrame(_PathPaymentBase):
    CODES = RecvCode
    PREFIX = "PATH_PAYMENT_STRICT_RECEIVE_"

    def do_check_valid(self, ledger_version: int):
        if self.body.destAmount <= 0 or self.body.sendMax <= 0:
            return self.fail("MALFORMED")
        if not self._check_assets_valid(ledger_version):
            return self.fail("MALFORMED")
        return True, None

    def do_apply(self, outer):
        with LedgerTxn(outer) as ltx:
            bypass = self.should_bypass_issuer_check()
            if not bypass and not ltx.exists(account_key(self.dest_id())):
                ltx.rollback()
                return self.fail("NO_DESTINATION")

            ok, fail = self.update_dest_balance(ltx, self.body.destAmount)
            if not ok:
                ltx.rollback()
                return False, fail

            offers = []
            recv_asset = self.dest_asset()
            max_amount_recv = self.body.destAmount
            full_path = list(reversed(self.body.path)) + [self.source_asset()]
            for send_asset in full_path:
                if send_asset == recv_asset:
                    continue
                from stellar_tpu_torch.tx import offer_exchange as ox
                # cumulative cross budget across the whole path (reference
                # maxOffersToCross -= offerTrail.size() per hop)
                ok, amount_send, trail, fail_name = ox.convert(
                    self, ltx, send_asset, recv_asset, max_amount_recv,
                    ox.MAX_OFFERS_TO_CROSS - len(offers))
                if not ok:
                    ltx.rollback()
                    if fail_name == ox.EXCEEDED_WORK_LIMIT:
                        return False, OperationFrame.make_top_result(
                            OperationResultCode.opEXCEEDED_WORK_LIMIT)
                    return self.fail(fail_name)
                max_amount_recv = amount_send
                recv_asset = send_asset
                offers = trail + offers

            if max_amount_recv > self.body.sendMax:
                ltx.rollback()
                return self.fail("OVER_SENDMAX")

            ok, fail = self.update_source_balance(ltx, max_amount_recv)
            if not ok:
                ltx.rollback()
                return False, fail
            ltx.commit()

        success = PathPaymentStrictReceiveResultSuccess(
            offers=offers,
            last=SimplePaymentResult(
                destination=self.dest_id(), asset=self.dest_asset(),
                amount=self.body.destAmount))
        return True, self.make_result(
            RecvCode.PATH_PAYMENT_STRICT_RECEIVE_SUCCESS, success)


@register_op(OperationType.PATH_PAYMENT_STRICT_SEND)
class PathPaymentStrictSendOpFrame(_PathPaymentBase):
    CODES = SendCode
    PREFIX = "PATH_PAYMENT_STRICT_SEND_"

    def do_check_valid(self, ledger_version: int):
        if self.body.sendAmount <= 0 or self.body.destMin <= 0:
            return self.fail("MALFORMED")
        if not self._check_assets_valid(ledger_version):
            return self.fail("MALFORMED")
        return True, None

    def do_apply(self, outer):
        with LedgerTxn(outer) as ltx:
            bypass = self.should_bypass_issuer_check()
            if not bypass and not ltx.exists(account_key(self.dest_id())):
                ltx.rollback()
                return self.fail("NO_DESTINATION")

            ok, fail = self.update_source_balance(ltx, self.body.sendAmount)
            if not ok:
                ltx.rollback()
                return False, fail

            offers = []
            send_asset = self.source_asset()
            amount_send = self.body.sendAmount
            full_path = list(self.body.path) + [self.dest_asset()]
            for recv_asset in full_path:
                if send_asset == recv_asset:
                    continue
                from stellar_tpu_torch.tx import offer_exchange as ox
                ok, amount_recv, trail, fail_name = ox.convert_send(
                    self, ltx, send_asset, recv_asset, amount_send,
                    ox.MAX_OFFERS_TO_CROSS - len(offers))
                if not ok:
                    ltx.rollback()
                    if fail_name == ox.EXCEEDED_WORK_LIMIT:
                        return False, OperationFrame.make_top_result(
                            OperationResultCode.opEXCEEDED_WORK_LIMIT)
                    return self.fail(fail_name)
                amount_send = amount_recv
                send_asset = recv_asset
                offers = offers + trail

            if amount_send < self.body.destMin:
                ltx.rollback()
                return self.fail("UNDER_DESTMIN")

            ok, fail = self.update_dest_balance(ltx, amount_send)
            if not ok:
                ltx.rollback()
                return False, fail
            ltx.commit()

        success = PathPaymentStrictSendResultSuccess(
            offers=offers,
            last=SimplePaymentResult(
                destination=self.dest_id(), asset=self.dest_asset(),
                amount=amount_send))
        return True, self.make_result(
            SendCode.PATH_PAYMENT_STRICT_SEND_SUCCESS, success)


# strict-receive inner code -> payment code (reference PaymentOpFrame)
_PP_TO_PAYMENT = {
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED:
        PaymentResultCode.PAYMENT_UNDERFUNDED,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED:
        PaymentResultCode.PAYMENT_SRC_NOT_AUTHORIZED,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST:
        PaymentResultCode.PAYMENT_SRC_NO_TRUST,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION:
        PaymentResultCode.PAYMENT_NO_DESTINATION,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST:
        PaymentResultCode.PAYMENT_NO_TRUST,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED:
        PaymentResultCode.PAYMENT_NOT_AUTHORIZED,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL:
        PaymentResultCode.PAYMENT_LINE_FULL,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER:
        PaymentResultCode.PAYMENT_NO_ISSUER,
    RecvCode.PATH_PAYMENT_STRICT_RECEIVE_MALFORMED:
        PaymentResultCode.PAYMENT_MALFORMED,
}


@register_op(OperationType.PAYMENT)
class PaymentOpFrame(OperationFrame):

    def _as_path_payment(self) -> PathPaymentStrictReceiveOpFrame:
        from stellar_tpu_torch.xdr.tx import (
            Operation, OperationBody, PathPaymentStrictReceiveOp,
        )
        pp = PathPaymentStrictReceiveOp(
            sendAsset=self.body.asset, sendMax=self.body.amount,
            destination=self.body.destination, destAsset=self.body.asset,
            destAmount=self.body.amount, path=[])
        op = Operation(
            sourceAccount=self.operation.sourceAccount,
            body=OperationBody.make(
                OperationType.PATH_PAYMENT_STRICT_RECEIVE, pp))
        return PathPaymentStrictReceiveOpFrame(
            op, self.parent_tx, self.index)

    def do_check_valid(self, ledger_version: int):
        ok, fail = self._as_path_payment().do_check_valid(ledger_version)
        if not ok:
            return False, self._translate(fail)
        return True, None

    def do_apply(self, ltx):
        # self-payment of native is an instant success (reference
        # PaymentOpFrame::doApply)
        if muxed_to_account_id(self.body.destination) == \
                self.source_account_id() and is_native(self.body.asset):
            return True, self.make_result(PaymentResultCode.PAYMENT_SUCCESS)
        ok, res = self._as_path_payment().do_apply(ltx)
        if not ok:
            return False, self._translate(res)
        return True, self.make_result(PaymentResultCode.PAYMENT_SUCCESS)

    def _translate(self, pp_result):
        inner_code = pp_result.value.value.arm
        code = _PP_TO_PAYMENT.get(inner_code)
        if code is None:
            raise RuntimeError(
                f"unexpected path-payment code {inner_code} inside Payment")
        return self.make_result(code)
