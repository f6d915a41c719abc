"""ChangeTrust + AllowTrust + SetTrustLineFlags (reference
``ChangeTrustOpFrame.cpp``, ``TrustFlagsOpFrameBase.cpp``,
``AllowTrustOpFrame.cpp``, ``SetTrustLineFlagsOpFrame.cpp``).

Liquidity-pool-share trustlines land with the pools milestone; the
classic credit-asset paths here are complete. Offer removal on
authorization revocation is wired through
``stellar_tpu_torch.tx.offer_exchange`` once the order book exists.

The port's copy of ``stellar_tpu/tx/ops/trust_ops.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, LedgerTxnError
from stellar_tpu_torch.tx.account_utils import (
    INT64_MAX, get_buying_liabilities,
)
from stellar_tpu_torch.tx.sponsorship import (
    SponsorshipResult, create_entry_with_possible_sponsorship,
    remove_entry_with_possible_sponsorship,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_asset_code_valid, is_asset_valid,
    is_change_trust_asset_valid, is_native, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, ThresholdLevel, account_key, register_op,
)
from stellar_tpu_torch.tx.ops.account_ops import (
    is_auth_required, is_auth_revocable, is_clawback_enabled,
)
from stellar_tpu_torch.xdr.results import (
    AllowTrustResultCode, ChangeTrustResultCode, OperationResultCode,
    SetTrustLineFlagsResultCode,
)
from stellar_tpu_torch.xdr.tx import OperationType
from stellar_tpu_torch.xdr.types import (
    AUTHORIZED_FLAG, AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG, AlphaNum4,
    AlphaNum12, Asset, AssetType, LedgerEntry, LedgerEntryType,
    MASK_TRUSTLINE_FLAGS_V17, TRUSTLINE_CLAWBACK_ENABLED_FLAG,
    TrustLineEntry,
)


TRUST_AUTH_FLAGS = (AUTHORIZED_FLAG |
                    AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)


def _is_issuer(account_id_v, asset) -> bool:
    return not is_native(asset) and get_issuer(asset) == account_id_v


def new_trustline_entry(account_id_v, tl_asset, limit: int,
                        flags: int, last_modified: int) -> LedgerEntry:
    tl = TrustLineEntry(
        accountID=account_id_v, asset=tl_asset, balance=0, limit=limit,
        flags=flags, ext=TrustLineEntry._types[5].make(0))
    return LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=LedgerEntry._types[1].make(LedgerEntryType.TRUSTLINE, tl),
        ext=LedgerEntry._types[2].make(0))


def prepare_trustline_ext_v2(tl):
    """Upgrade a TrustLineEntry to ext v2 in place (reference
    ``prepareTrustLineEntryExtensionV2``) to track liquidityPoolUseCount."""
    from stellar_tpu_torch.xdr.types import (
        Liabilities, TrustLineEntry, TrustLineEntryExtensionV2,
        TrustLineEntryV1,
    )
    if tl.ext.arm == 0:
        tl.ext = TrustLineEntry._types[5].make(1, TrustLineEntryV1(
            liabilities=Liabilities(buying=0, selling=0),
            ext=TrustLineEntryV1._types[1].make(0)))
    v1 = tl.ext.value
    if v1.ext.arm == 0:
        v1.ext = TrustLineEntryV1._types[1].make(2, TrustLineEntryExtensionV2(
            liquidityPoolUseCount=0,
            ext=TrustLineEntryExtensionV2._types[1].make(0)))
    return v1.ext.value


def trustline_ext_v2(tl):
    if tl.ext.arm == 1 and tl.ext.value.ext.arm == 2:
        return tl.ext.value.ext.value
    return None


def decrement_liquidity_pool_use_count(ltx, asset, account_id_v):
    """Unpin one pool use from an underlying-asset trustline (reference
    ``decrementLiquidityPoolUseCount``)."""
    if is_native(asset) or get_issuer(asset) == account_id_v:
        return
    h = ltx.load(trustline_key(account_id_v, asset))
    if h is None:
        raise LedgerTxnError("missing asset trustline for pool unpin")
    with h:
        v2 = trustline_ext_v2(h.data)
        if v2 is None or v2.liquidityPoolUseCount <= 0:
            raise LedgerTxnError("liquidityPoolUseCount underflow")
        v2.liquidityPoolUseCount -= 1


def decrement_pool_shares_trust_line_count(ltx, pool_id: bytes):
    """Drop one share-trustline reference; erase the pool at zero
    (reference ``decrementPoolSharesTrustLineCount``)."""
    from stellar_tpu_torch.tx.asset_utils import liquidity_pool_key
    pk = liquidity_pool_key(pool_id)
    h = ltx.load(pk)
    if h is None:
        raise LedgerTxnError("liquidity pool is missing")
    cp = h.data.body.value
    cp.poolSharesTrustLineCount -= 1
    count = cp.poolSharesTrustLineCount
    h.deactivate()
    if count == 0:
        ltx.erase(pk)
    elif count < 0:
        raise LedgerTxnError("poolSharesTrustLineCount is negative")


@register_op(OperationType.CHANGE_TRUST)
class ChangeTrustOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        Code = ChangeTrustResultCode
        line = self.body.line
        if self.body.limit < 0:
            return False, self.make_result(Code.CHANGE_TRUST_MALFORMED)
        if line.arm == AssetType.ASSET_TYPE_NATIVE or \
                not is_change_trust_asset_valid(line, ledger_version):
            return False, self.make_result(Code.CHANGE_TRUST_MALFORMED)
        if line.arm != AssetType.ASSET_TYPE_POOL_SHARE and \
                _is_issuer(self.source_account_id(), line):
            return False, self.make_result(Code.CHANGE_TRUST_MALFORMED)
        return True, None

    # ---------------- pool bookkeeping ----------------

    def _try_increment_pool_use(self, ltx, asset):
        """Pin an underlying-asset trustline while the account holds pool
        shares (reference ``tryIncrementPoolUseCount``). Returns a
        failure result or None."""
        Code = ChangeTrustResultCode
        src_id = self.source_account_id()
        if is_native(asset) or get_issuer(asset) == src_id:
            return None
        h = ltx.load(trustline_key(src_id, asset))
        if h is None:
            return self.make_result(Code.CHANGE_TRUST_TRUST_LINE_MISSING)
        with h:
            from stellar_tpu_torch.tx.account_utils import (
                is_authorized_to_maintain_liabilities,
            )
            if not is_authorized_to_maintain_liabilities(h.data):
                return self.make_result(
                    Code.CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES)
            prepare_trustline_ext_v2(h.data).liquidityPoolUseCount += 1
        return None

    def _manage_pool_on_new_trustline(self, outer, line, pool_id: bytes):
        """Increment use counts and create/reference the pool entry
        (reference ``tryManagePoolOnNewTrustLine``)."""
        from stellar_tpu_torch.tx.asset_utils import liquidity_pool_key
        from stellar_tpu_torch.xdr.types import (
            LedgerEntry, LedgerEntryType, LiquidityPoolEntry,
            LiquidityPoolEntryConstantProduct, LiquidityPoolType,
        )
        with LedgerTxn(outer) as ltx:
            cp = line.value.value  # constant-product parameters
            for asset in (cp.assetA, cp.assetB):
                fail = self._try_increment_pool_use(ltx, asset)
                if fail is not None:
                    return fail
            pk = liquidity_pool_key(pool_id)
            h = ltx.load(pk)
            if h is not None:
                with h:
                    h.data.body.value.poolSharesTrustLineCount += 1
            else:
                body = LiquidityPoolEntry._types[1].make(
                    LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
                    LiquidityPoolEntryConstantProduct(
                        params=cp, reserveA=0, reserveB=0,
                        totalPoolShares=0, poolSharesTrustLineCount=1))
                ltx.create(LedgerEntry(
                    lastModifiedLedgerSeq=ltx.header().ledgerSeq,
                    data=LedgerEntry._types[1].make(
                        LedgerEntryType.LIQUIDITY_POOL,
                        LiquidityPoolEntry(liquidityPoolID=pool_id,
                                           body=body)),
                    ext=LedgerEntry._types[2].make(0))).deactivate()
            ltx.commit()
        return None

    def _manage_pool_on_deleted_trustline(self, outer, line, pool_id):
        """Release use counts; drop the pool when its last share trustline
        goes (reference ``managePoolOnDeletedTrustLine``)."""
        src_id = self.source_account_id()
        with LedgerTxn(outer) as ltx:
            cp = line.value.value
            for asset in (cp.assetA, cp.assetB):
                decrement_liquidity_pool_use_count(ltx, asset, src_id)
            decrement_pool_shares_trust_line_count(ltx, pool_id)
            ltx.commit()

    # ---------------- apply ----------------

    def do_apply(self, outer):
        Code = ChangeTrustResultCode
        line = self.body.line
        limit = self.body.limit
        src_id = self.source_account_id()
        is_pool = line.arm == AssetType.ASSET_TYPE_POOL_SHARE
        from stellar_tpu_torch.tx.asset_utils import (
            change_trust_asset_to_trustline_asset, pool_id_from_params,
        )
        tl_asset = change_trust_asset_to_trustline_asset(line)
        pool_id = tl_asset.value if is_pool else None
        from stellar_tpu_torch.xdr.types import (
            LedgerKey, LedgerKeyTrustLine, LedgerEntryType as LET,
        )
        key = LedgerKey.make(LET.TRUSTLINE, LedgerKeyTrustLine(
            accountID=src_id, asset=tl_asset))
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            tl_handle = ltx.load(key)
            if tl_handle is not None:
                tl = tl_handle.data
                min_limit = tl.balance + get_buying_liabilities(
                    tl_handle.entry)
                if limit < min_limit:
                    tl_handle.deactivate()
                    return False, self.make_result(
                        Code.CHANGE_TRUST_INVALID_LIMIT)
                if limit == 0:
                    # an underlying-asset line pinned by pool shares
                    # cannot be deleted
                    v2 = trustline_ext_v2(tl)
                    if not is_pool and v2 is not None and \
                            v2.liquidityPoolUseCount != 0:
                        tl_handle.deactivate()
                        return False, self.make_result(
                            Code.CHANGE_TRUST_CANNOT_DELETE)
                    tl_entry = tl_handle.entry
                    tl_handle.deactivate()
                    with ltx.load(account_key(src_id)) as src:
                        remove_entry_with_possible_sponsorship(
                            ltx, header, tl_entry, src.entry)
                    ltx.erase(key)
                    if is_pool:
                        self._manage_pool_on_deleted_trustline(
                            ltx, line, pool_id)
                else:
                    if not is_pool and not ltx.exists(
                            account_key(get_issuer(line))):
                        tl_handle.deactivate()
                        return False, self.make_result(
                            Code.CHANGE_TRUST_NO_ISSUER)
                    tl.limit = limit
                    tl_handle.deactivate()
                ltx.commit()
                return True, self.make_result(Code.CHANGE_TRUST_SUCCESS)

            # new trustline
            if limit == 0:
                return False, self.make_result(
                    Code.CHANGE_TRUST_INVALID_LIMIT)
            flags = 0
            if not is_pool:
                issuer = ltx.load_without_record(
                    account_key(get_issuer(line)))
                if issuer is None:
                    return False, self.make_result(
                        Code.CHANGE_TRUST_NO_ISSUER)
                if not is_auth_required(issuer.data.value):
                    flags |= AUTHORIZED_FLAG
                if is_clawback_enabled(issuer.data.value):
                    flags |= TRUSTLINE_CLAWBACK_ENABLED_FLAG
            else:
                fail = self._manage_pool_on_new_trustline(ltx, line,
                                                          pool_id)
                if fail is not None:
                    ltx.rollback()
                    return False, fail
            tl_entry = new_trustline_entry(
                src_id, tl_asset, limit, flags, header.ledgerSeq)
            with ltx.load(account_key(src_id)) as src:
                res = create_entry_with_possible_sponsorship(
                    ltx, header, tl_entry, src.entry)
            if res != SponsorshipResult.SUCCESS:
                ltx.rollback()
                return False, self.sponsorship_failure(
                    res, Code.CHANGE_TRUST_LOW_RESERVE)
            ltx.create(tl_entry).deactivate()
            ltx.commit()
        return True, self.make_result(Code.CHANGE_TRUST_SUCCESS)


class _TrustFlagsBase(OperationFrame):
    """Shared auth-flag mutation (reference TrustFlagsOpFrameBase)."""

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def trustor(self):
        raise NotImplementedError

    def op_asset(self):
        raise NotImplementedError

    def _expected_flags(self, cur_flags: int):
        """(ok, new_flags, fail_result)."""
        raise NotImplementedError

    def _fail(self, code):
        return False, self.make_result(code)

    def pre_trustline_revocation_check(self, auth_revocable: bool):
        """Hook: failure result if revocation is invalid before even
        loading the trustline (AllowTrust's authorize==0 rule)."""
        return None

    def do_apply(self, outer):
        src_id = self.source_account_id()
        with LedgerTxn(outer) as ltx:
            src = ltx.load_without_record(account_key(src_id))
            auth_revocable = is_auth_revocable(src.data.value)
            early_fail = self.pre_trustline_revocation_check(auth_revocable)
            if early_fail is not None:
                return False, early_fail
            key = trustline_key(self.trustor(), self.op_asset())
            h = ltx.load(key)
            if h is None:
                return self._no_trustline()
            tl = h.data
            ok, new_flags, fail = self._expected_flags(tl.flags)
            if not ok:
                h.deactivate()
                return False, fail
            # revoking full authorization requires AUTH_REVOCABLE
            losing_auth = (tl.flags & AUTHORIZED_FLAG) and \
                not (new_flags & AUTHORIZED_FLAG)
            losing_maintain = (tl.flags & TRUST_AUTH_FLAGS) and \
                not (new_flags & TRUST_AUTH_FLAGS)
            if (losing_auth or losing_maintain) and not auth_revocable:
                h.deactivate()
                return self._cant_revoke()
            if losing_maintain:
                # dropping below maintain-liabilities pulls the trustor's
                # offers in this asset and redeems pool-share trustlines
                # into claimable balances (reference TrustFlagsOpFrameBase
                # removeOffersAndPoolShareTrustLines) — before the flags
                # flip, while liabilities can still be released
                h.deactivate()
                from stellar_tpu_torch.tx.revoke_utils import (
                    LOW_RESERVE, TOO_MANY_SPONSORING,
                    remove_offers_and_pool_share_trust_lines,
                )
                fail = remove_offers_and_pool_share_trust_lines(
                    ltx, self.trustor(), self.op_asset(),
                    self.parent_tx.source_account_id(),
                    self.parent_tx.seq_num, self.index)
                if fail == LOW_RESERVE:
                    ltx.rollback()
                    return False, self._low_reserve()
                if fail == TOO_MANY_SPONSORING:
                    ltx.rollback()
                    return False, self.make_top_result(
                        OperationResultCode.opTOO_MANY_SPONSORING)
                h = ltx.load(key)
                tl = h.data
            tl.flags = new_flags
            h.deactivate()
            ltx.commit()
        return True, self._success()

    def _low_reserve(self):
        raise NotImplementedError


@register_op(OperationType.ALLOW_TRUST)
class AllowTrustOpFrame(_TrustFlagsBase):

    def trustor(self):
        return self.body.trustor

    def op_asset(self):
        code = self.body.asset
        issuer = self.source_account_id()
        if code.arm == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            return Asset.make(code.arm,
                              AlphaNum4(assetCode=code.value, issuer=issuer))
        return Asset.make(code.arm,
                          AlphaNum12(assetCode=code.value, issuer=issuer))

    def do_check_valid(self, ledger_version: int):
        from stellar_tpu_torch.tx.asset_utils import is_raw_code_valid
        Code = AllowTrustResultCode
        if not is_raw_code_valid(self.body.asset.arm,
                                 self.body.asset.value):
            return False, self.make_result(Code.ALLOW_TRUST_MALFORMED)
        if self.body.authorize & ~TRUST_AUTH_FLAGS:
            return False, self.make_result(Code.ALLOW_TRUST_MALFORMED)
        if self.body.trustor == self.source_account_id():
            return False, self.make_result(
                Code.ALLOW_TRUST_SELF_NOT_ALLOWED)
        return True, None

    def pre_trustline_revocation_check(self, auth_revocable: bool):
        # reference AllowTrustOpFrame::isAuthRevocationValid: a full
        # revocation from a non-revocable issuer fails before the
        # trustline is consulted
        if not auth_revocable and self.body.authorize == 0:
            return self.make_result(
                AllowTrustResultCode.ALLOW_TRUST_CANT_REVOKE)
        return None

    def _expected_flags(self, cur_flags: int):
        new = (cur_flags & ~TRUST_AUTH_FLAGS) | self.body.authorize
        return True, new, None

    def _no_trustline(self):
        return self._fail(AllowTrustResultCode.ALLOW_TRUST_NO_TRUST_LINE)

    def _cant_revoke(self):
        return self._fail(AllowTrustResultCode.ALLOW_TRUST_CANT_REVOKE)

    def _low_reserve(self):
        return self.make_result(AllowTrustResultCode.ALLOW_TRUST_LOW_RESERVE)

    def _success(self):
        return self.make_result(AllowTrustResultCode.ALLOW_TRUST_SUCCESS)


@register_op(OperationType.SET_TRUST_LINE_FLAGS)
class SetTrustLineFlagsOpFrame(_TrustFlagsBase):

    def trustor(self):
        return self.body.trustor

    def op_asset(self):
        return self.body.asset

    def do_check_valid(self, ledger_version: int):
        Code = SetTrustLineFlagsResultCode
        b = self.body
        if b.trustor == self.source_account_id():
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        if is_native(b.asset) or \
                not is_asset_valid(b.asset, ledger_version):
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        if get_issuer(b.asset) != self.source_account_id():
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.setFlags & b.clearFlags:
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        if (b.setFlags | b.clearFlags) & ~MASK_TRUSTLINE_FLAGS_V17:
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        # clawback flag can only be cleared, never set, per trustline
        if b.setFlags & TRUSTLINE_CLAWBACK_ENABLED_FLAG:
            return False, self.make_result(
                Code.SET_TRUST_LINE_FLAGS_MALFORMED)
        return True, None

    def _expected_flags(self, cur_flags: int):
        new = (cur_flags & ~self.body.clearFlags) | self.body.setFlags
        # AUTHORIZED and MAINTAIN_LIABILITIES are mutually exclusive
        if (new & AUTHORIZED_FLAG) and \
                (new & AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return False, 0, self.make_result(
                SetTrustLineFlagsResultCode
                .SET_TRUST_LINE_FLAGS_INVALID_STATE)
        return True, new, None

    def _no_trustline(self):
        return self._fail(
            SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_NO_TRUST_LINE)

    def _cant_revoke(self):
        return self._fail(
            SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_CANT_REVOKE)

    def _low_reserve(self):
        return self.make_result(
            SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_LOW_RESERVE)

    def _success(self):
        return self.make_result(
            SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_SUCCESS)
