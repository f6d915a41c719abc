"""Asset helpers: validity, issuer extraction, trustline keys
(reference ``src/util/types.cpp`` ``isAssetValid``/``getIssuer`` and
``src/transactions/TransactionUtils.cpp`` ``trustlineKey``).

The port's copy of ``stellar_tpu/tx/asset_utils.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.types import (
    Asset, AssetType, LedgerEntryType, LedgerKey, LedgerKeyTrustLine,
    TrustLineAsset,
)

__all__ = [
    "is_asset_code_valid", "is_asset_valid", "get_issuer",
    "asset_to_trustline_asset", "trustline_key", "is_native",
    "asset_lt", "is_change_trust_asset_valid", "pool_id_from_params",
    "change_trust_asset_to_trustline_asset", "pool_share_trustline_key",
    "liquidity_pool_key", "LIQUIDITY_POOL_FEE_V18",
]

LIQUIDITY_POOL_FEE_V18 = 30  # basis points (Stellar-ledger-entries.x)

_ALNUM = set(b"abcdefghijklmnopqrstuvwxyz"
             b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")


def _code_ok(code: bytes, min_len: int, max_len: int) -> bool:
    """Zero-padded [a-zA-Z0-9]+ of length in [min_len, max_len]
    (reference ``isStringValid``/``isAssetValid``)."""
    n = len(code)
    # find content length: chars up to first NUL; rest must be NUL
    content = code.rstrip(b"\x00")
    if not (min_len <= len(content) <= max_len):
        return False
    if any(c not in _ALNUM for c in content):
        return False
    return code[len(content):] == b"\x00" * (n - len(content))


def is_asset_code_valid(asset) -> bool:
    if asset.arm == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
        return _code_ok(asset.value.assetCode, 1, 4)
    if asset.arm == AssetType.ASSET_TYPE_CREDIT_ALPHANUM12:
        return _code_ok(asset.value.assetCode, 5, 12)
    return False


def is_raw_code_valid(arm: int, code: bytes) -> bool:
    """Validity of bare AssetCode union contents (AllowTrustOp carries
    the code bytes without an issuer)."""
    if arm == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
        return _code_ok(code, 1, 4)
    if arm == AssetType.ASSET_TYPE_CREDIT_ALPHANUM12:
        return _code_ok(code, 5, 12)
    return False


def is_native(asset) -> bool:
    return asset.arm == AssetType.ASSET_TYPE_NATIVE


def is_asset_valid(asset, ledger_version: int) -> bool:
    if asset.arm == AssetType.ASSET_TYPE_NATIVE:
        return True
    if asset.arm in (AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                     AssetType.ASSET_TYPE_CREDIT_ALPHANUM12):
        return is_asset_code_valid(asset)
    return False


def get_issuer(asset):
    return asset.value.issuer


def asset_to_trustline_asset(asset):
    return TrustLineAsset.make(asset.arm, asset.value)


def trustline_key(account_id, asset) -> "LedgerKey.Value":
    # Asset and TrustLineAsset share arm values for the asset kinds a
    # trustline key can name, so re-tagging the same payload is exact.
    return LedgerKey.make(
        LedgerEntryType.TRUSTLINE,
        LedgerKeyTrustLine(accountID=account_id,
                           asset=asset_to_trustline_asset(asset)))


# ---------------- liquidity-pool assets ----------------

def asset_lt(a, b) -> bool:
    """Canonical asset ordering (reference xdrpp ``operator<`` on Asset).
    Field-order comparison equals byte order of the XDR encoding for
    assets: type discriminant, then code, then issuer key."""
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return to_bytes(Asset, a) < to_bytes(Asset, b)


def is_change_trust_asset_valid(ct_asset, ledger_version: int) -> bool:
    """ChangeTrustAsset validity incl. the pool-share arm (reference
    ``isPoolShareAssetValid(ChangeTrustAsset)``, util/types.cpp:132):
    both constituents valid, strictly ordered, canonical fee."""
    if ct_asset.arm != AssetType.ASSET_TYPE_POOL_SHARE:
        return is_asset_valid(ct_asset, ledger_version)
    cp = ct_asset.value.value  # LiquidityPoolParameters -> constantProduct
    return (is_asset_valid(cp.assetA, ledger_version) and
            is_asset_valid(cp.assetB, ledger_version) and
            asset_lt(cp.assetA, cp.assetB) and
            cp.fee == LIQUIDITY_POOL_FEE_V18)


def pool_id_from_params(params) -> bytes:
    """PoolID = SHA-256 of the XDR LiquidityPoolParameters (reference
    ``changeTrustAssetToTrustLineAsset`` → ``xdrSha256``)."""
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.types import LiquidityPoolParameters
    return sha256(to_bytes(LiquidityPoolParameters, params))


def change_trust_asset_to_trustline_asset(ct_asset):
    if ct_asset.arm == AssetType.ASSET_TYPE_POOL_SHARE:
        return TrustLineAsset.make(AssetType.ASSET_TYPE_POOL_SHARE,
                                   pool_id_from_params(ct_asset.value))
    return TrustLineAsset.make(ct_asset.arm, ct_asset.value)


def pool_share_trustline_key(account_id, pool_id: bytes):
    return LedgerKey.make(
        LedgerEntryType.TRUSTLINE,
        LedgerKeyTrustLine(
            accountID=account_id,
            asset=TrustLineAsset.make(AssetType.ASSET_TYPE_POOL_SHARE,
                                      pool_id)))


def liquidity_pool_key(pool_id: bytes):
    from stellar_tpu_torch.xdr.types import LedgerKeyLiquidityPool
    return LedgerKey.make(
        LedgerEntryType.LIQUIDITY_POOL,
        LedgerKeyLiquidityPool(liquidityPoolID=pool_id))
