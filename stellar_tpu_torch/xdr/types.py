"""Stellar base XDR types + ledger entries (wire-compatible).

Python declarations of the protocol structures the reference gets from its
``.x`` submodule (``src/protocol-curr/xdr``: Stellar-types.x,
Stellar-ledger-entries.x; compiled by xdrc per ``src/Makefile.am:88-91``).
Encodings are byte-identical to the canonical protocol so hashes agree.

The port's copy of ``stellar_tpu/xdr/types.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.runtime import (
    Bool, Enum, FixedArray, Int32, Int64, Opaque, Option, Struct, Uint32,
    Uint64, Union, VarArray, VarOpaque, Void, XdrString,
)

# ---------------- Stellar-types.x ----------------

Hash = Opaque(32)
Uint256 = Opaque(32)
SignatureHint = Opaque(4)
Signature = VarOpaque(64)

CryptoKeyType = Enum("CryptoKeyType", {
    "KEY_TYPE_ED25519": 0,
    "KEY_TYPE_PRE_AUTH_TX": 1,
    "KEY_TYPE_HASH_X": 2,
    "KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
    "KEY_TYPE_MUXED_ED25519": 0x100,
})

PublicKeyType = Enum("PublicKeyType", {"PUBLIC_KEY_TYPE_ED25519": 0})

PublicKey = Union("PublicKey", PublicKeyType, {
    PublicKeyType.PUBLIC_KEY_TYPE_ED25519: Uint256,
})

AccountID = PublicKey
NodeID = PublicKey
PoolID = Hash


def account_id(ed25519: bytes):
    """Convenience: raw 32-byte key -> AccountID value."""
    return PublicKey.make(PublicKeyType.PUBLIC_KEY_TYPE_ED25519, ed25519)


def account_ed25519(v) -> bytes:
    return v.value


SignerKeyType = Enum("SignerKeyType", {
    "SIGNER_KEY_TYPE_ED25519": 0,
    "SIGNER_KEY_TYPE_PRE_AUTH_TX": 1,
    "SIGNER_KEY_TYPE_HASH_X": 2,
    "SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
})


class SignerKeyEd25519SignedPayload(Struct):
    FIELDS = [("ed25519", Uint256), ("payload", VarOpaque(64))]


SignerKey = Union("SignerKey", SignerKeyType, {
    SignerKeyType.SIGNER_KEY_TYPE_ED25519: Uint256,
    SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX: Uint256,
    SignerKeyType.SIGNER_KEY_TYPE_HASH_X: Uint256,
    SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
        SignerKeyEd25519SignedPayload,
})


class Curve25519Secret(Struct):
    FIELDS = [("key", Opaque(32))]


class Curve25519Public(Struct):
    FIELDS = [("key", Opaque(32))]


class HmacSha256Key(Struct):
    FIELDS = [("key", Opaque(32))]


class HmacSha256Mac(Struct):
    FIELDS = [("mac", Opaque(32))]


# ---------------- Stellar-ledger-entries.x ----------------

Thresholds = Opaque(4)
String32 = XdrString(32)
String64 = XdrString(64)
SequenceNumber = Int64
TimePoint = Uint64
Duration = Uint64
DataValue = VarOpaque(64)

AssetCode4 = Opaque(4)
AssetCode12 = Opaque(12)

AssetType = Enum("AssetType", {
    "ASSET_TYPE_NATIVE": 0,
    "ASSET_TYPE_CREDIT_ALPHANUM4": 1,
    "ASSET_TYPE_CREDIT_ALPHANUM12": 2,
    "ASSET_TYPE_POOL_SHARE": 3,
})

AssetCode = Union("AssetCode", AssetType, {
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: AssetCode4,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: AssetCode12,
})


class AlphaNum4(Struct):
    FIELDS = [("assetCode", AssetCode4), ("issuer", AccountID)]


class AlphaNum12(Struct):
    FIELDS = [("assetCode", AssetCode12), ("issuer", AccountID)]


Asset = Union("Asset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: Void,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: AlphaNum4,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: AlphaNum12,
})

NATIVE_ASSET = Asset.make(AssetType.ASSET_TYPE_NATIVE)


def asset_alphanum4(code: bytes, issuer) -> Union.Value:
    code = code.ljust(4, b"\x00")
    return Asset.make(AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                      AlphaNum4(assetCode=code, issuer=issuer))


class Price(Struct):
    FIELDS = [("n", Int32), ("d", Int32)]


class Liabilities(Struct):
    FIELDS = [("buying", Int64), ("selling", Int64)]


THRESHOLD_MASTER_WEIGHT = 0
THRESHOLD_LOW = 1
THRESHOLD_MED = 2
THRESHOLD_HIGH = 3

LedgerEntryType = Enum("LedgerEntryType", {
    "ACCOUNT": 0,
    "TRUSTLINE": 1,
    "OFFER": 2,
    "DATA": 3,
    "CLAIMABLE_BALANCE": 4,
    "LIQUIDITY_POOL": 5,
    "CONTRACT_DATA": 6,
    "CONTRACT_CODE": 7,
    "CONFIG_SETTING": 8,
    "TTL": 9,
})


class Signer(Struct):
    FIELDS = [("key", SignerKey), ("weight", Uint32)]


AUTH_REQUIRED_FLAG = 0x1
AUTH_REVOCABLE_FLAG = 0x2
AUTH_IMMUTABLE_FLAG = 0x4
AUTH_CLAWBACK_ENABLED_FLAG = 0x8
MASK_ACCOUNT_FLAGS_V17 = 0xF

MAX_SIGNERS = 20

SponsorshipDescriptor = Option(AccountID)


class AccountEntryExtensionV3(Struct):
    FIELDS = [("ext", None), ("seqLedger", Uint32), ("seqTime", TimePoint)]


class AccountEntryExtensionV2(Struct):
    FIELDS = [("numSponsored", Uint32), ("numSponsoring", Uint32),
              ("signerSponsoringIDs",
               VarArray(SponsorshipDescriptor, MAX_SIGNERS)),
              ("ext", None)]


class AccountEntryExtensionV1(Struct):
    FIELDS = [("liabilities", Liabilities), ("ext", None)]


# ExtensionPoint: union(int v) { case 0: void }
ExtensionPoint = Union("ExtensionPoint", Int32, {0: Void})

AccountEntryExtensionV3.FIELDS[0] = ("ext", ExtensionPoint)
AccountEntryExtensionV3._types = (
    ExtensionPoint,) + AccountEntryExtensionV3._types[1:]

_AEV2Ext = Union("AccountEntryExtensionV2.ext", Int32, {
    0: Void, 3: AccountEntryExtensionV3})
AccountEntryExtensionV2.FIELDS[3] = ("ext", _AEV2Ext)
AccountEntryExtensionV2._types = (
    AccountEntryExtensionV2._types[:3] + (_AEV2Ext,))

_AEV1Ext = Union("AccountEntryExtensionV1.ext", Int32, {
    0: Void, 2: AccountEntryExtensionV2})
AccountEntryExtensionV1.FIELDS[1] = ("ext", _AEV1Ext)
AccountEntryExtensionV1._types = (Liabilities, _AEV1Ext)

_AccountEntryExt = Union("AccountEntry.ext", Int32, {
    0: Void, 1: AccountEntryExtensionV1})


class AccountEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("balance", Int64),
        ("seqNum", SequenceNumber),
        ("numSubEntries", Uint32),
        ("inflationDest", Option(AccountID)),
        ("flags", Uint32),
        ("homeDomain", String32),
        ("thresholds", Thresholds),
        ("signers", VarArray(Signer, MAX_SIGNERS)),
        ("ext", _AccountEntryExt),
    ]


TrustLineAsset = Union("TrustLineAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: Void,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: AlphaNum4,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: AlphaNum12,
    AssetType.ASSET_TYPE_POOL_SHARE: PoolID,
})

AUTHORIZED_FLAG = 1
AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG = 2
TRUSTLINE_CLAWBACK_ENABLED_FLAG = 4
MASK_TRUSTLINE_FLAGS_V17 = 7


class TrustLineEntryExtensionV2(Struct):
    FIELDS = [("liquidityPoolUseCount", Int32),
              ("ext", Union("TLEV2.ext", Int32, {0: Void}))]


class TrustLineEntryV1(Struct):
    FIELDS = [("liabilities", Liabilities),
              ("ext", Union("TLEV1.ext", Int32, {
                  0: Void, 2: TrustLineEntryExtensionV2}))]


class TrustLineEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("asset", TrustLineAsset),
        ("balance", Int64),
        ("limit", Int64),
        ("flags", Uint32),
        ("ext", Union("TrustLineEntry.ext", Int32, {
            0: Void, 1: TrustLineEntryV1})),
    ]


PASSIVE_FLAG = 1


class OfferEntry(Struct):
    FIELDS = [
        ("sellerID", AccountID),
        ("offerID", Int64),
        ("selling", Asset),
        ("buying", Asset),
        ("amount", Int64),
        ("price", Price),
        ("flags", Uint32),
        ("ext", Union("OfferEntry.ext", Int32, {0: Void})),
    ]


class DataEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("dataName", String64),
        ("dataValue", DataValue),
        ("ext", Union("DataEntry.ext", Int32, {0: Void})),
    ]


ClaimPredicateType = Enum("ClaimPredicateType", {
    "CLAIM_PREDICATE_UNCONDITIONAL": 0,
    "CLAIM_PREDICATE_AND": 1,
    "CLAIM_PREDICATE_OR": 2,
    "CLAIM_PREDICATE_NOT": 3,
    "CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME": 4,
    "CLAIM_PREDICATE_BEFORE_RELATIVE_TIME": 5,
})


class _ClaimPredicate:
    """Recursive union — delegates to a lazily-built Union."""

    def __init__(self):
        self._u = None

    def _real(self):
        if self._u is None:
            self._u = Union("ClaimPredicate", ClaimPredicateType, {
                ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL: Void,
                ClaimPredicateType.CLAIM_PREDICATE_AND: VarArray(self, 2),
                ClaimPredicateType.CLAIM_PREDICATE_OR: VarArray(self, 2),
                ClaimPredicateType.CLAIM_PREDICATE_NOT: Option(self),
                ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
                    Int64,
                ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
                    Int64,
            })
        return self._u

    def make(self, arm, value=None):
        return self._real().make(arm, value)

    def pack(self, p, v):
        self._real().pack(p, v)

    def unpack(self, u):
        return self._real().unpack(u)

    def copy(self, v):
        return self._real().copy(v)


ClaimPredicate = _ClaimPredicate()

ClaimantType = Enum("ClaimantType", {"CLAIMANT_TYPE_V0": 0})


class ClaimantV0(Struct):
    FIELDS = [("destination", AccountID), ("predicate", ClaimPredicate)]


Claimant = Union("Claimant", ClaimantType,
                 {ClaimantType.CLAIMANT_TYPE_V0: ClaimantV0})

ClaimableBalanceIDType = Enum("ClaimableBalanceIDType", {
    "CLAIMABLE_BALANCE_ID_TYPE_V0": 0})

ClaimableBalanceID = Union(
    "ClaimableBalanceID", ClaimableBalanceIDType,
    {ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0: Hash})

CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG = 1


class ClaimableBalanceEntryExtensionV1(Struct):
    FIELDS = [("ext", Union("CBEV1.ext", Int32, {0: Void})),
              ("flags", Uint32)]


class ClaimableBalanceEntry(Struct):
    FIELDS = [
        ("balanceID", ClaimableBalanceID),
        ("claimants", VarArray(Claimant, 10)),
        ("asset", Asset),
        ("amount", Int64),
        ("ext", Union("ClaimableBalanceEntry.ext", Int32, {
            0: Void, 1: ClaimableBalanceEntryExtensionV1})),
    ]


class LiquidityPoolConstantProductParameters(Struct):
    FIELDS = [("assetA", Asset), ("assetB", Asset), ("fee", Int32)]


LIQUIDITY_POOL_FEE_V18 = 30

LiquidityPoolType = Enum("LiquidityPoolType", {
    "LIQUIDITY_POOL_CONSTANT_PRODUCT": 0})

LiquidityPoolParameters = Union(
    "LiquidityPoolParameters", LiquidityPoolType,
    {LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
     LiquidityPoolConstantProductParameters})


class LiquidityPoolEntryConstantProduct(Struct):
    FIELDS = [
        ("params", LiquidityPoolConstantProductParameters),
        ("reserveA", Int64),
        ("reserveB", Int64),
        ("totalPoolShares", Int64),
        ("poolSharesTrustLineCount", Int64),
    ]


class LiquidityPoolEntry(Struct):
    FIELDS = [
        ("liquidityPoolID", PoolID),
        ("body", Union("LiquidityPoolEntry.body", LiquidityPoolType, {
            LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
                LiquidityPoolEntryConstantProduct})),
    ]


class TTLEntry(Struct):
    FIELDS = [("keyHash", Hash), ("liveUntilLedgerSeq", Uint32)]


class LedgerEntryExtensionV1(Struct):
    FIELDS = [("sponsoringID", SponsorshipDescriptor),
              ("ext", Union("LEEV1.ext", Int32, {0: Void}))]


class _LazyArm:
    """Defer an arm's payload type to break the types<->contract import
    cycle (ContractDataEntry/ContractCodeEntry live in xdr.contract,
    which imports this module)."""

    def __init__(self, loader):
        self._loader = loader
        self._t = None

    def _real(self):
        if self._t is None:
            self._t = self._loader()
            # collapse the indirection: instance attributes shadow the
            # class methods, so later calls skip this wrapper entirely
            self.pack = self._t.pack
            self.unpack = self._t.unpack
            self.copy = self._t.copy
        return self._t

    def pack(self, p, v):
        self._real().pack(p, v)

    def unpack(self, u):
        return self._real().unpack(u)

    def copy(self, v):
        return self._real().copy(v)


def _contract_data_entry():
    from stellar_tpu_torch.xdr.contract import ContractDataEntry
    return ContractDataEntry


def _contract_code_entry():
    from stellar_tpu_torch.xdr.contract import ContractCodeEntry
    return ContractCodeEntry


def _config_setting_entry():
    from stellar_tpu_torch.xdr.contract import ConfigSettingEntry
    return ConfigSettingEntry


LedgerEntryData = Union("LedgerEntry.data", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: AccountEntry,
    LedgerEntryType.TRUSTLINE: TrustLineEntry,
    LedgerEntryType.OFFER: OfferEntry,
    LedgerEntryType.DATA: DataEntry,
    LedgerEntryType.CLAIMABLE_BALANCE: ClaimableBalanceEntry,
    LedgerEntryType.LIQUIDITY_POOL: LiquidityPoolEntry,
    LedgerEntryType.CONTRACT_DATA: _LazyArm(_contract_data_entry),
    LedgerEntryType.CONTRACT_CODE: _LazyArm(_contract_code_entry),
    LedgerEntryType.CONFIG_SETTING: _LazyArm(_config_setting_entry),
    LedgerEntryType.TTL: TTLEntry,
})


class LedgerEntry(Struct):
    FIELDS = [
        ("lastModifiedLedgerSeq", Uint32),
        ("data", LedgerEntryData),
        ("ext", Union("LedgerEntry.ext", Int32, {
            0: Void, 1: LedgerEntryExtensionV1})),
    ]


class LedgerKeyAccount(Struct):
    FIELDS = [("accountID", AccountID)]


class LedgerKeyTrustLine(Struct):
    FIELDS = [("accountID", AccountID), ("asset", TrustLineAsset)]


class LedgerKeyOffer(Struct):
    FIELDS = [("sellerID", AccountID), ("offerID", Int64)]


class LedgerKeyData(Struct):
    FIELDS = [("accountID", AccountID), ("dataName", String64)]


class LedgerKeyClaimableBalance(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class LedgerKeyLiquidityPool(Struct):
    FIELDS = [("liquidityPoolID", PoolID)]


class LedgerKeyTtl(Struct):
    FIELDS = [("keyHash", Hash)]


def _config_setting_id():
    from stellar_tpu_torch.xdr.contract import ConfigSettingID
    return ConfigSettingID


class LedgerKeyConfigSetting(Struct):
    # field type resolved lazily (ConfigSettingID lives in contract.py,
    # which imports this module)
    FIELDS = [("configSettingID", _LazyArm(_config_setting_id))]


def _contract_data_key():
    from stellar_tpu_torch.xdr.contract import LedgerKeyContractData
    return LedgerKeyContractData


def _contract_code_key():
    from stellar_tpu_torch.xdr.contract import LedgerKeyContractCode
    return LedgerKeyContractCode


LedgerKey = Union("LedgerKey", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: LedgerKeyAccount,
    LedgerEntryType.TRUSTLINE: LedgerKeyTrustLine,
    LedgerEntryType.OFFER: LedgerKeyOffer,
    LedgerEntryType.DATA: LedgerKeyData,
    LedgerEntryType.CLAIMABLE_BALANCE: LedgerKeyClaimableBalance,
    LedgerEntryType.LIQUIDITY_POOL: LedgerKeyLiquidityPool,
    LedgerEntryType.CONTRACT_DATA: _LazyArm(_contract_data_key),
    LedgerEntryType.CONTRACT_CODE: _LazyArm(_contract_code_key),
    LedgerEntryType.CONFIG_SETTING: LedgerKeyConfigSetting,
    LedgerEntryType.TTL: LedgerKeyTtl,
})

EnvelopeType = Enum("EnvelopeType", {
    "ENVELOPE_TYPE_TX_V0": 0,
    "ENVELOPE_TYPE_SCP": 1,
    "ENVELOPE_TYPE_TX": 2,
    "ENVELOPE_TYPE_AUTH": 3,
    "ENVELOPE_TYPE_SCPVALUE": 4,
    "ENVELOPE_TYPE_TX_FEE_BUMP": 5,
    "ENVELOPE_TYPE_OP_ID": 6,
    "ENVELOPE_TYPE_POOL_REVOKE_OP_ID": 7,
    "ENVELOPE_TYPE_CONTRACT_ID": 8,
    "ENVELOPE_TYPE_SOROBAN_AUTHORIZATION": 9,
})
