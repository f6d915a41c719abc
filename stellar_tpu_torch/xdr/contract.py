"""Soroban contract XDR: SCVal tree, addresses, host functions, auth.

Python declarations of the structures the reference gets from
``Stellar-contract.x`` / ``Stellar-transaction.x`` (Soroban sections) in
its ``src/protocol-curr/xdr`` submodule. Wire-compatible encodings.

The port's copy of ``stellar_tpu/xdr/contract.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.runtime import (
    Bool, Enum, Int32, Int64, Opaque, Option, Struct, Uint32, Uint64,
    Union, VarArray, VarOpaque, Void, XdrString,
)
from stellar_tpu_torch.xdr.types import (
    AccountID, Asset, ExtensionPoint, Hash, Uint256,
)

# ---------------- error values ----------------

SCErrorType = Enum("SCErrorType", {
    "SCE_CONTRACT": 0,
    "SCE_WASM_VM": 1,
    "SCE_CONTEXT": 2,
    "SCE_STORAGE": 3,
    "SCE_OBJECT": 4,
    "SCE_CRYPTO": 5,
    "SCE_EVENTS": 6,
    "SCE_BUDGET": 7,
    "SCE_VALUE": 8,
    "SCE_AUTH": 9,
})

SCErrorCode = Enum("SCErrorCode", {
    "SCEC_ARITH_DOMAIN": 0,
    "SCEC_INDEX_BOUNDS": 1,
    "SCEC_INVALID_INPUT": 2,
    "SCEC_MISSING_VALUE": 3,
    "SCEC_EXISTING_VALUE": 4,
    "SCEC_EXCEEDED_LIMIT": 5,
    "SCEC_INVALID_ACTION": 6,
    "SCEC_INTERNAL_ERROR": 7,
    "SCEC_UNEXPECTED_TYPE": 8,
    "SCEC_UNEXPECTED_SIZE": 9,
})

SCError = Union("SCError", SCErrorType, {
    SCErrorType.SCE_CONTRACT: Uint32,
}, default=SCErrorCode)

# ---------------- big ints ----------------


class UInt128Parts(Struct):
    FIELDS = [("hi", Uint64), ("lo", Uint64)]


class Int128Parts(Struct):
    FIELDS = [("hi", Int64), ("lo", Uint64)]


class UInt256Parts(Struct):
    FIELDS = [("hi_hi", Uint64), ("hi_lo", Uint64),
              ("lo_hi", Uint64), ("lo_lo", Uint64)]


class Int256Parts(Struct):
    FIELDS = [("hi_hi", Int64), ("hi_lo", Uint64),
              ("lo_hi", Uint64), ("lo_lo", Uint64)]


# ---------------- addresses ----------------

SCAddressType = Enum("SCAddressType", {
    "SC_ADDRESS_TYPE_ACCOUNT": 0,
    "SC_ADDRESS_TYPE_CONTRACT": 1,
})

ContractID = Hash

SCAddress = Union("SCAddress", SCAddressType, {
    SCAddressType.SC_ADDRESS_TYPE_ACCOUNT: AccountID,
    SCAddressType.SC_ADDRESS_TYPE_CONTRACT: ContractID,
})


def contract_address(contract_id: bytes):
    return SCAddress.make(SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                          contract_id)


def account_address(acct) -> "Union.Value":
    return SCAddress.make(SCAddressType.SC_ADDRESS_TYPE_ACCOUNT, acct)


# ---------------- SCVal ----------------

SCValType = Enum("SCValType", {
    "SCV_BOOL": 0,
    "SCV_VOID": 1,
    "SCV_ERROR": 2,
    "SCV_U32": 3,
    "SCV_I32": 4,
    "SCV_U64": 5,
    "SCV_I64": 6,
    "SCV_TIMEPOINT": 7,
    "SCV_DURATION": 8,
    "SCV_U128": 9,
    "SCV_I128": 10,
    "SCV_U256": 11,
    "SCV_I256": 12,
    "SCV_BYTES": 13,
    "SCV_STRING": 14,
    "SCV_SYMBOL": 15,
    "SCV_VEC": 16,
    "SCV_MAP": 17,
    "SCV_ADDRESS": 18,
    "SCV_CONTRACT_INSTANCE": 19,
    "SCV_LEDGER_KEY_CONTRACT_INSTANCE": 20,
    "SCV_LEDGER_KEY_NONCE": 21,
})

SCSymbol = XdrString(32)
SCString = XdrString()
SCBytes = VarOpaque()


class SCNonceKey(Struct):
    FIELDS = [("nonce", Int64)]


ContractExecutableType = Enum("ContractExecutableType", {
    "CONTRACT_EXECUTABLE_WASM": 0,
    "CONTRACT_EXECUTABLE_STELLAR_ASSET": 1,
})

ContractExecutable = Union("ContractExecutable", ContractExecutableType, {
    ContractExecutableType.CONTRACT_EXECUTABLE_WASM: Hash,
    ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET: Void,
})


class _SCValLazy:
    """Recursive union (vec/map/instance contain SCVals)."""

    def __init__(self):
        self._u = None

    def _real(self):
        if self._u is None:
            sc_vec = VarArray(self)
            sc_map = VarArray(SCMapEntry)
            instance = SCContractInstance
            self._u = Union("SCVal", SCValType, {
                SCValType.SCV_BOOL: Bool,
                SCValType.SCV_VOID: Void,
                SCValType.SCV_ERROR: SCError,
                SCValType.SCV_U32: Uint32,
                SCValType.SCV_I32: Int32,
                SCValType.SCV_U64: Uint64,
                SCValType.SCV_I64: Int64,
                SCValType.SCV_TIMEPOINT: Uint64,
                SCValType.SCV_DURATION: Uint64,
                SCValType.SCV_U128: UInt128Parts,
                SCValType.SCV_I128: Int128Parts,
                SCValType.SCV_U256: UInt256Parts,
                SCValType.SCV_I256: Int256Parts,
                SCValType.SCV_BYTES: SCBytes,
                SCValType.SCV_STRING: SCString,
                SCValType.SCV_SYMBOL: SCSymbol,
                SCValType.SCV_VEC: Option(sc_vec),
                SCValType.SCV_MAP: Option(sc_map),
                SCValType.SCV_ADDRESS: SCAddress,
                SCValType.SCV_CONTRACT_INSTANCE: instance,
                SCValType.SCV_LEDGER_KEY_CONTRACT_INSTANCE: Void,
                SCValType.SCV_LEDGER_KEY_NONCE: SCNonceKey,
            })
        return self._u

    def make(self, arm, value=None):
        return self._real().make(arm, value)

    def pack(self, p, v):
        u = self._real()
        # collapse the indirection for every later call
        self.pack = u.pack
        u.pack(p, v)

    def unpack(self, u_):
        u = self._real()
        self.unpack = u.unpack
        return u.unpack(u_)

    def copy(self, v):
        u = self._real()
        self.copy = u.copy
        return u.copy(v)


SCVal = _SCValLazy()


class SCMapEntry(Struct):
    FIELDS = [("key", SCVal), ("val", SCVal)]


class SCContractInstance(Struct):
    FIELDS = [("executable", ContractExecutable),
              ("storage", Option(VarArray(SCMapEntry)))]


# convenience constructors (the sdk-style sugar used by tests/loadgen)

def scv_u32(v):
    return SCVal.make(SCValType.SCV_U32, v)


def scv_i64(v):
    return SCVal.make(SCValType.SCV_I64, v)


def scv_u64(v):
    return SCVal.make(SCValType.SCV_U64, v)


def scv_bytes(b):
    return SCVal.make(SCValType.SCV_BYTES, b)


def scv_symbol(s):
    return SCVal.make(SCValType.SCV_SYMBOL,
                      s.encode() if isinstance(s, str) else s)


def scv_void():
    return SCVal.make(SCValType.SCV_VOID)


def scv_bool(b):
    return SCVal.make(SCValType.SCV_BOOL, bool(b))


def scv_vec(items):
    return SCVal.make(SCValType.SCV_VEC, list(items))


def scv_map(pairs):
    return SCVal.make(SCValType.SCV_MAP,
                      [SCMapEntry(key=k, val=v) for k, v in pairs])


def scv_address(addr):
    return SCVal.make(SCValType.SCV_ADDRESS, addr)


def scv_i128(v: int):
    if not -(2**127) <= v < 2**127:
        raise ValueError("i128 out of range")
    lo = v & 0xFFFFFFFFFFFFFFFF
    hi = (v >> 64)
    return SCVal.make(SCValType.SCV_I128, Int128Parts(hi=hi, lo=lo))


# ---------------- host functions & auth ----------------


class InvokeContractArgs(Struct):
    FIELDS = [("contractAddress", SCAddress),
              ("functionName", SCSymbol),
              ("args", VarArray(SCVal))]


ContractIDPreimageType = Enum("ContractIDPreimageType", {
    "CONTRACT_ID_PREIMAGE_FROM_ADDRESS": 0,
    "CONTRACT_ID_PREIMAGE_FROM_ASSET": 1,
})


class ContractIDPreimageFromAddress(Struct):
    FIELDS = [("address", SCAddress), ("salt", Uint256)]


ContractIDPreimage = Union("ContractIDPreimage", ContractIDPreimageType, {
    ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS:
        ContractIDPreimageFromAddress,
    ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET: Asset,
})


class CreateContractArgs(Struct):
    FIELDS = [("contractIDPreimage", ContractIDPreimage),
              ("executable", ContractExecutable)]


class CreateContractArgsV2(Struct):
    FIELDS = [("contractIDPreimage", ContractIDPreimage),
              ("executable", ContractExecutable),
              ("constructorArgs", VarArray(SCVal))]


HostFunctionType = Enum("HostFunctionType", {
    "HOST_FUNCTION_TYPE_INVOKE_CONTRACT": 0,
    "HOST_FUNCTION_TYPE_CREATE_CONTRACT": 1,
    "HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM": 2,
    "HOST_FUNCTION_TYPE_CREATE_CONTRACT_V2": 3,
})

HostFunction = Union("HostFunction", HostFunctionType, {
    HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT:
        InvokeContractArgs,
    HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT:
        CreateContractArgs,
    HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM: VarOpaque(),
    HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT_V2:
        CreateContractArgsV2,
})

SorobanAuthorizedFunctionType = Enum("SorobanAuthorizedFunctionType", {
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN": 0,
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN": 1,
    "SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_V2_HOST_FN": 2,
})

SorobanAuthorizedFunction = Union(
    "SorobanAuthorizedFunction", SorobanAuthorizedFunctionType, {
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN: InvokeContractArgs,
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN:
            CreateContractArgs,
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_V2_HOST_FN:
            CreateContractArgsV2,
    })


class _AuthorizedInvocationLazy:
    """Recursive: subInvocations hold further invocations."""

    def __init__(self):
        self._t = None

    def _real(self):
        if self._t is None:
            self._t = SorobanAuthorizedInvocation
        return self._t

    def pack(self, p, v):
        self._real().pack(p, v)

    def unpack(self, u):
        return self._real().unpack(u)

    def copy(self, v):
        return self._real().copy(v)


class SorobanAuthorizedInvocation(Struct):
    FIELDS = [("function", SorobanAuthorizedFunction),
              ("subInvocations", VarArray(_AuthorizedInvocationLazy()))]


SorobanCredentialsType = Enum("SorobanCredentialsType", {
    "SOROBAN_CREDENTIALS_SOURCE_ACCOUNT": 0,
    "SOROBAN_CREDENTIALS_ADDRESS": 1,
})


class SorobanAddressCredentials(Struct):
    FIELDS = [("address", SCAddress),
              ("nonce", Int64),
              ("signatureExpirationLedger", Uint32),
              ("signature", SCVal)]


SorobanCredentials = Union("SorobanCredentials", SorobanCredentialsType, {
    SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT: Void,
    SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS:
        SorobanAddressCredentials,
})


class SorobanAuthorizationEntry(Struct):
    FIELDS = [("credentials", SorobanCredentials),
              ("rootInvocation", SorobanAuthorizedInvocation)]


# ---------------- contract ledger entries ----------------

ContractDataDurability = Enum("ContractDataDurability", {
    "TEMPORARY": 0,
    "PERSISTENT": 1,
})


class ContractDataEntry(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("contract", SCAddress),
              ("key", SCVal),
              ("durability", ContractDataDurability),
              ("val", SCVal)]


class ContractCodeCostInputs(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("nInstructions", Uint32),
              ("nFunctions", Uint32),
              ("nGlobals", Uint32),
              ("nTableEntries", Uint32),
              ("nTypes", Uint32),
              ("nDataSegments", Uint32),
              ("nElemSegments", Uint32),
              ("nImports", Uint32),
              ("nExports", Uint32),
              ("nDataSegmentBytes", Uint32)]


class ContractCodeEntryV1(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("costInputs", ContractCodeCostInputs)]


class ContractCodeEntry(Struct):
    FIELDS = [("ext", Union("ContractCodeEntry.ext", Int32, {
                  0: Void, 1: ContractCodeEntryV1})),
              ("hash", Hash),
              ("code", VarOpaque())]


# preimages used for contract-id derivation and soroban auth signing


class LedgerKeyContractData(Struct):
    FIELDS = [("contract", SCAddress),
              ("key", SCVal),
              ("durability", ContractDataDurability)]


class LedgerKeyContractCode(Struct):
    FIELDS = [("hash", Hash)]


# ---------------- contract events ----------------

ContractEventType = Enum("ContractEventType", {
    "SYSTEM": 0, "CONTRACT": 1, "DIAGNOSTIC": 2,
})


class ContractEventV0(Struct):
    FIELDS = [("topics", VarArray(SCVal)), ("data", SCVal)]


class ContractEvent(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("contractID", Option(Hash)),
              ("type", ContractEventType),
              ("body", Union("ContractEvent.body", Int32,
                             {0: ContractEventV0}))]


class InvokeHostFunctionSuccessPreImage(Struct):
    FIELDS = [("returnValue", SCVal),
              ("events", VarArray(ContractEvent))]


class HashIDPreimageContractID(Struct):
    FIELDS = [("networkID", Hash),
              ("contractIDPreimage", ContractIDPreimage)]


class HashIDPreimageSorobanAuthorization(Struct):
    FIELDS = [("networkID", Hash),
              ("nonce", Int64),
              ("signatureExpirationLedger", Uint32),
              ("invocation", SorobanAuthorizedInvocation)]


# ---------------- network config settings (upgradeable) ----------------

ConfigSettingID = Enum("ConfigSettingID", {
    "CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES": 0,
    "CONFIG_SETTING_CONTRACT_COMPUTE_V0": 1,
    "CONFIG_SETTING_CONTRACT_LEDGER_COST_V0": 2,
    "CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0": 3,
    "CONFIG_SETTING_CONTRACT_EVENTS_V0": 4,
    "CONFIG_SETTING_CONTRACT_BANDWIDTH_V0": 5,
    "CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS": 6,
    "CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES": 7,
    "CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES": 8,
    "CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES": 9,
    "CONFIG_SETTING_STATE_ARCHIVAL": 10,
    "CONFIG_SETTING_CONTRACT_EXECUTION_LANES": 11,
    "CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW": 12,
    "CONFIG_SETTING_EVICTION_ITERATOR": 13,
})


class ConfigSettingContractComputeV0(Struct):
    FIELDS = [("ledgerMaxInstructions", Int64),
              ("txMaxInstructions", Int64),
              ("feeRatePerInstructionsIncrement", Int64),
              ("txMemoryLimit", Uint32)]


class ConfigSettingContractLedgerCostV0(Struct):
    # field order mirrors the reference XDR (cross-checked against the
    # committed soroban-settings/pubnet_phase*.json serialization)
    FIELDS = [("ledgerMaxReadLedgerEntries", Uint32),
              ("ledgerMaxReadBytes", Uint32),
              ("ledgerMaxWriteLedgerEntries", Uint32),
              ("ledgerMaxWriteBytes", Uint32),
              ("txMaxReadLedgerEntries", Uint32),
              ("txMaxReadBytes", Uint32),
              ("txMaxWriteLedgerEntries", Uint32),
              ("txMaxWriteBytes", Uint32),
              ("feeReadLedgerEntry", Int64),
              ("feeWriteLedgerEntry", Int64),
              ("feeRead1KB", Int64),
              ("bucketListTargetSizeBytes", Int64),
              ("writeFee1KBBucketListLow", Int64),
              ("writeFee1KBBucketListHigh", Int64),
              ("bucketListWriteFeeGrowthFactor", Uint32)]


class ConfigSettingContractHistoricalDataV0(Struct):
    FIELDS = [("feeHistorical1KB", Int64)]


class ConfigSettingContractEventsV0(Struct):
    FIELDS = [("txMaxContractEventsSizeBytes", Uint32),
              ("feeContractEvents1KB", Int64)]


class StateArchivalSettings(Struct):
    FIELDS = [("maxEntryTTL", Uint32),
              ("minTemporaryTTL", Uint32),
              ("minPersistentTTL", Uint32),
              ("persistentRentRateDenominator", Int64),
              ("tempRentRateDenominator", Int64),
              ("maxEntriesToArchive", Uint32),
              ("bucketListSizeWindowSampleSize", Uint32),
              ("bucketListWindowSamplePeriod", Uint32),
              ("evictionScanSize", Uint32),
              ("startingEvictionScanLevel", Uint32)]


class EvictionIterator(Struct):
    FIELDS = [("bucketListLevel", Uint32),
              ("isCurrBucket", Bool),
              ("bucketFileOffset", Uint64)]


class ContractCostParamEntry(Struct):
    """One (const_term, linear_term) pricing row of the metered cost
    model (reference ContractCostParamEntry; linear term in 1/128
    units — see soroban/cost_model.py)."""
    FIELDS = [("ext", ExtensionPoint),
              ("constTerm", Int64),
              ("linearTerm", Int64)]


ContractCostParams = VarArray(ContractCostParamEntry, maxlen=1024)


class ConfigSettingContractExecutionLanesV0(Struct):
    FIELDS = [("ledgerMaxTxCount", Uint32)]


class ConfigSettingContractBandwidthV0(Struct):
    FIELDS = [("ledgerMaxTxsSizeBytes", Uint32),
              ("txMaxSizeBytes", Uint32),
              ("feeTxSize1KB", Int64)]


ConfigSettingEntry = Union("ConfigSettingEntry", ConfigSettingID, {
    ConfigSettingID.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES: Uint32,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_COMPUTE_V0:
        ConfigSettingContractComputeV0,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0:
        ConfigSettingContractLedgerCostV0,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0:
        ConfigSettingContractHistoricalDataV0,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_EVENTS_V0:
        ConfigSettingContractEventsV0,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0:
        ConfigSettingContractBandwidthV0,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS:
        ContractCostParams,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES:
        ContractCostParams,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES: Uint32,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES: Uint32,
    ConfigSettingID.CONFIG_SETTING_STATE_ARCHIVAL: StateArchivalSettings,
    ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES:
        ConfigSettingContractExecutionLanesV0,
    ConfigSettingID.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW:
        VarArray(Uint64),
    ConfigSettingID.CONFIG_SETTING_EVICTION_ITERATOR: EvictionIterator,
})


class ConfigUpgradeSet(Struct):
    FIELDS = [("updatedEntry", VarArray(ConfigSettingEntry))]
