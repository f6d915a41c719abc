"""The soroban metered cost model: ContractCostType + calibrated params.

The reference prices every host operation with a per-type linear model
``cpu_or_mem = const_term + linear_term * input / 128`` whose
calibrated parameters are CONSENSUS STATE, stored in two
CONFIG_SETTING ledger entries (cpu instructions / memory bytes) and
created or re-tuned at each protocol upgrade. The tables below
transcribe the reference's own initial values
(``src/ledger/NetworkConfig.cpp:240-330`` for the v20 cpu table,
``:360-440`` v21, ``:445-550`` v22; ``:607-840`` the memory tables) —
these are network constants, exactly like the ledger close cadence.

Type indices are the XDR ``ContractCostType`` enum order: the v20
table covers 0..22 (..ChaCha20DrawBytes), v21 appends 23..44
(wasm parse/instantiate split, secp256r1), v22 appends 45..69 (the
BLS12-381 family). Index order is cross-checked against the
reference's committed pubnet settings files
(``soroban-settings/pubnet_phase*.json``) by ``tests/test_cost_model``.

The linear term is fixed-point with a 1/128 scale (the soroban-env
``ScaledU64`` convention); ``eval_cost`` keeps the divisor in one
place should that convention ever need revisiting.

The port's copy of ``stellar_tpu/soroban/cost_model.py``, whole:
``ledger/network_config.py``'s ``setting_entry_from_config`` reads the
initial tables for the two cost-parameter settings.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["COST_TYPES", "cost_type_index", "initial_cost_params",
           "upgrade_cost_params", "eval_cost", "CostType",
           "COST_LINEAR_SCALE_BITS", "n_cost_types_for_protocol"]

COST_LINEAR_SCALE_BITS = 7  # linear_term is in 1/128 units

# name -> (index, min protocol era); order IS the XDR enum order
_P20, _P21, _P22 = 20, 21, 22

COST_TYPES: List[Tuple[str, int]] = [
    ("WasmInsnExec", _P20),               # 0
    ("MemAlloc", _P20),
    ("MemCpy", _P20),
    ("MemCmp", _P20),
    ("DispatchHostFunction", _P20),
    ("VisitObject", _P20),                # 5
    ("ValSer", _P20),
    ("ValDeser", _P20),
    ("ComputeSha256Hash", _P20),
    ("ComputeEd25519PubKey", _P20),
    ("VerifyEd25519Sig", _P20),           # 10
    ("VmInstantiation", _P20),
    ("VmCachedInstantiation", _P20),
    ("InvokeVmFunction", _P20),
    ("ComputeKeccak256Hash", _P20),
    ("DecodeEcdsaCurve256Sig", _P20),     # 15
    ("RecoverEcdsaSecp256k1Key", _P20),
    ("Int256AddSub", _P20),
    ("Int256Mul", _P20),
    ("Int256Div", _P20),
    ("Int256Pow", _P20),                  # 20
    ("Int256Shift", _P20),
    ("ChaCha20DrawBytes", _P20),
    ("ParseWasmInstructions", _P21),      # 23
    ("ParseWasmFunctions", _P21),
    ("ParseWasmGlobals", _P21),
    ("ParseWasmTableEntries", _P21),
    ("ParseWasmTypes", _P21),
    ("ParseWasmDataSegments", _P21),
    ("ParseWasmElemSegments", _P21),
    ("ParseWasmImports", _P21),           # 30
    ("ParseWasmExports", _P21),
    ("ParseWasmDataSegmentBytes", _P21),
    ("InstantiateWasmInstructions", _P21),
    ("InstantiateWasmFunctions", _P21),
    ("InstantiateWasmGlobals", _P21),     # 35
    ("InstantiateWasmTableEntries", _P21),
    ("InstantiateWasmTypes", _P21),
    ("InstantiateWasmDataSegments", _P21),
    ("InstantiateWasmElemSegments", _P21),
    ("InstantiateWasmImports", _P21),     # 40
    ("InstantiateWasmExports", _P21),
    ("InstantiateWasmDataSegmentBytes", _P21),
    ("Sec1DecodePointUncompressed", _P21),
    ("VerifyEcdsaSecp256r1Sig", _P21),    # 44
    ("Bls12381EncodeFp", _P22),           # 45
    ("Bls12381DecodeFp", _P22),
    ("Bls12381G1CheckPointOnCurve", _P22),
    ("Bls12381G1CheckPointInSubgroup", _P22),
    ("Bls12381G2CheckPointOnCurve", _P22),
    ("Bls12381G2CheckPointInSubgroup", _P22),  # 50
    ("Bls12381G1ProjectiveToAffine", _P22),
    ("Bls12381G2ProjectiveToAffine", _P22),
    ("Bls12381G1Add", _P22),
    ("Bls12381G1Mul", _P22),
    ("Bls12381G1Msm", _P22),              # 55
    ("Bls12381MapFpToG1", _P22),
    ("Bls12381HashToG1", _P22),
    ("Bls12381G2Add", _P22),
    ("Bls12381G2Mul", _P22),
    ("Bls12381G2Msm", _P22),              # 60
    ("Bls12381MapFp2ToG2", _P22),
    ("Bls12381HashToG2", _P22),
    ("Bls12381Pairing", _P22),
    ("Bls12381FrFromU256", _P22),
    ("Bls12381FrToU256", _P22),           # 65
    ("Bls12381FrAddSub", _P22),
    ("Bls12381FrMul", _P22),
    ("Bls12381FrPow", _P22),
    ("Bls12381FrInv", _P22),              # 69
]

_INDEX = {name: i for i, (name, _era) in enumerate(COST_TYPES)}


class CostType:
    """Symbolic index constants (CostType.VerifyEd25519Sig == 10)."""


for _name, _i in _INDEX.items():
    setattr(CostType, _name, _i)


def cost_type_index(name: str) -> int:
    return _INDEX[name]


def n_cost_types_for_protocol(protocol: int) -> int:
    """Table length at a protocol era (reference resizes the vectors
    at each upgrade: 23 at p20, 45 at p21, 70 at p22+)."""
    return sum(1 for _n, era in COST_TYPES if era <= protocol)


# (const_term, linear_term) by index; v21/v22 dicts OVERLAY the earlier
# era's table (v21 re-tunes VmCachedInstantiation, adds 23..44; v22
# adds 45..69) — reference updateCpuCostParamsEntryForV21/V22.
_CPU_V20 = [
    (4, 0), (434, 16), (42, 16), (44, 16), (310, 0), (61, 0),
    (230, 29), (59052, 4001), (3738, 7012), (40253, 0), (377524, 4068),
    (451626, 45405), (451626, 45405), (1948, 0), (3766, 5969),
    (710, 0), (2315295, 0), (4404, 0), (4947, 0), (4911, 0), (4286, 0),
    (913, 0), (1058, 501),
]
_CPU_V21 = {
    "VmCachedInstantiation": (41142, 634),
    "ParseWasmInstructions": (73077, 25410),
    "ParseWasmFunctions": (0, 540752),
    "ParseWasmGlobals": (0, 176363),
    "ParseWasmTableEntries": (0, 29989),
    "ParseWasmTypes": (0, 1061449),
    "ParseWasmDataSegments": (0, 237336),
    "ParseWasmElemSegments": (0, 328476),
    "ParseWasmImports": (0, 701845),
    "ParseWasmExports": (0, 429383),
    "ParseWasmDataSegmentBytes": (0, 28),
    "InstantiateWasmInstructions": (43030, 0),
    "InstantiateWasmFunctions": (0, 7556),
    "InstantiateWasmGlobals": (0, 10711),
    "InstantiateWasmTableEntries": (0, 3300),
    "InstantiateWasmTypes": (0, 0),
    "InstantiateWasmDataSegments": (0, 23038),
    "InstantiateWasmElemSegments": (0, 42488),
    "InstantiateWasmImports": (0, 828974),
    "InstantiateWasmExports": (0, 297100),
    "InstantiateWasmDataSegmentBytes": (0, 14),
    "Sec1DecodePointUncompressed": (1882, 0),
    "VerifyEcdsaSecp256r1Sig": (3000906, 0),
}
_CPU_V22 = {
    "Bls12381EncodeFp": (661, 0),
    "Bls12381DecodeFp": (985, 0),
    "Bls12381G1CheckPointOnCurve": (1934, 0),
    "Bls12381G1CheckPointInSubgroup": (730510, 0),
    "Bls12381G2CheckPointOnCurve": (5921, 0),
    "Bls12381G2CheckPointInSubgroup": (1057822, 0),
    "Bls12381G1ProjectiveToAffine": (92642, 0),
    "Bls12381G2ProjectiveToAffine": (100742, 0),
    "Bls12381G1Add": (7689, 0),
    "Bls12381G1Mul": (2458985, 0),
    "Bls12381G1Msm": (2426722, 96397671),
    "Bls12381MapFpToG1": (1541554, 0),
    "Bls12381HashToG1": (3211191, 6713),
    "Bls12381G2Add": (25207, 0),
    "Bls12381G2Mul": (7873219, 0),
    "Bls12381G2Msm": (8035968, 309667335),
    "Bls12381MapFp2ToG2": (2420202, 0),
    "Bls12381HashToG2": (7050564, 6797),
    "Bls12381Pairing": (10558948, 632860943),
    "Bls12381FrFromU256": (1994, 0),
    "Bls12381FrToU256": (1155, 0),
    "Bls12381FrAddSub": (74, 0),
    "Bls12381FrMul": (332, 0),
    "Bls12381FrPow": (691, 74558),
    "Bls12381FrInv": (35421, 0),
}

_MEM_V20 = [
    (0, 0), (16, 128), (0, 0), (0, 0), (0, 0), (0, 0),
    (242, 384), (0, 384), (0, 0), (0, 0), (0, 0),
    (130065, 5064), (130065, 5064), (14, 0), (0, 0),
    (0, 0), (181, 0), (99, 0), (99, 0), (99, 0), (99, 0),
    (99, 0), (0, 0),
]
_MEM_V21 = {
    "VmCachedInstantiation": (69472, 1217),
    "ParseWasmInstructions": (17564, 6457),
    "ParseWasmFunctions": (0, 47464),
    "ParseWasmGlobals": (0, 13420),
    "ParseWasmTableEntries": (0, 6285),
    "ParseWasmTypes": (0, 64670),
    "ParseWasmDataSegments": (0, 29074),
    "ParseWasmElemSegments": (0, 48095),
    "ParseWasmImports": (0, 103229),
    "ParseWasmExports": (0, 36394),
    "ParseWasmDataSegmentBytes": (0, 257),
    "InstantiateWasmInstructions": (70704, 0),
    "InstantiateWasmFunctions": (0, 14613),
    "InstantiateWasmGlobals": (0, 6833),
    "InstantiateWasmTableEntries": (0, 1025),
    "InstantiateWasmTypes": (0, 0),
    "InstantiateWasmDataSegments": (0, 129632),
    "InstantiateWasmElemSegments": (0, 13665),
    "InstantiateWasmImports": (0, 97637),
    "InstantiateWasmExports": (0, 9176),
    "InstantiateWasmDataSegmentBytes": (0, 126),
    "Sec1DecodePointUncompressed": (0, 0),
    "VerifyEcdsaSecp256r1Sig": (0, 0),
}
_MEM_V22 = {
    "Bls12381EncodeFp": (0, 0),
    "Bls12381DecodeFp": (0, 0),
    "Bls12381G1CheckPointOnCurve": (0, 0),
    "Bls12381G1CheckPointInSubgroup": (0, 0),
    "Bls12381G2CheckPointOnCurve": (0, 0),
    "Bls12381G2CheckPointInSubgroup": (0, 0),
    "Bls12381G1ProjectiveToAffine": (0, 0),
    "Bls12381G2ProjectiveToAffine": (0, 0),
    "Bls12381G1Add": (0, 0),
    "Bls12381G1Mul": (0, 0),
    "Bls12381G1Msm": (109494, 354667),
    "Bls12381MapFpToG1": (5552, 0),
    "Bls12381HashToG1": (9424, 0),
    "Bls12381G2Add": (0, 0),
    "Bls12381G2Mul": (0, 0),
    "Bls12381G2Msm": (219654, 354667),
    "Bls12381MapFp2ToG2": (3344, 0),
    "Bls12381HashToG2": (6816, 0),
    "Bls12381Pairing": (2204, 9340474),
    "Bls12381FrFromU256": (0, 0),
    "Bls12381FrToU256": (248, 0),
    "Bls12381FrAddSub": (0, 0),
    "Bls12381FrMul": (0, 0),
    "Bls12381FrPow": (0, 128),
    "Bls12381FrInv": (0, 0),
}


def _apply_era_overlay(params, era: int, dimension: str):
    """Extend to the era's vector length and overlay its new/retuned
    entries (shared by initial tables and era-crossing upgrades)."""
    overlay = {21: (_CPU_V21, _MEM_V21), 22: (_CPU_V22, _MEM_V22)}[era]
    table = overlay[0] if dimension == "cpu" else overlay[1]
    length = {21: 45, 22: 70}[era]
    if len(params) < length:
        params.extend([(0, 0)] * (length - len(params)))
    for name, cl in table.items():
        params[_INDEX[name]] = cl
    return params


def initial_cost_params(protocol: int, dimension: str
                        ) -> List[Tuple[int, int]]:
    """The reference's initial (const, linear) vector for a protocol
    era — what the upgrade path installs into the CONFIG_SETTING
    entries when crossing into soroban/p21/p22."""
    params = list(_CPU_V20 if dimension == "cpu" else _MEM_V20)
    for era in (21, 22):
        if protocol >= era:
            _apply_era_overlay(params, era, dimension)
    return params


def upgrade_cost_params(params, from_protocol: int, to_protocol: int,
                        dimension: str):
    """Carry an existing cost vector across a protocol-era crossing the
    way the reference's updateCpuCostParamsEntryForV21/V22 do: extend
    and overlay only the eras BETWEEN from and to (keyed on the actual
    previous protocol, never inferred from vector length) — values an
    operator upgrade already tuned within earlier eras are preserved."""
    out = list(params)
    for era in (21, 22):
        if from_protocol < era <= to_protocol:
            _apply_era_overlay(out, era, dimension)
    return out


def eval_cost(params: List[Tuple[int, int]], type_idx: int,
              input_size: int = 0) -> int:
    """const + linear * input / 128 (saturating at table bounds: an
    out-of-era type costs nothing, matching a shorter vector)."""
    if type_idx >= len(params):
        return 0
    const, linear = params[type_idx]
    if linear and input_size:
        return const + ((linear * input_size) >> COST_LINEAR_SCALE_BITS)
    return const
