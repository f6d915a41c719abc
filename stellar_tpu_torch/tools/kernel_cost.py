"""Cost accounting for the verify and hash kernels, on the CPU.

Two ledgers:

* **The plain versions' executed multiply work.** Each stage of the
  plain PyTorch kernels — ``decompress``, ``dsm`` (recode, table build
  and the Strauss-Shamir loop), ``dsm_hot``, ``compress_compare`` and the
  composed ``kernel_total`` / ``kernel_hot_total`` — runs eagerly under a
  counting dispatch mode that counts ``aten.mul`` ops and their output
  elements. In eager PyTorch every loop is unrolled, so this is the
  reference's "weighted" count (multiply ops executed a call, and the
  multiply volume by element); the reference's "static" count, each
  ``scan`` body once, has no counterpart. The counts are taken at the
  reference's batch, 128 rows: the field and group functions run
  thousands of times on a few shapes, so each (function, argument
  shapes) pair is counted once and its count reused, which makes a
  128-row count take seconds. Beside them: the affine table build and
  ``fe.batch_inv`` alone, the hot arm against cold, the signer-table
  geometry, the radix sweep (radix 16 against radix 32), and the SHA-256
  plain version's add and logic volume.
* **The CUDA kernels' multiply-adds and bounds.** The 32x32->64
  multiply-adds of each kernel's function on given rows (what the bound
  counts), what the four-lane kernels execute whatever the digits, K3's
  32-bit operations a block, and the bound: the larger of the operations
  over the card's rate and the bytes over its memory rate.
  ``chip_smoke.py`` computes every kernel's bound with these functions.

Run on the CPU:

    python -m stellar_tpu_torch.tools.kernel_cost            # pretty
    python -m stellar_tpu_torch.tools.kernel_cost --json     # one line
    python -m stellar_tpu_torch.tools.kernel_cost --json --batch=128 \\
        --sms=132 --clock-hz=1.98e9 --rows=build/rows.npz

``--sms`` and ``--clock-hz`` give the card's SM count and SM clock for the
bounds; ``--rows`` names an ``.npz`` of measured rows (``chip_smoke.py``
phase 28 writes it) whose multiply-adds, executed multiply-adds and
bounds are recomputed into the line's ``rows``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

BATCH_DEFAULT = 128

# ---------------- the CUDA kernels' work and bounds ----------------

# H100 figures for the bound: 32-bit integer multiply-adds, and 32-bit
# integer add, logic and shift operations, per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table) and HBM3 bandwidth (NVIDIA's data sheet).
IMAD_PER_CLOCK_PER_SM = 64
INT_OPS_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 4 * 32 + 1  # A, R, s, h read once, one bool written
HOT_ENTRY_BYTES = 3 * 20 * 2  # one int16 affine cached entry
# K3's bound counts the function's work, FIPS 180-4's operations on
# 32-bit words a 64-byte block, a three-input add or logic operation as
# one: a round is Sigma0 and Sigma1 (3 rotations and a three-way XOR
# each), Ch and Maj (one logic operation each) and 4 adds (2 for T1, one
# for e, one for a); a schedule word sigma0 and sigma1 (2 rotations, a
# shift and a three-way XOR each) and 2 adds; the feed-forward 8 adds.
SHA_ROUND_OPS = 2 * (3 + 1) + 2 + 4
SHA_SCHEDULE_OPS = 2 * (2 + 1 + 1) + 2
SHA_FEED_FORWARD_OPS = 8

# Field multiplies of the CUDA kernels' op sequences, for the operations
# bound. A ``fe_mul`` is 100 32x32->64 multiply-adds, an ``fe_sq`` 55
# (csrc/fe25519.cuh). (squarings, multiplies) per row:
FE_MUL_MACS = 100
FE_SQ_MACS = 55
# fe_invert / fe_pow22523 (ref10 chains): 254 / 251 squarings, 11 multiplies
_INVERT = (254, 11)
_POW22523 = (251, 11)
# decompress: 4 sq + 7 mul around pow22523, +1 mul for the sqrt(-1) fix
# (taken always), +1 mul for T
_DECOMPRESS = (4 + _POW22523[0], 9 + _POW22523[1])
# an addition: a mixed add of an affine entry (3 mul) or a cached add of a
# projective one (4 mul), and 4 mul to extended coordinates. (K1's count
# charges the 4th, T, to the operation before the add, the one that must
# make it; the sum is the same.)
_ADD_MULS = 7
_CACHED_ADD_MULS = 8
# encode: one inversion and two multiplies
_ENCODE = (_INVERT[0], _INVERT[1] + 2)
# K1 (csrc/verify_cold.cu): the function's work. The A-table: 16 cached
# forms (1 mul for 2dT), 1 doubling (4 sq + 4 mul), 14 cached adds (8 mul),
# no inversion (the entries stay projective)
_X4_TABLE = (4, 16 + 4 + 14 * 8)
# a doubling whose T is not read: 4 sq + 3 mul
_DOUBLING = (4, 3)
# What the four-lane kernel executes beyond that (its overhead, for the
# record, not the bound): every doubling's round 2 makes T (lane 3), and
# every one of the 52 windows adds an entry of B and one of -A, a zero
# digit adding the identity, whatever the scalars
_X4_DOUBLINGS = (51 * 5 * 4, 51 * 5 * 4)
_X4_ADDS = (0, 52 * (_ADD_MULS + _CACHED_ADD_MULS))
# K2 (csrc/verify_hot.cuh): the function's work is 8 doublings a window
# below the most significant nonzero radix-256 digit of s or h, a mixed
# add (7 mul, as above) for each nonzero digit, and encode. What the
# four-lane kernel executes beyond that: all 31 windows of 8 doublings,
# each making T, and both adds in every one of the 32 windows (lane 2's
# product by the constant 2 not counted, as for K1)
_HOT_WINDOW_DOUBLINGS = 8
_X4_HOT_DOUBLINGS = (31 * 8 * 4, 31 * 8 * 4)
_X4_HOT_ADDS = (0, 32 * 2 * _ADD_MULS)
# K5 (csrc/verify_r16.cu): the A-table, 1 doubling (4 sq, 4 mul to
# extended), 6 cached adds (4 mul + 4 to extended), 8 to-cached (1 mul);
# 63 windows of 4 doublings, 3 muls to projective after 3 of them and 4 to
# extended after the 4th; a mixed B add (3 mul + 4) per nonzero digit of
# s, a cached A add (4 mul + 4) per nonzero digit of h, a top digit above
# 8 included (it adds the zero entry)
_TABLE16 = (4, 4 + 6 * 8 + 8)
_R16_DOUBLINGS = (63 * 4 * 4, 63 * (3 * 3 + 4))
# What the four-lane K5 executes beyond that, as for K1: all 63 windows of
# 4 doublings making T, and both adds in each of the 64 windows
_X4_R16_DOUBLINGS = (63 * 4 * 4, 63 * 4 * 4)
_X4_R16_ADDS = (0, 64 * (_ADD_MULS + _CACHED_ADD_MULS))


def _vk():
    from stellar_tpu_torch.ops import verify as vk
    return vk


def cold_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds of K1's function on these rows, for its
    bound: decompress, the A-table and encode; from the most significant
    nonzero digit of s or h down, 5 doublings a window; and an addition
    for each nonzero digit (7 multiplies for s, 8 for h). (batch, 32)
    uint8 CPU tensors in, a Python int out."""
    vk = _vk()
    s_nz = vk.signed_digits32(s_bytes) != 0  # (52, batch), top first
    h_nz = vk.signed_digits32(h_bytes) != 0
    any_nz = s_nz | h_nz
    top = torch.where(any_nz.any(0), 51 - any_nz.int().argmax(0), 0)
    doublings = 5 * int(top.sum())
    fixed = [_DECOMPRESS, _X4_TABLE, _ENCODE]
    rows = s_bytes.shape[0]
    sq = rows * sum(f[0] for f in fixed) + doublings * _DOUBLING[0]
    mul = (rows * sum(f[1] for f in fixed)
           + doublings * _DOUBLING[1] + int(s_nz.sum()) * _ADD_MULS
           + int(h_nz.sum()) * _CACHED_ADD_MULS)
    return sq * FE_SQ_MACS + mul * FE_MUL_MACS


def cold_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K1 executes for ``rows`` rows,
    each round's four products counted once: the function's work plus the
    dead T products and the identity adds. Does not depend on the data."""
    fixed = [_DECOMPRESS, _X4_TABLE, _X4_DOUBLINGS, _X4_ADDS, _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def hot_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds of K2's function on these rows, for its
    bound: encode; from the most significant nonzero radix-256 digit of s
    or h down, 8 doublings a window; and a mixed add (7 multiplies) for
    each nonzero digit. (batch, 32) uint8 CPU tensors in, a Python int
    out."""
    vk = _vk()
    s_nz = vk.signed_digits256(s_bytes) != 0  # (32, batch), top first
    h_nz = vk.signed_digits256(h_bytes) != 0
    any_nz = s_nz | h_nz
    top = torch.where(any_nz.any(0), 31 - any_nz.int().argmax(0), 0)
    doublings = _HOT_WINDOW_DOUBLINGS * int(top.sum())
    rows = s_bytes.shape[0]
    sq = rows * _ENCODE[0] + doublings * _DOUBLING[0]
    mul = (rows * _ENCODE[1] + doublings * _DOUBLING[1]
           + int(s_nz.sum() + h_nz.sum()) * _ADD_MULS)
    return sq * FE_SQ_MACS + mul * FE_MUL_MACS


def hot_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K2 executes for ``rows`` rows,
    each round's products counted once: every window adds both entries
    (a zero digit the identity) and every doubling makes T. Does not
    depend on the data."""
    fixed = [_X4_HOT_DOUBLINGS, _X4_HOT_ADDS, _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def r16_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds of K5's function on these rows, for its
    bound: the fixed decompress, table, doublings and encode, and one add
    for each nonzero radix-16 digit (7 multiplies for s, 8 for h).
    (batch, 32) uint8 CPU tensors in, a Python int out."""
    vk = _vk()
    nz_s = int((vk.signed_digits16(s_bytes) != 0).sum())
    nz_h = int((vk.signed_digits16(h_bytes) != 0).sum())
    fixed = [_DECOMPRESS, _TABLE16, _R16_DOUBLINGS, _ENCODE]
    sq = sum(f[0] for f in fixed)
    mul = sum(f[1] for f in fixed)
    return (s_bytes.shape[0] * (sq * FE_SQ_MACS + mul * FE_MUL_MACS)
            + (nz_s * _ADD_MULS + nz_h * _CACHED_ADD_MULS) * FE_MUL_MACS)


def r16_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K5 executes for ``rows`` rows,
    each round's products counted once: every doubling makes T and every
    window adds both entries (a zero digit the identity, a top digit above
    8 the zero entry). Does not depend on the data."""
    fixed = [_DECOMPRESS, _TABLE16, _X4_R16_DOUBLINGS, _X4_R16_ADDS,
             _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def sha_ops_per_block() -> int:
    """K3's function: 32-bit operations a compressed block by FIPS 180-4
    (64 rounds, 48 schedule words, the feed-forward), 1,384."""
    return (64 * SHA_ROUND_OPS + 48 * SHA_SCHEDULE_OPS
            + SHA_FEED_FORWARD_OPS)


def bound(info, ops, ops_per_clock_per_sm, nbytes):
    """(least ms, what bounds it): the larger of the operations over the
    card's rate (``info``: ``sms``, ``clock_hz``) and the bytes over its
    memory rate."""
    ops_ms = ops / (ops_per_clock_per_sm * info["sms"]
                    * info["clock_hz"]) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


# the kernels whose rows a measured-rows file may carry: their function's
# multiply-adds and what the kernel executes, by name
_ROW_COSTS = {
    "verify_cold": (cold_kernel_multiplies, cold_kernel_executed),
    "verify_hot": (hot_kernel_multiplies, hot_kernel_executed),
    "verify_r16": (r16_kernel_multiplies, r16_kernel_executed),
}


def measured_row_cost(info, rec: dict) -> dict:
    """One measured record's cost: ``rec`` holds ``kernel`` and ``bytes``,
    and ``s``/``h`` (the rows' scalar bytes) for a verify kernel or
    ``blocks`` (active blocks) for K3. Returns its multiply-adds (or
    operations), what the kernel executes, and the bound."""
    if rec["kernel"] == "sha256":
        ops = int(rec["blocks"]) * sha_ops_per_block()
        ms, by = bound(info, ops, INT_OPS_PER_CLOCK_PER_SM, rec["bytes"])
        return {"operations": ops, "bound_ms": ms, "bound_by": by}
    fn, executed = _ROW_COSTS[rec["kernel"]]
    s = torch.as_tensor(rec["s"])
    h = torch.as_tensor(rec["h"])
    macs = fn(s, h)
    ms, by = bound(info, macs, IMAD_PER_CLOCK_PER_SM, rec["bytes"])
    return {"multiply_adds": macs,
            "executed_multiply_adds": executed(s.shape[0]),
            "bound_ms": ms, "bound_by": by}


def cuda_ledger() -> dict:
    """Per-row constants of the CUDA kernels (data-independent parts)."""
    zero = torch.zeros((1, 32), dtype=torch.uint8)
    return {
        "verify_cold": {
            "executed_multiply_adds_per_row": cold_kernel_executed(1),
            "multiply_adds_per_row_all_digits_zero":
                cold_kernel_multiplies(zero, zero)},
        "verify_hot": {
            "executed_multiply_adds_per_row": hot_kernel_executed(1),
            "multiply_adds_per_row_all_digits_zero":
                hot_kernel_multiplies(zero, zero)},
        "verify_r16": {
            "executed_multiply_adds_per_row": r16_kernel_executed(1),
            "multiply_adds_per_row_all_digits_zero":
                r16_kernel_multiplies(zero, zero)},
        "sha256": {"operations_per_block": sha_ops_per_block()},
    }


# ---------------- the plain versions' multiply work ----------------

# Bumped when the plain versions' window scheme or cost shape is reworked
# on purpose (the reference's ledger version 3: radix-32 cold arm,
# radix-256 hot arm, signer-table geometry)
LEDGER_VERSION = 3

# the functions counted once per (arguments' shapes) pair
_COUNT_ONCE = (
    ("stellar_tpu_torch.ops.field25519", "mul"),
    ("stellar_tpu_torch.ops.field25519", "sqr"),
    ("stellar_tpu_torch.ops.field25519", "add"),
    ("stellar_tpu_torch.ops.field25519", "sub"),
    ("stellar_tpu_torch.ops.field25519", "neg"),
    ("stellar_tpu_torch.ops.field25519", "canon"),
    ("stellar_tpu_torch.ops.edwards", "point_double"),
    ("stellar_tpu_torch.ops.edwards", "point_add_cached"),
    ("stellar_tpu_torch.ops.edwards", "table_select_affine"),
    ("stellar_tpu_torch.ops.edwards", "table_select"),
    ("stellar_tpu_torch.ops.sha256", "_rotr"),
)

_aten = torch.ops.aten
_MUL = (_aten.mul, _aten.mul_)
_ADD = (_aten.add, _aten.add_)
_LOGIC = (_aten.bitwise_xor, _aten.bitwise_and, _aten.bitwise_or,
          _aten.__xor__, _aten.__and__, _aten.__or__, _aten.__rshift__,
          _aten.__lshift__, _aten.bitwise_left_shift,
          _aten.bitwise_right_shift)


class _Counts(TorchDispatchMode):
    """Counts every op, and the ops and output elements of the multiply,
    add and logic classes, as they run."""

    KEYS = ("ops", "mul_ops", "mul_elems", "add_ops", "add_elems",
            "logic_ops", "logic_elems")

    def __init__(self):
        super().__init__()
        self.c = dict.fromkeys(self.KEYS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.c
        c["ops"] += 1
        packet = func._overloadpacket
        for cls, name in ((_MUL, "mul"), (_ADD, "add"), (_LOGIC, "logic")):
            if packet in cls:
                c[name + "_ops"] += 1
                c[name + "_elems"] += out.numel()
        return out


def _shape_key(a):
    if isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), a.dtype)
    if isinstance(a, (tuple, list)):
        return tuple(_shape_key(x) for x in a)
    return ("V", a)


def _empty_like_out(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.dtype)
    return (type(out), [_empty_like_out(o) for o in out])


def _make(cap):
    if cap[0] == "T":
        return torch.empty(cap[1], dtype=cap[2])
    return cap[0](_make(c) for c in cap[1])


def count(fn, args) -> dict:
    """Run ``fn(*args)`` under the counting mode; each function of
    ``_COUNT_ONCE`` is counted once per (arguments' shapes) pair and its
    count reused (its op stream depends on the shapes only), its output
    then an empty tensor of the right shape."""
    mode = _Counts()
    memo: Dict[tuple, tuple] = {}

    def wrap(name, orig):
        def counted(*a, **kw):
            key = (name, _shape_key(a), _shape_key(tuple(sorted(kw.items()))))
            hit = memo.get(key)
            if hit is not None:
                delta, cap = hit
                for k, v in delta.items():
                    mode.c[k] += v
                with torch.utils._python_dispatch._disable_current_modes():
                    return _make(cap)
            before = dict(mode.c)
            out = orig(*a, **kw)
            memo[key] = ({k: mode.c[k] - before[k] for k in mode.c},
                         _empty_like_out(out))
            return out
        return counted

    with contextlib.ExitStack() as stack:
        for modname, name in _COUNT_ONCE:
            mod = importlib.import_module(modname)
            orig = getattr(mod, name)
            setattr(mod, name, wrap(f"{modname}.{name}", orig))
            stack.callback(setattr, mod, name, orig)
        with mode:
            fn(*args)
    return dict(mode.c)


def _operands(batch: int) -> dict:
    from stellar_tpu_torch.ops import edwards as ed
    from stellar_tpu_torch.ops import field25519 as fe
    b32 = torch.zeros((batch, 32), dtype=torch.uint8)
    limb = torch.zeros((fe.NLIMBS, batch), dtype=torch.int32)
    table = torch.zeros((batch, ed.TABLE_ENTRIES256, ed.AFFINE_COORDS,
                         fe.NLIMBS), dtype=torch.int16)
    return {"bytes": b32, "point": (limb,) * 4, "table": table}


def _stage_count(c: dict) -> dict:
    return {"weighted_mul_ops": c["mul_ops"],
            "weighted_mul_elems": c["mul_elems"], "ops": c["ops"]}


def analytic_window_costs(radix: int) -> dict:
    """Closed-form window-scheme quantities for one arm: ``select_macs``,
    the one-hot select's multiply volume a verify (zero for the cmov-tree
    arms); ``select_logic_elems``, the cmov tree's element volume."""
    from stellar_tpu_torch.ops import edwards as ed
    if radix == 16:
        windows, entries, coords = ed.WINDOWS, ed.TABLE_ENTRIES, 4
        return {"radix": 16, "windows": windows, "table_entries": entries,
                "doublings": 4 * windows, "cached_adds": 2 * windows,
                "affine_a_table": False,
                "select_macs": 2 * windows * entries * coords * 20,
                "select_logic_elems": 0}
    if radix == 32:
        windows, entries = ed.WINDOWS32, ed.TABLE_ENTRIES32
        coords = ed.AFFINE_COORDS
        return {"radix": 32, "windows": windows, "table_entries": entries,
                # the top window skips its doubling chain (accumulator
                # seeded from the selected B-entry)
                "doublings": 5 * (windows - 1),
                "cached_adds": 2 * windows - 1,
                "affine_a_table": True, "select_macs": 0,
                "select_logic_elems":
                    2 * windows * (entries - 1) * coords * 20}
    if radix == 256:
        windows, entries = ed.WINDOWS256, ed.TABLE_ENTRIES256
        coords = ed.AFFINE_COORDS
        return {"radix": 256, "windows": windows, "table_entries": entries,
                "doublings": 8 * (windows - 1),
                "cached_adds": 2 * windows - 1,
                "affine_a_table": True, "cached_table_operand": True,
                "select_macs": 0,
                "select_logic_elems":
                    2 * windows * (entries - 1) * coords * 20}
    raise ValueError(f"unknown radix {radix}")


def stage_counts(batch: int = BATCH_DEFAULT) -> Dict[str, dict]:
    """Multiply ops and elements a call of each stage, at ``batch``."""
    from stellar_tpu_torch.analysis.overflow import stage_functions
    ops = _operands(batch)
    b, p, tab = ops["bytes"], ops["point"], ops["table"]
    fns = stage_functions()
    args = {"decompress": (b,), "dsm": (b, b) + p, "dsm_hot": (b, b, tab),
            "compress_compare": p + (b,), "kernel_total": (b, b, b, b),
            "kernel_hot_total": (tab, b, b, b)}
    return {name: _stage_count(count(fns[name], args[name]))
            for name in args}


def radix_sweep(batch: int = BATCH_DEFAULT) -> dict:
    """The radix-window sweep: the dsm stage's executed multiply volume
    with the radix-16 recode (K5's arm) against radix 32 (K1's), decided
    on that volume."""
    from stellar_tpu_torch.ops import edwards as ed
    vk = _vk()
    ops = _operands(batch)
    arms = {}
    for radix, recode in ((16, vk.signed_digits16),
                          (32, vk.signed_digits32)):
        def dsm(s, h, x, y, z, t, recode=recode):
            return ed.double_scalarmult(recode(s), recode(h), (x, y, z, t))
        c = count(dsm, (ops["bytes"], ops["bytes"]) + ops["point"])
        arms[f"radix{radix}"] = dict(_stage_count(c),
                                     **analytic_window_costs(radix))
    decision = min(arms, key=lambda k: arms[k]["weighted_mul_elems"])
    return {"batch": batch, "arms": arms, "decision": decision,
            "criterion": "min dsm weighted_mul_elems (executed multiply "
                         "volume a call)"}


def affine_table(batch: int = BATCH_DEFAULT) -> dict:
    """The batched-affine table build (``build_point_table_affine``: the
    ladder and the normalization) and ``fe.batch_inv`` alone: the rows
    that pin the Montgomery trick at one inversion a call."""
    from stellar_tpu_torch.ops import edwards as ed
    from stellar_tpu_torch.ops import field25519 as fe
    p = _operands(batch)["point"]
    build = count(lambda x, y, z, t: ed.build_point_table_affine(
        (x, y, z, t), ed.TABLE_ENTRIES32), p)
    zs = torch.zeros((fe.NLIMBS, ed.TABLE_ENTRIES32, batch),
                     dtype=torch.int32)
    inv = count(fe.batch_inv, (zs,))
    return {"entries": ed.TABLE_ENTRIES32,
            "build_weighted_mul_ops": build["mul_ops"],
            "build_weighted_mul_elems": build["mul_elems"],
            "batch_inv_weighted_mul_ops": inv["mul_ops"],
            "batch_inv_weighted_mul_elems": inv["mul_elems"]}


def trace_sha256(batch: int = BATCH_DEFAULT,
                 max_blocks: Optional[int] = None) -> dict:
    """K3's plain version's executed volume: every op, the adds and the
    logic (XOR, AND, OR, shifts), a call at ``batch`` rows."""
    from stellar_tpu_torch.crypto.batch_hasher import MAX_BLOCKS
    from stellar_tpu_torch.ops import sha256 as sk
    max_blocks = max_blocks or MAX_BLOCKS
    words = torch.zeros((batch, max_blocks, 16), dtype=torch.int32).view(
        torch.uint32)
    active = torch.zeros((batch, max_blocks), dtype=torch.bool)
    c = count(sk.sha256_kernel_plain, (words, active))
    return {"workload": "sha256", "batch": batch,
            "max_blocks": int(max_blocks), "rounds": 64,
            "weighted_ops": c["ops"],
            "add_weighted_ops": c["add_ops"],
            "add_weighted_elems": c["add_elems"],
            "logic_weighted_ops": c["logic_ops"],
            "logic_weighted_elems": c["logic_elems"]}


def trace_stages(batch: int = BATCH_DEFAULT) -> dict:
    """The plain versions' ledger: per-stage counts, the dsm headline with
    its cold and hot arms, the affine table, the signer-table geometry and
    the landed arm's window quantities."""
    from stellar_tpu_torch.parallel import signer_tables
    stages = stage_counts(batch)
    out = {"batch": batch, "ledger_version": LEDGER_VERSION,
           "stages": stages}
    landed = analytic_window_costs(32)
    out["radix"] = landed["radix"]
    out["table_entries"] = landed["table_entries"]
    out["windows"] = landed["windows"]
    out["select_macs_per_verify"] = landed["select_macs"]
    out["select_logic_elems_per_verify"] = landed["select_logic_elems"]
    cold, hot = stages["dsm"], stages["dsm_hot"]
    cold_macs, hot_macs = cold["weighted_mul_elems"], \
        hot["weighted_mul_elems"]
    out["dsm_weighted_mul_ops"] = cold["weighted_mul_ops"]
    out["dsm_weighted_mul_elems"] = cold_macs
    out["dsm"] = {
        "executed_macs_per_call": cold_macs,
        "executed_mul_ops_per_call": cold["weighted_mul_ops"],
        "cold": {"executed_macs_per_call": cold_macs},
        "hot": {"executed_macs_per_call": hot_macs,
                "executed_mul_ops_per_call": hot["weighted_mul_ops"],
                "vs_cold_frac": round(hot_macs / cold_macs, 4)},
    }
    out["affine_table"] = affine_table(batch)
    geom = analytic_window_costs(256)
    out["signer_table"] = {
        "radix": geom["radix"], "windows": geom["windows"],
        "entries": geom["table_entries"], "table_dtype": "int16",
        "bytes_per_signer": signer_tables.TABLE_BYTES,
        "doublings": geom["doublings"], "cached_adds": geom["cached_adds"],
        "select_logic_elems_per_verify": geom["select_logic_elems"],
        "hot_savings_frac": round(1.0 - hot_macs / cold_macs, 4),
    }
    return out


def report(batch: int = BATCH_DEFAULT, info: Optional[dict] = None,
           rows: Optional[list] = None) -> dict:
    """The whole line: the plain ledger, the radix sweep, K3's plain
    volume, the CUDA kernels' per-row constants, and with ``info`` (the
    card's ``sms`` and ``clock_hz``) each measured record's cost."""
    out = {"plain": trace_stages(batch), "radix_sweep": radix_sweep(batch),
           "sha256": trace_sha256(batch), "cuda": cuda_ledger()}
    if info is not None:
        out["card"] = dict(info)
        out["rows"] = [dict({"kernel": r["kernel"], "label": r["label"]},
                            **measured_row_cost(info, r))
                       for r in rows or []]
    return out


def load_rows(path: str) -> list:
    """The measured records of an ``.npz`` written by :func:`save_rows`."""
    import numpy as np
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        out = []
        for i, m in enumerate(meta):
            rec = dict(m)
            if f"s{i}" in z:
                rec["s"], rec["h"] = z[f"s{i}"], z[f"h{i}"]
            out.append(rec)
    return out


def save_rows(path: str, records: list) -> None:
    """Write measured records (``kernel``, ``label``, ``bytes``, and
    ``s``/``h`` uint8 arrays or ``blocks``) as an ``.npz``."""
    import numpy as np
    arrays, meta = {}, []
    for i, r in enumerate(records):
        meta.append({k: v for k, v in r.items() if k not in ("s", "h")})
        if "s" in r:
            arrays[f"s{i}"] = np.asarray(r["s"], dtype=np.uint8)
            arrays[f"h{i}"] = np.asarray(r["h"], dtype=np.uint8)
    np.savez(path, meta=np.array(json.dumps(meta)), **arrays)


def main(argv) -> int:
    as_json = "--json" in argv
    batch = BATCH_DEFAULT
    sms = clock = rows_path = None
    for a in argv:
        if a.startswith("--batch="):
            batch = int(a.split("=", 1)[1])
        elif a.startswith("--sms="):
            sms = int(a.split("=", 1)[1])
        elif a.startswith("--clock-hz="):
            clock = float(a.split("=", 1)[1])
        elif a.startswith("--rows="):
            rows_path = a.split("=", 1)[1]
    if (sms is None) != (clock is None):
        print("--sms and --clock-hz go together", file=sys.stderr)
        return 2
    info = None if sms is None else {"sms": sms, "clock_hz": clock}
    rows = load_rows(rows_path) if rows_path else None
    rec = report(batch, info, rows)
    print(json.dumps(rec) if as_json else json.dumps(rec, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
