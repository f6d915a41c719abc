"""The verifier's state, carried across from the JAX package.

Verification has no weights: its state is the constant tables and, on the
hot path, the per-signer tables. This module holds them in the port's
layouts, built from the port's own
:mod:`stellar_tpu_torch.crypto.ed25519_ref` at import:

* the plain version's tensors, in the reference's layout (radix 2^13
  limbs): ``base_table32`` (16, 3, 20) int32, ``base_table256``
  (128, 3, 20) int16, ``d``, ``d2``, ``sqrtm1`` and ``sub_pad`` (20,)
  int32;
* ``kernel_consts``, the block K1 keeps in ``__constant__`` memory
  (``csrc/verify_cold.cu``, ``struct verify_consts``): d, 2d, sqrt(-1),
  then the 16 affine cached B entries (y+x, y-x, 2dxy), each as ten int32
  limbs of ref10's radix 2^25.5 — 510 int32;
* ``hot_kernel_consts``, K2's block (``csrc/verify_hot.cuh``, ``struct
  verify_hot_consts``): d, 2d, then the 128 affine cached B entries in the
  same limbs — 3,860 int32, 15,440 bytes;
* ``r16_kernel_consts``, K5's block (``csrc/verify_r16.cu``, ``struct
  verify_r16_consts``): d, 2d, sqrt(-1), then the 8 affine cached B
  entries v*B, v = 1..8 (the first rows of ``base_table32``; the radix-16
  base table holds the same values with Z == 1) — 270 int32.

:func:`tables_from_jax` converts the JAX package's numpy constants into
the same dictionary, and :func:`signer_table_from_jax` takes one signer
table built by the JAX package into the form the port's cache holds;
tests hold both equal to what the port builds itself.
"""

from __future__ import annotations

import numpy as np
import torch

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.ops import edwards as ed
from stellar_tpu_torch.ops import field25519 as fe

__all__ = ["tables_from_jax", "port_tables", "signer_table_from_jax",
           "to_radix25_5", "from_radix13"]

# ref10's limb i starts at bit ceil(25.5 * i) and holds 26 bits (even i)
# or 25 (odd i).
_R25_START = [(51 * i + 1) // 2 for i in range(10)]
_R25_BITS = [26 if i % 2 == 0 else 25 for i in range(10)]


def to_radix25_5(x: int) -> np.ndarray:
    """Canonical int in [0, p) -> (10,) int32 limbs in radix 2^25.5."""
    if not 0 <= x < ref.P:
        raise ValueError("expected a canonical field element")
    return np.array([(x >> s) & ((1 << b) - 1)
                     for s, b in zip(_R25_START, _R25_BITS)], dtype=np.int32)


def from_radix13(limbs: np.ndarray) -> int:
    """(20,) radix-2^13 limbs -> the canonical int they stand for."""
    v = 0
    for i in range(fe.NLIMBS - 1, -1, -1):
        v = (v << fe.BITS) + int(limbs[i])
    return v % ref.P


def _kernel_consts(consts, base_table) -> np.ndarray:
    """Field constants, then each table entry's coordinates, in radix
    2^25.5 limbs, one flat int32 block."""
    rows = [to_radix25_5(from_radix13(c)) for c in consts]
    for entry in base_table:
        rows.extend(to_radix25_5(from_radix13(c)) for c in entry)
    return np.concatenate(rows).astype(np.int32)


def _tables(base_table32, base_table256, d, d2, sqrtm1, sub_pad) -> dict:
    return {
        "base_table32": torch.as_tensor(np.asarray(base_table32, np.int32)),
        "base_table256": torch.as_tensor(np.asarray(base_table256,
                                                    np.int16)),
        "d": torch.as_tensor(np.asarray(d, np.int32)),
        "d2": torch.as_tensor(np.asarray(d2, np.int32)),
        "sqrtm1": torch.as_tensor(np.asarray(sqrtm1, np.int32)),
        "sub_pad": torch.as_tensor(np.asarray(sub_pad, np.int32)),
        "kernel_consts": torch.as_tensor(
            _kernel_consts((d, d2, sqrtm1), base_table32)),
        "hot_kernel_consts": torch.as_tensor(
            _kernel_consts((d, d2), base_table256)),
        "r16_kernel_consts": torch.as_tensor(
            _kernel_consts((d, d2, sqrtm1),
                           np.asarray(base_table32)[:ed.TABLE_ENTRIES])),
    }


def tables_from_jax(consts: dict) -> dict:
    """The JAX package's numpy constants -> the port's tables.

    ``consts`` holds ``_BASE_TABLE32`` (16, 3, 20) int32 and
    ``_BASE_TABLE256`` (128, 3, 20) int16 (from
    ``stellar_tpu.ops.edwards``), ``D_LIMBS``, ``D2_LIMBS``,
    ``SQRTM1_LIMBS`` (20,) int32 and ``_SUB_PAD`` (20,) int32 (from
    ``stellar_tpu.ops.field25519``). Returns the plain version's tensors in
    the same layout plus the kernels' blocks, repacked through the
    canonical integers."""
    for key, entries, dtype in (("_BASE_TABLE32", ed.TABLE_ENTRIES32,
                                 np.int32),
                                ("_BASE_TABLE256", ed.TABLE_ENTRIES256,
                                 np.int16)):
        t = np.asarray(consts[key])
        if t.shape != (entries, ed.AFFINE_COORDS, fe.NLIMBS) or \
                t.dtype != dtype:
            raise ValueError(f"{key} is {t.shape} {t.dtype}")
    return _tables(consts["_BASE_TABLE32"], consts["_BASE_TABLE256"],
                   consts["D_LIMBS"], consts["D2_LIMBS"],
                   consts["SQRTM1_LIMBS"], consts["_SUB_PAD"])


def port_tables() -> dict:
    """The same tables, built from the port's own ed25519_ref."""
    return _tables(ed._BASE_TABLE32, ed._BASE_TABLE256, ed.D_LIMBS,
                   ed.D2_LIMBS, ed.SQRTM1_LIMBS, fe._SUB_PAD)


def signer_table_from_jax(table) -> np.ndarray:
    """One signer table from the JAX package's ``build_signer_table`` ->
    the read-only array the port's cache holds. It must be (128, 3, 20)
    int16 with every limb in [0, 2^13) and every coordinate a canonical
    field element (below p): the hot kernel converts limbs exactly only
    then."""
    t = np.asarray(table)
    want = (ed.TABLE_ENTRIES256, ed.AFFINE_COORDS, fe.NLIMBS)
    if t.shape != want or t.dtype != np.int16:
        raise ValueError(f"a signer table is {want} int16; got {t.shape} "
                         f"{t.dtype}")
    if (t < 0).any() or (t >= 1 << fe.BITS).any():
        raise ValueError("a signer table's limbs must be canonical 13-bit")
    for coord in t.reshape(-1, fe.NLIMBS):
        if sum(int(v) << (fe.BITS * i) for i, v in enumerate(coord)) \
                >= ref.P:
            raise ValueError("a signer table's coordinates must be below p")
    out = t.copy()
    out.setflags(write=False)
    return out
