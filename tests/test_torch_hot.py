"""K2, the hot-signer path: the port against the JAX package, exactly.

* the signed radix-256 recode, digit for digit;
* the signer tables, byte for byte, and their carry-over into the port;
* ``double_scalarmult_hot`` limb for limb and ``verify_kernel_hot`` bit for
  bit at one shape (B = 16, one JAX compile in one module fixture), on
  good signatures, rows whose top digit saturates the 128-entry select,
  and random R, s, h over real tables;
* the CUDA source's per-row function, compiled here for the host with g++,
  against the plain version;
* the port's signer-table cache and the partitioning ``BatchVerifier`` on
  the CPU, held against the oracle, the all-cold verdicts and the JAX
  ``BatchVerifier`` with its cache on;
* the same JAX ``BatchVerifier`` (one B = 16 compile for the module)
  against the port's verifier split over two CPU indices with a ``hang``
  at the fetch: the part whose deadline passed moves, the verdicts do
  not change.
* the signer-table cache's registry counters against the reference's on
  one sequence of lookups, installs and evictions;
* the slice as a whole: the same wire frames through the reference's
  ingress, fleet and JAX ``BatchVerifier`` (the module's B = 16 one) and
  through the port's ingress, fleet and CPU verifier, two passes.

Integer arithmetic throughout: tolerance zero."""

import ctypes
import hashlib
import os
import socket
import subprocess
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.ops import edwards as jed
from stellar_tpu.ops import field25519 as jfe
from stellar_tpu.ops import verify as jvk
from stellar_tpu.parallel import signer_tables as jst
from stellar_tpu_torch import state
from stellar_tpu_torch.crypto import batch_verifier as tbv
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import (
    BatchVerifier, Ed25519HotWorkload, Ed25519Workload)
from stellar_tpu_torch.ops import edwards as ted
from stellar_tpu_torch.ops import verify as tvk
from stellar_tpu_torch.parallel import batch_engine as tbe
from stellar_tpu_torch.parallel import signer_tables as st
from stellar_tpu_torch.utils import faults
from stellar_tpu_torch.utils.metrics import registry

B = 16
ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(ROOT, "stellar_tpu_torch", "csrc")


def _le(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), np.uint8)


def _hot_rows(seed=71, n_valid=4, n_match=6):
    """B hot rows (table, r, s, h): good signatures, matching rows whose
    scalars reach the top window's saturation, then random R, s and h over
    real tables."""
    rng = np.random.default_rng(seed)
    items = vectors.valid_items(rng, n_valid)
    _, (_a, r, s, h) = Ed25519Workload().encode(items)
    good = (np.stack([st.build_signer_table(pk) for pk, _m, _s in items]),
            r, s, h)
    match = vectors.hot_matching_rows(rng, n_match)
    n_rand = B - n_valid - n_match
    tabs = np.stack([st.build_signer_table(vectors.keypair(rng)[1])
                     for _ in range(n_rand)])
    rand = (tabs,) + vectors.random_rows(rng, n_rand)[1:]
    return tuple(np.ascontiguousarray(np.concatenate(
        [good[k], match[k], rand[k]])) for k in range(4))


def _jax_pipeline(tab, r, s, h):
    """JAX verify_kernel_hot plus its stages, in one jit (one compile)."""
    sd, hd = jvk.signed_digits256_dev(s), jvk.signed_digits256_dev(h)
    rp = jed.double_scalarmult_hot(sd, hd, jnp.moveaxis(tab, 0, -1))
    return jvk.verify_kernel_hot(tab, r, s, h), sd, hd, rp


@pytest.fixture(scope="module")
def rows():
    return _hot_rows()


@pytest.fixture(scope="module")
def jax_out(rows):
    out = jax.jit(_jax_pipeline)(*(jnp.asarray(x) for x in rows))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(rows):
    return tuple(torch.from_numpy(x) for x in rows)


def _same(got, want):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy()
    assert g.shape == want.shape and g.dtype == want.dtype
    np.testing.assert_array_equal(g, want)


# ---------------- the recode and the tables ----------------


def test_signed_digits256_matches_jax():
    rng = np.random.default_rng(72)
    scalars = [0, ref.L - 1, 2**253, 2**255 - 129, 2**255 - 128,
               2**256 - 1]
    b = np.stack([_le(v) for v in scalars]
                 + [np.full(32, x, np.uint8) for x in (0x7F, 0x80, 0xFF)]
                 + [rng.integers(0, 256, 32, dtype=np.uint8)
                    for _ in range(23)])
    got = tvk.signed_digits256(torch.from_numpy(b))
    _same(got, np.asarray(jvk.signed_digits256_dev(jnp.asarray(b))))
    d = got.numpy().astype(object)
    for i in range(len(b)):
        v = int.from_bytes(b[i].tobytes(), "little")
        assert sum(d[w, i] * 256 ** (31 - w) for w in range(32)) == v
    # the top digit passes 128 exactly where the select saturates
    top = d[0]
    assert top[5] == 256 and top[4] == 128 and top[3] == 128
    assert (top > 128).sum() >= 2


def test_build_signer_table_matches_jax():
    rng = np.random.default_rng(73)
    keys = [vectors.keypair(rng)[1] for _ in range(16)]
    keys += [ref.point_compress(ref.BASE), bytes(31), bytes(33)]
    y = 2
    while ref.point_decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    keys.append(y.to_bytes(32, "little"))
    built = 0
    for pk in keys:
        mine, theirs = st.build_signer_table(pk), jst.build_signer_table(pk)
        if theirs is None:
            assert mine is None
            continue
        assert mine.dtype == theirs.dtype == np.int16
        assert mine.tobytes() == theirs.tobytes()
        carried = state.signer_table_from_jax(theirs)
        assert carried.tobytes() == mine.tobytes()
        assert not carried.flags.writeable
        built += 1
    assert built == 17
    assert st.TABLE_BYTES == jst.TABLE_BYTES
    assert st.signer_fingerprint(keys[0]) == jst.signer_fingerprint(keys[0])
    assert st.signer_fingerprint(keys[0]) == \
        hashlib.sha256(keys[0]).digest()[:16]


def test_signer_table_from_jax_rejects_bad_tables():
    table = jst.build_signer_table(ref.point_compress(ref.BASE))
    with pytest.raises(ValueError):
        state.signer_table_from_jax(table[:64])
    with pytest.raises(ValueError):
        state.signer_table_from_jax(table.astype(np.int32))
    big = table.copy()
    big[3, 1, 7] = 1 << 13
    with pytest.raises(ValueError):
        state.signer_table_from_jax(big)
    above_p = table.copy()
    above_p[0, 0, :] = 0x1FFF  # 2^260 - 1: 13-bit limbs, not below p
    with pytest.raises(ValueError):
        state.signer_table_from_jax(above_p)


def test_hot_tables_from_jax_equal_port_tables():
    got = state.tables_from_jax({
        "_BASE_TABLE32": jed._BASE_TABLE32,
        "_BASE_TABLE256": jed._BASE_TABLE256, "D_LIMBS": jed.D_LIMBS,
        "D2_LIMBS": jed.D2_LIMBS, "SQRTM1_LIMBS": jed.SQRTM1_LIMBS,
        "_SUB_PAD": jfe._SUB_PAD})
    mine = state.port_tables()
    for key in ("base_table256", "hot_kernel_consts"):
        assert got[key].dtype == mine[key].dtype
        assert torch.equal(got[key], mine[key]), key
    assert mine["base_table256"].dtype == torch.int16
    k = mine["hot_kernel_consts"].numpy().reshape(-1, 10)
    start = [(51 * i + 1) // 2 for i in range(10)]
    vals = [sum(int(v) << s for v, s in zip(row, start)) for row in k]
    assert vals[:2] == [ref.D, 2 * ref.D % ref.P]
    rows = ref.affine_table_rows(ref.BASE, 128)
    assert vals[2:] == [c for row in rows for c in row]
    assert k.size * 4 == 15440


# ---------------- the plain version against JAX ----------------


def test_double_scalarmult_hot_limbs_match_jax(rows, jax_out):
    tab, _, s, h = _t(rows)
    sd, hd = tvk.signed_digits256(s), tvk.signed_digits256(h)
    _same((sd, hd), (jax_out[1], jax_out[2]))
    _same(ted.double_scalarmult_hot(sd, hd, tab.movedim(0, -1)),
          jax_out[3])


def test_verify_kernel_hot_matches_jax(rows, jax_out):
    launches = tvk.verify_kernel_hot.launches
    got = tvk.verify_kernel_hot(*_t(rows))
    _same(got, jax_out[0])
    _same(tvk.verify_kernel_hot_plain(*_t(rows)), jax_out[0])
    # good signatures and matching rows are True, random rows False
    assert got[:10].all() and not got[10:].any()
    # the matching rows include top digits above 128 in s and in h
    top = np.concatenate([jax_out[1][0, 4:10], jax_out[2][0, 4:10]])
    assert (top > 128).sum() >= 4
    assert tvk.verify_kernel_hot.launches == launches


def test_verify_kernel_hot_checks_operands(rows):
    tab, r, s, h = _t(rows)
    with pytest.raises(ValueError):
        tvk.verify_kernel_hot(tab.to(torch.int32), r, s, h)
    with pytest.raises(ValueError):
        tvk.verify_kernel_hot(tab[:, :64], r, s, h)
    with pytest.raises(ValueError):
        tvk.verify_kernel_hot(tab, r, s, h[:3])
    with pytest.raises(ValueError):
        tvk.verify_kernel_hot(*(t.to("meta") for t in (tab, r, s, h)))
    assert tvk.verify_kernel_hot(tab[:0], r[:0], s[:0], h[:0]).shape == (0,)


# ---------------- the CUDA source, built for the host ----------------


_HOST_SHIM = r"""
#define FE_FN static inline
#define FE_CALL static
#include "verify_hot.cuh"
extern "C" int verify_hot_rows_host(const int16_t* tab, const uint8_t* r,
                                    const uint8_t* s, const uint8_t* h,
                                    uint8_t* out, int n,
                                    const int32_t* consts) {
  verify_hot_consts K;
  memcpy(&K, consts, sizeof(K));
  for (int i = 0; i < n; ++i)
    out[i] = (uint8_t)verify_hot_row_x4(tab + (size_t)i * kTableLimbs,
                                        r + 32 * i, s + 32 * i, h + 32 * i,
                                        K);
  return (int)sizeof(K);
}
extern "C" void recode256_host(const uint8_t* s, int16_t* d) {
  recode256(d, s);
}
extern "C" void fe_from_limbs13_host(const int16_t* limbs, int32_t* out) {
  uint64_t w[5];
  memcpy(w, limbs, sizeof(w));
  fe f;
  fe_from_limbs13(f, w);
  memcpy(out, f.v, 40);
}
// The addition of -A's entry for ``digit`` from a row's table, the four
// lanes of ge25519_x4.cuh run in turn as the kernel runs them (hot_load,
// hot_entry_lane, x4_add_r1/r2), then ref10's one-thread ge_madd and
// ge_p1p1_to_p3 on the same entry: entry min(|digit|, 128) read as
// (y + x, y - x, 2dxy), negated for a negative digit, the identity (1, 1,
// 0) for digit 0. Points are extended (X, Y, Z, T), 4 x 10 limbs.
extern "C" void hot_add_host(const int32_t* p, const int16_t* table,
                             int digit, int32_t* x4, int32_t* one) {
  fe own[4], g[4], r1[4];
  memcpy(own, p, sizeof(own));
  x4_gather_xy<4>(g, own);
  for (int j = 0; j < 4; ++j) {
    uint64_t w[5];
    fe op;
    hot_load(w, table, j, digit);
    hot_entry_lane(op, j, w, digit);
    x4_add_r1(r1[j], j, g, op);
  }
  x4_gather<4>(g, r1);
  for (int j = 0; j < 4; ++j) x4_add_r2(own[j], j, g);
  memcpy(x4, own, sizeof(own));

  ge_p3 a, b;
  memcpy(&a, p, sizeof(a));
  ge_precomp e;
  fe_1(e.yplusx);
  fe_1(e.yminusx);
  fe_0(e.xy2d);
  if (digit != 0) {
    const int m = hot_saturate(digit < 0 ? -digit : digit);
    uint64_t w[15];
    memcpy(w, table + (m - 1) * kEntryLimbs, sizeof(w));
    fe_from_limbs13(e.yplusx, w);
    fe_from_limbs13(e.yminusx, w + 5);
    fe_from_limbs13(e.xy2d, w + 10);
    if (digit < 0) ge_precomp_neg(e);
  }
  ge_p1p1 t;
  ge_madd(t, a, e);
  ge_p1p1_to_p3(b, t);
  memcpy(one, &b, sizeof(b));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/verify_hot.cuh built with g++ behind a small C shim (the four
    lanes of ge25519_x4.cuh run in turn)."""
    d = tmp_path_factory.mktemp("host_hot")
    shim = d / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    out = d / "libverify_hot_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.verify_hot_rows_host.argtypes = [vp] * 5 + [ctypes.c_int, vp]
    lib.verify_hot_rows_host.restype = ctypes.c_int
    lib.recode256_host.argtypes = [vp, vp]
    lib.fe_from_limbs13_host.argtypes = [vp, vp]
    lib.hot_add_host.argtypes = [vp, vp, ctypes.c_int, vp, vp]
    return lib


def test_cuda_recode256_on_host(host_lib):
    rng = np.random.default_rng(74)
    b = np.stack([_le(v) for v in (0, ref.L - 1, 2**255 - 129, 2**255 - 128,
                                   2**256 - 1)]
                 + [np.full(32, x, np.uint8) for x in (0x7F, 0x80, 0xFF)]
                 + [rng.integers(0, 256, 32, dtype=np.uint8)
                    for _ in range(40)])
    plain = tvk.signed_digits256(torch.from_numpy(b)).numpy()
    d = np.zeros(32, np.int16)
    for i in range(len(b)):
        host_lib.recode256_host(np.ascontiguousarray(b[i]).ctypes.data,
                                d.ctypes.data)
        np.testing.assert_array_equal(d[::-1], plain[:, i])


def test_cuda_limb_conversion_on_host(host_lib):
    """Twenty canonical 13-bit limbs become exactly the radix-2^25.5 limbs
    that state.to_radix25_5 gives, for the extremes and random values."""
    rng = np.random.default_rng(75)
    vals = [0, 1, 2**13 - 1, 2**13, 2**26 - 1, 2**26, ref.P - 1, ref.D,
            2**255 - 20] + [int.from_bytes(rng.bytes(32), "little") % ref.P
                            for _ in range(200)]
    out = np.zeros(10, np.int32)
    for v in vals:
        limbs = np.array(st._limbs(v), np.int16)
        host_lib.fe_from_limbs13_host(limbs.ctypes.data, out.ctypes.data)
        np.testing.assert_array_equal(out, state.to_radix25_5(v))


def test_cuda_verify_hot_row_on_host_matches_plain(host_lib, rows):
    """The kernel's per-row function (verify_hot_row_x4, its four lanes
    run in turn), on the host, gives the plain version's bit: on the B = 16
    rows above and on 25 more (saturating matching rows, tampered R, s and
    h, random rows, zero scalars, and the engine's padding row)."""
    rng = np.random.default_rng(76)
    match = vectors.hot_matching_rows(rng, 12)
    tampered = [x.copy() for x in match]
    for k, i in enumerate(range(0, 12, 2)):
        tampered[1 + k % 3][i, int(rng.integers(0, 32))] ^= 1 << (k % 8)
    rand = (match[0][:6],) + vectors.random_rows(rng, 6)[1:]
    zeros = (match[0][:6], match[1][:6], np.zeros((6, 32), np.uint8),
             np.zeros((6, 32), np.uint8))
    pad = (tbv._PAD_TABLE, tbv._PAD_R, tbv._PAD_S, tbv._PAD_H)
    more = tuple(np.ascontiguousarray(np.concatenate(
        [tampered[k], rand[k], zeros[k], pad[k]])) for k in range(4))
    consts = state.port_tables()["hot_kernel_consts"].numpy()
    for tab, r, s, h in (rows, more):
        n = len(r)
        out = np.zeros(n, np.uint8)
        size = host_lib.verify_hot_rows_host(
            tab.ctypes.data, r.ctypes.data, s.ctypes.data, h.ctypes.data,
            out.ctypes.data, n, consts.ctypes.data)
        assert size == consts.nbytes
        plain = tvk.verify_kernel_hot_plain(*_t((tab, r, s, h))).numpy()
        np.testing.assert_array_equal(out.astype(bool), plain)
        assert plain.any() and not plain.all()
    assert out[-1]  # the padding row's bit is True


_START = [(51 * i + 1) // 2 for i in range(10)]


def _fe_values(limbs):
    return [sum(int(v) << s for v, s in zip(x, _START)) % ref.P
            for x in limbs.reshape(-1, 10)]


def _carried(point):
    """An extended point's coordinates carried into signed limbs, as a
    lane holds them (fe_carry's form)."""
    out = np.stack([state.to_radix25_5(v % ref.P) for v in point]).astype(
        np.int64)
    for row in out:
        for i in range(10):
            bits = 25 if i & 1 else 26
            c = (row[i] + (1 << (bits - 1))) >> bits
            row[i] -= c << bits
            if i < 9:
                row[i + 1] += c
            else:
                row[0] += 19 * c
    return np.ascontiguousarray(out.astype(np.int32))


@pytest.mark.parametrize("digits", ["positive", "negative", "saturating"])
def test_hot_lane_add_equals_ref10_madd(host_lib, digits):
    """The four-lane addition of an entry of the row's table, as K2 loads
    and maps it (lane 0 Y - X, lane 1 Y + X, lane 2 the constant 2, lane 3
    2dT, negated for a negative digit), gives ref10's ge_madd and
    ge_p1p1_to_p3 on the same entry coordinate for coordinate as field
    values: for the identity, the small-order points and multiples of B
    at a random projective scale, against entries of real points and
    entries at the canonical extremes (every component p - 1 = 2^255 - 20,
    or 0 and p - 1 mixed), with positive, negative and saturating digits
    (a top digit above 128 reads entry 128) and the zero digit (the
    identity). The sums stay within the header's bound: a lane's result
    is carried again."""
    rng = np.random.default_rng(77)
    small = [ref.point_decompress(e) for e in ref.SMALL_ORDER_ENCODINGS]
    pts = [ref.IDENTITY] + [p for p in small if p is not None]
    for _ in range(4):
        pt = ref.scalarmult_base(int(rng.integers(1, 2**62)))
        pts += [pt, vectors._neg(pt)]
    pts = [tuple(c * int(k) % ref.P for c in p)
           for p, k in zip(pts, rng.integers(1, 2**62, len(pts)))]
    top = ref.P - 1
    assert top == 2**255 - 20
    entries = [list(row) for row in ref.affine_table_rows(
        ref.scalarmult_base(int(rng.integers(1, 2**62))), 3)]
    entries += [[top, top, top], [top, 0, top], [0, top, 1]]
    table = np.stack([np.array([st._limbs(int.from_bytes(rng.bytes(32),
                                                         "little") % ref.P)
                                for _ in range(3)], np.int16)
                      for _ in range(st.TABLE_ENTRIES)])
    picks = {"positive": (1, 5, 127, 128), "negative": (-1, -5, -127, -128),
             "saturating": (129, 200, 256)}[digits] + (0,)
    x4 = np.zeros((4, 10), np.int32)
    one = np.zeros((4, 10), np.int32)
    checked = 0
    for p in pts:
        pl = _carried(p)
        for e in entries:
            for d in picks:
                tab = table.copy()
                m = min(abs(d), 128)
                if m:
                    tab[m - 1] = [st._limbs(c % ref.P) for c in e]
                tab = np.ascontiguousarray(tab)
                host_lib.hot_add_host(pl.ctypes.data, tab.ctypes.data, d,
                                      x4.ctypes.data, one.ctypes.data)
                assert _fe_values(x4) == _fe_values(one), (p, e, d)
                assert np.abs(x4).max() <= (1 << 25) + (1 << 6)
                checked += 1
    assert checked == len(pts) * len(entries) * len(picks)
    # the result is the group law's: P + (entry's point), or P - it
    q = ref.scalarmult_base(int(rng.integers(1, 2**62)))
    p = pts[-1]
    tab = table.copy()
    tab[4] = [st._limbs(c % ref.P) for c in ref.affine_table_rows(q, 1)[0]]
    for d in (5, -5):
        host_lib.hot_add_host(_carried(p).ctypes.data,
                              np.ascontiguousarray(tab).ctypes.data, d,
                              x4.ctypes.data, one.ctypes.data)
        want = ref.point_add(p, q if d > 0 else vectors._neg(q))
        got = _fe_values(x4)
        assert got[0] * want[2] % ref.P == want[0] * got[2] % ref.P
        assert got[1] * want[2] % ref.P == want[1] * got[2] % ref.P


def test_hot_kernel_multiplies_counts_the_op_sequence():
    """kernel_cost's count of K2's function, for chip_smoke.py's bound: encode, 8
    doublings a window below the most significant nonzero radix-256 digit
    of s or h, a mixed add for each nonzero digit; and what the four-lane
    kernel executes whatever the digits."""
    from stellar_tpu_torch.tools import kernel_cost as smoke
    zero = torch.zeros((2, 32), dtype=torch.uint8)
    # per row, with every digit zero: encode, 254 squarings (55 products)
    # and 13 multiplies (100)
    fixed = 254 * 55 + 13 * 100
    assert smoke.hot_kernel_multiplies(zero, zero) == 2 * fixed
    one = zero.clone()
    one[0, 0] = 1  # a nonzero digit in window 0 of one row: a mixed add
    assert smoke.hot_kernel_multiplies(one, zero) == 2 * fixed + 700
    assert smoke.hot_kernel_multiplies(zero, one) == 2 * fixed + 700
    top = zero.clone()
    top[1, 30] = 0x80  # digit -128 in window 30, carry 1 into window 31:
    # two digits, 31 windows of 8 doublings (4 squarings, 3 multiplies)
    assert smoke.hot_kernel_multiplies(zero, top) == \
        2 * fixed + 248 * (4 * 55 + 3 * 100) + 2 * 700
    # the four-lane kernel: 248 doublings making T, 64 adds, encode
    assert smoke.hot_kernel_executed(2) == \
        2 * ((992 + 254) * 55 + (992 + 64 * 7 + 13) * 100)


# ---------------- the port's signer-table cache ----------------


def _fake_table():
    return np.zeros((st.TABLE_ENTRIES, 3, 20), dtype=np.int16)


def _pk(i):
    return bytes([i]) * 32


def test_cache_lru_recency_and_byte_budget():
    cache = st.SignerTableCache(max_bytes=3 * st.TABLE_BYTES)
    for i in range(3):
        assert cache.install(_pk(i), _fake_table())
    assert cache.lookup(_pk(0)) is not None  # 0 is now the newest
    cache.install(_pk(3), _fake_table())     # over budget: evict the oldest
    snap = cache.snapshot()
    assert snap["entries"] == 3 and snap["evictions"] == 1
    assert snap["bytes"] == 3 * st.TABLE_BYTES
    assert cache.lookup(_pk(1)) is None
    assert cache.lookup(_pk(0)) is not None
    assert cache.lookup(_pk(3)) is not None
    table = cache.lookup(_pk(3))
    assert not table.flags.writeable
    small = st.SignerTableCache(max_bytes=st.TABLE_BYTES - 1)
    assert not small.install(_pk(0), _fake_table())
    assert small.snapshot()["entries"] == 0


def test_cache_shrink_evicts_and_disable_clears():
    cache = st.SignerTableCache(max_bytes=3 * st.TABLE_BYTES)
    for i in range(3):
        cache.install(_pk(i), _fake_table())
    cache.configure(max_bytes=st.TABLE_BYTES)
    snap = cache.snapshot()
    assert snap["entries"] == 1 and snap["evictions"] == 2
    assert cache.lookup(_pk(2)) is not None
    cache.configure(enabled=False)
    assert cache.snapshot()["entries"] == 0 and not cache.enabled
    assert cache.lookup(_pk(2)) is None
    assert not cache.install(_pk(4), _fake_table())
    cache.configure(enabled=True)
    assert cache.install(_pk(4), _fake_table())
    assert cache.lookup(_pk(4)) is not None
    cache._reset_for_testing()
    snap = cache.snapshot()
    assert snap["entries"] == snap["hits"] == snap["installs"] == 0
    assert snap["max_bytes"] == st.DEFAULT_CACHE_BYTES


def test_cache_audit_evict_drops_exactly_one_signer():
    cache = st.SignerTableCache(max_bytes=4 * st.TABLE_BYTES)
    cache.install(_pk(0), _fake_table())
    cache.install(_pk(1), _fake_table())
    assert cache.evict(_pk(0)) is True
    assert cache.evict(_pk(0)) is False
    snap = cache.snapshot()
    assert snap["audit_evictions"] == 1 and snap["entries"] == 1
    assert cache.lookup(_pk(0)) is None
    assert cache.lookup(_pk(1)) is not None


# ---------------- the partition, on the CPU ----------------


@pytest.fixture
def fresh_cache():
    """The process-wide caches as at process start, on, before and after
    (these tests change their knobs), and the JAX engine's dispatch state
    as at process start."""
    jbv._reset_dispatch_state_for_testing()
    for cache in (st.signer_table_cache, jst.signer_table_cache):
        cache._reset_for_testing()
        cache.configure(enabled=True)
    yield st.signer_table_cache
    for cache in (st.signer_table_cache, jst.signer_table_cache):
        cache._reset_for_testing()


def _hot_pool(seed):
    seed_bytes, pk = vectors.keypair(np.random.default_rng(seed))
    good = (pk, b"hot partition", ref.sign(seed_bytes, b"hot partition"))
    bad = (pk, good[1] + b"!", good[2])
    return pk, good, bad


def test_first_sight_cold_then_repeats_hot(fresh_cache):
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    _pk_, good, bad = _hot_pool(77)
    assert v.verify_batch([good, good, bad, good]).tolist() == \
        [True, True, False, True]
    snap = fresh_cache.snapshot()
    assert snap["installs"] == 1 and snap["entries"] == 1
    assert snap["hits"] == 3 and snap["misses"] == 1
    assert v.served["hot"] == 3 and v.served["device"] == 4
    assert v.verify_batch([bad, good]).tolist() == [False, True]
    assert fresh_cache.snapshot()["hits"] == 5
    assert v.served["hot"] == 5 and v.served["device"] == 6


def test_partition_marks_the_registry_once_a_batch(fresh_cache,
                                                   monkeypatch):
    """The partition's lookups mark the registry's hit and miss counters
    once a batch, by the batch's counts: after every call the counters
    have moved by the snapshot's tallies."""
    marks = []
    for kind, counter in (("hits", st._HITS), ("misses", st._MISSES)):
        real = counter.inc
        monkeypatch.setattr(counter, "inc", lambda n=1, kind=kind, real=real:
                            (marks.append((kind, n)), real(n)))
    names = ("hits", "misses", "installs")
    before = {k: registry.counter(f"crypto.verify.signer_table.{k}").count
              for k in names}
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    _pk_, good, bad = _hot_pool(81)
    assert v.verify_batch([good, good, bad, good]).tolist() == \
        [True, True, False, True]
    assert marks == [("hits", 3), ("misses", 1)]
    assert v.verify_batch([bad, good]).tolist() == [False, True]
    assert marks[2:] == [("hits", 2)]
    snap = fresh_cache.snapshot()
    assert {k: registry.counter(f"crypto.verify.signer_table.{k}").count
            - before[k] for k in names} == {k: snap[k] for k in names} == \
        {"hits": 5, "misses": 1, "installs": 1}


def test_disabled_cache_rides_everything_cold(fresh_cache):
    fresh_cache.configure(enabled=False)
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    _pk_, good, bad = _hot_pool(78)
    assert v.verify_batch([good, bad, good]).tolist() == [True, False, True]
    snap = fresh_cache.snapshot()
    assert snap["entries"] == snap["installs"] == 0
    assert snap["hits"] == snap["misses"] == 0
    assert v.served["hot"] == 0 and v.served["device"] == 3


def test_uncacheable_rows_always_ride_cold(fresh_cache):
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    pk, good, _bad = _hot_pool(79)
    y = 2
    while ref.point_decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    undecompressable = (y.to_bytes(32, "little"), b"m", bytes(64))
    rows = [good, (pk[:31], b"m", bytes(64)), undecompressable, good]
    assert v.verify_batch(rows).tolist() == [True, False, False, True]
    snap = fresh_cache.snapshot()
    assert snap["entries"] == snap["installs"] == 1 and snap["hits"] == 1
    assert v.served["hot"] == 1


def test_audit_conviction_evicts_served_tables(fresh_cache):
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    pk, good, _bad = _hot_pool(80)
    v.verify_batch([good, good])
    table = fresh_cache.lookup(pk)
    assert table is not None
    v._hot.on_audit_conviction([(good, table)])
    snap = fresh_cache.snapshot()
    assert snap["audit_evictions"] == 1 and snap["entries"] == 0
    v.verify_batch([good, good])  # the next sight rebuilds the table
    assert fresh_cache.snapshot()["installs"] == 2


def test_hot_padding_row_is_true():
    rows = tuple(torch.from_numpy(np.repeat(p, 3, axis=0)) for p in (
        tbv._PAD_TABLE, tbv._PAD_R, tbv._PAD_S, tbv._PAD_H))
    assert tvk.verify_kernel_hot(*rows).all()
    assert Ed25519HotWorkload().pad_rows()[0].shape == (1, 128, 3, 20)


@pytest.fixture(scope="module")
def jax_verifier():
    """The JAX BatchVerifier at bucket 16, shared by this module's tests
    so that its kernels compile once."""
    return jbv.BatchVerifier(bucket_sizes=(16,))


def test_slice_verdicts_equal_oracle_cold_and_jax(fresh_cache, jax_verifier):
    """The slice as a whole: two passes of the edge corpus plus fresh
    signatures through the port's partitioning verifier (the first pass
    installs tables, the second is the hot steady state) equal the oracle,
    the port's all-cold verdicts and the JAX BatchVerifier with its cache
    on, pass for pass."""
    rng = np.random.default_rng(81)
    items = vectors.edge_corpus(rng) + vectors.valid_items(rng, 3)
    oracle = np.array([ref.verify(*it) for it in items])
    np.testing.assert_array_equal(
        oracle, np.array([jref.verify(*it) for it in items]))
    fresh_cache.configure(enabled=False)
    cold = BatchVerifier(device="cpu", bucket_sizes=(16,)).verify_batch(items)
    fresh_cache.configure(enabled=True)
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    jv = jax_verifier
    for _ in range(2):
        got = v.verify_batch(items)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, cold)
        np.testing.assert_array_equal(jv.verify_batch(items), got)
    snap = fresh_cache.snapshot()
    assert snap["installs"] > 0 and snap["hits"] > len(items) // 2
    assert v.served["hot"] == snap["hits"]
    assert jst.signer_table_cache.snapshot()["hits"] == snap["hits"]
    assert oracle[0] and oracle[-3:].all() and not oracle.all()


@pytest.mark.chaos
def test_hang_at_fetch_moves_the_part_and_equals_jax(fresh_cache,
                                                     jax_verifier):
    """The edge corpus at B = 16 on the port's verifier over two CPU
    indices, cache off, with a ``hang`` armed at the fetch until it first
    fires and a 200 ms deadline: index 0's first part misses the deadline,
    index 0 is charged and the part moves to index 1; every verdict
    equals the oracle's and the JAX BatchVerifier's."""
    rng = np.random.default_rng(81)
    items = vectors.edge_corpus(rng) + vectors.valid_items(rng, 3)
    oracle = np.array([ref.verify(*it) for it in items])
    fresh_cache.configure(enabled=False)
    v = BatchVerifier(devices=["cpu"] * 2, bucket_sizes=(16,))
    deadline = tbe.DEADLINE_MS
    charged = [registry.counter(f"crypto.verify.device.{i}.failures")
               for i in (0, 1)]
    charged0 = [c.count for c in charged]
    faults.set_fault(faults.RESOLVE, "hang", 0.6)

    def clear_when_fired():
        while not faults.counters().get(faults.RESOLVE,
                                        {"fired": 1})["fired"]:
            time.sleep(0.002)
        faults.clear()

    try:
        tbe.configure_dispatch(deadline_ms=200)
        resolve = v.submit(items)
        helper = threading.Thread(target=clear_when_fired, daemon=True)
        helper.start()
        got = resolve()
        helper.join(5)
    finally:
        faults.clear()
        tbe.configure_dispatch(deadline_ms=deadline)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(jax_verifier.verify_batch(items), got)
    assert v.deadline_misses == 1
    assert [c.count - c0 for c, c0 in zip(charged, charged0)] == [1, 0]
    # index 0 served its two later parts (closing its streak again); its
    # first moved to index 1
    assert v.device_served == {0: 16, 1: len(items) - 16}
    assert v.served["device"] == len(items)


# ---------------- the constructor's default ladder ----------------


def test_direct_verifier_chunks_at_2048_like_the_reference(monkeypatch):
    """A directly built verifier takes the reference's constructor ladder
    (128, 512, 2048) and chunks a larger batch at 2,048 rows, as the
    reference's does; default_verifier keeps the full ladder. The rows
    fail the host gate, so no kernel runs."""
    assert BatchVerifier(device="cpu")._buckets == (128, 512, 2048) == \
        jbv.BatchVerifier()._buckets
    assert tbv.default_verifier("cpu")._buckets[-1] == 16384
    items = [(bytes(31), b"m", bytes(64))] * 2049
    seen = {}
    for name, cls in (("port", Ed25519Workload),
                      ("jax", jbv.Ed25519Workload)):
        encode = cls.encode

        def spy(self, chunk, _encode=encode, _name=name):
            seen.setdefault(_name, []).append(len(chunk))
            return _encode(self, chunk)

        monkeypatch.setattr(cls, "encode", spy)
    assert not BatchVerifier(device="cpu").verify_batch(items).any()
    assert not jbv.BatchVerifier().verify_batch(items).any()
    assert seen == {"port": [2048, 1], "jax": [2048, 1]}


# ---------------- the signer-table cache's counters ----------------


def test_signer_table_counters_equal_the_reference(fresh_cache):
    """One sequence of lookups, installs, evictions (the budget's and the
    audit's) fed to both packages' caches: their registries' counters
    ``crypto.verify.signer_table.*`` move by the same amounts, and the
    snapshots' tallies agree with them."""
    from stellar_tpu.utils.metrics import registry as jregistry
    names = [f"crypto.verify.signer_table.{k}" for k in (
        "misses", "hits", "installs", "audit_evictions", "evictions")]
    rng = np.random.default_rng(83)
    pks = [vectors.keypair(rng)[1] for _ in range(4)]
    tables = [st.build_signer_table(pk) for pk in pks]
    moved = {}
    for name, (cache, reg) in {"port": (st.signer_table_cache, registry),
                               "reference": (jst.signer_table_cache,
                                             jregistry)}.items():
        before = [reg.counter(n).count for n in names]
        cache.configure(max_bytes=2 * st.TABLE_BYTES)
        for pk, tab in zip(pks, tables):
            assert cache.lookup(pk) is None
            cache.install(pk, tab.copy())
        assert cache.lookup(pks[3]) is not None
        assert cache.lookup(pks[0]) is None        # evicted by the budget
        assert cache.evict(pks[3]) and not cache.evict(pks[0])
        cache.lookup(pks[2])
        cache.configure(max_bytes=0)               # evicts the rest
        moved[name] = [reg.counter(n).count - b
                       for n, b in zip(names, before)]
        snap = cache.snapshot()
        assert moved[name] == [snap[k] for k in (
            "misses", "hits", "installs", "audit_evictions", "evictions")]
    assert moved["port"] == moved["reference"] == [5, 2, 4, 1, 3]


# ---------------- the slice as a whole: wire, fleet, verifier ----------


def _wire_run(server_mod, fleet_mod, verifier, frames, n_frames):
    """``frames`` sent as they are on one loopback connection to a
    ``server_mod.IngressServer`` over a started three-replica
    ``fleet_mod.FleetRouter`` on ``verifier``; returns the verdicts by
    request id and the fleet's route log, trace IDs rebased."""
    from stellar_tpu_torch.utils import wire
    fleet = fleet_mod.FleetRouter(verifier=verifier, replicas=3).start()
    srv = server_mod.IngressServer(fleet, "127.0.0.1", 0).start()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=120)
    got = {}
    try:
        sock.sendall(frames)
        dec = wire.FrameDecoder()
        while len(got) < n_frames:
            data = sock.recv(65536)
            assert data, "the server closed the connection"
            for ftype, decoded in dec.feed_decoded(data):
                assert ftype == wire.VERDICT, decoded
                req_id, _lo, verdicts = decoded
                got[req_id] = verdicts
    finally:
        sock.close()
        srv.stop(timeout=30)
        fleet.stop(drain=True, timeout=60)
        # the health surfaces as at process start, for later tests
        server_mod.register_ingress_health(None)
        with server_mod._health_lock:
            server_mod._server_ref = None
        with fleet_mod._fleet_lock:
            fleet_mod._fleet = None
        server_mod.batch_verifier.register_fleet_health(None)
        server_mod.batch_verifier.register_service_health(None)
    assert srv.snapshot()["conservation_gap"] == 0
    assert fleet.snapshot()["conservation_gap"] == 0
    log = fleet.route_log()
    base = min(r["trace_lo"] for r in log)
    return got, [dict(r, trace_lo=r["trace_lo"] - base) for r in log]


def test_slice_wire_fleet_verifier_equals_jax(fresh_cache, jax_verifier):
    """The slice as a whole: the same wire frames (the edge corpus plus
    fresh signatures in frames of 8 over six tenants, two passes, so the
    second rides the hot path) through the reference's ``IngressServer``
    -> ``FleetRouter(verifier=jax_verifier)`` and the port's
    ``IngressServer`` -> ``FleetRouter`` over a CPU ``BatchVerifier``:
    verdicts equal to each other and to the oracle, the fleets' route logs
    equal, and the port's second pass served hot."""
    from stellar_tpu.crypto import fleet as jfleet
    from stellar_tpu.crypto import ingress as jingress
    from stellar_tpu_torch.crypto import fleet as tfleet
    from stellar_tpu_torch.crypto import ingress as tingress
    from stellar_tpu_torch.utils import wire
    rng = np.random.default_rng(87)
    items = vectors.edge_corpus(rng) + vectors.valid_items(rng, 3)
    oracle = np.array([ref.verify(*it) for it in items])
    per = 8
    frames, want = [], {}
    for p in range(2):
        for k in range(0, len(items), per):
            req = p * 100 + k // per
            frames.append(wire.encode_submit(items[k:k + per], "bulk",
                                             f"t{k // per}", req))
            want[req] = oracle[k:k + per].tolist()
    blob = b"".join(frames)
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    got_port, log_port = _wire_run(tingress, tfleet, v, blob, len(want))
    got_ref, log_ref = _wire_run(jingress, jfleet, jax_verifier, blob,
                                 len(want))
    assert got_port == want
    assert got_ref == want
    assert log_port == log_ref
    assert len({r["replica"] for r in log_port}) > 1
    assert v.served["hot"] > 0
    assert oracle.any() and not oracle.all()
