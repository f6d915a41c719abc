"""K1, the cold verify kernel: the port's plain version against the JAX
package's ``verify_kernel`` at one shape (B = 16), limb for limb through
decompress, the recode and the double scalar multiplication, bit for bit
at the end; the constant tables carried across from the JAX package; and
the CUDA source's arithmetic, compiled here for the host with g++ (the
``__device__`` parts stay behind ``__CUDACC__``) and held against the
plain version. Integer arithmetic throughout: tolerance zero."""

import ctypes
import importlib.util
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stellar_tpu.ops import edwards as jed
from stellar_tpu.ops import field25519 as jfe
from stellar_tpu.ops import verify as jvk
from stellar_tpu_torch import state
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import Ed25519Workload
from stellar_tpu_torch.ops import edwards as ted
from stellar_tpu_torch.ops import verify as tvk

B = 16
ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(ROOT, "stellar_tpu_torch", "csrc")


def _rows(seed=31, n_valid=4, n_match=4, n_edge=4):
    """(a, r, s, h) uint8 rows: good signatures, rows whose device bit is
    True for extreme and random 256-bit scalars, edge-corpus rows (bad A,
    small-order R, non-canonical s, ...) and random bytes, in that order,
    B rows in all."""
    rng = np.random.default_rng(seed)
    _, good = Ed25519Workload().encode(vectors.valid_items(rng, n_valid))
    match = vectors.matching_rows(rng, n_match)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng)[1::3])
    n_rand = B - n_valid - n_match - n_edge
    rand = vectors.random_rows(rng, n_rand)
    return tuple(np.ascontiguousarray(np.concatenate(
        [good[k], match[k], edge[k][:n_edge], rand[k]])) for k in range(4))


def _jax_pipeline(a, r, s, h):
    """JAX verify_kernel plus its stages, in one jit (one compile)."""
    ok, pt = jed.decompress(a)
    sd, hd = jvk.signed_digits32_dev(s), jvk.signed_digits32_dev(h)
    rp = jed._double_scalarmult32(sd, hd, jed.negate(pt))
    return jvk.verify_kernel(a, r, s, h), ok, pt, sd, hd, rp


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def jax_out(rows):
    out = jax.jit(_jax_pipeline)(*(jnp.asarray(x) for x in rows))
    return jax.tree_util.tree_map(np.asarray, out)


def _same(got, want):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy()
    assert g.shape == want.shape and g.dtype == want.dtype
    np.testing.assert_array_equal(g, want)


def _t(rows):
    return tuple(torch.from_numpy(x) for x in rows)


def test_verify_kernel_matches_jax(rows, jax_out):
    launches = tvk.verify_kernel.launches
    got = tvk.verify_kernel(*_t(rows))
    _same(got, jax_out[0])
    # good signatures and matching rows are True, random bytes False
    assert got[:8].all() and not got[12:].any()
    _same(tvk.verify_kernel_plain(*_t(rows)), jax_out[0])
    # the CPU path runs the plain version: no kernel launch is counted
    assert tvk.verify_kernel.launches == launches


def test_stages_match_jax_limb_exact(rows, jax_out):
    a, _, s, h = _t(rows)
    ok, pt = ted.decompress(a)
    _same((ok, pt), (jax_out[1], jax_out[2]))
    sd, hd = tvk.signed_digits32(s), tvk.signed_digits32(h)
    _same((sd, hd), (jax_out[3], jax_out[4]))
    _same(ted._double_scalarmult32(sd, hd, ted.negate(pt)), jax_out[5])
    _same(ted.double_scalarmult(sd, hd, ted.negate(pt)), jax_out[5])


def test_verify_kernel_checks_operands():
    good = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tvk.verify_kernel(good, good, good, good.to(torch.int32))
    with pytest.raises(ValueError):
        tvk.verify_kernel(good, good, good, good[:3])
    with pytest.raises(ValueError):
        tvk.verify_kernel(good, good, good, torch.zeros((4, 31),
                                                        dtype=torch.uint8))
    meta = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tvk.verify_kernel(meta, meta, meta, meta)
    assert tvk.verify_kernel(*(good[:0],) * 4).shape == (0,)


def test_tables_from_jax_equal_port_tables():
    """The JAX package's constants carried across equal the tables the
    port builds itself, in both layouts, exactly."""
    got = state.tables_from_jax({
        "_BASE_TABLE32": jed._BASE_TABLE32,
        "_BASE_TABLE256": jed._BASE_TABLE256, "D_LIMBS": jed.D_LIMBS,
        "D2_LIMBS": jed.D2_LIMBS, "SQRTM1_LIMBS": jed.SQRTM1_LIMBS,
        "_SUB_PAD": jfe._SUB_PAD})
    mine = state.port_tables()
    assert set(got) == set(mine)
    for key in mine:
        want = torch.int16 if key == "base_table256" else torch.int32
        assert got[key].dtype == mine[key].dtype == want, key
        assert torch.equal(got[key], mine[key]), key
    assert got["kernel_consts"].shape == (3 * 10 + 16 * 3 * 10,)
    with pytest.raises(ValueError):
        state.tables_from_jax({"_BASE_TABLE32": jed._BASE_TABLE32[:8],
                               "_BASE_TABLE256": jed._BASE_TABLE256})


def test_kernel_consts_are_the_curve_constants():
    k = state.port_tables()["kernel_consts"].numpy().reshape(-1, 10)
    start = [(51 * i + 1) // 2 for i in range(10)]
    vals = [sum(int(v) << s for v, s in zip(row, start)) for row in k]
    assert vals[:3] == [ref.D, 2 * ref.D % ref.P, ref.SQRT_M1]
    rows = ref.affine_table_rows(ref.BASE, 16)
    assert vals[3:] == [c for row in rows for c in row]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cold_kernel_multiplies_counts_the_op_sequence():
    smoke = _chip_smoke()
    zero = torch.zeros((2, 32), dtype=torch.uint8)
    # per row, with every digit zero: decompress, the A-table and encode,
    # 513 squarings (55 products) and 165 multiplies (100)
    fixed = 513 * 55 + 165 * 100
    assert smoke.cold_kernel_multiplies(zero, zero) == 2 * fixed
    one = zero.clone()
    one[0, 0] = 1  # a nonzero digit in window 0 of one row: an addition
    # of B (7 multiplies) for s, of -A (8) for h, and no doubling
    assert smoke.cold_kernel_multiplies(one, zero) == 2 * fixed + 700
    assert smoke.cold_kernel_multiplies(zero, one) == 2 * fixed + 800
    top = zero.clone()
    top[1, 31] = 0x10  # bit 252: digit 4 in window 50 of row 1, so 250
    # doublings (4 squarings, 3 multiplies) below it
    assert smoke.cold_kernel_multiplies(top, zero) == \
        2 * fixed + 250 * (4 * 55 + 3 * 100) + 700
    # what the four-lane kernel executes does not depend on the digits:
    # every doubling makes T, every window adds (a zero digit the
    # identity), 1,533 squarings and 1,965 multiplies a row
    assert smoke.cold_kernel_executed(2) == 2 * (1533 * 55 + 1965 * 100)


_HOST_SHIM = r"""
#define FE_FN static inline
#define FE_CALL static
#include "verify_cold.cu"
#include <string.h>
extern "C" int verify_rows_host(const uint8_t* a, const uint8_t* r,
                                const uint8_t* s, const uint8_t* h,
                                uint8_t* out, int n, const int32_t* consts) {
  verify_consts K;
  memcpy(&K, consts, sizeof(K));
  for (int i = 0; i < n; ++i)
    out[i] = (uint8_t)verify_row_x4(a + 32 * i, r + 32 * i, s + 32 * i,
                                    h + 32 * i, K);
  return (int)sizeof(K);
}
extern "C" void fe_mul_host(const int32_t* f, const int32_t* g, int32_t* out,
                            int square) {
  fe a, b, c;
  memcpy(a.v, f, 40);
  memcpy(b.v, g, 40);
  if (square) fe_sq(c, a); else fe_mul(c, a, b);
  memcpy(out, c.v, 40);
}
extern "C" void fe_roundtrip_host(const uint8_t* s, uint8_t* out) {
  fe a;
  fe_frombytes(a, s);
  fe_tobytes(out, a);
}
// One doubling or addition, the four lanes of ge25519_x4.cuh run in turn
// (op 0: doubling; 1: addition of q, a point, through its cached form; 2:
// addition of q, an affine (y + x, y - x, 2dxy) entry, as the B-table
// stages it), then ref10's one-thread counterpart; points are extended
// (X, Y, Z, T), 4 x 10 limbs. ``digit`` is 0, 1 or -1: the table read is
// [identity, q] and the entry is q, -q or the identity.
extern "C" void x4_step_host(int op, const int32_t* p, const int32_t* q,
                             int digit, const int32_t* d2, int32_t* x4,
                             int32_t* one) {
  fe own[4], g[4], r1[4], tab[8], d2v;
  memcpy(own, p, sizeof(own));
  memcpy(&d2v, d2, sizeof(d2v));
  x4_gather_xy<4>(g, own);
  if (op == 0) {
    for (int j = 0; j < 4; ++j) x4_dbl_r1(r1[j], j, g);
  } else {
    fe qv[4], qg[4];
    memcpy(qv, q, sizeof(qv));
    for (int j = 0; j < 4; ++j) x4_identity_cached(tab[j], j);
    if (op == 1) {
      x4_gather_xy<4>(qg, qv);
      for (int j = 0; j < 4; ++j) x4_to_cached(tab[4 + j], j, qg, d2v);
    } else {
      tab[4] = qv[1];
      tab[5] = qv[0];
      fe_0(tab[6]);
      tab[6].v[0] = 2;
      tab[7] = qv[2];
    }
    for (int j = 0; j < 4; ++j) {
      fe e;
      x4_entry(e, j, tab, digit);
      x4_add_r1(r1[j], j, g, e);
    }
  }
  x4_gather<4>(g, r1);
  for (int j = 0; j < 4; ++j) {
    if (op == 0) x4_dbl_r2(own[j], j, g); else x4_add_r2(own[j], j, g);
  }
  memcpy(x4, own, sizeof(own));

  ge_p3 a, b;
  memcpy(&a, p, sizeof(a));
  ge_p1p1 t;
  if (op == 0) {
    const ge_p2 a2 = {a.X, a.Y, a.Z};
    ge_p2_dbl(t, a2);
  } else if (digit == 0) {
    ge_p3_0(b);
    ge_cached c;
    ge_p3_to_cached(c, b, d2v);
    ge_add(t, a, c);
  } else if (op == 1) {
    memcpy(&b, q, sizeof(b));
    ge_cached c;
    ge_p3_to_cached(c, b, d2v);
    if (digit > 0) ge_add(t, a, c); else ge_sub(t, a, c);
  } else {
    ge_precomp e;
    memcpy(&e, q, sizeof(e));
    if (digit < 0) ge_precomp_neg(e);
    ge_madd(t, a, e);
  }
  ge_p1p1_to_p3(b, t);
  memcpy(one, &b, sizeof(b));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/verify_cold.cu's host-compilable part (everything outside
    __CUDACC__, with ge25519_x4.cuh's four lanes run in turn), built with
    g++ behind a small C shim."""
    d = tmp_path_factory.mktemp("host_kernel")
    shim = d / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    out = d / "libverify_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.verify_rows_host.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, vp]
    lib.verify_rows_host.restype = ctypes.c_int
    lib.fe_mul_host.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.fe_roundtrip_host.argtypes = [ctypes.c_char_p, vp]
    lib.x4_step_host.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int, vp, vp,
                                 vp]
    return lib


_START = [(51 * i + 1) // 2 for i in range(10)]


def _fe_int(limbs):
    return sum(int(v) << s for v, s in zip(limbs, _START))


def test_cuda_field_arithmetic_on_host(host_lib):
    """fe_mul / fe_sq on canonical and signed (uncarried) limbs, and the
    byte round trip for every 256-bit pattern class, against Python ints."""
    rng = np.random.default_rng(32)
    out = np.zeros(10, np.int32)
    for it in range(300):
        x, y = (int.from_bytes(rng.bytes(32), "little") % ref.P
                for _ in range(2))
        f, g = state.to_radix25_5(x), state.to_radix25_5(y)
        if it % 2:
            f = f.copy()
            f[3] -= 1 << 24  # a negative limb, as fe_sub leaves them
            f[4] += 1
        for square in (0, 1):
            host_lib.fe_mul_host(f.ctypes.data, g.ctypes.data,
                                 out.ctypes.data, square)
            want = _fe_int(f) * (_fe_int(f) if square else _fe_int(g))
            assert _fe_int(out) % ref.P == want % ref.P
            assert np.abs(out).max() <= (1 << 25) + (1 << 6)
    specials = [0, 1, 18, 19, ref.P - 1, ref.P, ref.P + 1, 2**255 - 1,
                2**255, 2**256 - 1]
    for v in specials + [int.from_bytes(rng.bytes(32), "little")
                         for _ in range(200)]:
        buf = (ctypes.c_uint8 * 32)()
        host_lib.fe_roundtrip_host(v.to_bytes(32, "little"), buf)
        assert int.from_bytes(bytes(buf), "little") == \
            (v % 2**255) % ref.P


def test_x4_uncarried_products_stay_exact(host_lib):
    """ge25519_x4.cuh leaves a round's sums uncarried: fe_mul stays exact
    on limbs of three units (a unit: 2^25 + 19 even, 2^24 + 2^15 odd) in
    either operand, and fe_sq on two units, for every sign pattern drawn
    and on random values of those sizes; the results are carried again."""
    rng = np.random.default_rng(36)
    odd = np.arange(10) % 2 == 1
    unit = np.where(odd, (1 << 24) + (1 << 15), (1 << 25) + 19)
    out = np.zeros(10, np.int32)
    for it in range(400):
        fs = [(rng.choice([-1, 1], 10) * k * unit).astype(np.int32)
              for k in (3, 3, 2)]
        if it % 2:  # random limbs within the same bounds
            fs = [(rng.integers(-1 << 30, 1 << 30, 10) % (k * unit + 1)
                   * rng.choice([-1, 1], 10)).astype(np.int32)
                  for k in (3, 3, 2)]
        f, g, sq = fs
        host_lib.fe_mul_host(f.ctypes.data, g.ctypes.data, out.ctypes.data,
                             0)
        assert _fe_int(out) % ref.P == _fe_int(f) * _fe_int(g) % ref.P
        assert np.abs(out).max() <= (1 << 25) + (1 << 15)
        host_lib.fe_mul_host(sq.ctypes.data, sq.ctypes.data,
                             out.ctypes.data, 1)
        assert _fe_int(out) % ref.P == _fe_int(sq) ** 2 % ref.P


def _host_bits(host_lib, rows):
    """verify_row_x4's bits for (a, r, s, h) uint8 rows, on the host."""
    consts = state.port_tables()["kernel_consts"].numpy()
    a, r, s, h = (np.ascontiguousarray(x) for x in rows)
    out = np.zeros(len(a), np.uint8)
    size = host_lib.verify_rows_host(a.ctypes.data, r.ctypes.data,
                                     s.ctypes.data, h.ctypes.data,
                                     out.ctypes.data, len(a),
                                     consts.ctypes.data)
    assert size == consts.nbytes
    return out.astype(bool)


def test_cuda_verify_row_on_host_matches_plain(host_lib, rows):
    """The kernel's per-row function (verify_row_x4, its four lanes run in
    turn), on the host, gives the plain version's bit on every row: the
    B = 16 rows above and 32 more (edge corpus, matching rows with extreme
    scalars, random bytes)."""
    rng = np.random.default_rng(33)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    match = vectors.matching_rows(rng, 6)
    rand = vectors.random_rows(rng, 6)
    more = tuple(np.ascontiguousarray(np.concatenate(
        [edge[k][:20], match[k], rand[k]])) for k in range(4))
    for part in (rows, more):
        plain = tvk.verify_kernel_plain(*_t(part)).numpy()
        np.testing.assert_array_equal(_host_bits(host_lib, part), plain)
        assert plain.any() and not plain.all()


def test_cuda_verify_row_on_host_top_digit_rows(host_lib):
    """verify_row_x4 on rows whose scalars take the largest top radix-32
    digit (2: bits 254 and 255 set), in s, in h and in both, with R right
    (bit True) and with R's low bit flipped (bit False): the plain
    version's bit on every row."""
    rng = np.random.default_rng(34)
    top = 3 << 254
    a, r, s, h = vectors._rows_for(
        rng, 12, [2**256 - 1, top, top + 1],
        lambda: int.from_bytes(rng.bytes(32), "little") | top)
    r[8:, 0] ^= np.uint8(1)
    rows = (a, r, s, h)
    digits = [tvk.signed_digits32(torch.from_numpy(x))[0] for x in (s, h)]
    assert (digits[0] == 2).all() and (digits[1] == 2).all()
    plain = tvk.verify_kernel_plain(*_t(rows)).numpy()
    np.testing.assert_array_equal(_host_bits(host_lib, rows), plain)
    assert plain[:8].all() and not plain[8:].any()


def _limbs(values):
    """Canonical limbs of each value (a constant's form: two units)."""
    return np.ascontiguousarray(np.stack(
        [state.to_radix25_5(v % ref.P) for v in values]))


def _centered(values):
    """Each value's limbs carried into signed form, as fe_carry leaves
    them (one unit): the form of every coordinate a lane holds."""
    out = _limbs(values).astype(np.int64)
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


def _fe_values(limbs):
    return [_fe_int(x) % ref.P for x in limbs.reshape(-1, 10)]


def _affine_entry(q):
    """ge_precomp (y + x, y - x, 2dxy) of an extended point, padded to
    four field elements."""
    zi = pow(q[2], ref.P - 2, ref.P)
    x, y = q[0] * zi % ref.P, q[1] * zi % ref.P
    return [y + x, y - x, 2 * ref.D * x * y, 0]


def _x4_points(rng):
    """Extended points for the round tests, each at a random projective
    scale: the identity, the small-order points, multiples of B and
    their negations."""
    small = [ref.point_decompress(e) for e in ref.SMALL_ORDER_ENCODINGS]
    pts = [ref.IDENTITY] + [p for p in small if p is not None]
    for _ in range(6):
        pt = ref.scalarmult_base(int(rng.integers(1, 2**62)))
        pts += [pt, vectors._neg(pt)]
    out = []
    for x, y, z, t in pts:
        k = int(rng.integers(1, 2**62))
        out.append((x * k % ref.P, y * k % ref.P, z * k % ref.P,
                    t * k % ref.P))
    return out


@pytest.mark.parametrize("op", ["dbl", "add", "madd"])
def test_x4_rounds_equal_ref10(host_lib, op):
    """A doubling, a cached addition and a mixed addition of
    ge25519_x4.cuh, the four lanes run in turn, give ref10's ge_p2_dbl,
    ge_add / ge_sub and ge_madd (ge25519.cuh, one thread, then
    ge_p1p1_to_p3) coordinate for coordinate as field values, on every
    pair of the identity, small-order points and multiples of B, for the
    digits 1, -1 and 0 (the identity entry). Coordinates go in carried,
    as a lane holds them; affine entries canonical, as the B-table."""
    rng = np.random.default_rng(35)
    pts = _x4_points(rng)
    d2 = state.to_radix25_5(2 * ref.D % ref.P)
    x4 = np.zeros((4, 10), np.int32)
    one = np.zeros((4, 10), np.int32)
    code = {"dbl": 0, "add": 1, "madd": 2}[op]
    checked = 0
    for i, p in enumerate(pts):
        for q in (pts if op != "dbl" else [pts[0]]):
            qv = _affine_entry(q) if op == "madd" else q
            for digit in ((0,) if op == "dbl" else (1, -1, 0)):
                pl = _centered(p)
                ql = _limbs(qv) if op == "madd" else _centered(qv)
                host_lib.x4_step_host(code, pl.ctypes.data, ql.ctypes.data,
                                      digit, d2.ctypes.data, x4.ctypes.data,
                                      one.ctypes.data)
                assert _fe_values(x4) == _fe_values(one), (op, i, digit)
                assert np.abs(x4).max() <= (1 << 25) + (1 << 6)
                checked += 1
    assert checked >= (len(pts) if op == "dbl" else 3 * len(pts) ** 2)
    # the result is the group law's: 2P, or P + Q
    p, q = pts[-1], pts[-3]
    want = ref.point_double(p) if op == "dbl" else ref.point_add(p, q)
    pl = _centered(p)
    ql = _limbs(_affine_entry(q)) if op == "madd" else _centered(q)
    host_lib.x4_step_host(code, pl.ctypes.data, ql.ctypes.data, 1,
                          d2.ctypes.data, x4.ctypes.data, one.ctypes.data)
    got = _fe_values(x4)
    assert got[0] * want[2] % ref.P == want[0] * got[2] % ref.P
    assert got[1] * want[2] % ref.P == want[1] * got[2] % ref.P
