"""K5, the radix-16 arm: the port's plain version against the JAX
package's radix-16 composition (``signed_digits16_dev``,
``build_point_table``, ``base_table``, ``table_select``,
``_double_scalarmult16``, decompress and ``compress_equals``, as the
radix sweep of ``tools/kernel_cost.py`` builds it) at one shape (B = 16),
limb for limb through every stage and bit for bit at the end; and the
CUDA source's per-row function (``csrc/verify_r16.cu`` over
``csrc/verify_lanes.cuh``: K1's four-lane row at 4 bits a window, its
four lanes run in turn), compiled here for the host with g++, against the
plain version and the JAX composition. Rows include scalars whose top
radix-16 digit exceeds the 8-entry table (s >= 9 * 2^252), in s alone, in
h alone and in both, where the select yields the zero point and the bit
is True exactly when R is 32 zero bytes. Integer arithmetic throughout:
tolerance zero."""

import ctypes
import importlib.util
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_tpu.ops import edwards as jed
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

# one lane each: every signed digit -8..7, then 0 and the top digits 8..16
# (the second row of the fused B/A select)
_DIGITS = np.array([list(range(-8, 8)),
                    [0, 8, 9, 10, 11, 12, 13, 14, 15, 16, -1, -2, -3, -4,
                     -5, 1]], dtype=np.int32)


def _le(v):
    return np.frombuffer(v.to_bytes(32, "little"), np.uint8)


def _rows(seed=61):
    """(a, r, s, h) uint8 rows, B in all: two good signatures, matching
    rows with extreme and random scalars below the overflow, overflow rows
    (R = 0 with the bit True, and R = the true point with the bit False),
    edge-corpus rows and random bytes."""
    rng = np.random.default_rng(seed)
    _, good = Ed25519Workload().encode(vectors.valid_items(rng, 2))
    match = vectors.r16_matching_rows(rng, 5)
    over = vectors.r16_overflow_rows(rng, 5)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng)[1::5])
    rand = vectors.random_rows(rng, 2)
    return tuple(np.ascontiguousarray(np.concatenate(
        [good[k], match[k], over[k], edge[k][:2], rand[k]]))
        for k in range(4))


def _jax_pipeline(a, r, s, h, digits):
    """The reference's radix-16 composition and its stages, in one jit."""
    ok, pt = jed.decompress(a)
    neg = jed.negate(pt)
    sd, hd = jvk.signed_digits16_dev(s), jvk.signed_digits16_dev(h)
    tab_a = jed.build_point_table(neg)
    tab_b = jed.base_table((a.shape[0],))
    sel = jed.table_select(jnp.stack([tab_b, tab_a], axis=3), digits)
    rp = jed.double_scalarmult(sd, hd, neg)
    bit = ok & jed.compress_equals(rp, r)
    return bit, ok, pt, sd, hd, tab_a, tab_b, sel, rp


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def jax_out(rows):
    args = [jnp.asarray(x) for x in rows] + [jnp.asarray(_DIGITS)]
    out = jax.jit(_jax_pipeline)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy()
    assert g.shape == want.shape and g.dtype == want.dtype
    np.testing.assert_array_equal(g, want)


def _t(rows):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in rows)


def test_rows_cover_the_cases(rows):
    """The rows hold good and matching rows (True), overflow rows of both
    outcomes, and top digits above 8 for s and for h."""
    s, h = _t(rows[2:])
    top = torch.stack([tvk.signed_digits16(s)[0], tvk.signed_digits16(h)[0]])
    over = (top > 8).any(0)
    assert over[7:12].all() and not over[:7].any()
    assert (top[0] > 8).sum() >= 2 and (top[1] > 8).sum() >= 2
    assert (rows[1][7:12].any(1) == np.array([0, 1, 0, 1, 0], bool)).all()


@pytest.mark.parametrize("value", [
    0, 1, ref.L - 1, 8 * 2**252, vectors.R16_OVERFLOW - 1,
    vectors.R16_OVERFLOW, 9 * 2**252 - 1, 9 * 2**252, 2**255 - 1,
    2**256 - 1])
def test_signed_digits16_matches_jax_edges(value):
    b = _le(value)[None]
    got = tvk.signed_digits16(torch.from_numpy(b.copy()))
    want = np.asarray(jvk.signed_digits16_dev(jnp.asarray(b)))
    _same(got, want)
    d = got[:, 0].tolist()[::-1]
    assert sum(x * 16**i for i, x in enumerate(d)) == value
    assert got[0, 0] <= 8 if value < vectors.R16_OVERFLOW else \
        got[0, 0] > 8


def test_signed_digits16_matches_jax_random():
    rng = np.random.default_rng(62)
    b = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    _same(tvk.signed_digits16(torch.from_numpy(b)),
          np.asarray(jvk.signed_digits16_dev(jnp.asarray(b))))


def test_verify_kernel_r16_matches_jax(rows, jax_out):
    launches = tvk.verify_kernel_r16.launches
    got = tvk.verify_kernel_r16(*_t(rows))
    _same(got, jax_out[0])
    _same(tvk.verify_kernel_r16_plain(*_t(rows)), jax_out[0])
    # good and matching rows True, overflow rows True exactly where R = 0
    want_head = [True] * 7 + [True, False, True, False, True]
    assert got[:12].tolist() == want_head
    assert not got[14:].any()
    # the CPU path runs the plain version: no kernel launch is counted
    assert tvk.verify_kernel_r16.launches == launches


def test_stages_match_jax_limb_exact(rows, jax_out):
    a, _, s, h = _t(rows)
    ok, pt = ted.decompress(a)
    _same((ok, pt), jax_out[1:3])
    sd, hd = tvk.signed_digits16(s), tvk.signed_digits16(h)
    _same((sd, hd), jax_out[3:5])
    neg = ted.negate(pt)
    tab_a = ted.build_point_table(neg)
    _same(tab_a, jax_out[5])
    tab_b = ted.base_table((B,), "cpu")
    _same(tab_b.contiguous(), jax_out[6])
    sel = ted.table_select(torch.stack([tab_b, tab_a], dim=3),
                           torch.from_numpy(_DIGITS))
    _same(sel, jax_out[7])
    _same(ted._double_scalarmult16(sd, hd, neg), jax_out[8])
    _same(ted.double_scalarmult(sd, hd, neg), jax_out[8])


def test_base_table_is_the_references():
    np.testing.assert_array_equal(ted._BASE_TABLE, jed._BASE_TABLE)


def test_r16_kernel_multiplies_counts_the_op_sequence():
    """chip_smoke.py's K5 bound: per row 1,521 squarings (55 products)
    and 912 multiplies (100), then 7 multiplies for each nonzero digit of
    s and 8 for each of h; and what the four-lane K5 executes whatever
    the digits, 1,521 squarings and 2,061 multiplies a row."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    zero = torch.zeros((2, 32), dtype=torch.uint8)
    fixed = 1521 * 55 + 912 * 100
    assert smoke.r16_kernel_multiplies(zero, zero) == 2 * fixed
    one = zero.clone()
    one[0, 0] = 1  # one nonzero digit
    assert smoke.r16_kernel_multiplies(one, zero) == 2 * fixed + 700
    assert smoke.r16_kernel_multiplies(zero, one) == 2 * fixed + 800
    # the four-lane kernel: every doubling makes T, every window both adds
    assert smoke.r16_kernel_executed(2) == 2 * (1521 * 55 + 2061 * 100)


def test_zero_and_overflow_digits_select_as_the_reference():
    """Digit 0 selects the cached identity (1, 1, 1, 0); a magnitude
    above 8 selects the all-zero point."""
    tab = ted.base_table((3,), "cpu")
    sel = ted.table_select(tab, torch.tensor([0, 9, 16], dtype=torch.int32))
    ident = [1, 1, 1, 0]
    for c, want in zip(sel, ident):
        assert c[:, 0].tolist() == [want] + [0] * 19
        assert not c[:, 1:].any()


_HOST_SHIM = r"""
#define FE_FN static inline
#define FE_CALL static
#include "verify_r16.cu"
#include <string.h>
extern "C" int verify_r16_rows_host(const uint8_t* a, const uint8_t* r,
                                    const uint8_t* s, const uint8_t* h,
                                    uint8_t* out, int n,
                                    const int32_t* consts) {
  verify_r16_consts K;
  memcpy(&K, consts, sizeof(K));
  for (int i = 0; i < n; ++i)
    out[i] = (uint8_t)verify_r16_row_x4(a + 32 * i, r + 32 * i, s + 32 * i,
                                        h + 32 * i, K);
  return (int)sizeof(K);
}
extern "C" void recode16_host(const uint8_t* s, int8_t* d) {
  recode16(d, s);
}
// The zero entry (index 9 of a radix-16 table) added to the extended
// point p in four-lane rounds, the lanes run in turn, then ``doublings``
// doublings: the point out (4 x 10 limbs) and whether it encodes to 32
// zero bytes.
extern "C" int x4_add_zero_host(const int32_t* p, int doublings,
                                int32_t* out) {
  fe own[4], g[4], q[4], op[4];
  fe tab[Radix16::table_fe];
  memset(tab, 0x55, sizeof(tab));
  for (int j = 0; j < 4; ++j) fe_0(tab[4 * (Radix16::multiples + 1) + j]);
  memcpy(own, p, sizeof(own));
  x4_gather_xy<4>(g, own);
  for (int j = 0; j < 4; ++j) {
    x4_entry(op[j], j, tab, Radix16::multiples + 1);
    x4_add_r1(q[j], j, g, op[j]);
  }
  x4_gather<4>(g, q);
  for (int j = 0; j < 4; ++j) x4_add_r2(own[j], j, g);
  for (int i = 0; i < doublings; ++i) {
    x4_gather_xy<4>(g, own);
    for (int j = 0; j < 4; ++j) x4_dbl_r1(q[j], j, g);
    x4_gather<4>(g, q);
    for (int j = 0; j < 4; ++j) x4_dbl_r2(own[j], j, g);
  }
  memcpy(out, own, sizeof(own));
  const ge_p3 acc = {own[0], own[1], own[2], own[3]};
  const uint8_t zero[32] = {0};
  return ge_p3_encodes_to(acc, zero);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/verify_r16.cu's host-compilable part (everything outside
    __CUDACC__, with ge25519_x4.cuh's four lanes run in turn), built with
    g++ behind a small C shim."""
    d = tmp_path_factory.mktemp("host_r16")
    shim = d / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    out = d / "libverify_r16_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.verify_r16_rows_host.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                         vp]
    lib.verify_r16_rows_host.restype = ctypes.c_int
    lib.recode16_host.argtypes = [vp, vp]
    lib.x4_add_zero_host.argtypes = [vp, ctypes.c_int, vp]
    lib.x4_add_zero_host.restype = ctypes.c_int
    return lib


def _host_bits(lib, rows):
    a, r, s, h = (np.ascontiguousarray(x) for x in rows)
    consts = state.port_tables()["r16_kernel_consts"].numpy()
    out = np.zeros(len(a), np.uint8)
    size = lib.verify_r16_rows_host(a.ctypes.data, r.ctypes.data,
                                    s.ctypes.data, h.ctypes.data,
                                    out.ctypes.data, len(a),
                                    consts.ctypes.data)
    assert size == consts.nbytes
    return out.astype(bool)


def test_cuda_recode16_on_host_matches_plain(host_lib):
    rng = np.random.default_rng(63)
    vals = [0, 1, ref.L - 1, vectors.R16_OVERFLOW - 1, vectors.R16_OVERFLOW,
            9 * 2**252, 2**255 - 1, 2**256 - 1]
    b = np.concatenate([np.stack([_le(v) for v in vals]),
                        rng.integers(0, 256, (40, 32), dtype=np.uint8)])
    want = tvk.signed_digits16(torch.from_numpy(b)).numpy()
    for i, row in enumerate(b):
        d = np.zeros(64, np.int8)
        host_lib.recode16_host(np.ascontiguousarray(row).ctypes.data,
                               d.ctypes.data)
        np.testing.assert_array_equal(d[::-1].astype(np.int32), want[:, i])


def test_cuda_verify_r16_row_on_host_matches_plain(host_lib, rows,
                                                   jax_out):
    """The kernel's per-row function (verify_r16_row_x4, its four lanes
    run in turn), on the host, gives the JAX composition's bit on the
    B = 16 rows above, and the plain version's bit on those and on the
    whole edge corpus, matching and overflow rows and random bytes."""
    rng = np.random.default_rng(64)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    match = vectors.r16_matching_rows(rng, 6)
    over = vectors.r16_overflow_rows(rng, 8)
    rand = vectors.random_rows(rng, 6)
    more = tuple(np.ascontiguousarray(np.concatenate(
        [edge[k], match[k], over[k], rand[k]])) for k in range(4))
    np.testing.assert_array_equal(_host_bits(host_lib, rows), jax_out[0])
    for batch in (rows, more):
        plain = tvk.verify_kernel_r16_plain(*_t(batch)).numpy()
        np.testing.assert_array_equal(_host_bits(host_lib, batch), plain)
        assert plain.any() and not plain.all()
    n_edge = len(edge[0])
    assert plain[n_edge:n_edge + 6].all()
    assert plain[n_edge + 6:n_edge + 14].tolist() == [True, False] * 4


def _overflow_rows(rng, which, zero_r, n=4):
    """``n`` rows over fresh keys whose s (``which`` "s"), h ("h") or both
    ("both") lie at or above R16_OVERFLOW, the other scalar below it, with
    R = 32 zero bytes (``zero_r``: the bit True) or R = encode(s*B +
    h*(-A)) (the bit False). The first rows take R16_OVERFLOW, 9 * 2^252
    and 2^256 - 1."""
    lo = vectors.R16_OVERFLOW
    extremes = [lo, 9 * 2**252, 2**256 - 1]

    def draw(big, i):
        v = int.from_bytes(rng.bytes(32), "little")
        if not big:
            return v % lo
        return extremes[i] if i < len(extremes) else lo + v % (2**256 - lo)

    a, r, s, h = (np.zeros((n, 32), np.uint8) for _ in range(4))
    for i in range(n):
        _, pk = vectors.keypair(rng)
        sv = draw(which != "h", i)
        hv = draw(which != "s", n - 1 - i)
        point = ref.point_add(ref.scalarmult_base(sv), ref.point_mul(
            hv, vectors._neg(ref.point_decompress(pk))))
        a[i] = np.frombuffer(pk, np.uint8)
        r[i] = np.frombuffer(bytes(32) if zero_r
                             else ref.point_compress(point), np.uint8)
        s[i] = np.frombuffer(sv.to_bytes(32, "little"), np.uint8)
        h[i] = np.frombuffer(hv.to_bytes(32, "little"), np.uint8)
    return a, r, s, h


@pytest.mark.parametrize("zero_r", [True, False], ids=["r0", "rpoint"])
@pytest.mark.parametrize("which", ["s", "h", "both"])
def test_cuda_verify_r16_row_on_host_overflow(host_lib, which, zero_r):
    """Overflow in s alone, in h alone and in both: the four-lane row adds
    the zero entry and ends at the zero point, so its bit is True exactly
    when R is 32 zero bytes, the plain version's bit on every row."""
    rows = _overflow_rows(np.random.default_rng(65), which, zero_r)
    s, h = _t(rows[2:])
    tops = [tvk.signed_digits16(x)[0] > 8 for x in (s, h)]
    assert tops[0].all() == (which != "h") and tops[1].all() == \
        (which != "s") and (tops[0] | tops[1]).all()
    plain = tvk.verify_kernel_r16_plain(*_t(rows)).numpy()
    assert plain.tolist() == [zero_r] * len(plain)
    np.testing.assert_array_equal(_host_bits(host_lib, rows), plain)


def test_x4_zero_entry_gives_the_zero_point(host_lib):
    """The zero entry, added in four-lane rounds to the identity, the
    small-order points and multiples of B at random projective scales,
    gives (0, 0, 0, 0), which stays there through doublings and encodes
    to 32 zero bytes."""
    rng = np.random.default_rng(66)
    small = [ref.point_decompress(e) for e in ref.SMALL_ORDER_ENCODINGS]
    pts = [ref.IDENTITY] + [p for p in small if p is not None]
    pts += [ref.scalarmult_base(int(rng.integers(1, 2**62)))
            for _ in range(6)]
    out = np.zeros((4, 10), np.int32)
    for x, y, z, t in pts:
        k = int(rng.integers(1, 2**62))
        p = np.ascontiguousarray(np.stack([state.to_radix25_5(v * k % ref.P)
                                           for v in (x, y, z, t)]))
        for doublings in (0, 4):
            out[:] = 1
            assert host_lib.x4_add_zero_host(p.ctypes.data, doublings,
                                             out.ctypes.data) == 1
            assert not out.any()


def test_r16_consts_are_the_curve_constants():
    k = state.port_tables()["r16_kernel_consts"].numpy().reshape(-1, 10)
    start = [(51 * i + 1) // 2 for i in range(10)]
    vals = [sum(int(v) << s for v, s in zip(row, start)) for row in k]
    assert vals[:3] == [ref.D, 2 * ref.D % ref.P, ref.SQRT_M1]
    rows = ref.affine_table_rows(ref.BASE, 8)
    assert vals[3:] == [c for row in rows for c in row]
