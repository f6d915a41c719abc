"""K5, the radix-16 arm: the port's plain version against the JAX
package's radix-16 composition (``signed_digits16_dev``,
``build_point_table``, ``base_table``, ``table_select``,
``_double_scalarmult16``, decompress and ``compress_equals``, as the
radix sweep of ``tools/kernel_cost.py`` builds it) at one shape (B = 16),
limb for limb through every stage and bit for bit at the end; and the
CUDA source's per-row function (``csrc/verify_r16.cu``), compiled here
for the host with g++, against the plain version. Rows include scalars
whose top radix-16 digit exceeds the 8-entry table (s >= 9 * 2^252),
where the select yields the zero point and the bit is True exactly when
R is 32 zero bytes. Integer arithmetic throughout: tolerance zero."""

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
    s and 8 for each of h."""
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
    out[i] = (uint8_t)verify_r16_row(a + 32 * i, r + 32 * i, s + 32 * i,
                                     h + 32 * i, K);
  return (int)sizeof(K);
}
extern "C" void recode16_host(const uint8_t* s, int8_t* d) {
  recode16(d, s);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/verify_r16.cu's host-compilable part, built with g++ behind a
    small C shim."""
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


def test_cuda_verify_r16_row_on_host_matches_plain(host_lib, rows):
    """The kernel's per-row function, run on the host, gives the plain
    version's bit on every row: the B = 16 rows above and 40 more (edge
    corpus, matching and overflow rows, random bytes)."""
    rng = np.random.default_rng(64)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    match = vectors.r16_matching_rows(rng, 6)
    over = vectors.r16_overflow_rows(rng, 8)
    rand = vectors.random_rows(rng, 6)
    more = tuple(np.ascontiguousarray(np.concatenate(
        [edge[k][:20], match[k], over[k], rand[k]])) for k in range(4))
    for batch in (rows, more):
        plain = tvk.verify_kernel_r16_plain(*_t(batch)).numpy()
        np.testing.assert_array_equal(_host_bits(host_lib, batch), plain)
        assert plain.any() and not plain.all()
    assert plain[26:34].tolist() == [True, False] * 4


def test_r16_consts_are_the_curve_constants():
    k = state.port_tables()["r16_kernel_consts"].numpy().reshape(-1, 10)
    start = [(51 * i + 1) // 2 for i in range(10)]
    vals = [sum(int(v) << s for v, s in zip(row, start)) for row in k]
    assert vals[:3] == [ref.D, 2 * ref.D % ref.P, ref.SQRT_M1]
    rows = ref.affine_table_rows(ref.BASE, 8)
    assert vals[3:] == [c for row in rows for c in row]
