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
    # per row: 1,787 squarings (55 products) and 1,072 multiplies (100)
    fixed = 1787 * 55 + 1072 * 100
    assert smoke.cold_kernel_multiplies(zero, zero) == 2 * fixed
    one = zero.clone()
    one[0, 0] = 1  # one nonzero digit: one mixed add, 7 multiplies
    assert smoke.cold_kernel_multiplies(one, zero) == 2 * fixed + 700


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
    out[i] = (uint8_t)verify_row(a + 32 * i, r + 32 * i, s + 32 * i,
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
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/verify_cold.cu's host-compilable part (everything outside
    __CUDACC__), built with g++ behind a small C shim."""
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


def test_cuda_verify_row_on_host_matches_plain(host_lib, rows):
    """The kernel's per-row function, run on the host, gives the plain
    version's bit on every row: the B = 16 rows above and 32 more (edge
    corpus, matching rows with extreme scalars, random bytes)."""
    rng = np.random.default_rng(33)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    match = vectors.matching_rows(rng, 6)
    rand = vectors.random_rows(rng, 6)
    more = tuple(np.ascontiguousarray(np.concatenate(
        [edge[k][:20], match[k], rand[k]])) for k in range(4))
    consts = state.port_tables()["kernel_consts"].numpy()
    for a, r, s, h in (rows, more):
        n = len(a)
        out = np.zeros(n, np.uint8)
        size = host_lib.verify_rows_host(a.ctypes.data, r.ctypes.data,
                                         s.ctypes.data, h.ctypes.data,
                                         out.ctypes.data, n,
                                         consts.ctypes.data)
        assert size == consts.nbytes
        plain = tvk.verify_kernel_plain(*_t((a, r, s, h))).numpy()
        np.testing.assert_array_equal(out.astype(bool), plain)
        assert plain.any() and not plain.all()
