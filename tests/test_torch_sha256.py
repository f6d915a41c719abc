"""K3, batched SHA-256: the port against the JAX package and hashlib,
exactly (digest words and bytes, tolerance zero).

* ``pack_messages`` equals the reference's on the edge corpus of
  ``tests/test_hash_differential.py``;
* ``sha256_kernel_plain`` equals JAX ``sha256_kernel`` at one bucket
  (B = 128, one compile in one module fixture) and hashlib;
* the CUDA source's compression function, compiled here for the host with
  g++, equals hashlib and the plain version, at every padding edge too;
* ``chip_smoke.py``'s K3 bound counts the standard's 1,384 operations a
  block;
* ``BatchHasher(device="cpu")`` equals hashlib, oversize rows and padding
  lanes included; ``hash_many``'s policy."""

import ctypes
import hashlib
import importlib.util
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stellar_tpu.crypto import batch_hasher as jbh
from stellar_tpu.ops import sha256 as jsk
from stellar_tpu_torch.crypto import batch_hasher as tbh
from stellar_tpu_torch.crypto.batch_hasher import BatchHasher, hash_many
from stellar_tpu_torch.ops import sha256 as tsk

from test_hash_differential import edge_corpus

B = 128
ROOT = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(ROOT, "stellar_tpu_torch", "csrc")


def _corpus(seed=91, n=B - 3):
    """The reference's edge corpus filled up with random messages of
    every length up to the capacity (503 bytes)."""
    rng = np.random.default_rng(seed)
    msgs = edge_corpus()
    while len(msgs) < n:
        msgs.append(rng.bytes(int(rng.integers(0, 504))))
    return msgs


@pytest.fixture(scope="module")
def packed():
    """(words, active) at B = 128: the corpus, one padding row (no active
    block), one row whose active blocks are not a prefix and one row with
    every block active over random words."""
    rng = np.random.default_rng(92)
    msgs = _corpus()
    words, active, fits = tsk.pack_messages(msgs, tbh.MAX_BLOCKS)
    assert fits.all()
    extra_w = np.zeros((3, tbh.MAX_BLOCKS, 16), np.uint32)
    extra_a = np.zeros((3, tbh.MAX_BLOCKS), bool)
    extra_w[1:] = rng.integers(0, 2**32, (2, tbh.MAX_BLOCKS, 16),
                               dtype=np.uint32)
    extra_a[1] = [True, False, True, True, False, False, True, False]
    extra_a[2] = True
    return (np.concatenate([words, extra_w]),
            np.concatenate([active, extra_a]), msgs)


@pytest.fixture(scope="module")
def jax_digests(packed):
    words, active, _ = packed
    return np.asarray(jax.jit(jsk.sha256_kernel)(jnp.asarray(words),
                                                 jnp.asarray(active)))


def test_pack_messages_matches_reference():
    msgs = edge_corpus() + [bytes(504), bytes(1000)]
    for max_blocks in (tbh.MAX_BLOCKS, 2):
        mine = tsk.pack_messages(msgs, max_blocks)
        theirs = jsk.pack_messages(msgs, max_blocks)
        for m, t in zip(mine, theirs):
            assert m.dtype == t.dtype
            np.testing.assert_array_equal(m, t)
    assert (tsk.K, tsk.H0) == (jsk.K, jsk.H0)
    assert tsk.max_message_bytes(8) == jsk.max_message_bytes(8) == 503
    for n in (0, 55, 56, 119, 120, 503, 504):
        assert tsk.blocks_needed(n) == jsk.blocks_needed(n)


def test_sha256_plain_matches_jax_and_hashlib(packed, jax_digests):
    words, active, msgs = packed
    launches = tsk.sha256_kernel.launches
    got = tsk.sha256_kernel(torch.from_numpy(words),
                            torch.from_numpy(active))
    assert got.dtype == torch.uint32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), jax_digests)
    np.testing.assert_array_equal(
        tsk.sha256_kernel_plain(torch.from_numpy(words),
                                torch.from_numpy(active)).numpy(),
        jax_digests)
    np.testing.assert_array_equal(got.numpy()[:len(msgs)],
                                  tsk.host_digest_words(msgs))
    np.testing.assert_array_equal(got.numpy()[len(msgs)],
                                  np.array(tsk.H0, np.uint32))
    assert tsk.sha256_kernel.launches == launches
    assert tsk.digest_words_to_bytes(got.numpy()[0]) == \
        hashlib.sha256(b"abc").digest()


def test_sha256_kernel_checks_operands():
    words = torch.zeros((4, 8, 16), dtype=torch.uint32)
    active = torch.zeros((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        tsk.sha256_kernel(words.to(torch.int32), active)
    with pytest.raises(ValueError):
        tsk.sha256_kernel(words, active[:, :4])
    with pytest.raises(ValueError):
        tsk.sha256_kernel(words[0], active)
    with pytest.raises(ValueError):
        tsk.sha256_kernel(words.to("meta"), active.to("meta"))
    assert tsk.sha256_kernel(words[:0], active[:0]).shape == (0, 8)


_HOST_SHIM = r"""
#define SHA_FN static inline
#include "sha256.cuh"
extern "C" void sha256_rows_host(const uint32_t* words, const uint8_t* active,
                                 uint32_t* out, int n, int max_blocks) {
  for (int i = 0; i < n; ++i)
    sha256_row(out + 8 * i, words + (size_t)i * max_blocks * 16,
               active + (size_t)i * max_blocks, max_blocks);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/sha256.cuh built with g++ behind a small C shim."""
    d = tmp_path_factory.mktemp("host_sha")
    shim = d / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    out = d / "libsha256_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.sha256_rows_host.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int]
    return lib


def test_cuda_compression_on_host(host_lib, packed, jax_digests):
    """The kernel's per-message function, run on the host, equals hashlib
    on the corpus and the plain version (and JAX) on every row."""
    words, active, msgs = packed
    out = np.zeros((len(words), 8), np.uint32)
    flags = active.astype(np.uint8)
    host_lib.sha256_rows_host(words.ctypes.data, flags.ctypes.data,
                              out.ctypes.data, len(words), words.shape[1])
    np.testing.assert_array_equal(out[:len(msgs)],
                                  tsk.host_digest_words(msgs))
    np.testing.assert_array_equal(out, jax_digests)
    rng = np.random.default_rng(93)
    more = [rng.bytes(n) for n in (0, 1, 55, 56, 63, 64, 65, 503)]
    w, a, _ = tsk.pack_messages(more, tbh.MAX_BLOCKS)
    flags = a.astype(np.uint8)
    out = np.zeros((len(more), 8), np.uint32)
    host_lib.sha256_rows_host(w.ctypes.data, flags.ctypes.data,
                              out.ctypes.data, len(more), w.shape[1])
    assert [tsk.digest_words_to_bytes(r) for r in out] == \
        [hashlib.sha256(m).digest() for m in more]


def _host_words(lib, words, active):
    out = np.zeros((len(words), 8), np.uint32)
    flags = np.ascontiguousarray(active.astype(np.uint8))
    words = np.ascontiguousarray(words)
    lib.sha256_rows_host(words.ctypes.data, flags.ctypes.data,
                         out.ctypes.data, len(words), words.shape[1])
    return out


def test_cuda_compression_on_host_block_edges(host_lib):
    """Messages at every padding edge (0, 55, 56, 63, 64, 119, 120 and 503
    bytes: one to eight blocks) among random lengths, so that the rows of
    one warp's 32 have different active-block counts, then 32 rows with no
    active block: hashlib's digests, H0, and the plain version's words on
    every row."""
    rng = np.random.default_rng(96)
    lens = [0, 1, 55, 56, 63, 64, 65, 119, 120, 503]
    lens += [int(n) for n in rng.integers(0, 504, 54)]
    msgs = [rng.bytes(n) for n in lens]
    w, a, fits = tsk.pack_messages(msgs, tbh.MAX_BLOCKS)
    assert fits.all()
    w = np.concatenate([w, np.zeros((32, tbh.MAX_BLOCKS, 16), np.uint32)])
    a = np.concatenate([a, np.zeros((32, tbh.MAX_BLOCKS), bool)])
    assert len(set(a[:32].sum(1))) > 4
    out = _host_words(host_lib, w, a)
    assert [tsk.digest_words_to_bytes(r) for r in out[:64]] == \
        [hashlib.sha256(m).digest() for m in msgs]
    np.testing.assert_array_equal(
        out[64:], np.tile(np.array(tsk.H0, np.uint32), (32, 1)))
    np.testing.assert_array_equal(
        out, tsk.sha256_kernel_plain(torch.from_numpy(w),
                                     torch.from_numpy(a)).numpy())


def test_sha_bound_counts_the_standards_operations():
    """chip_smoke.py's K3 bound: 1,384 32-bit operations a block from FIPS
    180-4 (64 rounds of 14, 48 schedule words of 10, 8 feed-forward adds),
    whatever kernel is built."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SHA_ROUND_OPS == 14 and smoke.SHA_SCHEDULE_OPS == 10
    assert smoke.sha_ops_per_block() == 64 * 14 + 48 * 10 + 8 == 1384


def test_batch_hasher_on_cpu_equals_hashlib():
    """Edge corpus, random rows, oversize rows (hashed on the host) and a
    batch that chunks and pads (bucket 16)."""
    rng = np.random.default_rng(94)
    msgs = edge_corpus() + [rng.bytes(n) for n in (504, 640, 2000)]
    msgs += [rng.bytes(int(rng.integers(0, 504))) for _ in range(9)]
    assert len(msgs) % 16 != 0 and len(msgs) > 16
    h = BatchHasher(device="cpu", bucket_sizes=(16,))
    got = h.hash_batch(msgs)
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    np.testing.assert_array_equal(h.hash_words(msgs),
                                  tsk.host_digest_words(msgs))
    assert h.served["host"] == 2 * 3
    assert h.served["device"] == 2 * len(msgs)
    assert h.hash_batch([]) == []
    # a chunk of only oversize rows skips the device
    assert h.hash_batch([bytes(600)]) == [hashlib.sha256(bytes(600)).digest()]
    assert h.served["device"] == 2 * len(msgs)
    assert BatchHasher(device="cpu")._buckets == \
        tbh.DEFAULT_HASH_BUCKET_SIZES == jbh.DEFAULT_HASH_BUCKET_SIZES
    assert (tbh.MAX_BLOCKS, tbh.MIN_DEVICE_HASH_BATCH) == \
        (jbh.MAX_BLOCKS, jbh.MIN_DEVICE_HASH_BATCH)


def test_hash_many_policy(monkeypatch):
    """Below MIN_DEVICE_HASH_BATCH hashlib serves and the engine is not
    touched; at or above it the card serves, and with no card the call
    raises instead of hashing on the host."""
    rng = np.random.default_rng(95)
    blobs = [rng.bytes(int(n)) for n in rng.integers(0, 700, 40)]
    want = [hashlib.sha256(b).digest() for b in blobs]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = blobs[:tbh.MIN_DEVICE_HASH_BATCH - 1]
    assert hash_many(small) == want[:len(small)]
    assert hash_many([]) == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hash_many(blobs[:tbh.MIN_DEVICE_HASH_BATCH])
    hasher = tbh.default_hasher("cpu")
    assert hasher is tbh.default_hasher(torch.device("cpu"))
    before = hasher.served["device"]
    assert hash_many(blobs, device="cpu") == want
    assert hasher.served["device"] - before == len(blobs)
