"""K4 and the multi-device path on the CPU: the port's
``verify_kernel_sharded(["cpu"] * 4)`` against the JAX package's
``verify_kernel_sharded(batch_mesh(4))`` (conftest forces 8 virtual CPU
devices) at B = 16, bit for bit; the split ``BatchVerifier`` and
``BatchHasher`` against the single-device port and the oracle; and the
default entry points' choice of devices; and the source line that
``chip_smoke.py`` names for K4. Integer results: tolerance zero."""

import hashlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_tpu.ops import verify as jvk
from stellar_tpu.parallel import mesh as jmesh
from stellar_tpu_torch.crypto import batch_hasher as bh
from stellar_tpu_torch.crypto import batch_verifier as bv
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import (BatchVerifier,
                                                     Ed25519Workload)
from stellar_tpu_torch.ops import verify as tvk
from stellar_tpu_torch.parallel import mesh, signer_tables

B = 16
N_DEV = 4


def _rows(seed=81):
    """Good signatures, matching rows, edge-corpus rows, random bytes."""
    rng = np.random.default_rng(seed)
    _, good = Ed25519Workload().encode(vectors.valid_items(rng, 4))
    match = vectors.matching_rows(rng, 4)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng)[2::4])
    rand = vectors.random_rows(rng, 4)
    return tuple(np.ascontiguousarray(np.concatenate(
        [good[k], match[k], edge[k][:4], rand[k]])) for k in range(4))


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def jax_sharded(rows):
    fn = jvk.verify_kernel_sharded(jmesh.batch_mesh(N_DEV))
    return np.asarray(fn(*(jnp.asarray(x) for x in rows)))


def _t(rows):
    return tuple(torch.from_numpy(x) for x in rows)


def test_sharded_matches_jax(rows, jax_sharded):
    launches = tvk.verify_kernel_sharded.launches
    got = tvk.verify_kernel_sharded(["cpu"] * N_DEV)(*_t(rows))
    assert got.dtype == torch.bool and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), jax_sharded)
    # good and matching rows True, random bytes False
    assert got[:8].all() and not got[12:].any()
    # CPU shards run the plain version: no launch is counted
    assert tvk.verify_kernel_sharded.launches == launches


def test_sharded_equals_unsharded(rows):
    two = tvk.verify_kernel_sharded(["cpu", "cpu"])(*_t(rows))
    np.testing.assert_array_equal(
        two.numpy(), tvk.verify_kernel_plain(*_t(rows)).numpy())


def test_sharded_checks_its_arguments(rows):
    with pytest.raises(ValueError, match="divide"):
        tvk.verify_kernel_sharded(["cpu"] * 3)(*_t(rows))
    with pytest.raises(ValueError):
        tvk.verify_kernel_sharded([])
    with pytest.raises(ValueError):
        tvk.verify_kernel_sharded(["cpu", "meta"])
    bad = _t(rows)[:3] + (torch.zeros((B, 31), dtype=torch.uint8),)
    with pytest.raises(ValueError):
        tvk.verify_kernel_sharded(["cpu"] * 2)(*bad)


def test_split_verifier_equals_single_device_and_oracle():
    """30 items (good, corrupted, edge) in one 32-row bucket: 4 parts of
    8, every index serves, verdicts equal the single-device verifier's
    and the oracle's; then with the signer-table cache on, the hot rows
    ride the split too."""
    rng = np.random.default_rng(82)
    items = vectors.valid_items(rng, 14) + vectors.edge_corpus(rng)[:16]
    items[3] = (items[3][0], items[3][1] + b"!", items[3][2])
    want = np.array([ref.verify(*it) for it in items])
    cache = signer_tables.signer_table_cache
    try:
        cache.configure(enabled=False)
        single = BatchVerifier(device="cpu", bucket_sizes=(32,))
        split = BatchVerifier(devices=["cpu"] * N_DEV, bucket_sizes=(32,))
        assert split.devices is not None and len(split.devices) == N_DEV
        got_single = single.verify_batch(items)
        got = split.verify_batch(items)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_single, want)
        assert sorted(split.device_served) == [0, 1, 2, 3]
        assert sum(split.device_served.values()) == len(items)
        assert split.served["device"] == len(items)
        assert single.device_served == {}
        cache._reset_for_testing()
        cache.configure(enabled=True)
        split.verify_batch(items)  # first sights: cold, tables installed
        hot = split.served["hot"]
        np.testing.assert_array_equal(split.verify_batch(items), want)
        cacheable = sum(ref.point_decompress(pk) is not None
                        for pk, _m, _s in items)
        assert split.served["hot"] - hot == cacheable == 28
        assert split.health.quarantined(N_DEV) == [] and not split.convicted
    finally:
        cache._reset_for_testing()


def test_split_hasher_equals_hashlib():
    msgs = [bytes([i]) * (17 * i) for i in range(30)] + [b"x" * 600]
    h = bh.BatchHasher(devices=["cpu"] * N_DEV, bucket_sizes=(32,))
    assert h.hash_batch(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert sorted(h.device_served) == [0, 1, 2, 3]
    assert h.served["host"] == 1 and h.served["device"] == len(msgs)


def test_auto_devices_spans_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((0, None), (1, None), (2, 2), (8, 8)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        got = mesh.auto_devices()
        assert (got is None) if want is None else len(got) == want
        assert mesh.device_count() == count
    assert mesh.batch_devices(3) == [torch.device("cuda", i)
                                     for i in range(3)]
    with pytest.raises(RuntimeError):
        mesh.batch_devices(9)


@pytest.mark.parametrize("module, default", [
    (bv, bv.default_verifier), (bh, bh.default_hasher)])
def test_default_entry_points_follow_auto_devices(monkeypatch, module,
                                                  default):
    """Several cards: one engine split over all of them; one card (auto
    gives None): that card unsplit; no card: raises."""
    monkeypatch.setattr(module, "_defaults", {})
    monkeypatch.setattr(mesh, "auto_devices", lambda: ["cpu"] * 3)
    eng = default()
    assert eng.devices == [torch.device("cpu")] * 3
    assert default() is eng
    monkeypatch.setattr(mesh, "auto_devices", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        default()
    # one card: resolve_device(None) names it, and the engine is unsplit
    monkeypatch.setattr(module, "resolve_device",
                        lambda d: torch.device("cpu"))
    one = default()
    assert one.devices is None and one.device == torch.device("cpu")


def test_k4_source_line_points_at_the_function():
    """The kernels line's K4 source is derived from the function, so it
    names the line of ``def verify_kernel_sharded`` in the port."""
    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    path, line = smoke.source_line(tvk.verify_kernel_sharded).split(":")
    assert path == "stellar_tpu_torch/ops/verify.py"
    with open(os.path.join(root, path)) as f:
        assert f.read().splitlines()[int(line) - 1].startswith(
            "def verify_kernel_sharded(")
