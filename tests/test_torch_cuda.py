"""K1, K2, K3 and K5 on the card: each hand-written CUDA kernel against
its plain PyTorch version on the same CUDA tensors, bit for bit and word
for word (integer arithmetic, tolerance zero), all four also at ragged
sizes (K3 at 16,384 rows too), K1 and K2 at each block size they take; K4 over the one card named
four times against K1; the batch verifier's (unsplit and split) and
hasher's main paths through the kernels; and a three-replica fleet over
one card's verifier behind the wire ingress on loopback.

Every test needs a CUDA card and skips inside the test when there is
none; on the card run ``python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import hashlib

import numpy as np
import pytest
import torch

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_hasher import BatchHasher
from stellar_tpu_torch.crypto import batch_verifier as bv
from stellar_tpu_torch.crypto.batch_verifier import (BatchVerifier,
                                                     Ed25519Workload)
from stellar_tpu_torch.ops import _build
from stellar_tpu_torch.ops import sha256 as tsk
from stellar_tpu_torch.ops import verify as tvk
from stellar_tpu_torch.parallel import mesh
from stellar_tpu_torch.parallel import signer_tables as st
from stellar_tpu_torch.utils import faults

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda:0")


def _rows(rng, n):
    """n rows: the encoded edge corpus, good signatures repeated, rows
    whose bit is True for arbitrary 256-bit scalars, random bytes."""
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    _, good = Ed25519Workload().encode(vectors.valid_items(rng, 32))
    match = vectors.matching_rows(rng, 16)
    parts = [edge, good, match]
    have = sum(len(p[0]) for p in parts)
    reps = max(0, (n // 2 - have) // 32)
    parts.append(tuple(np.tile(g, (reps, 1)) for g in good))
    have += 32 * reps
    parts.append(vectors.random_rows(rng, max(0, n - have)))
    return tuple(np.ascontiguousarray(np.concatenate([p[k] for p in parts])
                                      [:n]) for k in range(4))


def _kernel_vs_plain(rows, dev):
    ops = tuple(torch.from_numpy(x).to(dev) for x in rows)
    before = tvk.verify_kernel.launches
    got = tvk.verify_kernel(*ops)
    torch.cuda.synchronize(dev)
    assert tvk.verify_kernel.launches == before + 1
    want = tvk.verify_kernel_plain(*ops)
    assert got.dtype == torch.bool and got.shape == (len(rows[0]),)
    assert torch.equal(got, want), torch.nonzero(got != want).flatten()
    return got.cpu().numpy()


def test_kernel_matches_plain_on_edge_corpus(card):
    rng = np.random.default_rng(61)
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    match = vectors.matching_rows(rng, 8)
    rows = tuple(np.ascontiguousarray(np.concatenate([edge[k], match[k]]))
                 for k in range(4))
    got = _kernel_vs_plain(rows, card)
    assert got[0] and got[-8:].all()


@pytest.mark.parametrize("batch", [128, 2048, 4096])
def test_kernel_matches_plain_at_bucket(card, batch):
    got = _kernel_vs_plain(_rows(np.random.default_rng(62), batch), card)
    assert got.any() and not got.all()


@pytest.mark.parametrize("batch", [1, 5, 127, 129, 2047])
def test_kernel_matches_plain_at_ragged_size(card, batch):
    """K1 runs four threads a row: rows past n inside a group and partial
    warps still join every shuffle and store nothing."""
    got = _kernel_vs_plain(_rows(np.random.default_rng(71), batch), card)
    assert got[0]  # the edge corpus's first item is a good signature


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_kernel_matches_plain_at_each_block_size(card, threads):
    ops = tuple(torch.from_numpy(x).to(card)
                for x in _rows(np.random.default_rng(72), 129))
    got = torch.empty((129,), dtype=torch.bool, device=card)
    _build.launch("verify_cold", ops, got, 129, threads)
    assert torch.equal(got, tvk.verify_kernel_plain(*ops))
    with pytest.raises(RuntimeError):
        _build.launch("verify_cold", ops, got, 129, 48)


def test_kernel_rejects_bad_operands(card):
    ok = torch.zeros((4, 32), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        tvk.verify_kernel(ok, ok, ok, ok.to(torch.int32))
    with pytest.raises(ValueError):
        tvk.verify_kernel(ok, ok, ok, ok.cpu())
    assert "registers" in _build.build_log(_build.library_path("verify_cold"))


def test_batch_verifier_main_path_on_card(card):
    rng = np.random.default_rng(63)
    items = vectors.valid_items(rng, 40) + vectors.edge_corpus(rng)
    st.signer_table_cache.configure(enabled=False)
    try:
        v = BatchVerifier(bucket_sizes=(16, 128))
        before = tvk.verify_kernel.launches
        got = v.verify_batch(items)
    finally:
        st.signer_table_cache._reset_for_testing()
    assert tvk.verify_kernel.launches > before
    assert got.tolist() == [ref.verify(*it) for it in items]
    assert v.served["device"] == len(items)


def _hot_rows(rng, n):
    """n hot rows: 24 matching rows (top digits saturating), then their
    tables again under random R, s and h."""
    match = vectors.hot_matching_rows(rng, 24)
    parts = [match]
    have = 24
    while have < n:
        k = min(24, n - have)
        rand = vectors.random_rows(rng, k)
        parts.append((match[0][:k],) + rand[1:])
        have += k
    return tuple(np.ascontiguousarray(np.concatenate([p[k] for p in parts])
                                      [:n]) for k in range(4))


def _hot_kernel_vs_plain(rows, dev):
    ops = tuple(torch.from_numpy(x).to(dev) for x in rows)
    before = tvk.verify_kernel_hot.launches
    got = tvk.verify_kernel_hot(*ops)
    torch.cuda.synchronize(dev)
    assert tvk.verify_kernel_hot.launches == before + 1
    want = tvk.verify_kernel_hot_plain(*ops)
    assert got.dtype == torch.bool and got.shape == (len(rows[0]),)
    assert torch.equal(got, want), torch.nonzero(got != want).flatten()
    return got.cpu().numpy()


@pytest.mark.parametrize("batch", [128, 2048])
def test_hot_kernel_matches_plain_at_bucket(card, batch):
    got = _hot_kernel_vs_plain(_hot_rows(np.random.default_rng(64), batch),
                               card)
    assert got[:24].all() and not got[24:].all()
    assert "registers" in _build.build_log(_build.library_path("verify_hot"))


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_hot_kernel_matches_plain_at_each_block_size(card, threads):
    ops = tuple(torch.from_numpy(x).to(card)
                for x in _hot_rows(np.random.default_rng(67), 129))
    got = torch.empty((129,), dtype=torch.bool, device=card)
    _build.launch("verify_hot", ops, got, 129, threads)
    assert torch.equal(got, tvk.verify_kernel_hot_plain(*ops))
    with pytest.raises(RuntimeError):
        _build.launch("verify_hot", ops, got, 129, 48)


@pytest.mark.parametrize("batch", [1, 5, 127, 129, 2047])
def test_hot_kernel_matches_plain_at_ragged_size(card, batch):
    """K2 runs four threads a row: rows past n inside a group and partial
    warps still join every shuffle and store nothing."""
    got = _hot_kernel_vs_plain(_hot_rows(np.random.default_rng(66), batch),
                               card)
    assert got[:24].all()  # the matching rows come first


def test_hot_main_path_on_card(card):
    """Repeat signers ride K2; verdicts equal the oracle."""
    rng = np.random.default_rng(65)
    items = vectors.valid_items(rng, 8) + vectors.edge_corpus(rng)
    st.signer_table_cache._reset_for_testing()
    st.signer_table_cache.configure(enabled=True)
    try:
        v = BatchVerifier(bucket_sizes=(16, 128))
        want = [ref.verify(*it) for it in items]
        assert v.verify_batch(items).tolist() == want
        before = tvk.verify_kernel_hot.launches
        assert v.verify_batch(items).tolist() == want
        assert tvk.verify_kernel_hot.launches > before
        assert v.served["hot"] > len(items) // 2
    finally:
        st.signer_table_cache._reset_for_testing()


def test_sha256_kernel_matches_plain_and_hashlib(card):
    rng = np.random.default_rng(66)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 504, 2000)]
    words, active, fits = tsk.pack_messages(msgs, 8)
    assert fits.all()
    words = np.concatenate([words, rng.integers(0, 2**32, (48, 8, 16),
                                                dtype=np.uint32)])
    active = np.concatenate([active, rng.random((48, 8)) < 0.5])
    w = torch.from_numpy(words).to(card)
    a = torch.from_numpy(active).to(card)
    before = tsk.sha256_kernel.launches
    got = tsk.sha256_kernel(w, a)
    torch.cuda.synchronize(card)
    assert tsk.sha256_kernel.launches == before + 1
    want = tsk.sha256_kernel_plain(w, a)
    assert torch.equal(got.cpu(), want.cpu())
    np.testing.assert_array_equal(got.cpu().numpy()[:2000],
                                  tsk.host_digest_words(msgs))


def _sha_rows(rng, n):
    """``n`` packed rows: messages of every length up to the capacity, the
    block edges first, with a row of no active block and a row whose
    active blocks are not a prefix every 64 rows, so that the rows of one
    warp have different active-block counts."""
    lens = [0, 55, 56, 63, 64, 119, 120, 503]
    lens += [int(k) for k in rng.integers(0, 504, max(0, n - len(lens)))]
    words, active, fits = tsk.pack_messages([rng.bytes(k) for k in lens[:n]],
                                            8)
    assert fits.all()
    active[5::64] = False
    words[7::64] = rng.integers(0, 2**32, words[7::64].shape,
                                dtype=np.uint32)
    active[7::64] = [True, False, True, True, False, False, True, False]
    return words, active


@pytest.mark.parametrize("batch", [1, 5, 127, 129, 2047, 16384])
def test_sha256_kernel_matches_plain_at_size(card, batch):
    words, active = _sha_rows(np.random.default_rng(70), batch)
    w = torch.from_numpy(words).to(card)
    a = torch.from_numpy(active).to(card)
    before = tsk.sha256_kernel.launches
    got = tsk.sha256_kernel(w, a)
    torch.cuda.synchronize(card)
    assert tsk.sha256_kernel.launches == before + 1
    want = tsk.sha256_kernel_plain(w, a)
    assert torch.equal(got.cpu(), want.cpu())
    if batch > 5:
        np.testing.assert_array_equal(got.cpu().numpy()[5],
                                      np.array(tsk.H0, np.uint32))


def test_batch_hasher_main_path_on_card(card):
    rng = np.random.default_rng(67)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 2000, 600)]
    h = BatchHasher(bucket_sizes=(128, 512))
    before = tsk.sha256_kernel.launches
    assert h.hash_batch(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert tsk.sha256_kernel.launches == before + 2
    assert h.served["host"] == sum(len(m) > 503 for m in msgs)


def _r16_rows(rng, n):
    """n rows: the encoded edge corpus, radix-16 matching rows, overflow
    rows (top digit above 8; R = 0 on even ones), then K1's rows."""
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    head = [edge, vectors.r16_matching_rows(rng, 16),
            vectors.r16_overflow_rows(rng, 16)]
    have = sum(len(p[0]) for p in head)
    tail = _rows(rng, n - have)
    return tuple(np.ascontiguousarray(np.concatenate(
        [p[k] for p in head] + [tail[k]])) for k in range(4)), len(edge[0])


@pytest.mark.parametrize("batch", [128, 2048])
def test_r16_kernel_matches_plain_at_bucket(card, batch):
    rows, n_edge = _r16_rows(np.random.default_rng(68), batch)
    ops = tuple(torch.from_numpy(x).to(card) for x in rows)
    before = tvk.verify_kernel_r16.launches
    got = tvk.verify_kernel_r16(*ops)
    torch.cuda.synchronize(card)
    assert tvk.verify_kernel_r16.launches == before + 1
    want = tvk.verify_kernel_r16_plain(*ops)
    assert torch.equal(got, want), torch.nonzero(got != want).flatten()
    head = got[n_edge:n_edge + 32].tolist()
    assert head == [True] * 16 + [True, False] * 8
    assert "registers" in _build.build_log(_build.library_path("verify_r16"))


@pytest.mark.parametrize("batch", [1, 5, 127, 129, 2047])
def test_r16_kernel_matches_plain_at_ragged_size(card, batch):
    """Rows past n inside a group of four lanes, and partial warps: the
    head of phase 11's rows (edge corpus, matching and overflow rows)."""
    rows, _ = _r16_rows(np.random.default_rng(71), 2048)
    rows = tuple(np.ascontiguousarray(x[:batch]) for x in rows)
    ops = tuple(torch.from_numpy(x).to(card) for x in rows)
    got = tvk.verify_kernel_r16(*ops)
    torch.cuda.synchronize(card)
    want = tvk.verify_kernel_r16_plain(*ops)
    assert torch.equal(got, want), torch.nonzero(got != want).flatten()


@pytest.mark.parametrize("batch", [128, 2048])
def test_sharded_over_one_card_named_four_times(card, batch):
    rows = _rows(np.random.default_rng(69), batch)
    ops = tuple(torch.from_numpy(x).to(card) for x in rows)
    before = tvk.verify_kernel_sharded.launches
    k1 = tvk.verify_kernel.launches
    got = tvk.verify_kernel_sharded([card] * 4)(*ops)
    torch.cuda.synchronize(card)
    assert tvk.verify_kernel_sharded.launches == before + 1
    assert tvk.verify_kernel.launches == k1 + 4
    assert got.device == card
    assert torch.equal(got, tvk.verify_kernel(*ops))


def test_split_verifier_main_path_on_card(card):
    """A verifier over the card named 4 times: every index serves, the
    verdicts equal the oracle, nothing fails over, the audit is clean."""
    rng = np.random.default_rng(70)
    items = vectors.valid_items(rng, 90) + vectors.edge_corpus(rng)
    items = items[:128]
    st.signer_table_cache.configure(enabled=False)
    try:
        v = BatchVerifier(devices=[card] * 4, bucket_sizes=(128,))
        got = v.verify_batch(items)
    finally:
        st.signer_table_cache._reset_for_testing()
    assert got.tolist() == [ref.verify(*it) for it in items]
    assert sorted(v.device_served) == [0, 1, 2, 3]
    assert v.served["device"] == len(items) and v.audit_mismatches == 0
    assert v.health.quarantined(4) == [] and not v.convicted


def test_card_launch_fault_raises(card):
    """A launch fault on the one card raises to the caller: the rows are
    not recomputed on the host."""
    rng = np.random.default_rng(69)
    items = vectors.valid_items(rng, 4)
    st.signer_table_cache.configure(enabled=False)
    v = BatchVerifier(device=card, bucket_sizes=(128,))
    faults.set_fault(faults.DISPATCH, "raise")
    try:
        with pytest.raises(RuntimeError, match="no device left"):
            v.verify_batch(items)
    finally:
        faults.clear()
        st.signer_table_cache._reset_for_testing()
    assert v.served["device"] == 0


def test_default_verifier_spans_every_card(card):
    v = bv.default_verifier()
    n = mesh.device_count()
    if n == 1:
        assert v.devices is None and v.device == card
    else:
        assert v.devices == mesh.batch_devices()


def test_fleet_behind_ingress_on_card(card):
    """A ``FleetRouter`` of three replicas over one card's verifier behind
    an ``IngressServer``: a TxSet of 500 signatures from 500 signers (2%
    corrupted) sent twice on loopback in frames of 100 over five tenants;
    every verdict equals the oracle, the second pass rides K2, and the
    wire's and the fleet's conservation laws read 0."""
    from stellar_tpu_torch.crypto import fleet, ingress, native_verify
    rng = np.random.default_rng(72)
    items = vectors.valid_items(rng, 500)
    for i in range(0, 500, 50):
        pk, msg, sig = items[i]
        items[i] = (pk, msg + b"!", sig)
    want = native_verify.host_verify(items)
    st.signer_table_cache._reset_for_testing()
    st.signer_table_cache.configure(enabled=True)
    v = BatchVerifier(device=card, bucket_sizes=(128, 512, 2048))
    fl = fleet.FleetRouter(verifier=v, replicas=3).start()
    srv = ingress.IngressServer(fl, "127.0.0.1", 0).start()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=120)
    hot0 = tvk.verify_kernel_hot.launches
    try:
        for _ in range(2):
            tkts = [(cli.submit(items[k:k + 100], tenant=f"t{k // 100}"), k)
                    for k in range(0, 500, 100)]
            for tkt, k in tkts:
                assert tkt.result(timeout=120).tolist() == \
                    want[k:k + 100].tolist()
    finally:
        cli.close()
        srv.stop(timeout=30)
        fl.stop(drain=True, timeout=60)
        st.signer_table_cache._reset_for_testing()
    assert tvk.verify_kernel_hot.launches > hot0
    assert srv.snapshot()["conservation_gap"] == 0
    assert fl.snapshot()["conservation_gap"] == 0
    assert not want.all() and want.sum() == 490
