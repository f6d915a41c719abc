"""The port's overlay (``stellar_tpu_torch.overlay``: ``peer``,
``overlay_manager``, ``peer_manager``, ``tx_adverts``, ``survey_manager``,
``loopback``) and its X25519 and sealed boxes (``crypto.curve25519``,
``crypto.nacl_box``) against the reference's.

The copies are held to the reference's source (``_torch_port.check_copy``).
The port's pure-Python X25519 ladder, which is what runs where
``cryptography`` is missing (the card's machine), equals OpenSSL's and the
reference's on seeded scalars and points, and refuses the same small-order
points; HKDF and the per-direction channel keys are equal, and a sealed box
made by one package opens in the other. A payment injected at one node of
the port's ``core4`` floods by advert and demand with the reference's
message counts (three bodies for four nodes) and balances, and so do
payments a peer relays to a node as TRANSACTION messages, with the
nodes' worker pools inline as in ``chip_smoke.py``'s flood. The three verify
call sites ride the port's ``VerifyService`` lanes (peer auth certs on
``auth``, the flood's pre-verify on ``bulk``, SCP envelopes on ``scp``)
over a host stub verifier, and fall back to the direct path without a
service. ``chip_smoke.py``'s flood pins are checked by a ``slow`` test.

Both packages verify through their pure-Python oracles unless a case
installs a service. No JAX program is compiled.
"""

import copy
import importlib

import numpy as np
import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.herder import herder as pherder

from tests._torch_node import Side, apps, authenticated, closes
from tests._torch_port import chip_smoke_constants, check_copy

PORT, REF = Side("stellar_tpu_torch"), Side("stellar_tpu")

MODULES = ["overlay/__init__.py", "overlay/peer_manager.py",
           "overlay/tx_adverts.py", "overlay/survey_manager.py",
           "overlay/peer.py", "overlay/overlay_manager.py",
           "overlay/loopback.py", "crypto/curve25519.py",
           "crypto/nacl_box.py"]


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


_REAL_HASH_MANY = pbh.hash_many


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    """Both packages verify with their oracles and flush their caches
    around each case; the port hashes on the CPU."""
    saved = (REF.keys._backend, PORT.keys._backend)
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    for side in (PORT, REF):
        side.keys.flush_verify_cache()
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    REF.keys.set_verifier_backend(saved[0])
    PORT.keys.set_verifier_backend(saved[1])
    for side in (PORT, REF):
        side.keys.flush_verify_cache()


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


# ---------------- X25519, HKDF, sealed boxes ----------------

def _c25519(side):
    return importlib.import_module(f"{side.package}.crypto.curve25519")


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return ValueError


def test_x25519_ladder_equals_openssl_and_reference(monkeypatch):
    """The port's ladder (``scalarmult`` with ``cryptography`` hidden, as
    on the card's machine) against OpenSSL's X25519 and the reference's,
    on seeded scalars over base-derived points and over arbitrary 32-byte
    points (result or refusal); the small-order points 0 and 1 are
    refused by every path."""
    pc, rc = _c25519(PORT), _c25519(REF)
    assert pc._OsslX25519Priv is not None      # OpenSSL in this sandbox
    rng = np.random.default_rng(25519)
    pairs = []
    for i in range(24):
        s = rng.bytes(32)
        p = rc.scalarmult_base(rng.bytes(32)) if i % 2 else rng.bytes(32)
        pairs.append((s, p))
    openssl = [_outcome(pc.scalarmult, s, p) for s, p in pairs]
    ref = [_outcome(rc.scalarmult, s, p) for s, p in pairs]
    monkeypatch.setattr(pc, "_OsslX25519Priv", None)
    ladder = [_outcome(pc.scalarmult, s, p) for s, p in pairs]
    assert ladder == openssl == ref
    assert sum(x is ValueError for x in ladder) < len(ladder)
    s = rng.bytes(32)
    assert pc.public_from_secret(s) == rc.public_from_secret(s)
    for bad in (bytes(32), (1).to_bytes(32, "little")):
        for fn in (pc.scalarmult, pc._scalarmult_ladder):
            with pytest.raises(ValueError):
                fn(s, bad)


def test_hkdf_and_channel_keys_equal_reference():
    """HKDF extract and expand, and ``PeerAuth.shared_keys`` for both
    ends of a channel from the same ECDH secrets and nonces: the port's
    keys equal the reference's, and each end's sending key is the other's
    receiving key."""
    pc, rc = _c25519(PORT), _c25519(REF)
    rng = np.random.default_rng(8)
    ikm, info = rng.bytes(96), rng.bytes(65)
    assert pc.hkdf_extract(ikm) == rc.hkdf_extract(ikm)
    prk = pc.hkdf_extract(ikm)
    assert pc.hkdf_expand(prk, info) == rc.hkdf_expand(prk, info)
    secrets = [rng.bytes(32), rng.bytes(32)]
    nonces = [rng.bytes(32), rng.bytes(32)]
    got = {}
    for side in (PORT, REF):
        auths = []
        for i, sec in enumerate(secrets):
            a = side.peer.PeerAuth(side.keys.SecretKey.from_seed_str(
                f"chan-{i}"), b"\x05" * 32, now=1000)
            a.ecdh_secret = sec
            a.ecdh_public = _c25519(side).public_from_secret(sec)
            auths.append(a)
        a, b = auths
        ka = a.shared_keys(b.ecdh_public, nonces[0], nonces[1], True)
        kb = b.shared_keys(a.ecdh_public, nonces[1], nonces[0], False)
        assert ka[0] == kb[1] and ka[1] == kb[0]
        got[side.package] = (ka, kb)
    assert got["stellar_tpu_torch"] == got["stellar_tpu"]


def test_sealed_box_crosses_packages(monkeypatch):
    """A sealed box made by either package opens in the other, through
    its bytes, with the port on its pure-Python ladder; a flipped byte
    is refused by both."""
    boxes = {s.package: importlib.import_module(
        f"{s.package}.crypto.nacl_box") for s in (PORT, REF)}
    monkeypatch.setattr(_c25519(PORT), "_OsslX25519Priv", None)
    rng = np.random.default_rng(3)
    sk = rng.bytes(32)
    pk = _c25519(REF).public_from_secret(sk)
    msg = rng.bytes(200)
    for maker, opener in (("stellar_tpu_torch", "stellar_tpu"),
                          ("stellar_tpu", "stellar_tpu_torch")):
        sealed = boxes[maker].seal(msg, pk)
        assert boxes[opener].seal_open(sealed, sk, pk) == msg
        bad = bytearray(sealed)
        bad[60] ^= 1
        for box in boxes.values():
            with pytest.raises(box.BoxError):
                box.seal_open(bytes(bad), sk, pk)


# ---------------- the flood over loopback ----------------

def _flood_one(side):
    """core4 over two funded accounts; one payment injected at node 0
    once every node is authenticated, cranked until it has applied on
    every node and three ledgers have closed."""
    sim = side.network(4, accounts=side.flood_accounts(1))
    sim.start_all_nodes()
    assert authenticated(sim)
    counts = side.count_flood_messages(sim)
    a0 = apps(sim)[0]
    frame = side.flood_frames(sim, 0, 1)[0]
    assert a0.herder.recv_transaction(frame).code == 0
    target = a0.lm.ledger_seq + 3
    assert sim.crank_until_ledger(target, timeout=300)
    assert sim.in_consensus()
    want = vectors.FLOOD_BALANCE + vectors.FLOOD_AMOUNT
    return ({int(k): v for k, v in counts.items()},
            [side.balance(a) for a in apps(sim)] == [want] * 4,
            [side.balance(a, "flood-src-0") for a in apps(sim)],
            {seq: closes(sim, seq) for seq in range(3, target + 1)})


@pytest.fixture
def inline_workers():
    """Both packages' worker pools run their work inline for the case
    (``workers.set_background(False)``): the flood's pre-verify then
    finishes before the next crank, so which peer a node demands a body
    from does not depend on thread timing."""
    mods = [importlib.import_module(f"{s.package}.utils.workers")
            for s in (PORT, REF)]
    for m in mods:
        m.set_background(False)
    yield
    for m in mods:
        m.set_background(True)


def test_flood_of_one_payment_equals_reference(inline_workers):
    """The pull-mode flood: the same FLOOD_ADVERT, FLOOD_DEMAND and
    TRANSACTION counts (each node receives the body once: three for four
    nodes), the same balances and the same ledgers."""
    port, ref = _flood_one(PORT), _flood_one(REF)
    assert port == ref
    counts = port[0]
    assert counts[int(PORT.xov.MessageType.TRANSACTION)] == 3
    assert counts[int(PORT.xov.MessageType.FLOOD_ADVERT)] >= 3
    assert counts[int(PORT.xov.MessageType.FLOOD_DEMAND)] >= 3
    assert port[1]


def _flood(side, sources, per, via="relay", **knobs):
    """core4 over ``sources`` funded sources with the worker pool inline
    (``BACKGROUND_BUCKET_MERGES`` off): before each ledger ``per``
    payments, relayed by node 1 to node 0 as TRANSACTION messages
    (``via`` "relay", as ``chip_smoke.py``'s flood) or given to node 0's
    ``recv_transaction`` ("herder"); then cranked while any is left. The
    payments applied on each node, the FLOOD_ADVERT, FLOOD_DEMAND and
    TRANSACTION messages sent, the TRANSACTION messages received, the
    last ledger and every ledger's header hashes from ledger 3."""
    sim = side.network(4, accounts=side.flood_accounts(sources),
                       BACKGROUND_BUCKET_MERGES=False, **knobs)
    sim.start_all_nodes()
    assert authenticated(sim)
    sent = side.count_flood_messages(sim)
    received = side.count_received(sim)
    a0 = apps(sim)[0]
    for first in range(0, sources, per):
        seq = a0.lm.ledger_seq
        frames = side.flood_frames(sim, first, per)
        if via == "relay":
            side.relay(sim, frames)
        else:
            assert all(a0.herder.recv_transaction(f).code == 0
                       for f in frames)
        assert sim.crank_until_ledger(seq + 1, timeout=300)
    want = vectors.FLOOD_BALANCE + sources * vectors.FLOOD_AMOUNT
    sim.crank_until(
        lambda: all(side.balance(a) == want for a in apps(sim)), 120)
    applied = [(side.balance(a) - vectors.FLOOD_BALANCE) //
               vectors.FLOOD_AMOUNT for a in apps(sim)]
    last = min(a.lm.ledger_seq for a in apps(sim))
    return (applied, {int(k): v for k, v in sent.items()}, received[0],
            last, {seq: closes(sim, seq) for seq in range(3, last + 1)})


def test_relayed_flood_equals_reference(inline_workers):
    """Payments a peer relays to node 0 (``chip_smoke.py``'s flood at a
    small size): the same messages, the same ledgers, every payment
    applied; each body reaches each node once, the relayed ones too."""
    port, ref = (_flood(side, 12, 6) for side in (PORT, REF))
    assert port == ref
    applied, sent, received, _last, hashes = port
    assert applied == [12] * 4
    assert sent[int(PORT.xov.MessageType.TRANSACTION)] == received == 12 * 4
    assert all(len(h) == 1 for h in hashes.values())


@pytest.mark.slow
@pytest.mark.parametrize("via", ["relay", "herder"])
def test_flood_of_200_a_ledger_drops_bodies(inline_workers, via):
    """The flood at 200 payments a ledger over 5 ledgers, where
    ``chip_smoke.py`` sends 100 over 10: in both packages some payments
    never apply, because a node sends more flood messages to a peer than
    the peer's credit allows (``PEER_FLOOD_READING_CAPACITY``, 200) and
    ``Peer.send`` drops the rest; what never arrives is demanded once and
    ages out of node 0's queue. Both packages apply and drop the same."""
    port, ref = (_flood(side, 1000, 200, via, MAX_TX_SET_SIZE=1000)
                 for side in (PORT, REF))
    applied, sent, received = ref[:3]
    tx = sent[int(REF.xov.MessageType.TRANSACTION)]
    print(f"via {via}: applied {applied}, TRANSACTION sent {tx}, "
          f"received {received}")
    assert port == ref
    assert len(set(applied)) == 1 and applied[0] < 1000
    assert tx > received


@pytest.mark.slow
def test_flood_pin_is_the_reference(inline_workers):
    """``chip_smoke.py``'s flood pins are the reference's run of the same
    shape: ``FLOOD_SOURCES`` funded sources over core4 with
    ``MAX_TX_SET_SIZE`` ``FLOOD_MAX_TX_SET_SIZE`` and the worker pool
    inline, ``FLOOD_PER_LEDGER`` payments relayed to node 0 before each
    ledger: every payment has applied on every node at
    ``FLOOD_LAST_LEDGER``, whose hash is ``FLOOD_LEDGER_HASH``, and the
    destination holds ``FLOOD_DEST_BALANCE``."""
    const = chip_smoke_constants()
    assert const["FLOOD_VALIDATORS"] == 4
    n = const["FLOOD_SOURCES"]
    assert const["FLOOD_DEST_BALANCE"] == \
        vectors.FLOOD_BALANCE + n * vectors.FLOOD_AMOUNT
    applied, _sent, _received, last, hashes = _flood(
        REF, n, const["FLOOD_PER_LEDGER"],
        MAX_TX_SET_SIZE=const["FLOOD_MAX_TX_SET_SIZE"])
    assert applied == [n] * 4
    assert last == const["FLOOD_LAST_LEDGER"]
    assert hashes[last] == {const["FLOOD_LEDGER_HASH"]}


# ---------------- the verify lanes ----------------

class _LaneOracle:
    """A service transport stub: the port's oracle decides, the lane
    accounting is the real ``VerifyService``'s around it."""

    def __init__(self):
        self.rows = 0

    def submit(self, items, trace_ids=None):
        res = np.array([PORT.ref.verify(*it) for it in items], dtype=bool)
        self.rows += len(items)
        return lambda: res


@pytest.fixture
def lane_service(monkeypatch):
    """A started port ``VerifyService`` over the stub as the
    process-wide service, stopped and removed after the case."""
    vs = PORT.vs
    oracle = _LaneOracle()
    svc = vs.VerifyService(verifier=oracle).start()
    monkeypatch.setattr(vs, "_service", svc)
    PORT.keys.flush_verify_cache()
    yield svc, oracle
    svc.stop(drain=False)
    monkeypatch.setattr(vs, "_service", None)


def _signed(n, tag):
    ref = PORT.ref
    out = []
    for i in range(n):
        seed = bytes([(23 * (i + 1) + tag) % 251]) * 32
        msg = b"lane-%d-%d" % (tag, i)
        out.append((ref.secret_to_public(seed), msg, ref.sign(seed, msg)))
    return out


def test_peer_auth_rides_the_auth_lane(lane_service):
    """``verify_remote_cert`` asks the cache, then the ``auth`` lane; the
    verdict seeds the cache; a tampered cert is refused on the lane; an
    expired one before any signature work; without a service the direct
    path decides the same."""
    svc, oracle = lane_service
    node = PORT.keys.SecretKey.from_seed_str("auth-lane-node")
    auth = PORT.peer.PeerAuth(node, b"\x07" * 32, now=1000)
    nid = node.public_key.raw
    assert auth.verify_remote_cert(auth.cert, nid, now=1000)
    assert oracle.rows == 1
    lane = svc.snapshot()["lanes"]["auth"]
    assert (lane["submitted"], lane["verified"]) == (1, 1)
    assert auth.verify_remote_cert(auth.cert, nid, now=1000)
    assert oracle.rows == 1
    bad = copy.copy(auth.cert)
    bad.sig = bytes(64)
    assert not auth.verify_remote_cert(bad, nid, now=1000)
    assert oracle.rows == 2
    assert not auth.verify_remote_cert(auth.cert, nid, now=10**9)
    svc.stop(drain=False)
    PORT.keys.flush_verify_cache()
    assert auth.verify_remote_cert(auth.cert, nid, now=1000)
    assert oracle.rows == 2


def test_tx_preverify_rides_the_bulk_lane(lane_service):
    """The flood's pre-verify (``_preverify_into_cache``) rides the
    ``bulk`` lane, its verdicts seed the cache, a repeat submits nothing;
    without a service the direct batch path decides the same."""
    svc, oracle = lane_service
    items = _signed(3, tag=1)
    PORT.om._preverify_into_cache(items)
    lane = svc.snapshot()["lanes"]["bulk"]
    assert (lane["submitted"], lane["verified"]) == (3, 3)
    assert all(PORT.keys.cached_verify_sig(*it) is True for it in items)
    PORT.om._preverify_into_cache(items)
    assert svc.snapshot()["lanes"]["bulk"]["submitted"] == 3
    svc.stop(drain=False)
    PORT.keys.flush_verify_cache()
    PORT.om._preverify_into_cache(items)
    assert all(PORT.keys.cached_verify_sig(*it) is True for it in items)


def test_scp_envelope_rides_the_scp_lane(lane_service):
    """A node's ``verify_envelope`` sends another validator's envelope to
    the ``scp`` lane; one with a flipped signature byte is refused there
    and ``recv_scp_envelope`` answers INVALID; both verdicts are the
    oracle's."""
    svc, oracle = lane_service
    sim = PORT.network(2, threshold=2)
    a0, a1 = apps(sim)
    st = PORT.xscp.SCPStatement(
        nodeID=PORT.quorum.make_node_id(
            a1.config.NODE_SEED.public_key.raw),
        slotIndex=2,
        pledges=PORT.xscp.SCPStatementPledges.make(
            PORT.xscp.SCPStatementType.SCP_ST_NOMINATE,
            PORT.xscp.SCPNomination(
                quorumSetHash=b"\x01" * 32, votes=[b"v"], accepted=[])))
    payload = pherder.scp_envelope_sign_payload(
        a1.config.network_id(), st)
    sig = a1.config.NODE_SEED.sign(payload)
    good = PORT.xscp.SCPEnvelope(statement=st, signature=sig)
    assert a0.herder.verify_envelope(good)
    flipped = bytes([sig[0] ^ 1]) + sig[1:]
    bad = PORT.xscp.SCPEnvelope(statement=st, signature=flipped)
    assert a0.herder.recv_scp_envelope(bad) == 0     # EnvelopeState.INVALID
    lane = svc.snapshot()["lanes"]["scp"]
    assert (lane["submitted"], lane["verified"]) == (2, 2)
    assert oracle.rows == 2
    pk = a1.config.NODE_SEED.public_key.raw
    assert PORT.ref.verify(pk, payload, sig)
    assert not PORT.ref.verify(pk, payload, flipped)
