"""The port's TCP transport (``stellar_tpu_torch.overlay.tcp``: ``TCPPeer``,
``PeerDoor``, ``TCPDriver``) against the reference's.

The module is the reference's with the port's imports
(``_torch_port.check_copy``). Two port validators over localhost sockets,
driven by the port's ``Simulation`` in its ``OVER_TCP`` mode, authenticate
and agree on their ledgers; and one reference validator and one port
validator, each with its own package's transport, authenticate each other
in a 2-of-2 quorum and agree on every ledger hash: the wire format, the
handshake's keys and MACs and SCP's messages are the same bytes in both.
Ports are bound at 0 and read back. Both packages verify with their
oracles; no JAX program is compiled."""

import importlib
import threading
import time

import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh

from tests._torch_node import Side
from tests._torch_port import check_copy

PORT, REF = Side("stellar_tpu_torch"), Side("stellar_tpu")

_REAL_HASH_MANY = pbh.hash_many


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
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


def test_copy_equals_reference():
    check_copy("overlay/tcp.py")


def _pair_qset(side, keys):
    return side.xscp.SCPQuorumSet(
        threshold=2,
        validators=[side.quorum.make_node_id(k.public_key.raw)
                    for k in keys],
        innerSets=[])


def _config(side, key, qset):
    cfg = side.config.Config()
    cfg.NODE_SEED = key
    cfg.QUORUM_SET = qset
    cfg.EXPECTED_LEDGER_CLOSE_TIME = 1
    cfg.QUORUM_INTERSECTION_CHECKER = False
    return cfg


def _agreed(apps):
    """Whether two nodes' last closed ledgers agree, compared through the
    header chain when one is a ledger ahead."""
    (sa, ha, pa), (sb, hb, pb) = [
        (a.lm.last_closed_header.ledgerSeq, a.lm.last_closed_hash,
         a.lm.last_closed_header.previousLedgerHash) for a in apps]
    if sa == sb:
        return ha == hb
    if sa + 1 == sb:
        return ha == pb
    if sb + 1 == sa:
        return hb == pa
    return False


def test_port_pair_over_tcp_simulation():
    """``Simulation(mode=OVER_TCP)`` of the port: two validators on
    real-time clocks, their drivers listening on ports bound at 0, one
    dial; both authenticate their one peer, close ledger 4 and agree."""
    sim = PORT.sim.Simulation(mode=PORT.sim.Simulation.OVER_TCP)
    keys = [PORT.keys.SecretKey.from_seed_str(f"tcp-port-{i}")
            for i in range(2)]
    qset = _pair_qset(PORT, keys)
    apps = [sim.add_node(k, qset, config=_config(PORT, k, qset))
            for k in keys]
    try:
        assert all(d.door.port > 0 for d in sim.drivers.values())
        sim.add_connection(keys[0].public_key.raw, keys[1].public_key.raw)
        assert sim.crank_until(lambda: all(
            a.overlay.authenticated_count() == 1 for a in apps), 20)
        sim.start_all_nodes()
        assert sim.crank_until_ledger(4, 40), \
            [a.lm.ledger_seq for a in apps]
        assert sim.crank_until(lambda: _agreed(apps), 10)
    finally:
        sim.close()


def test_reference_and_port_nodes_agree_over_tcp():
    """One reference validator and one port validator in a 2-of-2 quorum,
    each on its own package's ``TCPDriver`` and a real-time clock, each
    cranked on a thread of its own: the port dials the reference, both
    authenticate, and both close ledger 4 with the same hashes (aligned
    through ``previousLedgerHash`` while one is a ledger ahead)."""
    ka = REF.keys.SecretKey.from_seed_str("tcp-mixed-ref")
    kb = PORT.keys.SecretKey.from_seed_str("tcp-mixed-port")
    raws = [ka.public_key.raw, kb.public_key.raw]
    apps, drivers = [], []
    for side, key in ((REF, ka), (PORT, kb)):
        qset = side.xscp.SCPQuorumSet(
            threshold=2,
            validators=[side.quorum.make_node_id(r) for r in raws],
            innerSets=[])
        app_mod = importlib.import_module(
            f"{side.package}.main.application")
        tcp = importlib.import_module(f"{side.package}.overlay.tcp")
        timer = importlib.import_module(f"{side.package}.utils.timer")
        app = app_mod.Application(
            _config(side, key, qset),
            clock=timer.VirtualClock(timer.REAL_TIME))
        apps.append(app)
        drivers.append(tcp.TCPDriver(app, listen_port=0))
    drivers[1].connect("127.0.0.1", drivers[0].door.port)
    stop = threading.Event()

    def crank(app):
        while not stop.is_set():
            app.crank(block=True)
    threads = [threading.Thread(target=crank, args=(a,), daemon=True)
               for a in apps]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 20
        while time.time() < deadline and not all(
                a.overlay.authenticated_count() == 1 for a in apps):
            time.sleep(0.05)
        assert all(a.overlay.authenticated_count() == 1 for a in apps)
        assert [p.remote_node_id for a in apps
                for p in a.overlay.peers] == [raws[1], raws[0]]
        for a in apps:
            a.clock.post_to_main(a.start)
        deadline = time.time() + 40
        while time.time() < deadline and not all(
                a.lm.ledger_seq >= 4 for a in apps):
            time.sleep(0.1)
        assert all(a.lm.ledger_seq >= 4 for a in apps), \
            [a.lm.ledger_seq for a in apps]
        deadline = time.time() + 10
        while time.time() < deadline and not _agreed(apps):
            time.sleep(0.05)
        assert _agreed(apps)
    finally:
        stop.set()
        for a in apps:
            a.clock.post_to_main(lambda: None)
        for d in drivers:
            d.close()
