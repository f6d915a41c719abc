"""The networks that the node tests (``test_torch_scp.py``,
``test_torch_overlay.py``, ``test_torch_isolation.py``) build with either
package: ``Topologies.core`` through ``Simulation.add_node`` with a
``Config`` a node, the nodes' closes recorded, the statements they
exchanged digested, and the payments of a flood over loopback. Each
package signs and verifies with its own code; values cross between the
two only as bytes and hex. The port's network and digest are its own
``vectors.core_network`` and ``vectors.statement_digest``, the ones
``chip_smoke.py`` pins; the reference's are built here the same way."""

import hashlib
import importlib

from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.vectors import (FLOOD_AMOUNT, FLOOD_BALANCE,
                                              FLOOD_DESTINATION,
                                              flood_sources)

PORT_PACKAGE = "stellar_tpu_torch"


class Side:
    """One package's modules for a simulated network."""

    MODULES = {
        "sim": "simulation.simulation", "config": "main.config",
        "keys": "crypto.keys", "ref": "crypto.ed25519_ref",
        "quorum": "scp.quorum", "rt": "xdr.runtime", "xscp": "xdr.scp",
        "xt": "xdr.types", "tu": "tx.tx_test_utils", "opf": "tx.op_frame",
        "lt": "ledger.ledger_txn", "peer": "overlay.peer",
        "om": "overlay.overlay_manager", "xov": "xdr.overlay",
        "vs": "crypto.verify_service"}

    def __init__(self, package):
        self.package = package
        for attr, rel in self.MODULES.items():
            setattr(self, attr, importlib.import_module(f"{package}.{rel}"))

    def network(self, n, threshold=None, accounts=None, **knobs):
        """``Topologies.core(n)``'s nodes, keys and connections, each
        node added with a ``Config`` of its own: the knobs set and
        ``QUORUM_INTERSECTION_CHECKER`` off (``Simulation.add_node``'s
        default). Each node's closes are recorded in ``closes``."""
        if self.package == PORT_PACKAGE:
            sim = vectors.core_network(n, threshold=threshold,
                                       accounts=accounts, **knobs)
            for app in apps(sim):
                record(app)
            return sim
        sim = self.sim.Simulation()
        keys = [self.keys.SecretKey.from_seed_str(f"sim-node-{i}")
                for i in range(n)]
        qset = self.xscp.SCPQuorumSet(
            threshold=threshold if threshold is not None
            else n - (n - 1) // 3,
            validators=[self.quorum.make_node_id(k.public_key.raw)
                        for k in keys],
            innerSets=[])
        for k in keys:
            cfg = self.config.Config()
            cfg.QUORUM_INTERSECTION_CHECKER = False
            for name, value in knobs.items():
                setattr(cfg, name, value)
            record(sim.add_node(k, qset, accounts=accounts, config=cfg))
        ids = [k.public_key.raw for k in keys]
        for i in range(n):
            for j in range(i + 1, n):
                sim.add_connection(ids[i], ids[j])
        return sim

    def flood_accounts(self, sources):
        """``vectors.flood_accounts``' sources and destination, as this
        package's keys."""
        return [(self.tu.keypair(name), FLOOD_BALANCE)
                for name in flood_sources(sources) + [FLOOD_DESTINATION]]

    def flood_frames(self, sim, first, count):
        """``vectors.flood_envelopes``' payments from sources ``first`` to
        ``first + count - 1`` as frames, signed by this package for the
        network's id."""
        network_id = apps(sim)[0].config.network_id()
        tu = self.tu
        return [tu.make_tx(tu.keypair(name), (1 << 32) + 1,
                           [tu.payment_op(tu.keypair(FLOOD_DESTINATION),
                                          FLOOD_AMOUNT)],
                           network_id=network_id)
                for name in flood_sources(first + count)[first:]]

    def relay(self, sim, frames):
        """Node 1 sends each frame to node 0 as an overlay TRANSACTION
        message, as a peer relaying a flood does."""
        a0, a1 = apps(sim)[:2]
        id0 = a0.config.NODE_SEED.public_key.raw
        peer = next(p for p in a1.overlay.peers if p.remote_node_id == id0)
        for frame in frames:
            peer.send(self.xov.StellarMessage.make(
                self.xov.MessageType.TRANSACTION, frame.envelope))

    def balance(self, app, name=FLOOD_DESTINATION):
        """An account's balance in ``app``'s ledger."""
        raw = self.tu.keypair(name).public_key.raw
        entry = app.lm.root.store.get(self.lt.key_bytes(
            self.opf.account_key(self.xt.account_id(raw))))
        return entry.data.value.balance

    def statement_digest(self, sim, slot=None):
        """SHA-256 over the sorted XDR bytes of every distinct statement
        in the nodes' ``statements_history`` (of one slot, or all)."""
        if self.package == PORT_PACKAGE:
            return vectors.statement_digest(apps(sim), slot)
        blobs = set()
        for app in apps(sim):
            for index, s in app.herder.scp.known_slots.items():
                if slot is None or index == slot:
                    blobs |= {self.rt.to_bytes(self.xscp.SCPStatement, st)
                              for st, _validated in s.statements_history}
        return hashlib.sha256(b"".join(sorted(blobs))).hexdigest()

    def statements(self, sim):
        return sum(len(s.statements_history) for app in apps(sim)
                   for s in app.herder.scp.known_slots.values())

    def count_received(self, sim):
        """Count the TRANSACTION messages every node receives from now
        on (its overlay's ``recv_message`` wrapped)."""
        got = [0]
        tx = self.xov.MessageType.TRANSACTION
        for app in apps(sim):
            def counted(peer, msg, msg_bytes=None,
                        _orig=app.overlay.recv_message):
                if msg.arm == tx:
                    got[0] += 1
                return _orig(peer, msg, msg_bytes)
            app.overlay.recv_message = counted
        return got

    def count_flood_messages(self, sim):
        """Count the FLOOD_ADVERT, FLOOD_DEMAND and TRANSACTION messages
        every peer sends from now on (its ``send`` wrapped)."""
        mt = self.xov.MessageType
        counts = {mt.FLOOD_ADVERT: 0, mt.FLOOD_DEMAND: 0,
                  mt.TRANSACTION: 0}
        for app in apps(sim):
            for p in app.overlay.peers:
                def counted(msg, msg_bytes=None, _orig=p.send):
                    if msg.arm in counts:
                        counts[msg.arm] += 1
                    return _orig(msg, msg_bytes)
                p.send = counted
        return counts


def apps(sim):
    return list(sim.nodes.values())


def record(app):
    """Keep ``{ledger: header hash hex}`` of every close of ``app`` in
    ``app.closes``."""
    app.closes = {}
    close = app.lm.close_ledger

    def recorded(lcd):
        res = close(lcd)
        app.closes[lcd.ledger_seq] = res.header_hash.hex()
        return res
    app.lm.close_ledger = recorded
    return app


def authenticated(sim, timeout=60):
    n = len(sim.nodes)
    return sim.crank_until(
        lambda: all(a.overlay.authenticated_count() >= n - 1
                    for a in apps(sim)), timeout)


def closes(sim, seq):
    """Every node's header hash of ledger ``seq`` (a set)."""
    return {a.closes[seq] for a in apps(sim)}
