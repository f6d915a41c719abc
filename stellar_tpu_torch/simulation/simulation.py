"""Multi-node in-process simulation (reference
``src/simulation/Simulation.h:29-132`` + ``Topologies.cpp``): N complete
Applications in one process over loopback transports, cranked in
lockstep on one shared VIRTUAL_TIME clock — the load-bearing mechanism
that lets a consensus network be tested deterministically on one
machine."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from stellar_tpu_torch.crypto.keys import SecretKey
from stellar_tpu_torch.main.application import Application
from stellar_tpu_torch.main.config import Config
from stellar_tpu_torch.overlay.loopback import connect_loopback
from stellar_tpu_torch.scp.quorum import make_node_id
from stellar_tpu_torch.utils.timer import VIRTUAL_TIME, VirtualClock
from stellar_tpu_torch.xdr.scp import SCPQuorumSet

__all__ = ["Simulation", "Topologies"]


class Simulation:
    OVER_LOOPBACK = "loopback"
    OVER_TCP = "tcp"

    def __init__(self, mode: str = OVER_LOOPBACK,
                 network_passphrase: str = "simulation network"):
        self.mode = mode
        self.network_passphrase = network_passphrase
        # loopback: ONE shared virtual clock cranked in lockstep;
        # tcp: per-node real-time clocks + real sockets on localhost
        # (reference Simulation::OVER_TCP)
        self.clock = VirtualClock(VIRTUAL_TIME)
        self.nodes: Dict[bytes, Application] = {}
        self.drivers: Dict[bytes, object] = {}
        self.pending_connections: List = []

    # ---------------- construction ----------------

    def add_node(self, seed: SecretKey, qset: SCPQuorumSet,
                 accounts=None, config: Optional[Config] = None
                 ) -> Application:
        cfg = config if config is not None else Config()
        if config is None:
            # reference test harness parity (test.cpp:321): in-process
            # simulation nodes skip the background quorum-intersection
            # recheck unless a test opts in — 16-validator storms would
            # otherwise spend their wall time in bounded sat searches
            cfg.QUORUM_INTERSECTION_CHECKER = False
        cfg.NODE_SEED = seed
        cfg.QUORUM_SET = qset
        cfg.NETWORK_PASSPHRASE = self.network_passphrase
        root = None
        if accounts:
            from stellar_tpu_torch.tx.tx_test_utils import (
                seed_root_with_accounts,
            )
            root = seed_root_with_accounts(list(accounts))
        if self.mode == self.OVER_TCP:
            from stellar_tpu_torch.overlay.tcp import TCPDriver
            from stellar_tpu_torch.utils.timer import REAL_TIME
            app = Application(cfg, clock=VirtualClock(REAL_TIME),
                              root=root)
            self.drivers[seed.public_key.raw] = TCPDriver(
                app, listen_port=0)
        else:
            app = Application(cfg, clock=self.clock, root=root)
        self.nodes[seed.public_key.raw] = app
        return app

    def add_connection(self, node_a: bytes, node_b: bytes):
        if self.mode == self.OVER_TCP:
            return self.drivers[node_a].connect(
                "127.0.0.1", self.drivers[node_b].door.port)
        return connect_loopback(self.nodes[node_a], self.nodes[node_b])

    def start_all_nodes(self):
        for app in self.nodes.values():
            app.start()

    def close(self):
        """Tear down TCP listeners/sockets (no-op for loopback)."""
        for d in self.drivers.values():
            d.close()

    # ---------------- cranking ----------------

    def crank_all_nodes(self, n: int = 1) -> int:
        progress = 0
        if self.mode == self.OVER_TCP:
            for _ in range(n):
                for app in self.nodes.values():
                    progress += app.crank(block=False)
            return progress
        for _ in range(n):
            progress += self.clock.crank(block=True)
        return progress

    def crank_until(self, pred: Callable[[], bool],
                    timeout: float = 120.0) -> bool:
        if self.mode == self.OVER_TCP:
            import time as _time
            deadline = _time.monotonic() + timeout
            while _time.monotonic() < deadline:
                if pred():
                    return True
                worked = self.crank_all_nodes()
                if not worked:
                    _time.sleep(0.005)
            return pred()
        return self.clock.crank_until(pred, timeout)

    def crank_until_ledger(self, seq: int, timeout: float = 120.0) -> bool:
        return self.crank_until(
            lambda: all(a.lm.ledger_seq >= seq
                        for a in self.nodes.values()), timeout)

    # ---------------- convenience ----------------

    def ledger_hashes(self) -> set:
        return {a.lm.last_closed_hash for a in self.nodes.values()}

    def in_consensus(self) -> bool:
        return len(self.ledger_hashes()) == 1


class Topologies:
    """Standard test topologies (reference ``Topologies.cpp``)."""

    @staticmethod
    def core(n: int, sim: Optional[Simulation] = None, accounts=None,
             threshold: Optional[int] = None):
        """Fully connected clique of n validators sharing one qset
        (reference ``Topologies::core``)."""
        sim = sim if sim is not None else Simulation()
        keys = [SecretKey.from_seed_str(f"sim-node-{i}")
                for i in range(n)]
        qset = SCPQuorumSet(
            threshold=threshold if threshold is not None
            else n - (n - 1) // 3,
            validators=[make_node_id(k.public_key.raw) for k in keys],
            innerSets=[])
        for k in keys:
            sim.add_node(k, qset, accounts=accounts)
        ids = [k.public_key.raw for k in keys]
        for i in range(n):
            for j in range(i + 1, n):
                sim.add_connection(ids[i], ids[j])
        return sim

    @staticmethod
    def core4(sim=None, accounts=None):
        return Topologies.core(4, sim, accounts)

    @staticmethod
    def pair(sim: Optional[Simulation] = None, accounts=None):
        """Two mutually trusting validators (reference
        ``Topologies::pair``)."""
        return Topologies.core(2, sim, accounts, threshold=2)

    @staticmethod
    def branched_cycle(n: int, sim: Optional[Simulation] = None,
                       accounts=None):
        """Ring of n core validators, each with one leaf validator
        hanging off it (reference ``Topologies::branchedcycle``): the
        leaf trusts {self, core} (both required); the core nodes run
        the cycle quorum. Exercises asymmetric trust + non-clique
        connectivity."""
        sim = Topologies.cycle(n, sim, accounts)
        core_ids = list(sim.nodes)[-n:]  # the nodes cycle() just added
        for i, core_id in enumerate(core_ids):
            leaf = SecretKey.from_seed_str(f"sim-leaf-{i}")
            qset = SCPQuorumSet(
                threshold=2,
                validators=[make_node_id(leaf.public_key.raw),
                            make_node_id(core_id)],
                innerSets=[])
            sim.add_node(leaf, qset, accounts=accounts)
            sim.add_connection(leaf.public_key.raw, core_id)
        return sim

    @staticmethod
    def hierarchical_quorum(n_core: int = 4, n_branches: int = 2,
                            branch_size: int = 3,
                            sim: Optional[Simulation] = None,
                            accounts=None):
        """Tiered quorums (reference ``Topologies::hierarchicalQuorum``):
        a BFT core clique, plus branches of validators whose quorum
        requires BOTH a core majority and a branch majority."""
        sim = sim if sim is not None else Simulation()
        # the BFT core clique is exactly Topologies.core
        sim = Topologies.core(n_core, sim, accounts)
        core_ids = list(sim.nodes)[-n_core:]
        core_qset = sim.nodes[core_ids[0]].config.QUORUM_SET
        for b in range(n_branches):
            branch_keys = [
                SecretKey.from_seed_str(f"sim-hq-b{b}-{i}")
                for i in range(branch_size)]
            branch_set = SCPQuorumSet(
                threshold=branch_size // 2 + 1,
                validators=[make_node_id(k.public_key.raw)
                            for k in branch_keys],
                innerSets=[])
            qset = SCPQuorumSet(threshold=2, validators=[],
                                innerSets=[core_qset, branch_set])
            for k in branch_keys:
                sim.add_node(k, qset, accounts=accounts)
            bids = [k.public_key.raw for k in branch_keys]
            for i in range(branch_size):
                for j in range(i + 1, branch_size):
                    sim.add_connection(bids[i], bids[j])
                # every branch node also talks to every core node
                for cid in core_ids:
                    sim.add_connection(bids[i], cid)
        return sim

    @staticmethod
    def cycle(n: int, sim: Optional[Simulation] = None, accounts=None):
        """Ring: each node trusts itself + both neighbours, all three
        required — adjacent slices overlap, so quorum intersection
        holds (threshold 2 would admit disjoint quorums)."""
        sim = sim if sim is not None else Simulation()
        keys = [SecretKey.from_seed_str(f"sim-ring-{i}")
                for i in range(n)]
        for i, k in enumerate(keys):
            left = keys[(i - 1) % n]
            right = keys[(i + 1) % n]
            qset = SCPQuorumSet(
                threshold=3,
                validators=[make_node_id(x.public_key.raw)
                            for x in (k, left, right)],
                innerSets=[])
            sim.add_node(k, qset, accounts=accounts)
        ids = [k.public_key.raw for k in keys]
        for i in range(n):
            sim.add_connection(ids[i], ids[(i + 1) % n])
        return sim
