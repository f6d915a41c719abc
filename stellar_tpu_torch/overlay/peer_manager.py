"""Peer directory + bans (reference ``src/overlay/PeerManager.h``,
``RandomPeerSource.h``, ``BanManagerImpl.cpp``).

The PeerManager is the node's address book: every address it has heard
of (config KNOWN_PEERS, PEERS gossip, inbound connections) with failure
counts and backoff, queried by the connection maintainer through
``random_peers``. The BanManager holds operator bans by node id; banned
peers are refused at HELLO and dropped if connected. Both persist in
the node database when one is attached.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["PeerRecord", "PeerManager", "BanManager", "PeerType"]

MAX_FAILURES = 10  # reference REALLY_DEAD_NUM_FAILURES_CUTOFF (~120/10)


class PeerType:
    INBOUND = 0
    OUTBOUND = 1
    PREFERRED = 2


@dataclass
class PeerRecord:
    host: str
    port: int
    num_failures: int = 0
    peer_type: int = PeerType.OUTBOUND
    next_attempt: float = 0.0  # clock time gate (backoff)

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"


class PeerManager:
    def __init__(self, db=None):
        self.records: Dict[str, PeerRecord] = {}
        self.db = db
        if db is not None:
            with db.conn:
                db.conn.execute(
                    "CREATE TABLE IF NOT EXISTS peers ("
                    "host TEXT, port INTEGER, numfailures INTEGER, "
                    "type INTEGER, PRIMARY KEY (host, port))")
            for host, port, nf, pt in db.conn.execute(
                    "SELECT host, port, numfailures, type FROM peers"):
                rec = PeerRecord(host, port, nf, pt)
                self.records[rec.key] = rec

    # ---------------- updates ----------------

    def ensure_exists(self, host: str, port: int,
                      peer_type: int = PeerType.OUTBOUND) -> PeerRecord:
        key = f"{host}:{port}"
        rec = self.records.get(key)
        if rec is None:
            rec = PeerRecord(host, port, peer_type=peer_type)
            self.records[key] = rec
            self._store(rec)
        return rec

    def on_connection_success(self, host: str, port: int, now: float = 0):
        rec = self.ensure_exists(host, port)
        rec.num_failures = 0
        rec.next_attempt = now
        self._store(rec)

    def on_connection_failure(self, host: str, port: int, now: float = 0):
        """Exponential backoff per failure (reference
        ``PeerManager::update`` BACKOFF handling)."""
        rec = self.ensure_exists(host, port)
        rec.num_failures += 1
        rec.next_attempt = now + min(2 ** rec.num_failures, 3600)
        self._store(rec)

    def _store(self, rec: PeerRecord):
        if self.db is None:
            return
        with self.db.conn:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO peers (host, port, numfailures, "
                "type) VALUES (?, ?, ?, ?)",
                (rec.host, rec.port, rec.num_failures, rec.peer_type))

    # ---------------- queries (RandomPeerSource) ----------------

    def random_peers(self, n: int, now: float = 0.0,
                     rng: Optional[random.Random] = None
                     ) -> List[PeerRecord]:
        """Connectable candidates: not backed off, not really dead;
        preferred peers first, then random (reference
        ``RandomPeerSource::getRandomPeers``)."""
        rng = rng or random
        live = [r for r in self.records.values()
                if r.num_failures < MAX_FAILURES and r.next_attempt <= now]
        preferred = [r for r in live if r.peer_type == PeerType.PREFERRED]
        others = [r for r in live if r.peer_type != PeerType.PREFERRED]
        rng.shuffle(others)
        return (preferred + others)[:n]

    def known_addresses(self, limit: int = 50) -> List[PeerRecord]:
        """What we share in a PEERS message."""
        return [r for r in self.records.values()
                if r.num_failures < MAX_FAILURES][:limit]


class BanManager:
    """Operator bans by node id (reference ``BanManagerImpl``)."""

    def __init__(self, db=None):
        self.banned: set = set()
        self.db = db
        if db is not None:
            with db.conn:
                db.conn.execute(
                    "CREATE TABLE IF NOT EXISTS ban "
                    "(nodeid BLOB PRIMARY KEY)")
            self.banned = {row[0] for row in
                           db.conn.execute("SELECT nodeid FROM ban")}

    def ban(self, node_id: bytes):
        self.banned.add(bytes(node_id))
        if self.db is not None:
            with self.db.conn:
                self.db.conn.execute(
                    "INSERT OR IGNORE INTO ban (nodeid) VALUES (?)",
                    (bytes(node_id),))

    def unban(self, node_id: bytes):
        self.banned.discard(bytes(node_id))
        if self.db is not None:
            with self.db.conn:
                self.db.conn.execute("DELETE FROM ban WHERE nodeid = ?",
                                     (bytes(node_id),))

    def is_banned(self, node_id: bytes) -> bool:
        return bytes(node_id) in self.banned

    def banned_nodes(self) -> List[bytes]:
        return sorted(self.banned)
