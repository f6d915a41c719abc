"""Node-local persistence: SQLite store + crash-ordered ledger commit
(reference ``src/database/Database.h`` + ``src/main/PersistentState.h``).

The division of labor mirrors the reference post-BucketListDB
(``src/bucket/readme.md:35-50``): SQL holds only small critical state —
ledger headers, the PersistentState key/value rows (LCL pointer,
bucket-list manifest, HAS, SCP data), tx/scp history — while live ledger
entries live in content-addressed bucket files on disk (see
``stellar_tpu_torch.bucket.bucket_manager``).

Crash ordering (reference ``LedgerManagerImpl.cpp:1026-1077``): bucket
files are durably written *before* the single SQL transaction that
flips the LCL pointer. A crash between the two leaves orphan bucket
files (GC'd later) and a DB that still points at the previous LCL — the
node restarts from a consistent earlier state, never a torn one.
"""

from __future__ import annotations

import json
import sqlite3
from typing import List, Optional, Tuple

__all__ = ["Database", "PersistentState", "NodePersistence"]

SCHEMA_VERSION = 2

_SCHEMA = """
CREATE TABLE IF NOT EXISTS storestate (
    statename TEXT PRIMARY KEY,
    state     TEXT
);
CREATE TABLE IF NOT EXISTS ledgerheaders (
    ledgerhash BLOB PRIMARY KEY,
    prevhash   BLOB,
    ledgerseq  INTEGER UNIQUE,
    closetime  INTEGER,
    data       BLOB
);
CREATE TABLE IF NOT EXISTS txhistory (
    txid      BLOB,
    ledgerseq INTEGER,
    txindex   INTEGER,
    txbody    BLOB,
    txresult  BLOB,
    PRIMARY KEY (ledgerseq, txindex)
);
CREATE TABLE IF NOT EXISTS scphistory (
    nodeid    BLOB,
    ledgerseq INTEGER,
    envelope  BLOB
);
CREATE INDEX IF NOT EXISTS scphistorybyseq ON scphistory (ledgerseq);
"""

_TXSETS_DDL = """
CREATE TABLE IF NOT EXISTS txsets (
    ledgerseq INTEGER PRIMARY KEY,
    txset     BLOB
);
"""
_SCHEMA += _TXSETS_DDL

# schema version -> DDL bringing it to version+1 (reference
# ``Database::applySchemaUpgrade``; run by the ``upgrade-db`` CLI)
_MIGRATIONS = {
    1: _TXSETS_DDL,
}


class Database:
    """Thin sqlite3 wrapper (reference soci ``Database``). ``path`` may
    be ``:memory:`` for tests."""

    def __init__(self, path: str = ":memory:", for_upgrade: bool = False):
        self.path = path
        # check_same_thread=False: construction-time writes happen on
        # the constructing thread; all steady-state access is funneled
        # through the single crank thread (admin routes via _on_main),
        # so the single-writer discipline holds without sqlite's
        # same-thread guard (reference: SOCI sessions cross threads)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=FULL")
        if not for_upgrade:
            self.initialize()

    def initialize(self):
        """Create the schema on a fresh database (reference ``new-db``).
        An existing database at an older schema version is refused, like
        the reference — run ``upgrade-db`` first."""
        has_state = self.conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name='storestate'").fetchone() is not None
        if not has_state:
            with self.conn:
                self.conn.executescript(_SCHEMA)
            PersistentState(self).set(PersistentState.DATABASE_SCHEMA,
                                      str(SCHEMA_VERSION))
            return
        current = self.schema_version()
        if current < SCHEMA_VERSION:
            raise RuntimeError(
                f"database schema is version {current}, need "
                f"{SCHEMA_VERSION}: run upgrade-db")
        if current > SCHEMA_VERSION:
            raise RuntimeError(
                f"database schema {current} is newer than this binary "
                f"({SCHEMA_VERSION})")

    def schema_version(self) -> int:
        v = PersistentState(self).get(PersistentState.DATABASE_SCHEMA)
        return int(v) if v is not None else 0

    def upgrade_schema(self) -> List[int]:
        """Apply pending migrations in order; returns the versions
        stepped through (reference ``upgrade-db``)."""
        applied = []
        while (v := self.schema_version()) < SCHEMA_VERSION:
            ddl = _MIGRATIONS.get(v)
            if ddl is None:
                raise RuntimeError(f"no migration from schema {v}")
            with self.conn:
                self.conn.executescript(ddl)
            PersistentState(self).set(PersistentState.DATABASE_SCHEMA,
                                      str(v + 1))
            applied.append(v + 1)
        return applied

    def close(self):
        self.conn.close()

    # ---------------- ledger headers ----------------

    def store_header(self, header_hash: bytes, prev_hash: bytes,
                     seq: int, close_time: int, data: bytes,
                     commit: bool = True):
        sql = ("INSERT OR REPLACE INTO ledgerheaders "
               "(ledgerhash, prevhash, ledgerseq, closetime, data) "
               "VALUES (?, ?, ?, ?, ?)")
        args = (header_hash, prev_hash, seq, close_time, data)
        if commit:
            with self.conn:
                self.conn.execute(sql, args)
        else:
            self.conn.execute(sql, args)

    def load_header_by_hash(self, header_hash: bytes) -> Optional[bytes]:
        row = self.conn.execute(
            "SELECT data FROM ledgerheaders WHERE ledgerhash = ?",
            (header_hash,)).fetchone()
        return row[0] if row else None

    def load_header_by_seq(self, seq: int) -> Optional[bytes]:
        row = self.conn.execute(
            "SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
            (seq,)).fetchone()
        return row[0] if row else None

    def max_header_seq(self) -> Optional[int]:
        row = self.conn.execute(
            "SELECT MAX(ledgerseq) FROM ledgerheaders").fetchone()
        return row[0]

    # ---------------- tx history ----------------

    def store_tx_history(self, seq: int,
                         rows: List[Tuple[bytes, bytes, bytes]],
                         commit: bool = True):
        """rows: (txid, envelope_xdr, result_xdr) in apply order."""
        sql = ("INSERT OR REPLACE INTO txhistory "
               "(txid, ledgerseq, txindex, txbody, txresult) "
               "VALUES (?, ?, ?, ?, ?)")
        args = [(txid, seq, i, body, result)
                for i, (txid, body, result) in enumerate(rows)]
        if commit:
            with self.conn:
                self.conn.executemany(sql, args)
        else:
            self.conn.executemany(sql, args)

    def load_tx_history(self, seq: int) -> List[Tuple[bytes, bytes, bytes]]:
        return [(r[0], r[1], r[2]) for r in self.conn.execute(
            "SELECT txid, txbody, txresult FROM txhistory "
            "WHERE ledgerseq = ? ORDER BY txindex", (seq,))]

    def store_txset(self, seq: int, txset_xdr: bytes,
                    commit: bool = True):
        """The applied GeneralizedTransactionSet per ledger — what the
        ``publish`` CLI needs to rebuild checkpoint files after
        downtime (reference keeps streamed .dirty checkpoint files)."""
        sql = "INSERT OR REPLACE INTO txsets (ledgerseq, txset) VALUES (?, ?)"
        if commit:
            with self.conn:
                self.conn.execute(sql, (seq, txset_xdr))
        else:
            self.conn.execute(sql, (seq, txset_xdr))

    def load_txset(self, seq: int) -> Optional[bytes]:
        row = self.conn.execute(
            "SELECT txset FROM txsets WHERE ledgerseq = ?",
            (seq,)).fetchone()
        return row[0] if row else None

    # ---------------- scp history ----------------

    def load_scp_history(self, seq: int) -> List[bytes]:
        return [r[0] for r in self.conn.execute(
            "SELECT envelope FROM scphistory WHERE ledgerseq = ?",
            (seq,))]

    def store_scp_history(self, seq: int,
                          envelopes: List[Tuple[bytes, bytes]],
                          commit: bool = True):
        sql = ("INSERT INTO scphistory (nodeid, ledgerseq, envelope) "
               "VALUES (?, ?, ?)")
        args = [(n, seq, e) for n, e in envelopes]
        if commit:
            with self.conn:
                self.conn.executemany(sql, args)
        else:
            self.conn.executemany(sql, args)


class PersistentState:
    """Key/value critical state (reference ``PersistentState.h`` —
    same row names where they exist there)."""

    LAST_CLOSED_LEDGER = "lastclosedledger"     # header hash, hex
    HISTORY_ARCHIVE_STATE = "historyarchivestate"
    LAST_SCP_DATA = "lastscpdata"
    DATABASE_SCHEMA = "databaseschema"
    BUCKET_LIST_STATE = "bucketliststate"       # JSON level manifest
    LEDGER_UPGRADES = "ledgerupgrades"

    def __init__(self, db: Database):
        self.db = db

    def get(self, key: str) -> Optional[str]:
        row = self.db.conn.execute(
            "SELECT state FROM storestate WHERE statename = ?",
            (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: str, value: str, commit: bool = True):
        sql = ("INSERT OR REPLACE INTO storestate (statename, state) "
               "VALUES (?, ?)")
        if commit:
            with self.db.conn:
                self.db.conn.execute(sql, (key, value))
        else:
            self.db.conn.execute(sql, (key, value))

    def list_cursors(self) -> dict:
        """Registered downstream cursors (reference ExternalQueue):
        id -> acknowledged ledger. The ONE owner of the 'cursor.'
        namespace — setcursor/getcursor/dropcursor and the maintenance
        GC floor all go through here."""
        rows = self.db.conn.execute(
            "SELECT statename, state FROM storestate "
            "WHERE statename LIKE 'cursor.%'").fetchall()
        return {name[len("cursor."):]: int(v) for name, v in rows}


class NodePersistence:
    """The LedgerManager's durability hook: saves each close in crash
    order and restores (header, bucket list, store) at startup."""

    def __init__(self, db: Database, bucket_manager):
        self.db = db
        self.state = PersistentState(db)
        self.buckets = bucket_manager

    # ---------------- save (called at every close) ----------------

    HOT_ARCHIVE_STATE = "hotarchivestate"

    def save_ledger(self, header, header_hash: bytes, bucket_list,
                    tx_rows: List[Tuple[bytes, bytes, bytes]],
                    scp_rows: Optional[List[Tuple[bytes, bytes]]] = None,
                    txset_xdr: Optional[bytes] = None,
                    hot_archive=None):
        """Persist one closed ledger. Step 1: bucket files on disk.
        Step 2: one SQL transaction moving the LCL pointer."""
        from stellar_tpu_torch.xdr.ledger import LedgerHeader
        from stellar_tpu_torch.xdr.runtime import to_bytes
        manifest = self.buckets.persist_bucket_list(bucket_list)
        hot_manifest = self.buckets.persist_hot_archive(hot_archive) \
            if hot_archive is not None else None
        with self.db.conn:  # single transaction
            self.db.store_header(
                header_hash, header.previousLedgerHash, header.ledgerSeq,
                header.scpValue.closeTime,
                to_bytes(LedgerHeader, header), commit=False)
            if tx_rows:
                self.db.store_tx_history(header.ledgerSeq, tx_rows,
                                         commit=False)
            if scp_rows:
                self.db.store_scp_history(header.ledgerSeq, scp_rows,
                                          commit=False)
            if txset_xdr is not None:
                self.db.store_txset(header.ledgerSeq, txset_xdr,
                                    commit=False)
            self.state.set(PersistentState.BUCKET_LIST_STATE,
                           json.dumps(manifest), commit=False)
            if hot_manifest is not None:
                self.state.set(self.HOT_ARCHIVE_STATE,
                               json.dumps(hot_manifest), commit=False)
            self.state.set(PersistentState.LAST_CLOSED_LEDGER,
                           header_hash.hex(), commit=False)

    # ---------------- restore (startup) ----------------

    def load_last_ledger(self):
        """(header, header_hash, bucket_list) from disk, or None on a
        fresh database. Verifies the restored list hashes to the
        header's bucketListHash."""
        from stellar_tpu_torch.xdr.ledger import LedgerHeader
        from stellar_tpu_torch.xdr.runtime import from_bytes
        lcl_hex = self.state.get(PersistentState.LAST_CLOSED_LEDGER)
        if lcl_hex is None:
            return None
        header_hash = bytes.fromhex(lcl_hex)
        raw = self.db.load_header_by_hash(header_hash)
        if raw is None:
            raise RuntimeError("LCL pointer without header row")
        header = from_bytes(LedgerHeader, raw)
        manifest = json.loads(
            self.state.get(PersistentState.BUCKET_LIST_STATE) or "[]")
        bucket_list = self.buckets.restore_bucket_list(manifest)
        hot_raw = self.state.get(NodePersistence.HOT_ARCHIVE_STATE)
        try:
            hot_archive = self.buckets.restore_hot_archive(
                json.loads(hot_raw)) if hot_raw else None
        except (OSError, ValueError) as e:
            raise RuntimeError(
                "restored hot archive is unreadable "
                f"({e}) — catch up from history instead")
        from stellar_tpu_torch.bucket.hot_archive import (
            header_bucket_list_hash,
        )
        # p23+ headers commit to live+hot (empty archive hashes as a
        # fresh list); one shared protocol-gated combine
        want = header_bucket_list_hash(bucket_list.hash(), hot_archive,
                                       header.ledgerVersion)
        if want != header.bucketListHash:
            raise RuntimeError(
                "restored bucket list does not match LCL header "
                "(bucket dir corrupt?) — catch up from history instead")
        return header, header_hash, bucket_list, hot_archive
