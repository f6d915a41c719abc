"""Offline / operator CLI commands (reference ``src/main/CommandLine.cpp``
command table: the non-daemon half — archive bootstrap + publish, DB
schema migration, bucket diagnostics, XDR utilities, settings upgrades).

Each ``cmd_*`` takes parsed argparse args and returns an exit code;
``register`` wires them into the main parser (cli.py).
"""

from __future__ import annotations

import base64
import json
import os
import sys

__all__ = ["register"]


def _load_config(args):
    from stellar_tpu_torch.main.config import Config
    if getattr(args, "conf", None):
        return Config.from_toml(args.conf)
    return Config()


def _open_persisted(cfg):
    """(persistence, ledger_manager|None) for a config with DATABASE."""
    from stellar_tpu_torch.bucket.bucket_manager import BucketManager
    from stellar_tpu_torch.database import Database, NodePersistence
    from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
    if not cfg.DATABASE:
        print("config has no DATABASE", file=sys.stderr)
        return None, None
    bucket_dir = cfg.BUCKET_DIR_PATH or os.path.join(
        os.path.dirname(os.path.abspath(cfg.DATABASE)), "buckets")
    pers = NodePersistence(Database(cfg.DATABASE),
                           BucketManager(bucket_dir))
    lm = LedgerManager.from_persistence(cfg.network_id(), pers)
    return pers, lm


# ---------------- info / diagnostics ----------------

def cmd_offline_info(args) -> int:
    """Node state without running it (reference ``offline-info``)."""
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    cfg = _load_config(args)
    pers, lm = _open_persisted(cfg)
    if pers is None:
        return 1
    out = {
        "network_passphrase": cfg.NETWORK_PASSPHRASE,
        "protocol_version": CURRENT_LEDGER_PROTOCOL_VERSION,
        "database_schema": pers.db.schema_version(),
    }
    if lm is None:
        out["state"] = "empty database (no LCL)"
    else:
        h = lm.last_closed_header
        out["ledger"] = {
            "seq": lm.ledger_seq,
            "hash": lm.last_closed_hash.hex(),
            "closeTime": h.scpValue.closeTime,
            "version": h.ledgerVersion,
            "baseFee": h.baseFee,
            "baseReserve": h.baseReserve,
            "maxTxSetSize": h.maxTxSetSize,
            "bucketListHash": h.bucketListHash.hex(),
        }
        import dataclasses
        out["soroban_settings"] = dataclasses.asdict(lm.soroban_config)
        if pers.state.get("forcescp") is not None:
            out["forcescp"] = pers.state.get("forcescp") == "true"
    print(json.dumps(out, indent=2))
    return 0


def cmd_diag_bucket_stats(args) -> int:
    """Per-level bucket entry/byte stats (reference
    ``diag-bucket-stats`` / ``main/Diagnostics.cpp``)."""
    cfg = _load_config(args)
    _, lm = _open_persisted(cfg)
    if lm is None:
        print("no persisted ledger state", file=sys.stderr)
        return 1
    levels = []
    for i, lev in enumerate(lm.bucket_list.levels):
        def stat(b):
            if b is None or b.is_empty():
                return {"entries": 0, "bytes": 0}
            init, live, dead = b.count_entries()
            size = b.size_bytes
            return {"entries": init + live + dead, "init": init,
                    "live": live, "dead": dead,
                    "bytes": size() if callable(size) else size,
                    "hash": b.hash.hex()[:16]}
        levels.append({"level": i, "curr": stat(lev.curr),
                       "snap": stat(lev.snap)})
    print(json.dumps({"lcl": lm.ledger_seq, "levels": levels}, indent=2))
    return 0


def cmd_dump_archival_stats(args) -> int:
    """Soroban state-archival stats: TTL liveness at the LCL (reference
    ``dump-archival-stats``)."""
    from stellar_tpu_torch.bucket.bucket_list_db import (
        SearchableBucketListSnapshot,
    )
    from stellar_tpu_torch.xdr.types import LedgerEntryType
    cfg = _load_config(args)
    _, lm = _open_persisted(cfg)
    if lm is None:
        print("no persisted ledger state", file=sys.stderr)
        return 1
    lcl = lm.ledger_seq
    counts = {"contract_data_temporary": 0,
              "contract_data_persistent": 0, "contract_code": 0,
              "ttl_live": 0, "ttl_expired": 0}
    snap = SearchableBucketListSnapshot.from_bucket_list(lm.bucket_list)
    for _, entry in snap.iter_live_entries():
        arm = entry.data.arm
        if arm == LedgerEntryType.CONTRACT_DATA:
            d = entry.data.value
            if d.durability == 0:  # TEMPORARY
                counts["contract_data_temporary"] += 1
            else:
                counts["contract_data_persistent"] += 1
        elif arm == LedgerEntryType.CONTRACT_CODE:
            counts["contract_code"] += 1
        elif arm == LedgerEntryType.TTL:
            if entry.data.value.liveUntilLedgerSeq >= lcl:
                counts["ttl_live"] += 1
            else:
                counts["ttl_expired"] += 1
    counts["hot_archive_entries"] = lm.hot_archive.total_entry_count()
    counts["hot_archive_hash"] = lm.hot_archive.hash().hex()
    print(json.dumps({"lcl": lcl, **counts}))
    return 0


# ---------------- database ----------------

def cmd_upgrade_db(args) -> int:
    """Apply pending schema migrations (reference ``upgrade-db``)."""
    from stellar_tpu_torch.database import Database
    cfg = _load_config(args)
    if not cfg.DATABASE:
        print("config has no DATABASE", file=sys.stderr)
        return 1
    if cfg.DATABASE != ":memory:" and not os.path.exists(cfg.DATABASE):
        print(f"no database at {cfg.DATABASE}", file=sys.stderr)
        return 1
    db = Database(cfg.DATABASE, for_upgrade=True)
    before = db.schema_version()
    applied = db.upgrade_schema()
    print(json.dumps({"schema_before": before,
                      "schema_after": db.schema_version(),
                      "migrations_applied": applied}))
    return 0


def cmd_force_scp(args) -> int:
    """Set/reset the force-SCP flag (reference ``force-scp`` — stored in
    PersistentState and consumed at the next ``run``). In this framework
    a restarted validator always resumes consensus from its durable LCL
    (the reference's post-v19 default), so the flag is recorded for
    operator-workflow parity and reported by ``offline-info``."""
    from stellar_tpu_torch.database import PersistentState
    cfg = _load_config(args)
    pers, _ = _open_persisted(cfg)
    if pers is None:
        return 1
    val = "false" if args.reset else "true"
    pers.state.set("forcescp", val)
    print(json.dumps({"forcescp": val == "true"}))
    return 0


# ---------------- history archives ----------------

def _write_state_snapshot(archive, lm, network_passphrase: str):
    """Write the HAS + referenced bucket files for the LCL state."""
    import gzip
    from stellar_tpu_torch.history.history_manager import HistoryArchiveState
    bucket_hashes = []
    buckets = {}
    for lev in lm.bucket_list.levels:
        nxt = lev.next
        bucket_hashes.append({
            "curr": lev.curr.hash.hex(),
            "snap": lev.snap.hash.hex(),
            "next": ({"state": 1, "output": nxt.hash.hex()}
                     if nxt is not None else {"state": 0}),
        })
        for b in (lev.curr, lev.snap, nxt):
            if b is not None and not b.is_empty():
                buckets[b.hash.hex()] = b
    has = HistoryArchiveState(lm.ledger_seq, network_passphrase,
                              bucket_hashes)
    has_json = has.to_json().encode()
    for hexhash, bucket in buckets.items():
        rel = (f"bucket/{hexhash[0:2]}/{hexhash[2:4]}/{hexhash[4:6]}/"
               f"bucket-{hexhash}.xdr.gz")
        archive.put(rel, gzip.compress(bucket.serialize()))
    archive.put(".well-known/stellar-history.json", has_json)
    return has


def cmd_new_hist(args) -> int:
    """Initialize history archive(s) with this node's current state
    (reference ``new-hist``): root HAS + bucket files."""
    from stellar_tpu_torch.history.history_manager import archive_from_config
    from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
    cfg = _load_config(args)
    if not cfg.HISTORY_ARCHIVES:
        print("no HISTORY_ARCHIVES configured", file=sys.stderr)
        return 1
    _, lm = _open_persisted(cfg) if cfg.DATABASE else (None, None)
    if lm is None:
        # fresh genesis state (reference initializes archives pre-run)
        lm = LedgerManager(cfg.network_id())
    else:
        from stellar_tpu_torch.history.history_manager import (
            is_last_in_checkpoint,
        )
        if lm.ledger_seq > 1 and not is_last_in_checkpoint(lm.ledger_seq):
            # a root HAS at a mid-checkpoint LCL poisons catchup: its
            # current_ledger's header exists in no published checkpoint
            # category file, so a default-target/MINIMAL catchup
            # against the archive cannot adopt state there — and the
            # bucket snapshot is only correct at THIS ledger, so it
            # cannot be re-pointed at the last boundary either
            print(
                f"LCL {lm.ledger_seq} is mid-checkpoint; new-hist "
                "needs a checkpoint-boundary LCL (run the node to the "
                "next boundary, or init fresh archives pre-run)",
                file=sys.stderr)
            return 1
    out = []
    for spec in cfg.HISTORY_ARCHIVES:
        archive = archive_from_config(spec)
        has = _write_state_snapshot(archive, lm, cfg.NETWORK_PASSPHRASE)
        out.append({"archive": getattr(archive, "root", str(spec)),
                    "current_ledger": has.current_ledger})
    print(json.dumps({"initialized": out}))
    return 0


def cmd_report_last_history_checkpoint(args) -> int:
    """Print the archive's root HAS (reference
    ``report-last-history-checkpoint``)."""
    from stellar_tpu_torch.history.history_manager import (
        HistoryManager, archive_from_config,
    )
    cfg = _load_config(args)
    spec = args.archive or (cfg.HISTORY_ARCHIVES[0]
                            if cfg.HISTORY_ARCHIVES else None)
    if spec is None:
        print("no archive configured or given", file=sys.stderr)
        return 1
    has = HistoryManager.get_root_has(archive_from_config(spec))
    if has is None:
        print("archive has no root HAS", file=sys.stderr)
        return 1
    print(has.to_json())
    return 0


def _complete_checkpoints_in_db(db, lcl: int):
    """Checkpoint ledger seqs whose full header range is in the DB."""
    from stellar_tpu_torch.history.history_manager import (
        checkpoint_containing, first_in_checkpoint,
    )
    # the genesis header is never a DB row — closes start one past it,
    # matching what the in-process CheckpointBuilder accumulates from a
    # node that began publishing mid-checkpoint
    min_seq = db.conn.execute(
        "SELECT MIN(ledgerseq) FROM ledgerheaders").fetchone()[0]
    if min_seq is None:
        return []
    out = []
    cp = 63
    while cp <= lcl:
        first = max(min_seq, first_in_checkpoint(cp))
        want = cp - first + 1
        headers = db.conn.execute(
            "SELECT COUNT(*) FROM ledgerheaders WHERE ledgerseq "
            "BETWEEN ? AND ?", (first, cp)).fetchone()[0]
        # every ledger needs its stored txset too (pre-schema-2 or
        # Maintainer-pruned rows can't rebuild a replayable archive —
        # publishing headers without tx sets would poison catchup)
        txsets = db.conn.execute(
            "SELECT COUNT(*) FROM txsets WHERE ledgerseq "
            "BETWEEN ? AND ?", (first, cp)).fetchone()[0]
        if first <= cp and headers == want and txsets == want:
            out.append(cp)
        cp += 64
    return out


def _rebuild_checkpoint(db, cp: int):
    """(headers, tx_entries, result_entries) for checkpoint ``cp`` from
    DB rows — the ``publish``-after-downtime path (the reference keeps
    streamed .dirty checkpoint files instead; we re-derive from the
    txsets/txhistory tables)."""
    from stellar_tpu_torch.history.history_manager import first_in_checkpoint
    from stellar_tpu_torch.xdr.ledger import (
        GeneralizedTransactionSet, LedgerHeader,
        LedgerHeaderHistoryEntry, TransactionHistoryEntry,
        TransactionHistoryResultEntry, TransactionResultSet,
        TransactionSet,
    )
    from stellar_tpu_torch.xdr.results import (
        TransactionResult, TransactionResultPair,
    )
    from stellar_tpu_torch.xdr.runtime import from_bytes
    from stellar_tpu_torch.xdr.ledger import ledger_header_hash
    min_seq = db.conn.execute(
        "SELECT MIN(ledgerseq) FROM ledgerheaders").fetchone()[0]
    headers, txs, results = [], [], []
    for seq in range(max(min_seq, first_in_checkpoint(cp)), cp + 1):
        raw = db.load_header_by_seq(seq)
        header = from_bytes(LedgerHeader, raw)
        headers.append(LedgerHeaderHistoryEntry(
            hash=ledger_header_hash(header), header=header,
            ext=LedgerHeaderHistoryEntry._types[2].make(0)))
        ts_raw = db.load_txset(seq)
        if ts_raw is not None:
            txs.append(TransactionHistoryEntry(
                ledgerSeq=seq,
                txSet=TransactionSet(
                    previousLedgerHash=header.previousLedgerHash, txs=[]),
                ext=TransactionHistoryEntry._types[2].make(
                    1, from_bytes(GeneralizedTransactionSet, ts_raw))))
        pairs = [TransactionResultPair(
            transactionHash=txid,
            result=from_bytes(TransactionResult, res))
            for txid, _, res in db.load_tx_history(seq)]
        if pairs:
            results.append(TransactionHistoryResultEntry(
                ledgerSeq=seq,
                txResultSet=TransactionResultSet(results=pairs),
                ext=TransactionHistoryResultEntry._types[2].make(0)))
    return headers, txs, results


def cmd_publish(args) -> int:
    """Publish any checkpoints present in the DB but missing from the
    configured archives (reference ``publish`` — drains the publish
    queue after downtime)."""
    import gzip
    from stellar_tpu_torch.history.history_manager import (
        _layered_path, _records, archive_from_config,
    )
    from stellar_tpu_torch.xdr.ledger import (
        LedgerHeaderHistoryEntry, TransactionHistoryEntry,
        TransactionHistoryResultEntry,
    )
    from stellar_tpu_torch.xdr.runtime import to_bytes
    cfg = _load_config(args)
    pers, lm = _open_persisted(cfg)
    if pers is None:
        return 1
    if lm is None:
        print("empty database; nothing to publish", file=sys.stderr)
        return 1
    if not cfg.HISTORY_ARCHIVES:
        print("no HISTORY_ARCHIVES configured", file=sys.stderr)
        return 1
    archives = [archive_from_config(s) for s in cfg.HISTORY_ARCHIVES]
    published = []
    for cp in _complete_checkpoints_in_db(pers.db, lm.ledger_seq):
        missing = [a for a in archives
                   if a.get(_layered_path("ledger", cp, "xdr.gz")) is None]
        if not missing:
            continue
        headers, txs, results = _rebuild_checkpoint(pers.db, cp)
        files = {
            _layered_path("ledger", cp, "xdr.gz"): gzip.compress(_records(
                [to_bytes(LedgerHeaderHistoryEntry, h) for h in headers])),
            _layered_path("transactions", cp, "xdr.gz"): gzip.compress(
                _records([to_bytes(TransactionHistoryEntry, t)
                          for t in txs])),
            _layered_path("results", cp, "xdr.gz"): gzip.compress(
                _records([to_bytes(TransactionHistoryResultEntry, r)
                          for r in results])),
        }
        for a in missing:
            for rel, data in files.items():
                a.put(rel, data)
        published.append(cp)
    # state snapshot (HAS + buckets) is only correct at the LCL
    has_written = False
    if published and lm.ledger_seq == published[-1]:
        for a in archives:
            _write_state_snapshot(a, lm, cfg.NETWORK_PASSPHRASE)
        has_written = True
    print(json.dumps({"published_checkpoints": published,
                      "has_written": has_written,
                      "lcl": lm.ledger_seq}))
    return 0


def cmd_print_publish_queue(args) -> int:
    """Checkpoints in the DB not yet in the first configured archive
    (reference ``print-publish-queue``)."""
    from stellar_tpu_torch.history.history_manager import (
        _layered_path, archive_from_config,
    )
    cfg = _load_config(args)
    pers, lm = _open_persisted(cfg)
    if pers is None:
        return 1
    if lm is None:
        print(json.dumps({"queue": []}))
        return 0
    archive = (archive_from_config(cfg.HISTORY_ARCHIVES[0])
               if cfg.HISTORY_ARCHIVES else None)
    queue = []
    for cp in _complete_checkpoints_in_db(pers.db, lm.ledger_seq):
        if archive is None or \
                archive.get(_layered_path("ledger", cp, "xdr.gz")) is None:
            queue.append(cp)
    print(json.dumps({"queue": queue, "lcl": lm.ledger_seq}))
    return 0


# ---------------- bucket utilities ----------------

def cmd_merge_bucketlist(args) -> int:
    """Flatten the whole live bucket list into one bucket file
    (reference ``merge-bucketlist``)."""
    from stellar_tpu_torch.bucket.bucket import fresh_bucket
    from stellar_tpu_torch.bucket.bucket_list_db import (
        SearchableBucketListSnapshot,
    )
    cfg = _load_config(args)
    _, lm = _open_persisted(cfg)
    if lm is None:
        print("no persisted ledger state", file=sys.stderr)
        return 1
    snap = SearchableBucketListSnapshot.from_bucket_list(lm.bucket_list)
    live = [entry for _, entry in snap.iter_live_entries()]
    merged = fresh_bucket(lm.last_closed_header.ledgerVersion, [], live, [])
    path = os.path.join(args.outputdir,
                        f"bucket-{merged.hash.hex()}.xdr")
    os.makedirs(args.outputdir, exist_ok=True)
    with open(path, "wb") as f:
        f.write(merged.serialize())
    print(json.dumps({"hash": merged.hash.hex(), "entries": len(live),
                      "file": path}))
    return 0


def cmd_rebuild_ledger_from_buckets(args) -> int:
    """Re-derive the live ledger state purely from the persisted bucket
    files and verify it against the LCL header (reference
    ``rebuild-ledger-from-buckets`` re-populates SQL from buckets; with
    BucketListDB the buckets ARE the state, so this is a full
    re-index + hash verification)."""
    cfg = _load_config(args)
    pers, lm = _open_persisted(cfg)
    if pers is None:
        return 1
    if lm is None:
        print("no persisted ledger state", file=sys.stderr)
        return 1
    got = lm.bucket_list.hash()
    want = lm.last_closed_header.bucketListHash
    entries = lm.bucket_list.total_entry_count()
    ok = got == want
    print(json.dumps({"lcl": lm.ledger_seq, "entries": entries,
                      "bucket_list_hash_ok": ok}))
    return 0 if ok else 1


def cmd_load_xdr(args) -> int:
    """Load a file of LedgerEntry XDR frames into the persisted state as
    a synthetic ledger close (reference ``load-xdr``, a BUILD_TESTS
    debugging utility)."""
    from stellar_tpu_torch.bucket.bucket import _record_frame  # noqa: F401
    from stellar_tpu_torch.xdr.ledger import ledger_header_hash
    from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
    from stellar_tpu_torch.xdr.types import LedgerEntry
    cfg = _load_config(args)
    pers, lm = _open_persisted(cfg)
    if pers is None:
        return 1
    if lm is None:
        print("no persisted ledger state (run new-db + close one "
              "ledger, or catchup, first)", file=sys.stderr)
        return 1
    with open(args.file, "rb") as f:
        raw = f.read()
    # bucket record framing (4-byte big-endian length | 0x80000000)
    entries = []
    off = 0
    import struct
    while off + 4 <= len(raw):
        (n,) = struct.unpack_from(">I", raw, off)
        n &= 0x7FFFFFFF
        off += 4
        entries.append(from_bytes(LedgerEntry, raw[off:off + n]))
        off += n
    seq = lm.ledger_seq + 1
    for e in entries:
        e.lastModifiedLedgerSeq = seq
    header = lm.last_closed_header
    prev_hash = lm.last_closed_hash
    lm.bucket_list.add_batch(seq, header.ledgerVersion, entries, [], [])
    header.ledgerSeq = seq
    header.previousLedgerHash = prev_hash
    header.bucketListHash = lm.bucket_list.hash()
    new_hash = ledger_header_hash(header)
    pers.save_ledger(header, new_hash, lm.bucket_list, [])
    print(json.dumps({"loaded_entries": len(entries), "new_lcl": seq,
                      "hash": new_hash.hex()}))
    return 0


# ---------------- XDR / key utilities ----------------

def cmd_encode_asset(args) -> int:
    """Asset (code + issuer) -> base64 Asset XDR (reference
    ``encode-asset``)."""
    from stellar_tpu_torch.crypto import strkey
    from stellar_tpu_torch.scp.quorum import make_node_id
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.types import (
        AlphaNum12, Asset, AssetType, NATIVE_ASSET, asset_alphanum4,
    )
    if not args.code:
        asset = NATIVE_ASSET
    else:
        code = args.code.encode()
        if not args.issuer:
            print("--issuer required for a non-native asset",
                  file=sys.stderr)
            return 1
        issuer = make_node_id(strkey.decode_account(args.issuer))
        if len(code) <= 4:
            asset = asset_alphanum4(code, issuer)
        elif len(code) <= 12:
            asset = Asset.make(
                AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
                AlphaNum12(assetCode=code.ljust(12, b"\x00"),
                           issuer=issuer))
        else:
            print("asset code too long (max 12)", file=sys.stderr)
            return 1
    print(base64.b64encode(to_bytes(Asset, asset)).decode())
    return 0


def cmd_dump_xdr(args) -> int:
    """Pretty-print a file of FRAMED XDR records (history category
    files, bucket files, meta streams) — the streaming counterpart of
    ``print-xdr`` (reference ``dump-xdr`` / dumpxdr.cpp). Gzip is
    detected from the magic bytes."""
    import gzip
    from stellar_tpu_torch.history.history_manager import _unrecords
    from stellar_tpu_torch.xdr.runtime import from_bytes
    types = _stream_types()
    t = types.get(args.filetype)
    if t is None:
        print(f"unknown type {args.filetype}; one of {sorted(types)}",
              file=sys.stderr)
        return 1
    with open(args.file, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    records = _unrecords(raw)[:args.limit]
    for rec in records:
        print(repr(from_bytes(t, rec)))
    print(json.dumps({"records": len(records)}), file=sys.stderr)
    return 0


def _stream_types():
    from stellar_tpu_torch.xdr import ledger as xl, tx as xt
    from stellar_tpu_torch.xdr.types import LedgerEntry
    return {
        "LedgerHeaderHistoryEntry": xl.LedgerHeaderHistoryEntry,
        "TransactionHistoryEntry": xl.TransactionHistoryEntry,
        "TransactionHistoryResultEntry": xl.TransactionHistoryResultEntry,
        "BucketEntry": xl.BucketEntry,
        "LedgerCloseMeta": xl.LedgerCloseMeta,
        "LedgerEntry": LedgerEntry,
        "TransactionEnvelope": xt.TransactionEnvelope,
    }


def cmd_replay_debug_meta(args) -> int:
    """Verify a framed LedgerCloseMeta stream file: per-ledger decode,
    seq continuity, and header hash-chain (reference
    ``replay-debug-meta`` / ``ReplayDebugMetaWork``)."""
    import struct
    from stellar_tpu_torch.xdr.ledger import LedgerCloseMeta, ledger_header_hash
    from stellar_tpu_torch.xdr.runtime import from_bytes
    with open(args.file, "rb") as f:
        raw = f.read()
    off = 0
    count = 0
    first = last = None
    prev_hash = None
    while off + 4 <= len(raw):
        (n,) = struct.unpack_from(">I", raw, off)
        n &= 0x7FFFFFFF
        off += 4
        meta = from_bytes(LedgerCloseMeta, raw[off:off + n])
        off += n
        v1 = meta.value
        hhe = v1.ledgerHeader
        seq = hhe.header.ledgerSeq
        if ledger_header_hash(hhe.header) != hhe.hash:
            print(json.dumps({"error": "header hash mismatch",
                              "ledger": seq}))
            return 1
        if last is not None and seq != last + 1:
            print(json.dumps({"error": "sequence gap",
                              "after": last, "got": seq}))
            return 1
        if prev_hash is not None and \
                hhe.header.previousLedgerHash != prev_hash:
            print(json.dumps({"error": "hash chain broken",
                              "ledger": seq}))
            return 1
        prev_hash = hhe.hash
        first = seq if first is None else first
        last = seq
        count += 1
    print(json.dumps({"ledgers": count, "first": first, "last": last}))
    return 0


def cmd_get_settings_upgrade_txs(args) -> int:
    """Build the ConfigUpgradeSet publication artifacts for a Soroban
    settings upgrade (reference ``get-settings-upgrade-txs`` /
    ``SettingsUpgradeUtils.cpp``): the ledger entries that make the
    upgrade set visible to validators plus the ConfigUpgradeSetKey to
    schedule via the ``upgrades`` admin endpoint."""
    from stellar_tpu_torch.main.settings_upgrade import (
        build_config_upgrade_publication,
    )
    from stellar_tpu_torch.xdr.contract import (
        ConfigSettingEntry, ConfigUpgradeSet,
    )
    from stellar_tpu_torch.xdr.ledger import ConfigUpgradeSetKey
    from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
    from stellar_tpu_torch.xdr.types import LedgerEntry
    with open(args.file, "rb") as f:
        raw = f.read()
    if raw.lstrip().startswith(b"{"):
        # the reference's JSON settings-upgrade format (the committed
        # soroban-settings/pubnet_phase*.json files work verbatim)
        from stellar_tpu_torch.ledger.network_config import (
            load_settings_upgrade_json,
        )
        upgrade_set = ConfigUpgradeSet(
            updatedEntry=load_settings_upgrade_json(raw.decode()))
    else:
        try:
            upgrade_set = from_bytes(ConfigUpgradeSet, raw)
        except Exception:
            upgrade_set = from_bytes(ConfigUpgradeSet,
                                     base64.b64decode(raw))
    contract_id = bytes.fromhex(args.contract_id) if args.contract_id \
        else b"\x01" * 32
    entry, ttl, key = build_config_upgrade_publication(
        contract_id, upgrade_set, args.ledger_seq,
        args.ledger_seq + 100_000)
    print(json.dumps({
        "config_upgrade_set_key": base64.b64encode(
            to_bytes(ConfigUpgradeSetKey, key)).decode(),
        "publication_entry": base64.b64encode(
            to_bytes(LedgerEntry, entry)).decode(),
        "ttl_entry": base64.b64encode(to_bytes(LedgerEntry, ttl)).decode(),
        "settings_updated": len(upgrade_set.updatedEntry),
    }))
    return 0


def cmd_test(args) -> int:
    """Run the test suite (reference ``stellar-core test``)."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "pytest",
           os.path.join(repo, "tests"), "-q"]
    if args.filter:
        cmd += ["-k", args.filter]
    return subprocess.call(cmd)


# ---------------- registration ----------------

def register(sub) -> None:
    """Attach all offline commands to the cli.py subparsers object."""
    sub.add_parser("offline-info").set_defaults(fn=cmd_offline_info)
    sub.add_parser("diag-bucket-stats").set_defaults(
        fn=cmd_diag_bucket_stats)
    sub.add_parser("dump-archival-stats").set_defaults(
        fn=cmd_dump_archival_stats)
    sub.add_parser("upgrade-db").set_defaults(fn=cmd_upgrade_db)
    sp = sub.add_parser("force-scp")
    sp.add_argument("--reset", action="store_true")
    sp.set_defaults(fn=cmd_force_scp)
    sub.add_parser("new-hist").set_defaults(fn=cmd_new_hist)
    sp = sub.add_parser("report-last-history-checkpoint")
    sp.add_argument("--archive", help="archive dir (default: config)")
    sp.set_defaults(fn=cmd_report_last_history_checkpoint)
    sub.add_parser("publish").set_defaults(fn=cmd_publish)
    sub.add_parser("print-publish-queue").set_defaults(
        fn=cmd_print_publish_queue)
    sp = sub.add_parser("merge-bucketlist")
    sp.add_argument("outputdir")
    sp.set_defaults(fn=cmd_merge_bucketlist)
    sub.add_parser("rebuild-ledger-from-buckets").set_defaults(
        fn=cmd_rebuild_ledger_from_buckets)
    sp = sub.add_parser("load-xdr")
    sp.add_argument("file", help="framed LedgerEntry XDR records")
    sp.set_defaults(fn=cmd_load_xdr)
    sp = sub.add_parser("encode-asset")
    sp.add_argument("--code", default="")
    sp.add_argument("--issuer", default="")
    sp.set_defaults(fn=cmd_encode_asset)
    sp = sub.add_parser("dump-xdr")
    sp.add_argument("file", help="framed XDR record stream (.xdr/.gz)")
    sp.add_argument("--filetype", default="LedgerHeaderHistoryEntry")
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_dump_xdr)
    sp = sub.add_parser("replay-debug-meta")
    sp.add_argument("file", help="framed LedgerCloseMeta stream file")
    sp.set_defaults(fn=cmd_replay_debug_meta)
    sp = sub.add_parser("get-settings-upgrade-txs")
    sp.add_argument("file", help="ConfigUpgradeSet XDR (raw or base64)")
    sp.add_argument("--contract-id", dest="contract_id", default="")
    sp.add_argument("--ledger-seq", dest="ledger_seq", type=int,
                    default=1)
    sp.set_defaults(fn=cmd_get_settings_upgrade_txs)
    sp = sub.add_parser("test")
    sp.add_argument("--filter", default="")
    sp.set_defaults(fn=cmd_test)
