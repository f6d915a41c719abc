"""Command-line interface (reference ``src/main/CommandLine.cpp`` ~35
commands; the operational core here: run, catchup, publish, new-ledger
state, self-check, version, gen-seed, print-xdr, apply-load)."""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]


def _load_config(args):
    from stellar_tpu_torch.main.config import Config
    if getattr(args, "conf", None):
        return Config.from_toml(args.conf)
    return Config()


def cmd_version(args) -> int:
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    print(json.dumps({
        "stellar_tpu": "0.1.0",
        "ledger_protocol_version": CURRENT_LEDGER_PROTOCOL_VERSION,
    }))
    return 0


def cmd_gen_seed(args) -> int:
    from stellar_tpu_torch.crypto.keys import SecretKey
    sk = SecretKey.random()
    print(json.dumps({"secret_seed": sk.to_strkey_seed(),
                      "public_key": sk.public_key.to_strkey()}))
    return 0


def cmd_run(args) -> int:
    """Run a node until interrupted (reference ``run``)."""
    from stellar_tpu_torch.main.application import Application
    from stellar_tpu_torch.main.command_handler import CommandHandler
    from stellar_tpu_torch.overlay.tcp import TCPDriver
    cfg = _load_config(args)
    app = Application(cfg)
    tcp = None
    if cfg.MODE_AUTO_STARTS_OVERLAY:
        tcp = TCPDriver(app, cfg.PEER_PORT)
    http = CommandHandler(app, cfg.HTTP_PORT)
    app.command_handler = http
    query = None
    if cfg.HTTP_QUERY_PORT:
        from stellar_tpu_torch.main.command_handler import QueryServer
        query = QueryServer(app, cfg.HTTP_QUERY_PORT)
    print("stellar_tpu node up: "
          + (f"peer port {tcp.door.port}, " if tcp else "no overlay, ")
          + f"http port {http.port}"
          + (f", query port {query.port}" if query else ""),
          file=sys.stderr)
    if tcp is not None:
        for spec in cfg.KNOWN_PEERS:
            host, _, port = spec.partition(":")
            tcp.connect(host, int(port or 11625))
    app.start()
    try:
        while True:
            app.crank(block=True)
    except KeyboardInterrupt:
        if app.history is not None:
            # a stopping node must not lose cut-but-deferred
            # checkpoints (PUBLISH_TO_ARCHIVE_DELAY)
            app.history.flush_deferred_publishes()
        return 0


def cmd_catchup(args) -> int:
    """Catch up from a local archive (reference ``catchup``)."""
    from stellar_tpu_torch.catchup.catchup import (
        CatchupConfiguration, CatchupWork,
    )
    from stellar_tpu_torch.history.history_manager import archive_from_config
    from stellar_tpu_torch.main.application import Application
    from stellar_tpu_torch.utils.timer import VIRTUAL_TIME, VirtualClock
    from stellar_tpu_torch.work.work import State, WorkScheduler
    cfg = _load_config(args)
    if not cfg.HISTORY_ARCHIVES:
        print("no HISTORY_ARCHIVES configured", file=sys.stderr)
        return 1
    to_ledger, _, mode = args.spec.partition("/")
    app = Application(cfg, clock=VirtualClock(VIRTUAL_TIME))
    ws = WorkScheduler(app.clock)
    target = int(to_ledger) if to_ledger != "current" else 0
    if mode == "minimal":
        conf = CatchupConfiguration(target, CatchupConfiguration.MINIMAL)
    elif mode.isdigit():
        # <ledger>/<count>: CATCHUP_RECENT — buckets + last N replayed
        conf = CatchupConfiguration(target, CatchupConfiguration.RECENT,
                                    count=int(mode))
    else:
        conf = CatchupConfiguration(target, CatchupConfiguration.COMPLETE)
    trusted = None
    if getattr(args, "trusted_checkpoint_hashes", None):
        with open(args.trusted_checkpoint_hashes) as f:
            trusted = {int(seq): hexhash for seq, hexhash in json.load(f)}
        if not trusted:
            # anchoring was requested; an empty file must not silently
            # disable it
            print("trusted-checkpoint-hashes file holds no anchors",
                  file=sys.stderr)
            return 1
    work = CatchupWork(app.lm,
                       archive_from_config(cfg.HISTORY_ARCHIVES[0]),
                       conf, status_manager=app.status_manager,
                       trusted_hashes=trusted)
    ws.schedule(work)
    ws.run_until_done(timeout=3600)
    print(json.dumps({"state": work.state,
                      "ledger": app.lm.ledger_seq,
                      "hash": app.lm.last_closed_hash.hex()}))
    return 0 if work.state == State.SUCCESS else 1


def cmd_print_xdr(args) -> int:
    """Decode an XDR blob file (reference ``print-xdr`` / dumpxdr)."""
    from stellar_tpu_torch.xdr import ledger as xl, tx as xt
    types = {
        "TransactionEnvelope": xt.TransactionEnvelope,
        "LedgerHeader": xl.LedgerHeader,
        "GeneralizedTransactionSet": xl.GeneralizedTransactionSet,
    }
    t = types.get(args.filetype)
    if t is None:
        print(f"unknown type {args.filetype}; one of {list(types)}",
              file=sys.stderr)
        return 1
    from stellar_tpu_torch.xdr.runtime import from_bytes
    with open(args.file, "rb") as f:
        raw = f.read()
    print(repr(from_bytes(t, raw)))
    return 0


def cmd_self_check(args) -> int:
    """Integrity checks (reference ``self-check`` 4 phases,
    ``main/ApplicationUtils.cpp:290-370``): state-hash verification,
    bucket file re-hashing, full store-vs-bucket-list scan, crypto
    benchmark."""
    from stellar_tpu_torch.crypto.keys import (
        sign_ops_per_second, verify_ops_per_second,
    )
    out = {}
    cfg = _load_config(args)
    if cfg.DATABASE:
        import os
        from stellar_tpu_torch.bucket.bucket_manager import BucketManager
        from stellar_tpu_torch.database import Database, NodePersistence
        from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
        bucket_dir = cfg.BUCKET_DIR_PATH or os.path.join(
            os.path.dirname(os.path.abspath(cfg.DATABASE)), "buckets")
        pers = NodePersistence(Database(cfg.DATABASE),
                               BucketManager(bucket_dir))
        lm = LedgerManager.from_persistence(b"\x00" * 32, pers)
        if lm is None:
            out["state"] = "no last closed ledger"
        else:
            # phase 1: bucket list hash chains into the LCL header
            # (p23+: the header commits to live+hot combined)
            from stellar_tpu_torch.bucket.hot_archive import (
                header_bucket_list_hash,
            )
            ok_hash = header_bucket_list_hash(
                lm.bucket_list.hash(), lm.hot_archive,
                lm.last_closed_header.ledgerVersion) == \
                lm.last_closed_header.bucketListHash
            # phase 2: every bucket file re-hashes to its name
            ok_files = True
            checked = 0
            for b in lm.bucket_list.all_buckets():
                if b.is_empty():
                    continue
                from stellar_tpu_torch.bucket.bucket import Bucket
                again = Bucket.deserialize(b.serialize())
                ok_files &= (again.hash == b.hash)
                checked += 1
            # phase 3: store point reads agree with the bucket list
            ok_scan = True
            scanned = 0
            from stellar_tpu_torch.bucket.bucket_list_db import (
                SearchableBucketListSnapshot,
            )
            snap = SearchableBucketListSnapshot.from_bucket_list(
                lm.bucket_list)
            for kb, entry in snap.iter_live_entries():
                got = lm.root.store.get(kb)
                from stellar_tpu_torch.xdr.runtime import to_bytes
                from stellar_tpu_torch.xdr.types import LedgerEntry
                ok_scan &= (got is not None and
                            to_bytes(LedgerEntry, got) ==
                            to_bytes(LedgerEntry, entry))
                scanned += 1
                if scanned >= 10_000:
                    break
            out["state"] = {
                "lcl": lm.ledger_seq,
                "bucket_list_hash_ok": ok_hash,
                "bucket_files_ok": ok_files,
                "bucket_files_checked": checked,
                "store_scan_ok": ok_scan,
                "entries_scanned": scanned,
            }
            if not (ok_hash and ok_files and ok_scan):
                print(json.dumps(out))
                return 1
    # phase 4: crypto benchmark (reference SecretKey::benchmarkOpsPerSecond)
    out["sign_ops_per_sec"] = round(sign_ops_per_second(50), 1)
    out["verify_ops_per_sec"] = round(verify_ops_per_second(50), 1)
    print(json.dumps(out))
    return 0


def cmd_sec_to_pub(args) -> int:
    """Seed (stdin or --conf NODE_SEED) -> public strkey (reference
    ``sec-to-pub``)."""
    from stellar_tpu_torch.crypto.keys import SecretKey
    cfg = _load_config(args)
    if cfg.NODE_SEED is not None:
        sk = cfg.NODE_SEED
    else:
        seed = sys.stdin.readline().strip()
        sk = SecretKey.from_strkey_seed(seed) if seed.startswith("S") \
            else SecretKey.from_seed_str(seed)
    print(sk.public_key.to_strkey())
    return 0


def cmd_convert_id(args) -> int:
    """Translate an id between strkey and hex forms (reference
    ``convert-id``)."""
    from stellar_tpu_torch.crypto import strkey
    ident = args.id
    out = {"input": ident}
    if ident.startswith("G") and len(ident) == 56:
        out["hex"] = strkey.decode_account(ident).hex()
    else:
        raw = bytes.fromhex(ident)
        out["strkey"] = strkey.encode_account(raw)
    print(json.dumps(out))
    return 0


def cmd_http_command(args) -> int:
    """Send a command to a running node's admin port (reference
    ``http-command``)."""
    import urllib.request
    cfg = _load_config(args)
    url = f"http://127.0.0.1:{cfg.HTTP_PORT}/{args.command_line}"
    with urllib.request.urlopen(url, timeout=30) as r:
        sys.stdout.write(r.read().decode() + "\n")
    return 0


def cmd_gen_fuzz(args) -> int:
    """Write a seed corpus entry: one valid signed envelope as raw XDR
    (reference ``gen-fuzz``)."""
    from stellar_tpu_torch.crypto.keys import SecretKey
    from stellar_tpu_torch.tx.tx_test_utils import keypair, make_tx, payment_op
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.tx import TransactionEnvelope
    a, b = keypair("fuzz-seed-a"), keypair("fuzz-seed-b")
    frame = make_tx(a, (1 << 32) + 1, [payment_op(b, 10_000_000)])
    with open(args.file, "wb") as f:
        f.write(to_bytes(TransactionEnvelope, frame.envelope))
    print(json.dumps({"written": args.file}))
    return 0


def cmd_fuzz(args) -> int:
    """Deterministic fuzz campaign (reference ``fuzz`` CLI +
    FuzzerImpl tx/overlay modes)."""
    from stellar_tpu_torch.main.fuzz import run_fuzz
    out = run_fuzz(args.mode, args.iterations, args.seed)
    print(json.dumps(out))
    return 1 if out["crashes"] else 0


def cmd_new_db(args) -> int:
    """(Re)initialize the node database (reference ``new-db``)."""
    import os
    cfg = _load_config(args)
    if not cfg.DATABASE:
        print("config has no DATABASE", file=sys.stderr)
        return 1
    for suffix in ("", "-wal", "-shm"):
        path = cfg.DATABASE + suffix
        if os.path.exists(path):
            os.unlink(path)
    from stellar_tpu_torch.database import Database
    Database(cfg.DATABASE).close()
    print(json.dumps({"database": cfg.DATABASE, "status": "initialized"}))
    return 0


def cmd_dump_ledger(args) -> int:
    """Dump committed ledger entries from a persisted node (reference
    ``dump-ledger``)."""
    from stellar_tpu_torch.bucket.bucket_manager import BucketManager
    from stellar_tpu_torch.database import Database, NodePersistence
    from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
    import os
    cfg = _load_config(args)
    if not cfg.DATABASE:
        print("config has no DATABASE", file=sys.stderr)
        return 1
    bucket_dir = cfg.BUCKET_DIR_PATH or os.path.join(
        os.path.dirname(os.path.abspath(cfg.DATABASE)), "buckets")
    pers = NodePersistence(Database(cfg.DATABASE),
                           BucketManager(bucket_dir))
    lm = LedgerManager.from_persistence(b"\x00" * 32, pers)
    if lm is None:
        print("database has no last closed ledger", file=sys.stderr)
        return 1
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.types import LedgerEntry, LedgerEntryType
    limit = args.limit
    count = 0
    snapshot = lm.bucket_list
    from stellar_tpu_torch.bucket.bucket_list_db import (
        SearchableBucketListSnapshot,
    )
    predicate = None
    if getattr(args, "filter", None):
        from stellar_tpu_torch.utils.xdrquery import compile_query
        predicate = compile_query(args.filter)
    snap = SearchableBucketListSnapshot.from_bucket_list(snapshot)
    for kb, entry in snap.iter_live_entries():
        if count >= limit:
            break
        if predicate is not None and not predicate(entry):
            continue
        print(json.dumps({
            "type": LedgerEntryType.name_of(entry.data.arm),
            "key": kb.hex(),
            "entry": to_bytes(LedgerEntry, entry).hex()}))
        count += 1
    print(json.dumps({"lcl": lm.ledger_seq, "dumped": count}),
          file=sys.stderr)
    return 0


def cmd_sign_transaction(args) -> int:
    """Add this node's signature to an envelope file (reference
    ``sign-transaction``)."""
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
    from stellar_tpu_torch.xdr.tx import (
        TransactionEnvelope, transaction_sig_payload,
    )
    cfg = _load_config(args)
    if cfg.NODE_SEED is None:
        print("config has no NODE_SEED", file=sys.stderr)
        return 1
    with open(args.file, "rb") as f:
        env = from_bytes(TransactionEnvelope, f.read())
    network_id = cfg.network_id()
    payload = transaction_sig_payload(network_id, env.value.tx)
    env.value.signatures.append(
        cfg.NODE_SEED.sign_decorated(sha256(payload)))
    out = to_bytes(TransactionEnvelope, env)
    sys.stdout.write(out.hex() + "\n")
    return 0


def cmd_verify_checkpoints(args) -> int:
    """Walk an archive's header chain backwards from its HAS, verifying
    every previousLedgerHash link; optionally write the verified
    checkpoint hashes as a trust anchor file (reference
    ``verify-checkpoints`` / ``WriteVerifiedCheckpointHashesWork``:
    ``[[seq, hex], ...]`` newest first, consumed by
    ``catchup --trusted-checkpoint-hashes``)."""
    from stellar_tpu_torch.history.history_manager import (
        FileArchive, HistoryManager, checkpoint_containing,
        is_last_in_checkpoint,
    )
    from stellar_tpu_torch.xdr.ledger import ledger_header_hash
    archive = FileArchive(args.archive)
    has = HistoryManager.get_root_has(archive)
    if has is None:
        print("archive has no root HAS", file=sys.stderr)
        return 1
    verified = 0
    expected_hash = None
    checkpoint_hashes = []  # [(seq, hex)], newest first
    cp = checkpoint_containing(has.current_ledger)
    while cp >= 63:
        chk = HistoryManager.get_checkpoint(archive, cp)
        if chk is None:
            break
        headers = chk[0]
        for he in reversed(headers):
            got = ledger_header_hash(he.header)
            if got != he.hash:
                print(json.dumps({"error": "header hash mismatch",
                                  "ledger": he.header.ledgerSeq}))
                return 1
            if expected_hash is not None and got != expected_hash:
                print(json.dumps({"error": "chain broken",
                                  "ledger": he.header.ledgerSeq}))
                return 1
            if is_last_in_checkpoint(he.header.ledgerSeq):
                checkpoint_hashes.append(
                    [he.header.ledgerSeq, got.hex()])
            expected_hash = he.header.previousLedgerHash
            verified += 1
        cp -= 64
    complete = cp < 63  # the walk reached the first checkpoint
    if getattr(args, "output", None):
        if not complete or not checkpoint_hashes:
            # never write a partial anchor file: a gap would leave
            # older history silently unguarded
            print(json.dumps({
                "error": "archive walk incomplete (missing checkpoint "
                         f"{cp}); refusing to write partial anchors"}))
            return 1
        with open(args.output, "w") as f:
            json.dump(checkpoint_hashes, f)
    print(json.dumps({"verified_headers": verified,
                      "tip": has.current_ledger,
                      "complete": complete,
                      "checkpoints": len(checkpoint_hashes)}))
    return 0


def cmd_check_quorum_intersection(args) -> int:
    """Offline safety analysis (reference ``check-quorum-intersection``,
    ``CommandLine.cpp``): JSON file {node strkey: {"THRESHOLD": n,
    "VALIDATORS": [strkey...], "INNER_SETS": [...]}} -> enjoys/split."""
    from stellar_tpu_torch.crypto import strkey
    from stellar_tpu_torch.herder.quorum_intersection import (
        QuorumIntersectionChecker,
    )
    from stellar_tpu_torch.scp.quorum import make_node_id
    from stellar_tpu_torch.xdr.scp import SCPQuorumSet

    def parse_qset(d):
        return SCPQuorumSet(
            threshold=d["THRESHOLD"],
            validators=[make_node_id(strkey.decode_account(v))
                        for v in d.get("VALIDATORS", [])],
            innerSets=[parse_qset(i) for i in d.get("INNER_SETS", [])])

    with open(args.file) as f:
        raw = json.load(f)
    qmap = {strkey.decode_account(k): parse_qset(v)
            for k, v in raw.items()}
    qic = QuorumIntersectionChecker(qmap)
    ok = qic.network_enjoys_quorum_intersection()
    out = {"node_count": len(qmap),
           "quorum_found": qic.quorum_found,
           "enjoys_quorum_intersection": ok}
    if not ok:
        out["split"] = [[strkey.encode_account(n) for n in side]
                        for side in qic.last_split]
    print(json.dumps(out))
    return 0 if ok else 1


def cmd_apply_load(args) -> int:
    """Benchmark scenarios (reference ``apply-load`` +
    performance-eval methodology): close = synthetic-queue closeLedger
    distribution; catchup = BASELINE #3 replay; scp-storm = BASELINE #4
    16-validator consensus rounds."""
    from stellar_tpu_torch.simulation.load_generator import (
        apply_load, catchup_replay_bench, multisig_apply_load,
        scp_storm_bench, soroban_apply_load, soroban_compute_load,
    )
    cfg = _load_config(args) if getattr(args, "conf", None) else None
    if cfg is not None:
        # APPLY_LOAD_* overrides (reference apply-load reading Config):
        # retune the process-wide soroban limits the scenarios build on
        import dataclasses
        from stellar_tpu_torch.tx.ops import soroban_ops
        overrides = {}
        for cfg_name, field_name in (
                ("APPLY_LOAD_TX_MAX_INSTRUCTIONS",
                 "tx_max_instructions"),
                ("APPLY_LOAD_LEDGER_MAX_INSTRUCTIONS",
                 "ledger_max_instructions"),
                ("APPLY_LOAD_TX_MAX_READ_LEDGER_ENTRIES",
                 "tx_max_read_ledger_entries"),
                ("APPLY_LOAD_TX_MAX_WRITE_LEDGER_ENTRIES",
                 "tx_max_write_ledger_entries"),
                ("APPLY_LOAD_TX_MAX_READ_BYTES", "tx_max_read_bytes"),
                ("APPLY_LOAD_TX_MAX_WRITE_BYTES",
                 "tx_max_write_bytes"),
                ("APPLY_LOAD_MAX_TX_COUNT", "ledger_max_tx_count"),
                ("APPLY_LOAD_MAX_TX_SIZE_BYTES", "tx_max_size_bytes"),
                ("APPLY_LOAD_MAX_LEDGER_TX_SIZE_BYTES",
                 "ledger_max_txs_size_bytes"),
                ("APPLY_LOAD_MAX_CONTRACT_EVENT_SIZE_BYTES",
                 "tx_max_contract_events_size_bytes"),
                ("APPLY_LOAD_LEDGER_MAX_READ_LEDGER_ENTRIES",
                 "ledger_max_read_ledger_entries"),
                ("APPLY_LOAD_LEDGER_MAX_READ_BYTES",
                 "ledger_max_read_bytes"),
                ("APPLY_LOAD_LEDGER_MAX_WRITE_LEDGER_ENTRIES",
                 "ledger_max_write_ledger_entries"),
                ("APPLY_LOAD_LEDGER_MAX_WRITE_BYTES",
                 "ledger_max_write_bytes"),
                ("APPLY_LOAD_DATA_ENTRY_SIZE_FOR_TESTING",
                 "max_contract_data_entry_size")):
            v = getattr(cfg, cfg_name, 0)
            if v:
                overrides[field_name] = v
        if overrides:
            base = soroban_ops.default_soroban_config()
            soroban_ops._DEFAULT_CONFIG = dataclasses.replace(
                base, **overrides)
    # the card is the default wherever one answers the probe; "host"
    # forces the host oracle even for large batches (the CPU baseline
    # side of the A/B)
    from stellar_tpu_torch.crypto.batch_verifier import select_verifier
    select_verifier(getattr(args, "verify", "auto"))
    if args.scenario == "catchup":
        stats = catchup_replay_bench(n_ledgers=args.ledgers,
                                     txs_per_ledger=args.txs)
    elif args.scenario == "scp-storm":
        stats = scp_storm_bench(n_validators=16, n_rounds=args.ledgers)
    elif args.scenario == "multisig":
        stats = multisig_apply_load(n_ledgers=args.ledgers,
                                    txs_per_ledger=args.txs)
    elif args.scenario == "soroban":
        stats = soroban_apply_load(
            n_ledgers=args.ledgers, txs_per_ledger=args.txs,
            use_wasm=args.wasm, config=cfg)
    elif args.scenario == "compute":
        stats = soroban_compute_load(n_ledgers=args.ledgers,
                                     txs_per_ledger=args.txs,
                                     use_wasm=args.wasm)
    else:
        stats = apply_load(n_ledgers=args.ledgers,
                           txs_per_ledger=args.txs)
    print(json.dumps(stats))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="stellar_tpu",
        description="TPU-native stellar-core-class node")
    p.add_argument("--conf", help="TOML config file")
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("version").set_defaults(fn=cmd_version)
    sub.add_parser("gen-seed").set_defaults(fn=cmd_gen_seed)
    sub.add_parser("run").set_defaults(fn=cmd_run)
    sp = sub.add_parser("catchup")
    sp.add_argument("spec", help="<ledger>/<mode: complete|minimal>")
    sp.add_argument("--trusted-checkpoint-hashes",
                    dest="trusted_checkpoint_hashes",
                    help="verify-checkpoints --output file: refuse "
                    "archives whose checkpoints diverge from it")
    sp.set_defaults(fn=cmd_catchup)
    sp = sub.add_parser("print-xdr")
    sp.add_argument("file")
    sp.add_argument("--filetype", default="TransactionEnvelope")
    sp.set_defaults(fn=cmd_print_xdr)
    sub.add_parser("self-check").set_defaults(fn=cmd_self_check)
    sub.add_parser("new-db").set_defaults(fn=cmd_new_db)
    sub.add_parser("sec-to-pub").set_defaults(fn=cmd_sec_to_pub)
    sp = sub.add_parser("convert-id")
    sp.add_argument("id")
    sp.set_defaults(fn=cmd_convert_id)
    sp = sub.add_parser("http-command")
    sp.add_argument("command_line", help="e.g. 'info' or 'll?level=debug'")
    sp.set_defaults(fn=cmd_http_command)
    sp = sub.add_parser("gen-fuzz")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_gen_fuzz)
    sp = sub.add_parser("fuzz")
    sp.add_argument("--mode", choices=["tx", "overlay", "wasm"],
                    default="tx")
    sp.add_argument("--iterations", type=int, default=1000)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_fuzz)
    sp = sub.add_parser("dump-ledger")
    sp.add_argument("--limit", type=int, default=1000)
    sp.add_argument("--filter", help="xdrquery, e.g. "
                    "\"type=='ACCOUNT' && data.balance > 1000000\"")
    sp.set_defaults(fn=cmd_dump_ledger)
    sp = sub.add_parser("sign-transaction")
    sp.add_argument("file", help="binary TransactionEnvelope XDR")
    sp.set_defaults(fn=cmd_sign_transaction)
    sp = sub.add_parser("verify-checkpoints")
    sp.add_argument("archive", help="archive directory")
    sp.add_argument("--output", help="write verified [[seq, hash]] "
                    "trust anchors (newest first)")
    sp.set_defaults(fn=cmd_verify_checkpoints)
    sp = sub.add_parser("check-quorum-intersection")
    sp.add_argument("file", help="JSON quorum map")
    sp.set_defaults(fn=cmd_check_quorum_intersection)
    sp = sub.add_parser("apply-load")
    sp.add_argument("--ledgers", type=int, default=10)
    sp.add_argument("--txs", type=int, default=100)
    sp.add_argument("--scenario", default="close",
                    choices=["close", "catchup", "scp-storm",
                             "multisig", "soroban", "compute"])
    sp.add_argument("--wasm", action="store_true",
                    help="soroban/compute scenarios run a compiled "
                         "wasm contract (native engine when built)")
    sp.add_argument("--verify", default="auto",
                    choices=["auto", "host", "device"],
                    help="signature verification routing: auto = "
                    "device for large batches only; host / device "
                    "force one side of the A/B")
    sp.set_defaults(fn=cmd_apply_load)
    from stellar_tpu_torch.main.cli_offline import register as register_offline
    register_offline(sub)
    args = p.parse_args(argv)
    return args.fn(args)
