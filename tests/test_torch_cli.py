"""The port's operator surface against the reference's: ``python -m
stellar_tpu_torch``, the CLI (``main/cli.py``) and its offline commands
(``main/cli_offline.py``), ``utils/xdrquery.py``,
``main/settings_upgrade.py`` and the HTTP admin routes
(``main/command_handler.py``).

Each module is the reference's with the port's imports
(``_torch_port.check_copy``), but for ``cli.cmd_apply_load``, whose
default ``--verify auto`` takes the card wherever one answers.
``main(argv)`` of both packages prints the
same JSON for the commands that need no node, and, on a persisted
standalone node that each package builds from the same genesis and the
same transactions (``vectors.operator_genesis`` and ``operator_rounds``
cut to a few accounts, then empty ledgers to checkpoint 63 at fixed close
times, so both chains are the same bytes), for ``offline-info``,
``dump-ledger --filter``, the state half of ``self-check``,
``print-publish-queue`` and ``publish``, and ``catchup 63/complete`` into
a fresh database, whose printed hash is ledger 63's. The port's node runs
as a user starts it, ``python -m stellar_tpu_torch --conf <file> run``,
and takes the same transactions over its ``tx`` route. Its
``CommandHandler`` answers on a port ``Application`` as the reference's
does. ``chip_smoke.py`` phase 27's pin, the accounts after config 1's
three ledgers at full width, is recomputed by a ``slow`` test with both
packages. Both packages verify with their oracles and the port hashes
on the CPU; no JAX program is compiled."""

import base64
import importlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.crypto import vectors

from tests._torch_node import Side
from tests._torch_port import ROOT, check_copy

PORT, REF = Side("stellar_tpu_torch"), Side("stellar_tpu")
PASSPHRASE = "Standalone stellar_tpu Network"   # Config's default
# the tier-1 chain's accounts; the card's arm and the pin take 100
SMALL = 6

MODULES = ["utils/xdrquery.py", "main/settings_upgrade.py",
           "main/command_handler.py", "main/cli_offline.py",
           "main/cli.py", "__main__.py"]

_REAL_HASH_MANY = pbh.hash_many


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


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


def _mod(side, rel):
    return importlib.import_module(f"{side.package}.{rel}")


def _cli(side, argv, capsys, stdin=None, monkeypatch=None):
    """``main(argv)`` of one package: its exit code and what it printed."""
    capsys.readouterr()
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = _mod(side, "main.cli").main(argv)
    return rc, capsys.readouterr().out


# ---------------- commands that need no node ----------------

def _stateless_argv(case, tmp_path):
    """The ``argv`` of one case; its input files written by the port."""
    from stellar_tpu_torch.tx.tx_test_utils import keypair, make_tx, \
        payment_op
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.tx import TransactionEnvelope
    alice = keypair("cli-alice")
    if case == "version":
        return ["version"]
    if case == "convert-id-strkey":
        return ["convert-id", alice.public_key.to_strkey()]
    if case == "convert-id-hex":
        return ["convert-id", alice.public_key.raw.hex()]
    if case == "print-xdr":
        path = tmp_path / "tx.xdr"
        frame = make_tx(alice, (1 << 32) + 1,
                        [payment_op(keypair("cli-bob"), 12_345)])
        path.write_bytes(to_bytes(TransactionEnvelope, frame.envelope))
        return ["print-xdr", str(path)]
    if case == "encode-asset":
        return ["encode-asset", "--code", "EURO5", "--issuer",
                alice.public_key.to_strkey()]
    if case == "encode-asset-native":
        return ["encode-asset"]
    if case == "check-quorum-intersection":
        names = [keypair(f"qic-{i}").public_key.to_strkey()
                 for i in range(4)]
        qmap = {n: {"THRESHOLD": 3, "VALIDATORS": names} for n in names}
        path = tmp_path / "qmap.json"
        path.write_text(json.dumps(qmap))
        return ["check-quorum-intersection", str(path)]
    if case == "check-quorum-intersection-split":
        names = [keypair(f"qic-{i}").public_key.to_strkey()
                 for i in range(4)]
        qmap = {n: {"THRESHOLD": 2, "VALIDATORS": names[:2] if i < 2
                    else names[2:]} for i, n in enumerate(names)}
        path = tmp_path / "qmap.json"
        path.write_text(json.dumps(qmap))
        return ["check-quorum-intersection", str(path)]
    assert case == "get-settings-upgrade-txs"
    from stellar_tpu_torch.xdr.contract import (
        ConfigSettingContractExecutionLanesV0, ConfigSettingEntry,
        ConfigSettingID, ConfigUpgradeSet)
    upgrade = ConfigUpgradeSet(updatedEntry=[ConfigSettingEntry.make(
        ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES,
        ConfigSettingContractExecutionLanesV0(ledgerMaxTxCount=77))])
    path = tmp_path / "upgrade.xdr"
    path.write_bytes(to_bytes(ConfigUpgradeSet, upgrade))
    return ["get-settings-upgrade-txs", str(path), "--ledger-seq", "10",
            "--contract-id", "ab" * 32]


@pytest.mark.parametrize("case", [
    "version", "convert-id-strkey", "convert-id-hex", "print-xdr",
    "encode-asset", "encode-asset-native", "check-quorum-intersection",
    "check-quorum-intersection-split", "get-settings-upgrade-txs"])
def test_stateless_commands_equal_reference(case, tmp_path, capsys):
    """The same ``argv`` through both packages' ``main``: the same exit
    code and the same output (JSON, or the decoded value's ``repr``)."""
    argv = _stateless_argv(case, tmp_path)
    (rc_p, out_p), (rc_r, out_r) = [_cli(s, argv, capsys)
                                    for s in (PORT, REF)]
    assert (rc_p, out_p) == (rc_r, out_r)
    assert rc_p == (1 if case.endswith("-split") else 0) and out_p


def test_sec_to_pub_equals_reference(capsys, monkeypatch):
    """``sec-to-pub`` reads a seed from standard input."""
    seed = PORT.keys.SecretKey.from_seed_str("cli-seed").to_strkey_seed()
    outs = [_cli(s, ["sec-to-pub"], capsys, stdin=seed + "\n",
                 monkeypatch=monkeypatch) for s in (PORT, REF)]
    assert outs[0] == outs[1]
    assert outs[0][1].strip() == \
        PORT.keys.SecretKey.from_strkey_seed(seed).public_key.to_strkey()


def test_compile_query_equals_reference():
    """``compile_query`` of both packages over the same entries, each
    package's entry decoded from the same bytes: the same verdicts, and
    the same refusal of a malformed query."""
    from stellar_tpu_torch.tx.ops.create_account import new_account_entry
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.types import LedgerEntry, account_id
    blobs = [to_bytes(LedgerEntry, new_account_entry(
        account_id(bytes([i]) * 32), 10 ** i, 7 + i)) for i in range(1, 6)]
    queries = ["type == 'ACCOUNT' && data.balance > 1000",
               "type == 'TRUSTLINE'", "data.seqNum == 9",
               "data.accountID == " + "03" * 32,
               "data.balance <= 100 && data.seqNum != 8"]
    got = {}
    for side in (PORT, REF):
        xq = _mod(side, "utils.xdrquery")
        entries = [side.rt.from_bytes(side.xt.LedgerEntry, b)
                   for b in blobs]
        got[side.package] = [[xq.compile_query(q)(e) for e in entries]
                             for q in queries]
        with pytest.raises(ValueError):
            xq.compile_query("not a query")
    assert got[PORT.package] == got[REF.package]
    assert any(any(row) for row in got[PORT.package])
    assert not all(all(row) for row in got[PORT.package])


@pytest.mark.parametrize("card", [True, False])
def test_apply_load_verifies_on_the_card_by_default(monkeypatch, capsys,
                                                    card):
    """The port's ``apply-load`` with its default ``--verify`` puts the
    device batch verifier behind ``verify_sig`` wherever a card answers
    the probe, and leaves the reference's routing (none installed) where
    none does. The probe's answer is patched, the verifier is one on the
    CPU and the scenario is stubbed: nothing launches."""
    from stellar_tpu_torch.crypto import batch_verifier
    from stellar_tpu_torch.simulation import load_generator
    verifier = batch_verifier.BatchVerifier(device="cpu")
    monkeypatch.setattr(batch_verifier, "default_verifier",
                        lambda device=None: verifier)
    monkeypatch.setattr(batch_verifier, "device_available", lambda: card)
    monkeypatch.setattr(load_generator, "apply_load",
                        lambda **kwargs: {"scenario": kwargs})
    PORT.keys.set_verifier_backend(None)
    rc, out = _cli(PORT, ["apply-load", "--ledgers", "1", "--txs", "3"],
                   capsys)
    assert rc == 0 and json.loads(out) == {
        "scenario": {"n_ledgers": 1, "txs_per_ledger": 3}}
    if card:
        assert PORT.keys.get_verifier_backend_name() == "device-batch"
        assert PORT.keys._backend.__self__ is verifier
    else:
        assert PORT.keys._backend is None


# ---------------- a persisted standalone node ----------------

def _network_id(side):
    return _mod(side, "crypto.sha").sha256(PASSPHRASE.encode())


def _genesis(side, database, bucket_dir):
    """``vectors.operator_genesis`` with ``side``'s modules."""
    if side is PORT:
        return vectors.operator_genesis(database, bucket_dir, PASSPHRASE)
    bm = _mod(side, "bucket.bucket_manager")
    dbm = _mod(side, "database")
    ts = _mod(side, "herder.tx_set")
    lmm = _mod(side, "ledger.ledger_manager")
    db = dbm.Database(database)
    try:
        root = side.tu.seed_root_with_accounts(
            [(side.keys.SecretKey.from_seed_str(PASSPHRASE),
              vectors.OPERATOR_TOTAL_COINS)])
        header = root.header()
        header.ledgerVersion = _mod(
            side, "protocol").CURRENT_LEDGER_PROTOCOL_VERSION
        header.maxTxSetSize = vectors.OPERATOR_MAX_TX_SET_SIZE
        lm = lmm.LedgerManager(
            _network_id(side), root,
            persistence=dbm.NodePersistence(db, bm.BucketManager(
                bucket_dir)))
        lcl = lm.last_closed_header
        tx_set, _ = ts.make_tx_set_from_transactions(
            [], lcl, lm.last_closed_hash)
        lm.close_ledger(lmm.LedgerCloseData(
            ledger_seq=lcl.ledgerSeq + 1, tx_set=tx_set,
            close_time=lcl.scpValue.closeTime + 5))
        return lm.ledger_seq, lm.last_closed_hash.hex()
    finally:
        db.close()


def _rounds_blobs(n):
    """``vectors.operator_rounds`` as envelope XDR blobs, a list a
    ledger."""
    from stellar_tpu_torch.xdr.runtime import to_bytes
    from stellar_tpu_torch.xdr.tx import TransactionEnvelope
    return [[to_bytes(TransactionEnvelope, f.envelope) for f in frames]
            for frames in vectors.operator_rounds(PASSPHRASE, n)]


def _close(side, lm, blobs):
    """One ledger of ``blobs`` closed on ``lm`` at the last close time
    plus 5: the close's result."""
    ts = _mod(side, "herder.tx_set")
    lmm = _mod(side, "ledger.ledger_manager")
    tf = _mod(side, "tx.transaction_frame")
    xtx = _mod(side, "xdr.tx")
    frames = [tf.make_transaction_frame(
        lm.network_id, side.rt.from_bytes(xtx.TransactionEnvelope, b))
        for b in blobs]
    lcl = lm.last_closed_header
    tx_set, _ = ts.make_tx_set_from_transactions(frames, lcl,
                                                 lm.last_closed_hash)
    return lm.close_ledger(lmm.LedgerCloseData(
        ledger_seq=lcl.ledgerSeq + 1, tx_set=tx_set,
        close_time=lcl.scpValue.closeTime + 5))


def _accounts(side, lm, n):
    """``(strkey, balance, seqNum)`` of the root and the ``n`` accounts
    in ``lm``'s state."""
    keys = [side.keys.SecretKey.from_seed_str(name)
            for name in [PASSPHRASE] + vectors.operator_names(n)]
    out = []
    for k in keys:
        e = lm.root.store.get(side.lt.key_bytes(side.opf.account_key(
            side.xt.account_id(k.public_key.raw))))
        out.append((k.public_key.to_strkey(), e.data.value.balance,
                    e.data.value.seqNum))
    return out


def _write_conf(path, database, bucket_dir, archive, **extra):
    lines = [f'NETWORK_PASSPHRASE = "{PASSPHRASE}"',
             f'DATABASE = "{database}"', f'BUCKET_DIR_PATH = "{bucket_dir}"',
             f'HISTORY_ARCHIVES = ["{archive}"]']
    lines += [f"{k} = {json.dumps(v)}" for k, v in extra.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _chain(side, tmp, n, last=vectors.OPERATOR_CHECKPOINT):
    """``side``'s persisted node: the genesis, the three transaction
    ledgers of ``n`` accounts and empty ledgers to ``last``. Returns its
    config file, the genesis, each ledger's header hash (hex), the
    applied count of each transaction ledger and the accounts."""
    bm = _mod(side, "bucket.bucket_manager")
    dbm = _mod(side, "database")
    lmm = _mod(side, "ledger.ledger_manager")
    database, buckets = str(tmp / "node.db"), str(tmp / "buckets")
    genesis = _genesis(side, database, buckets)
    db = dbm.Database(database)
    lm = lmm.LedgerManager.from_persistence(
        _network_id(side), dbm.NodePersistence(db, bm.BucketManager(buckets)))
    hashes, applied = {}, []
    for blobs in _rounds_blobs(n):
        res = _close(side, lm, blobs)
        applied.append(res.applied_count)
        hashes[lm.ledger_seq] = lm.last_closed_hash.hex()
    while lm.ledger_seq < last:
        _close(side, lm, [])
        hashes[lm.ledger_seq] = lm.last_closed_hash.hex()
    accounts = _accounts(side, lm, n)
    db.close()
    conf = _write_conf(tmp / "node.toml", database, buckets,
                       tmp / "archive")
    return conf, genesis, hashes, applied, accounts


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both packages' persisted nodes over ``SMALL`` accounts."""
    saved = (REF.keys._backend, PORT.keys._backend)
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    real = pbh.hash_many
    pbh.hash_many = _cpu_hash_many
    try:
        return {side.package: _chain(side, tmp_path_factory.mktemp(
            side.package), SMALL) for side in (PORT, REF)}
    finally:
        pbh.hash_many = real
        REF.keys.set_verifier_backend(saved[0])
        PORT.keys.set_verifier_backend(saved[1])


def test_chains_are_the_same_bytes(chains):
    """The two packages' genesis, every ledger's header hash, the applied
    counts and the accounts are the same."""
    port, ref = chains[PORT.package], chains[REF.package]
    assert port[1:] == ref[1:]
    assert port[1][0] == vectors.OPERATOR_GENESIS_SEQ
    assert port[3] == [1, SMALL, SMALL]
    assert max(port[2]) == vectors.OPERATOR_CHECKPOINT


def test_offline_info_and_dump_ledger_equal_reference(chains, capsys):
    """``offline-info`` and ``dump-ledger --filter "type=='ACCOUNT'"`` on
    each package's node: the same JSON, ledger 63 and its hash, and the
    dumped accounts' balances and sequence numbers the chain's."""
    outs = {}
    for side in (PORT, REF):
        conf = chains[side.package][0]
        rc, info = _cli(side, ["--conf", conf, "offline-info"], capsys)
        assert rc == 0
        rc, dump = _cli(side, ["--conf", conf, "dump-ledger", "--filter",
                               "type=='ACCOUNT'"], capsys)
        assert rc == 0
        outs[side.package] = (json.loads(info), dump)
    assert outs[PORT.package] == outs[REF.package]
    info, dump = outs[PORT.package]
    assert info["ledger"]["seq"] == vectors.OPERATOR_CHECKPOINT
    assert info["ledger"]["hash"] == \
        chains[PORT.package][2][vectors.OPERATOR_CHECKPOINT]
    from stellar_tpu_torch.crypto import strkey
    from stellar_tpu_torch.xdr.runtime import from_bytes
    from stellar_tpu_torch.xdr.types import LedgerEntry
    dumped = []
    for line in dump.splitlines():
        e = from_bytes(LedgerEntry, bytes.fromhex(json.loads(line)["entry"]))
        dumped.append((strkey.encode_account(e.data.value.accountID.value),
                       e.data.value.balance, e.data.value.seqNum))
    assert sorted(dumped) == sorted(chains[PORT.package][4])


def test_self_check_state_equals_reference(chains, capsys):
    """``self-check``'s state half on each package's node: every check
    true, the same counts."""
    states = []
    for side in (PORT, REF):
        rc, out = _cli(side, ["--conf", chains[side.package][0],
                              "self-check"], capsys)
        assert rc == 0
        states.append(json.loads(out.splitlines()[-1])["state"])
    assert states[0] == states[1]
    assert states[0]["bucket_list_hash_ok"] and \
        states[0]["bucket_files_ok"] and states[0]["store_scan_ok"]
    assert states[0]["lcl"] == vectors.OPERATOR_CHECKPOINT


def test_publish_and_catchup_complete_equal_reference(chains, tmp_path,
                                                      capsys):
    """``print-publish-queue`` and ``publish`` on each package's node
    (checkpoint 63 queued, then published with its state), then
    ``catchup 63/complete`` through each package's CLI into a fresh
    database holding only the genesis: the printed hash is ledger 63's,
    the same in both."""
    got = {}
    for side in (PORT, REF):
        conf, _genesis_, hashes, _a, _acc = chains[side.package]
        rc, queue = _cli(side, ["--conf", conf, "print-publish-queue"],
                         capsys)
        assert rc == 0 and json.loads(queue)["queue"] == [63]
        rc, pub = _cli(side, ["--conf", conf, "publish"], capsys)
        assert rc == 0
        assert json.loads(pub)["published_checkpoints"] == [63]
        assert json.loads(pub)["has_written"] is True
        fresh = tmp_path / side.package
        fresh.mkdir()
        archive = os.path.join(os.path.dirname(conf), "archive")
        conf2 = _write_conf(fresh / "node.toml", fresh / "node.db",
                            fresh / "buckets", archive)
        assert _genesis(side, str(fresh / "node.db"),
                        str(fresh / "buckets")) == _genesis_
        rc, out = _cli(side, ["--conf", conf2, "catchup", "63/complete"],
                       capsys)
        out = json.loads(out.splitlines()[-1])
        assert rc == 0 and out["ledger"] == 63, out
        assert out["hash"] == hashes[63]
        got[side.package] = out
    assert got[PORT.package] == got[REF.package]


@pytest.mark.slow
def test_operator_pin_is_the_reference_state():
    """``chip_smoke.py`` phase 27 (a)'s pin: the reference's closes of
    ``vectors.operator_rounds`` at full width (100 accounts) over the
    genesis, in memory, each payment ledger applying 100; the port's give
    the same accounts."""
    blobs = _rounds_blobs(vectors.OPERATOR_ACCOUNTS)
    digests = []
    for side in (REF, PORT):
        root = side.tu.seed_root_with_accounts(
            [(side.keys.SecretKey.from_seed_str(PASSPHRASE),
              vectors.OPERATOR_TOTAL_COINS)])
        header = root.header()
        header.ledgerVersion = _mod(
            side, "protocol").CURRENT_LEDGER_PROTOCOL_VERSION
        header.maxTxSetSize = vectors.OPERATOR_MAX_TX_SET_SIZE
        lm = _mod(side, "ledger.ledger_manager").LedgerManager(
            _network_id(side), root)
        _close(side, lm, [])
        applied = [_close(side, lm, b).applied_count for b in blobs]
        assert applied == [1, 100, 100]
        digests.append(vectors.operator_state_digest(
            _accounts(side, lm, vectors.OPERATOR_ACCOUNTS)))
    assert digests == [vectors.OPERATOR_STATE_DIGEST] * 2


# ---------------- the port's node, started as a user starts it ----------

def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{route}",
                                timeout=60) as r:
        body = r.read().decode()
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        return body


def _blob(raw):
    return urllib.parse.quote(base64.b64encode(raw).decode())


def test_run_takes_transactions_over_http(tmp_path):
    """``python -m stellar_tpu_torch --conf <file> run`` in a process of
    its own, its database given the genesis, standalone with manual
    close and its HTTP port bound at 0 (read from its ``node up:``
    line): the root's transaction and two rounds of ``SMALL`` payments
    over the ``tx`` route each answer ``PENDING`` and close on
    ``manualclose``; ``info``, ``quorum``, ``dispatch``, ``metrics`` and
    its Prometheus form answer; the accounts from ``testacc`` equal the
    persisted chain's; SIGINT stops it with exit code 0."""
    database, buckets = tmp_path / "node.db", tmp_path / "buckets"
    vectors.operator_genesis(str(database), str(buckets), PASSPHRASE)
    conf = _write_conf(
        tmp_path / "node.toml", database, buckets, tmp_path / "archive",
        RUN_STANDALONE=True, MANUAL_CLOSE=True, NODE_SEED="operator-node",
        HTTP_PORT=0, MODE_AUTO_STARTS_OVERLAY=False,
        EXPECTED_LEDGER_CLOSE_TIME=3600)
    proc = subprocess.Popen(
        [sys.executable, "-m", "stellar_tpu_torch", "--conf", conf, "run"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    up = threading.Event()

    def drain():
        for line in proc.stderr:
            lines.append(line)
            if "node up:" in line:
                up.set()
        up.set()
    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        assert up.wait(120) and proc.poll() is None, "".join(lines)
        port = int(next(ln for ln in lines if "node up:" in ln)
                   .rsplit("http port ", 1)[1].split(",")[0])
        assert _get(port, "info")["ledger"]["num"] == \
            vectors.OPERATOR_GENESIS_SEQ
        for blobs in _rounds_blobs(SMALL):
            for raw in blobs:
                assert _get(port, f"tx?blob={_blob(raw)}") == \
                    {"status": "PENDING"}
            seq = _get(port, "info")["ledger"]["num"]
            assert _get(port, "manualclose") == {"ledger": seq + 1}
        assert _get(port, "quorum")["threshold"] == 1
        assert "engines" in _get(port, "dispatch")
        assert isinstance(_get(port, "metrics"), dict)
        assert "# TYPE" in _get(port, "metrics?format=prometheus")
        accounts = []
        for name in [PASSPHRASE] + vectors.operator_names(SMALL):
            acc = _get(port, "testacc?name=" + urllib.parse.quote(name))
            accounts.append((acc["id"], acc["balance"], acc["seqnum"]))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        rc = proc.wait(60)
        reader.join(10)
    assert rc == 0, "".join(lines)[-3000:]
    (tmp_path / "chain").mkdir()
    chain = _chain(PORT, tmp_path / "chain", SMALL, last=6)
    assert sorted(accounts) == sorted(chain[4])


# ---------------- the admin routes on an Application ----------------

def test_command_handler_routes(capsys):
    """The port's ``CommandHandler`` on a port ``Application`` cranked
    on a thread of real time: ``info``, a payment over ``tx``
    (``PENDING``) that a ledger then closes, ``quorum``, the Prometheus
    text, ``dispatch`` (the port's ``engines`` and the backend's name),
    and with no fleet or service running ``fleet`` and ``journal``, whose
    bodies equal the reference's routes' on the same state."""
    app_mod = _mod(PORT, "main.application")
    ch = _mod(PORT, "main.command_handler")
    timer = _mod(PORT, "utils.timer")
    cfg = PORT.config.Config()
    cfg.NODE_SEED = PORT.keys.SecretKey.from_seed_str("http-node")
    cfg.EXPECTED_LEDGER_CLOSE_TIME = 1
    a, b = PORT.tu.keypair("alice"), PORT.tu.keypair("bob")
    root = PORT.tu.seed_root_with_accounts([(a, 10 ** 10), (b, 10 ** 10)])
    app = app_mod.Application(cfg, clock=timer.VirtualClock(timer.REAL_TIME),
                              root=root)
    handler = ch.CommandHandler(app, port=0)
    app.start()
    stop = threading.Event()

    def crank():
        while not stop.is_set():
            app.crank(block=True)
    t = threading.Thread(target=crank, daemon=True)
    t.start()
    try:
        port = handler.port
        assert _get(port, "info")["state"] in ("booting", "synced")
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.tx import TransactionEnvelope
        tx = PORT.tu.make_tx(a, (1 << 32) + 1,
                             [PORT.tu.payment_op(b, 10_000_000)],
                             network_id=cfg.network_id())
        out = _get(port, "tx?blob=" + _blob(
            to_bytes(TransactionEnvelope, tx.envelope)))
        assert out == {"status": "PENDING"}
        assert _get(port, "tx") == {"status": "ERROR",
                                    "detail": "missing blob param"}
        deadline = time.time() + 30
        while time.time() < deadline and \
                _get(port, "testacc?name=bob")["balance"] == 10 ** 10:
            time.sleep(0.1)
        assert _get(port, "testacc?name=bob")["balance"] == \
            10 ** 10 + 10_000_000
        assert _get(port, "info")["ledger"]["num"] >= 3
        q = _get(port, "quorum")
        assert q == {"threshold": 1, "validators": [
            cfg.NODE_SEED.public_key.raw.hex()[:16]]}
        assert "# TYPE" in _get(port, "metrics?format=prometheus")
        d = _get(port, "dispatch")
        assert isinstance(d["engines"], dict) and "backend" in d
        assert d["backend"] == "host-oracle"
        ref_ch = _mod(REF, "main.command_handler").CommandHandler
        for route in ("fleet", "journal", "service"):
            assert _get(port, route) == getattr(
                ref_ch, f"cmd_{route}")(None, {}), route
    finally:
        stop.set()
        app.clock.post_to_main(lambda: None)
        handler.stop()
