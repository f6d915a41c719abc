"""The port stands alone: it imports neither JAX nor the JAX package, and
it plugs into the node's verify seam (``stellar_tpu.crypto.keys``) from the
outside. Only tests import both packages."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np

from stellar_tpu.crypto import keys
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+stellar_tpu\b"
    r"|from\s+stellar_tpu\b)", re.MULTILINE)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT,
                                                   "stellar_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


# the node's TxSet slice: the ledger, the transaction and classic
# operation frames, surge pricing and the TxSet
NODE_MODULES = (
    "protocol", "ledger.ledger_txn", "ledger.network_config",
    "soroban.cost_model", "tx.account_utils", "tx.asset_utils", "tx.op_frame", "tx.sponsorship",
    "tx.offer_exchange", "tx.revoke_utils", "tx.transaction_frame",
    "tx.tx_test_utils", "tx.ops.account_ops", "tx.ops.claimable_balances",
    "tx.ops.create_account", "tx.ops.liquidity_pool_ops", "tx.ops.misc",
    "tx.ops.offers", "tx.ops.payment", "tx.ops.soroban_ops",
    "tx.ops.sponsorship_ops", "tx.ops.trust_ops", "herder.surge_pricing",
    "herder.tx_set")

# the node's ledger close: the ledger manager, the invariants, the
# upgrades, the Soroban host's module, the bucket list with eviction and
# the hot archive, the worker pool and the bucket-stream bridge
CLOSE_MODULES = (
    "utils.workers", "utils.native", "soroban", "soroban.host",
    "herder.upgrades", "invariant", "invariant.invariants", "bucket",
    "bucket.bucket", "bucket.bucket_list", "bucket.eviction",
    "bucket.hot_archive", "ledger.ledger_manager")

# catchup and the node's persistence: the work system, the history
# archive, catchup, the database, the bucket files and BucketListDB
CATCHUP_MODULES = (
    "utils.scheduler", "utils.timer", "utils.status", "work", "work.work",
    "process", "process.process_manager", "history",
    "history.history_manager", "historywork", "catchup", "catchup.catchup",
    "crypto.shorthash", "bucket.bucket_index", "bucket.bucket_list_db",
    "bucket.bucket_manager", "database", "database.database")

# the node: X25519 and sealed boxes, SCP, the herder, the overlay, the
# Config and Application, the simulation driver
NETWORK_MODULES = (
    "crypto.curve25519", "crypto.nacl_box", "scp", "scp.quorum",
    "scp.driver", "scp.nomination", "scp.ballot", "scp.slot", "scp.scp",
    "herder.transaction_queue", "herder.quorum_tracker",
    "herder.quorum_intersection", "herder.herder", "overlay",
    "overlay.peer_manager", "overlay.tx_adverts", "overlay.survey_manager",
    "overlay.peer", "overlay.overlay_manager", "overlay.loopback",
    "utils.toml_compat", "utils.logging", "main", "main.config",
    "main.maintainer", "main.application", "simulation",
    "simulation.simulation")

# Soroban: the host's curves, the wasm stack, the host environment, the
# three operation frames and the load generator
SOROBAN_MODULES = (
    "crypto.keccak", "crypto.secp256", "crypto._h2c_constants",
    "crypto.h2c", "crypto.bls12_381", "soroban.wasm",
    "soroban.env_interface", "soroban.legacy_abi", "soroban.asset_contract",
    "soroban.env", "soroban.native_wasm", "soroban.wasm_builder",
    "soroban.example_contracts", "tx.ops.soroban_ops",
    "simulation.load_generator")

# the operator surface: the TCP transport, the CLI and its offline
# commands, the admin routes, the fuzzers and the entry point
OPERATOR_MODULES = (
    "overlay.tcp", "utils.xdrquery", "main.settings_upgrade",
    "main.command_handler", "main.fuzz", "main.cli_offline", "main.cli",
    "__main__")

# the analysis gates and the tools that drive them
ANALYSIS_MODULES = (
    "analysis", "analysis.lint_base", "analysis.locks", "analysis.nondet",
    "analysis.lockorder", "analysis.hotpath", "analysis.intervals",
    "analysis.overflow", "analysis.coverage", "tools", "tools.analyze",
    "tools.kernel_cost", "tools.device_probe")

# the benchmark runner, the profiler trace's reader, the span exporter
# and the engine's four self-checks
TOOLS_MODULES = ("tools.run_benchmarks", "tools.trace_kernel_time",
                 "tools.trace_export", "tools.metrics_selfcheck",
                 "tools.transfer_selfcheck", "tools.pipeline_selfcheck",
                 "tools.hot_signer_selfcheck")

# modules the port names in a late import but lacks, each waiting for a
# later slice (ROADMAP.md's known gaps): none
KNOWN_GAPS = ()


def test_forbidden_imports_absent():
    files = _port_sources()
    assert len(files) > 10 and all(os.path.exists(f) for f in files)
    for module in ("metrics", "tracing", "timeline", "resilience",
                   "faults", "transfer_ledger", "cache", "wire",
                   "journal"):
        assert os.path.join(ROOT, "stellar_tpu_torch", "utils",
                            f"{module}.py") in files
    for module in ("verify_service", "tenant", "controller", "keys",
                   "audit", "batch_verifier", "fleet", "ingress"):
        assert os.path.join(ROOT, "stellar_tpu_torch", "crypto",
                            f"{module}.py") in files
    for module in ("residency", "hostbuf", "signer_tables"):
        assert os.path.join(ROOT, "stellar_tpu_torch", "parallel",
                            f"{module}.py") in files
    for module in ("crypto/sha", "crypto/strkey", "xdr/runtime",
                   "xdr/types", "xdr/contract", "xdr/tx", "xdr/scp",
                   "xdr/results", "xdr/ledger", "xdr/overlay",
                   "tx/signature_utils", "tx/signature_checker"):
        assert os.path.join(ROOT, "stellar_tpu_torch",
                            f"{module}.py") in files
    for module in (NODE_MODULES + CLOSE_MODULES + CATCHUP_MODULES +
                   NETWORK_MODULES + SOROBAN_MODULES + OPERATOR_MODULES +
                   ANALYSIS_MODULES + TOOLS_MODULES):
        assert _module_path("stellar_tpu_torch." + module) in files, module
    for path in files:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, (path, hits)


def test_import_and_verify_with_jax_blocked():
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports the port, verifies three items on the CPU twice (the second
    time through the hot-signer path), runs K5 and K4 on two rows, verifies
    the three items again over a verifier split across two indices,
    hashes forty messages, attributes a traced blocking call, reads the
    transfer ledger, the resident cache, the Prometheus text and the
    Chrome trace, raises from a deadline-guarded call under a ``hang``
    fault, verifies the three items through a ``VerifyService`` over a
    CPU verifier on each lane and through a ``TrickleBatcher``, reads
    the service in ``dispatch_health()``, and runs a three-replica
    ``FleetRouter`` over a CPU verifier behind an ``IngressServer`` with
    one ``WireClient`` on loopback, then ``journal.collect`` over both."""
    code = "\n".join([
        "import sys, hashlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import numpy as np",
        "from stellar_tpu_torch.crypto import ed25519_ref as ref",
        "from stellar_tpu_torch.crypto import vectors",
        "from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier",
        "from stellar_tpu_torch.crypto.batch_hasher import hash_many",
        "from stellar_tpu_torch.parallel import signer_tables",
        "import stellar_tpu_torch.state, stellar_tpu_torch.ops._build",
        "import stellar_tpu_torch.ops.sha256",
        "rng = np.random.default_rng(51)",
        "items = vectors.valid_items(rng, 3)",
        "items[1] = (items[1][0], b'tampered', items[1][2])",
        "v = BatchVerifier(device='cpu', bucket_sizes=(4,))",
        "assert v.verify_batch(items).tolist() == [True, False, True]",
        "assert v.served['hot'] == 0",
        "print(v.verify_batch(items).tolist())",
        "assert v.served['hot'] == 3",
        "import torch",
        "from stellar_tpu_torch.ops import verify as vk",
        "rows = vectors.r16_matching_rows(rng, 2)",
        "t = [torch.from_numpy(x) for x in rows]",
        "assert vk.verify_kernel_r16(*t).tolist() == [True, True]",
        "assert vk.verify_kernel_sharded(['cpu'] * 2)(*t).tolist() == "
        "[True, True]",
        "signer_tables.signer_table_cache.configure(enabled=False)",
        "from stellar_tpu_torch.parallel.residency import resident_cache",
        "resident_cache.configure(enabled=True)",
        "v2 = BatchVerifier(devices=['cpu'] * 2, bucket_sizes=(4,))",
        "assert v2.verify_batch(items).tolist() == [True, False, True]",
        "assert sorted(v2.device_served) == [0, 1]",
        "msgs = [bytes([i]) * (13 * i) for i in range(40)]",
        "assert hash_many(msgs, device='cpu') == "
        "[hashlib.sha256(m).digest() for m in msgs]",
        "from stellar_tpu_torch.parallel import batch_engine as be",
        "from stellar_tpu_torch.utils import faults, resilience, tracing",
        "before = tracing.span_totals()",
        "assert v2.verify_batch(items).tolist() == [True, False, True]",
        "att = be.dispatch_attribution(before, tracing.span_totals())",
        "assert att['coverage'] >= 0.95, att",
        "from stellar_tpu_torch.utils.metrics import registry",
        "from stellar_tpu_torch.utils.transfer_ledger import "
        "transfer_ledger",
        "h = be.dispatch_health()",
        "assert h['transfer'] == transfer_ledger.totals()",
        "assert h['transfer']['bytes_h2d'] > 0 and "
        "h['transfer']['resident_hits'] > 0, h['transfer']",
        "assert h['resident'] == resident_cache.snapshot()",
        "assert h['resident']['entries'] > 0, h['resident']",
        "assert 'crypto_transfer_bytes_h2d ' in registry.to_prometheus()",
        "trace = tracing.flight_recorder.to_chrome_trace()",
        "assert any(e['name'] == 'transfer.bytes' for e in "
        "trace['traceEvents'])",
        "be.configure_dispatch(deadline_ms=100)",
        "faults.set_fault(faults.RESOLVE, 'hang', 0.5)",
        "v3 = BatchVerifier(device='cpu', bucket_sizes=(4,))",
        "try:",
        "    v3.verify_batch(items)",
        "    raise SystemExit('the hung fetch did not raise')",
        "except RuntimeError as e:",
        "    assert isinstance(e.__cause__, resilience.DeadlineExceeded)",
        "faults.clear()",
        "assert v3.deadline_misses == 1",
        "assert 'watchdog-timeout:device0' in "
        "tracing.flight_recorder.stats()['dump_reasons']",
        "be.configure_dispatch(deadline_ms=8000)",
        "from stellar_tpu_torch.crypto import verify_service as vs",
        "from stellar_tpu_torch.crypto.batch_verifier import "
        "TrickleBatcher",
        "v4 = BatchVerifier(device='cpu', bucket_sizes=(4,))",
        "svc = vs.VerifyService(verifier=v4).start()",
        "for lane in vs.LANES:",
        "    assert svc.verify(items, lane=lane, timeout=120).tolist() "
        "== [True, False, True], lane",
        "tb = TrickleBatcher(v4)",
        "assert [tb.verify_sig(*it) for it in items] == "
        "[True, False, True]",
        "s = be.dispatch_health()['service']",
        "assert s['running'] and s['conservation_gap'] == 0, s",
        "assert s['totals']['verified'] == 9, s['totals']",
        "svc.stop()",
        "from stellar_tpu_torch.crypto import fleet, ingress",
        "from stellar_tpu_torch.utils import journal",
        "fl = fleet.FleetRouter(verifier=v4, replicas=3).start()",
        "srv = ingress.IngressServer(fl, '127.0.0.1', 0).start()",
        "cli = ingress.WireClient('127.0.0.1', srv.port, timeout=60)",
        "tk = [cli.submit(items, lane=lane, tenant=f't{k}') for k in "
        "range(3) for lane in vs.LANES]",
        "assert all(t.result(timeout=120).tolist() == [True, False, True] "
        "for t in tk)",
        "cli.close()",
        "srv.stop(timeout=30)",
        "fl.stop(drain=True, timeout=60)",
        "j = journal.collect(fleet=fl, ingress=srv)",
        "c = journal.completeness(journal.merge(j), drained=True)",
        "assert c['gap'] == 0, c",
        "assert j['nondet']['ingress']['resolved'] == 27, j['nondet']",
        "assert be.dispatch_health()['fleet']['conservation_gap'] == 0",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[True, False, True]"


def test_node_transactions_with_jax_blocked():
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports the XDR, identity and transaction-signature modules and runs
    a miniature of ``chip_smoke.py`` phase 20 on the CPU: 40 transactions
    from ``vectors.node_txset`` decoded, hashed through ``hash_many``,
    their candidates prefetched through a CPU verifier, every checker
    verdict with no cache miss, equal to the same checker over the
    pure-Python oracle; the time-series ring samples ``frame_mark`` and
    the verify cache's gauges, and its thread stops."""
    code = "\n".join([
        "import sys, hashlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import numpy as np",
        "from stellar_tpu_torch.crypto import ed25519_ref, keys, vectors",
        "from stellar_tpu_torch.crypto import strkey, sha",
        "from stellar_tpu_torch.crypto.batch_hasher import hash_many",
        "from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier",
        "from stellar_tpu_torch.tx import signature_checker",
        "from stellar_tpu_torch.utils import metrics, tracing",
        "from stellar_tpu_torch.xdr import ledger, overlay, results, scp",
        "from stellar_tpu_torch.xdr import tx as xtx",
        "from stellar_tpu_torch.xdr.runtime import from_bytes",
        "sk = keys.SecretKey(bytes(range(32)))",
        "assert keys.PublicKey.from_strkey(sk.public_key.to_strkey()) "
        "== sk.public_key",
        "ring = metrics.TimeSeriesRing(metrics.registry, "
        "prefixes=('crypto.', 'frame.'))",
        "ring.start(interval_s=0.02)",
        "rng = np.random.default_rng(53)",
        "envs, accounts = vectors.node_txset(rng, single=5, multisig=22, "
        "two_op=8, special=5, corrupt=0.06, short_multisig=2)",
        "nid = vectors.NODE_NETWORK_ID",
        "def run(prefetch):",
        "    keys.flush_verify_cache()",
        "    dec = [from_bytes(xtx.TransactionEnvelope, e) for e in envs]",
        "    pays = [xtx.transaction_sig_payload(nid, d.value.tx) "
        "for d in dec]",
        "    hs = hash_many(pays, device='cpu')",
        "    assert hs == [hashlib.sha256(p).digest() for p in pays]",
        "    if prefetch:",
        "        keys.batch_verify_into_cache(",
        "            vectors.collect_candidates(dec, accounts, hs))",
        "    before = keys.get_verify_cache_stats()['misses']",
        "    out = [vectors.check_transaction(d, accounts, h) "
        "for d, h in zip(dec, hs)]",
        "    tracing.frame_mark()",
        "    st = keys.get_verify_cache_stats()",
        "    for k in ('hits', 'misses'):",
        "        g = metrics.registry.gauge(f'crypto.verify.cache.{k}')",
        "        g.set(st[k])",
        "    return out, st['misses'] - before",
        "v = BatchVerifier(device='cpu', bucket_sizes=(16,)).install()",
        "got, misses = run(True)",
        "assert misses == 0, misses",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "want, oracle_misses = run(False)",
        "assert oracle_misses > 0",
        "assert got == want, (got, want)",
        "assert 0 < [ok for ok, _ in got].count(False) < 40",
        "ring.sample_once()",
        "ring.stop()",
        "snap = ring.snapshot()",
        "assert not snap['sampling']['running']",
        "assert snap['sampling']['dropped_series'] == 0",
        "for name in ('frame.ledger_close.count', "
        "'crypto.verify.cache.hits', 'crypto.verify.cache.misses'):",
        "    assert name in snap['series'], sorted(snap['series'])",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(sum(ok for ok, _ in got))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 0 < int(proc.stdout.strip().splitlines()[-1]) < 40


def test_node_txset_with_jax_blocked():
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports every module of the node's TxSet slice and runs a miniature
    of ``chip_smoke.py`` phase 21 on the CPU over the pure-Python oracle:
    40 transactions of ``vectors.node_txset`` admitted over
    ``vectors.node_ledger`` (one ``prefetch_signature_batch``, then each
    frame's ``check_valid``), the accepted ones nominated, the set's bytes
    decoded and prepared, its ``check_valid`` True with every
    per-transaction check a cache hit, and a set holding one rejected
    transaction refused. ``prefetch_contents_hashes`` over the set's
    frames raises with no card rather than hashing on the host."""
    code = "\n".join([
        "import sys, importlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import numpy as np",
        f"for m in {NODE_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "import stellar_tpu_torch.tx.ops",
        "from stellar_tpu_torch.crypto import ed25519_ref, keys, vectors",
        "from stellar_tpu_torch.crypto.batch_hasher import hash_many",
        "from stellar_tpu_torch.herder import tx_set as ts",
        "from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn",
        "from stellar_tpu_torch.tx.transaction_frame import "
        "make_transaction_frame",
        "from stellar_tpu_torch.xdr import ledger as xl, tx as xtx",
        "from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "rng = np.random.default_rng(54)",
        "envs, accounts = vectors.node_txset(rng, single=5, multisig=22, "
        "two_op=8, special=5, corrupt=0.06, short_multisig=2)",
        "nid, lcl = vectors.NODE_NETWORK_ID, bytes(range(32))",
        "root = vectors.node_ledger(accounts)",
        "frames = [make_transaction_frame(nid, from_bytes("
        "xtx.TransactionEnvelope, e)) for e in envs]",
        "adm = LedgerTxn(root)",
        "ts.prefetch_signature_batch(adm, frames)",
        "codes = [f.check_valid(adm).code for f in frames]",
        "adm.rollback()",
        "ok = [f for f, c in zip(frames, codes) if c == 0]",
        "bad = next(f for f, c in zip(frames, codes) if c != 0)",
        "assert 0 < len(ok) < 40, codes",
        "def received(chosen):",
        "    app, excluded = ts.make_tx_set_from_transactions(",
        "        chosen, root.header(), lcl)",
        "    assert excluded == []",
        "    raw = to_bytes(xl.GeneralizedTransactionSet, app.xdr)",
        "    got = ts.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(nid)",
        "    assert got.hash == app.hash",
        "    return got",
        "got = received(ok)",
        "import torch",
        "if not torch.cuda.is_available():",
        "    try:",
        "        ts.prefetch_contents_hashes(got.frames)",
        "        raise SystemExit('the hashes fell back to the host')",
        "    except RuntimeError:",
        "        pass",
        "for f, d in zip(got.frames, hash_many("
        "[f.contents_preimage() for f in got.frames], device='cpu')):",
        "    f._hash = d",
        "keys.flush_verify_cache()",
        "ltx = LedgerTxn(root)",
        "assert got.check_valid(ltx, lcl)",
        "ltx.rollback()",
        "st = keys.get_verify_cache_stats()",
        "assert st['misses'] == len(got.sig_triples), st",
        "worse = received(ok + [bad])",
        "ltx = LedgerTxn(root)",
        "assert not worse.check_valid(ltx, lcl)",
        "ltx.rollback()",
        "assert len(got.get_txs_in_apply_order()) == len(ok)",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(len(ok))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 0 < int(proc.stdout.strip().splitlines()[-1]) < 40


def test_node_close_with_jax_blocked():
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports every module of the ledger-close slice and runs a miniature
    of ``chip_smoke.py`` phase 22 on the CPU over the pure-Python oracle:
    40 transactions of ``vectors.node_txset`` admitted over
    ``vectors.node_ledger``, the accepted ones over
    ``vectors.node_close_ledger``, nominated, replayed from the wire bytes
    and closed by a ``LedgerManager`` with a close-meta consumer and every
    invariant on; the C++ bucket runtime serves the bucket list. Its
    header hash equals the reference's close of the same ledger, run
    here."""
    code = "\n".join([
        "import sys, importlib, hashlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import numpy as np",
        f"for m in {CLOSE_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "import stellar_tpu_torch.tx.ops",
        "from stellar_tpu_torch import invariant",
        "from stellar_tpu_torch.crypto import ed25519_ref, keys, vectors",
        "from stellar_tpu_torch.crypto.batch_hasher import hash_many",
        "from stellar_tpu_torch.herder import tx_set as ts",
        "from stellar_tpu_torch.invariant.invariants import "
        "InvariantManager",
        "from stellar_tpu_torch.ledger import ledger_manager as lmm",
        "from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn",
        "from stellar_tpu_torch.tx.transaction_frame import "
        "make_transaction_frame",
        "from stellar_tpu_torch.utils import native",
        "from stellar_tpu_torch.xdr import ledger as xl, tx as xtx",
        "from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "rng = np.random.default_rng(55)",
        "envs, accounts = vectors.node_txset(rng, single=5, multisig=22, "
        "two_op=8, special=5, corrupt=0.06, short_multisig=2)",
        "nid = vectors.NODE_NETWORK_ID",
        "def frames_of(es):",
        "    return [make_transaction_frame(nid, from_bytes("
        "xtx.TransactionEnvelope, e)) for e in es]",
        "adm = LedgerTxn(vectors.node_ledger(accounts))",
        "ok = [e for e, f in zip(envs, frames_of(envs)) "
        "if f.check_valid(adm).code == 0]",
        "adm.rollback()",
        "lm = lmm.LedgerManager(nid, vectors.node_close_ledger(accounts, "
        "ok))",
        "app, excluded = ts.make_tx_set_from_transactions(frames_of(ok), "
        "lm.last_closed_header, lm.last_closed_hash)",
        "assert excluded == []",
        "raw = to_bytes(xl.GeneralizedTransactionSet, app.xdr)",
        "got = ts.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(nid)",
        "for f, d in zip(got.frames, hash_many("
        "[f.contents_preimage() for f in got.frames], device='cpu')):",
        "    f._hash = d",
        "metas = []",
        "lm.close_meta_stream.append(lambda m: metas.append("
        "to_bytes(xl.LedgerCloseMeta, m)))",
        "invariant.set_active_manager(InvariantManager())",
        "res = lm.close_ledger(lmm.LedgerCloseData(ledger_seq="
        "lm.ledger_seq + 1, tx_set=got, close_time=5000))",
        "invariant.set_active_manager(None)",
        "assert res.failed_count == 0 and res.applied_count == len(ok), "
        "(res.applied_count, res.failed_count)",
        "assert len(metas) == 1 and native.available()",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(res.header_hash.hex())",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == _ref_node_close(55)


def _ref_node_close(seed) -> str:
    """The reference's close of the miniature above, as hex."""
    import stellar_tpu.tx.ops  # noqa: F401
    from stellar_tpu.crypto import ed25519_ref as jref
    from stellar_tpu.herder import tx_set as jts
    from stellar_tpu.ledger import ledger_manager as jlm
    from stellar_tpu.ledger.ledger_txn import LedgerTxn
    from stellar_tpu.tx.transaction_frame import make_transaction_frame
    from stellar_tpu.xdr import ledger as jledger
    from stellar_tpu.xdr import tx as jtx
    from stellar_tpu.xdr.runtime import from_bytes, to_bytes

    from tests._torch_port import ref_root
    previous = keys._backend
    keys.set_verifier_backend(jref.verify)
    try:
        envs, accounts = vectors.node_txset(
            np.random.default_rng(seed), single=5, multisig=22, two_op=8,
            special=5, corrupt=0.06, short_multisig=2)
        nid = vectors.NODE_NETWORK_ID

        def frames_of(es):
            return [make_transaction_frame(nid, from_bytes(
                jtx.TransactionEnvelope, e)) for e in es]
        adm = LedgerTxn(ref_root(vectors.node_ledger(accounts)))
        ok = [e for e, f in zip(envs, frames_of(envs))
              if f.check_valid(adm).code == 0]
        adm.rollback()
        lm = jlm.LedgerManager(nid, ref_root(
            vectors.node_close_ledger(accounts, ok)))
        app, _ex = jts.make_tx_set_from_transactions(
            frames_of(ok), lm.last_closed_header, lm.last_closed_hash)
        got = jts.TxSetXDRFrame.from_bytes(to_bytes(
            jledger.GeneralizedTransactionSet, app.xdr)) \
            .prepare_for_apply(nid)
        res = lm.close_ledger(jlm.LedgerCloseData(
            ledger_seq=lm.ledger_seq + 1, tx_set=got, close_time=5000))
    finally:
        keys.set_verifier_backend(previous)
        keys.flush_verify_cache()
    return res.header_hash.hex()


def test_node_catchup_with_jax_blocked(tmp_path):
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports every module of the catchup slice, builds a miniature of
    ``chip_smoke.py`` phase 23's chain on the CPU (two senders, ledgers
    64 to 127 of two payments each, over the oracle) into a
    ``FileArchive``, catches a fresh node with ``NodePersistence`` up to
    ledger 127 in ``RECENT`` mode (adopting checkpoint 63, replaying 64 to
    127), restarts it with ``LedgerManager.from_persistence`` over a
    ``BucketListStore`` at index cutoff 0 and closes ledger 128. Ledger
    127's and ledger 128's header hashes equal the reference's chain,
    built here."""
    code = "\n".join([
        "import sys, importlib, os",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import numpy as np",
        f"for m in {CATCHUP_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "import stellar_tpu_torch.tx.ops",
        "from stellar_tpu_torch.bucket import bucket_index",
        "from stellar_tpu_torch.bucket.bucket_manager import BucketManager",
        "from stellar_tpu_torch.catchup import catchup",
        "from stellar_tpu_torch.crypto import batch_hasher, ed25519_ref, "
        "keys, vectors",
        "from stellar_tpu_torch.database import Database, NodePersistence",
        "from stellar_tpu_torch.herder import tx_set as ts",
        "from stellar_tpu_torch.history import history_manager as hmm",
        "from stellar_tpu_torch.ledger import ledger_manager as lmm",
        "from stellar_tpu_torch.tx.transaction_frame import "
        "make_transaction_frame",
        "from stellar_tpu_torch.utils.timer import VIRTUAL_TIME, "
        "VirtualClock",
        "from stellar_tpu_torch.work.work import WorkScheduler",
        "from stellar_tpu_torch.xdr import tx as xtx",
        "from stellar_tpu_torch.xdr.runtime import from_bytes",
        "real = batch_hasher.hash_many",
        "batch_hasher.hash_many = lambda b, device=None: real(b, "
        "device='cpu')",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "nid = bytes(range(32))",
        "plan = vectors.catchup_plan(np.random.default_rng(1717), "
        "senders=2)",
        "envs = vectors.catchup_envelopes(plan, range(64, 129), nid)",
        "def close(lm, es, ups=()):",
        "    frames = [make_transaction_frame(nid, from_bytes("
        "xtx.TransactionEnvelope, e)) for e in es]",
        "    txset, ex = ts.make_tx_set_from_transactions(frames, "
        "lm.last_closed_header, lm.last_closed_hash)",
        "    assert ex == []",
        "    seq = lm.ledger_seq + 1",
        "    res = lm.close_ledger(lmm.LedgerCloseData(seq, txset, "
        "vectors.catchup_close_time(seq), upgrades=list(ups)))",
        "    assert res.failed_count == 0 and res.applied_count == len(es)",
        "    return res, txset",
        "tmp = sys.argv[1]",
        "archive = hmm.FileArchive(os.path.join(tmp, 'archive'))",
        "hm = hmm.HistoryManager([archive], 'test-net')",
        "lm = lmm.LedgerManager(nid, vectors.catchup_root(plan))",
        "while lm.ledger_seq < 127:",
        "    seq = lm.ledger_seq + 1",
        "    res, txset = close(lm, envs.get(seq, []), "
        "vectors.catchup_upgrades() if seq == 3 else ())",
        "    hm.ledger_closed(res, txset, lm.bucket_list, "
        "hot_archive=lm.hot_archive)",
        "assert hm.published_checkpoints == [63, 127]",
        "db = os.path.join(tmp, 'node.db')",
        "buckets = os.path.join(tmp, 'buckets')",
        "pers = NodePersistence(Database(db), BucketManager(buckets))",
        "node = lmm.LedgerManager(nid, persistence=pers)",
        "ws = WorkScheduler(VirtualClock(VIRTUAL_TIME))",
        "work = catchup.CatchupWork(node, archive, "
        "catchup.CatchupConfiguration(127, 'RECENT', count=63))",
        "ws.schedule(work)",
        "assert ws.run_until_done(600) and work.state == 'SUCCESS'",
        "assert node.last_closed_hash == lm.last_closed_hash",
        "pers.db.close()",
        "bucket_index.INDEX_CUTOFF_BYTES = 0",
        "pers = NodePersistence(Database(db), BucketManager(buckets))",
        "back = lmm.LedgerManager.from_persistence(nid, pers)",
        "assert back.root.store.is_bucket_backed",
        "assert back.last_closed_hash == lm.last_closed_hash",
        "assert back.bucket_list.hash() == lm.bucket_list.hash()",
        "res, _set = close(back, envs[128])",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(lm.last_closed_hash.hex(), res.header_hash.hex())",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == _ref_catchup_chain(
        tmp_path / "ref")


def _ref_catchup_chain(path) -> str:
    """The reference's chain of the miniature above: ledger 127's and
    ledger 128's header hashes, as hex."""
    from tests._torch_chain import REF
    previous = REF.keys._backend
    REF.keys.set_verifier_backend(REF.ref.verify)
    try:
        plan = vectors.catchup_plan(np.random.default_rng(1717), senders=2)
        envs = REF.envelopes(plan, range(64, 129))
        lm, _hm = REF.build(plan, envs, str(path))
        lcl = lm.last_closed_hash
        res, _set = REF.close(lm, envs[128])
    finally:
        REF.keys.set_verifier_backend(previous)
        REF.keys.flush_verify_cache()
    return f"{lcl.hex()} {res.header_hash.hex()}"


def test_node_consensus_with_jax_blocked():
    """A fresh interpreter in which importing jax, stellar_tpu or
    ``cryptography`` fails (so X25519 runs the port's pure-Python ladder,
    as on the card's machine) imports every module of the node slice,
    builds ``Topologies.core4`` over loopback, and cranks it to ledger 4
    in consensus, verifying through the port's oracle. Ledger 4's header
    hash and the statements' digest equal the reference's core4, run
    here."""
    code = "\n".join([
        "import sys, importlib, hashlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "sys.modules['cryptography'] = None",
        f"for m in {NETWORK_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "from stellar_tpu_torch.crypto import batch_hasher, curve25519, "
        "ed25519_ref, keys",
        "from stellar_tpu_torch.simulation.simulation import Topologies",
        "from stellar_tpu_torch.xdr.runtime import to_bytes",
        "from stellar_tpu_torch.xdr.scp import SCPStatement",
        "assert curve25519._OsslX25519Priv is None",
        "real = batch_hasher.hash_many",
        "batch_hasher.hash_many = lambda b, device=None: real(b, "
        "device='cpu')",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "sim = Topologies.core4()",
        "seen = set()",
        "for a in sim.nodes.values():",
        "    def rec(lcd, _close=a.lm.close_ledger):",
        "        res = _close(lcd)",
        "        if lcd.ledger_seq == 4:",
        "            seen.add(res.header_hash.hex())",
        "        return res",
        "    a.lm.close_ledger = rec",
        "sim.start_all_nodes()",
        "assert sim.crank_until_ledger(4, timeout=300)",
        "assert len(seen) == 1, seen",
        "assert sim.in_consensus()",
        "blobs = {to_bytes(SCPStatement, st) for a in sim.nodes.values() "
        "for slot in a.herder.scp.known_slots.values() "
        "for st, _v in slot.statements_history "
        "if st.slotIndex <= 4}",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(seen.pop(), hashlib.sha256(b''.join(sorted(blobs)))"
        ".hexdigest())",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = proc.stdout.strip().splitlines()[-1].split()
    assert got == _ref_core4(4)


def test_soroban_load_with_jax_blocked():
    """A fresh interpreter in which importing jax or stellar_tpu fails
    imports every module of the Soroban slice and runs ``BASELINE.json``
    config 5 cut to one ledger of 5 transactions
    (``soroban_apply_load(n_ledgers=1, txs_per_ledger=5)``) over the
    pure-Python oracle, on the SCVal program and on the compiled counter
    (the port's native engine); every close's header hash equals the
    reference's run of the same calls here."""
    code = "\n".join([
        "import sys, importlib",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        f"for m in {SOROBAN_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "import stellar_tpu_torch.tx.ops",
        "from stellar_tpu_torch.crypto import ed25519_ref, keys",
        "from stellar_tpu_torch.simulation import load_generator as lg",
        "keys.set_verifier_backend(ed25519_ref.verify)",
        "hashes = []",
        "class Recording(lg.LedgerManager):",
        "    def close_ledger(self, lcd):",
        "        res = super().close_ledger(lcd)",
        "        hashes.append(res.header_hash.hex())",
        "        return res",
        "lg.LedgerManager = Recording",
        "for use_wasm in (False, True):",
        "    out = lg.soroban_apply_load(n_ledgers=1, txs_per_ledger=5, "
        "use_wasm=use_wasm)",
        "    assert out['total_applied'] == out['counter_value'] == 5, out",
        "    assert out['engine'] == ('wasm-native' if use_wasm else "
        "'scval'), out",
        "assert not any(m == 'jax' or m.startswith('jax.') or m == "
        "'stellar_tpu' or m.startswith('stellar_tpu.') for m in "
        "sys.modules if sys.modules[m] is not None)",
        "print(' '.join(hashes))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import stellar_tpu.tx.ops  # noqa: F401
    from stellar_tpu.crypto import ed25519_ref as jref

    from tests._torch_port import harness_closes
    previous = keys._backend
    keys.set_verifier_backend(jref.verify)
    want = []
    try:
        for use_wasm in (False, True):
            _out, hashes, _meta = harness_closes(
                "stellar_tpu", "soroban_apply_load", n_ledgers=1,
                txs_per_ledger=5, use_wasm=use_wasm)
            want += hashes
    finally:
        keys.set_verifier_backend(previous)
        keys.flush_verify_cache()
    assert len(want) == 6
    assert proc.stdout.strip().splitlines()[-1].split() == want


def _ref_core4(seq):
    """The reference's core4 to ledger ``seq`` over its oracle: ledger
    ``seq``'s header hash (the same on every node) and the digest of the
    statements of slots up to ``seq``, as hex."""
    import hashlib

    from stellar_tpu.crypto import ed25519_ref as jref
    from stellar_tpu.simulation.simulation import Topologies
    from stellar_tpu.xdr.runtime import to_bytes
    from stellar_tpu.xdr.scp import SCPStatement
    previous = keys._backend
    keys.set_verifier_backend(jref.verify)
    seen = set()
    try:
        sim = Topologies.core4()
        for app in sim.nodes.values():
            def rec(lcd, _close=app.lm.close_ledger):
                res = _close(lcd)
                if lcd.ledger_seq == seq:
                    seen.add(res.header_hash.hex())
                return res
            app.lm.close_ledger = rec
        sim.start_all_nodes()
        assert sim.crank_until_ledger(seq, timeout=300)
    finally:
        keys.set_verifier_backend(previous)
        keys.flush_verify_cache()
    assert len(seen) == 1
    blobs = {to_bytes(SCPStatement, st) for a in sim.nodes.values()
             for slot in a.herder.scp.known_slots.values()
             for st, _v in slot.statements_history if st.slotIndex <= seq}
    return [seen.pop(), hashlib.sha256(b"".join(sorted(blobs))).hexdigest()]


def _package_names(path):
    """The names an ``__init__.py`` binds at its top level."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


def _module_path(name):
    """The file of a ``stellar_tpu_torch`` module or package, or None."""
    base = os.path.join(ROOT, *name.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(path):
            return path
    return None


def test_every_port_import_resolves_but_the_known_gaps():
    """Every ``import`` in the port, late ones inside functions too,
    names a ``stellar_tpu_torch`` module that exists (a name imported
    from a package must be bound in its ``__init__`` or be a submodule),
    except exactly ``KNOWN_GAPS``: the modules of later slices that
    ROADMAP.md lists."""
    missing = {}
    for path in _port_sources():
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                wanted = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                wanted = [node.module]
                init = _module_path(node.module)
                if init is not None and init.endswith("__init__.py"):
                    bound = _package_names(init)
                    wanted += [f"{node.module}.{a.name}" for a in node.names
                               if a.name not in bound]
            else:
                continue
            for name in wanted:
                if name.split(".")[0] == "stellar_tpu_torch" and \
                        _module_path(name) is None:
                    missing.setdefault(name, []).append(
                        f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert sorted(missing) == sorted(KNOWN_GAPS), missing
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    for name in KNOWN_GAPS:
        assert name.replace("stellar_tpu_torch.", "") in roadmap, name


def test_entry_point_with_jax_blocked():
    """``python -m stellar_tpu_torch version`` in a fresh interpreter in
    which importing jax or stellar_tpu fails: the port's CLI runs, and
    prints its version line; the CLI, the offline commands, the admin
    routes, the fuzzers and the TCP transport import there too."""
    code = "\n".join([
        "import runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import importlib",
        f"for m in {OPERATOR_MODULES[:-1]!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "sys.argv = ['stellar_tpu_torch', 'version']",
        "runpy.run_module('stellar_tpu_torch', run_name='__main__')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    assert out == {"stellar_tpu": "0.1.0", "ledger_protocol_version":
                   CURRENT_LEDGER_PROTOCOL_VERSION}


def test_tools_with_jax_blocked(tmp_path):
    """The tools in a fresh interpreter in which importing jax or
    stellar_tpu fails: every module of ``TOOLS_MODULES`` imports;
    ``metrics_selfcheck.main`` on the CPU (one resolve through the plain
    K1 and K2);
    ``run_benchmarks.main`` over stub harnesses with the host oracle,
    writing into a temporary directory; ``trace_kernel_time`` over a
    trace of one kernel; ``trace_export``'s fleet window to a file."""
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "verify_cold_kernel",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 500.0}]}))
    code = "\n".join([
        "import json, pathlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "import importlib",
        f"for m in {TOOLS_MODULES!r}:",
        "    importlib.import_module('stellar_tpu_torch.' + m)",
        "from stellar_tpu_torch.simulation import load_generator as lg",
        "from stellar_tpu_torch.tools import run_benchmarks as rb",
        "from stellar_tpu_torch.tools import trace_export as te",
        "from stellar_tpu_torch.tools import trace_kernel_time as tk",
        "from stellar_tpu_torch.tools import metrics_selfcheck as ms",
        "assert ms.main(['--device', 'cpu']) == 0",
        "def stub(**kw):",
        "    return {'txs_per_sec': 1.0, 'close_mean_ms': 1.0,",
        "            'close_p99_ms': 1.0, 'tx_apply_per_sec': 1.0,",
        "            'ledgers': 1, 'ledgers_per_sec': 1.0,",
        "            'replayed_ledgers': 1, 'signatures_per_ledger': 3,",
        "            'engine': 'scval', 'loop_iterations': 1}",
        "for name in ('apply_load', 'multisig_apply_load',",
        "             'catchup_replay_bench', 'scp_storm_bench',",
        "             'soroban_apply_load', 'soroban_compute_load'):",
        "    setattr(lg, name, stub)",
        f"out = pathlib.Path({str(tmp_path)!r})",
        "rb.OUT_JSON, rb.OUT_MD, rb.REPO = out / 'b.json', out / 'b.md', out",
        "assert rb.main(['--quick', '--verify', 'host']) == 0",
        f"assert tk.main([{str(trace)!r}, '1']) == 0",
        "assert te.main(['--fleet', '--out', str(out / 'f.json')]) == 0",
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules",
        "                     if sys.modules[m] is not None]",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1])["device_busy_ms_per_iter"] == 0.5
    assert json.loads(lines[-2])["wrote"] == ["b.json", "b.md"]
    assert json.loads(lines[0])["ok"] is True
    rows = json.loads((tmp_path / "b.json").read_text())
    assert {r["verify_backend"] for r in rows.values()} == {"host-oracle"}
    fleet = json.loads((tmp_path / "f.json").read_text())
    assert any(e["ph"] == "C" for e in fleet["traceEvents"])


def test_node_verify_seam():
    """The port's verify_sig behind keys.set_verifier_backend gives the
    oracle's answers through keys.verify_sig; the backend is restored."""
    rng = np.random.default_rng(52)
    items = vectors.valid_items(rng, 2)
    pk, msg, sig = items[0]
    small = sorted(ref.SMALL_ORDER_ENCODINGS)[0]
    items += [(pk, msg + b"!", sig), (small, msg, sig),
              (pk, msg, sig[:32] + ref.L.to_bytes(32, "little"))]
    verifier = BatchVerifier(device="cpu", bucket_sizes=(4,))
    calls = []

    def backend(p, m, s):
        calls.append(p)
        return verifier.verify_sig(p, m, s)

    previous = keys._backend
    keys.flush_verify_cache()
    keys.set_verifier_backend(backend)
    try:
        got = [keys.verify_sig(*it) for it in items]
    finally:
        keys.set_verifier_backend(previous)
        keys.flush_verify_cache()
    assert got == [ref.verify(*it) for it in items]
    assert got == [True, True, False, False, False]
    assert len(calls) == len(items)


def test_environment_does_not_reach_the_port():
    """The port reads no environment option: no ``os.environ`` or
    ``getenv`` in the package or ``chip_smoke.py``, and a fresh
    interpreter that imports the port with the reference's
    ``VERIFY_SIGNER_TABLE_ENABLED=0`` and ``VERIFY_SIGNER_TABLE_BYTES=0``
    set still has the signer-table cache on at its 64 MiB default."""
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert "os.environ" not in text and "getenv" not in text, path
    code = "\n".join([
        "from stellar_tpu_torch.parallel import signer_tables as st",
        "c = st.signer_table_cache",
        "assert c.enabled is True, c.snapshot()",
        "assert c.snapshot()['max_bytes'] == 64 << 20, c.snapshot()",
        "c._reset_for_testing()",
        "assert c.enabled is True and st.ENABLED is True",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT, VERIFY_SIGNER_TABLE_ENABLED="0",
               VERIFY_SIGNER_TABLE_BYTES="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
