"""The port stands alone: it imports neither JAX nor the JAX package, and
it plugs into the node's verify seam (``stellar_tpu.crypto.keys``) from the
outside. Only tests import both packages."""

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
    for module in NODE_MODULES:
        assert os.path.join(ROOT, "stellar_tpu_torch",
                            *module.split(".")) + ".py" in files, module
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
