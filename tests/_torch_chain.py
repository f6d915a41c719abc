"""The chain that the catchup and persistence tests (``test_torch_catchup.py``,
``test_torch_persistence.py``, ``test_torch_isolation.py``) build with each
package: ``vectors.catchup_plan``'s payments over ``vectors.catchup_root``,
ledger 3's upgrades, a checkpoint published every 64 ledgers. Each package
signs its own envelopes (the port in pure Python, the reference through
OpenSSL) and closes its own ledgers; values cross between the two only as
bytes."""

import importlib

from stellar_tpu_torch.crypto import vectors

from tests._torch_port import ref_root

NID = bytes(range(32))      # tx_test_utils.TEST_NETWORK_ID in both packages
PASSPHRASE = "test-net"


class Side:
    """One package's modules for a chain, a catchup and a restart."""

    MODULES = {
        "cu": "catchup.catchup", "hm": "history.history_manager",
        "work": "work.work", "timer": "utils.timer",
        "sched": "utils.scheduler", "status": "utils.status",
        "lm": "ledger.ledger_manager", "lt": "ledger.ledger_txn",
        "ts": "herder.tx_set", "tf": "tx.transaction_frame",
        "tu": "tx.tx_test_utils", "keys": "crypto.keys",
        "ref": "crypto.ed25519_ref", "rt": "xdr.runtime",
        "xl": "xdr.ledger", "xtx": "xdr.tx", "xt": "xdr.types",
        "db": "database.database", "bm": "bucket.bucket_manager",
        "bi": "bucket.bucket_index", "bucket": "bucket.bucket",
        "sh": "crypto.shorthash", "inv": "invariant",
        "workers": "utils.workers"}

    def __init__(self, package):
        self.package = package
        importlib.import_module(package + ".tx.ops")   # the op registry
        for attr, rel in self.MODULES.items():
            setattr(self, attr, importlib.import_module(f"{package}.{rel}"))

    @property
    def is_port(self):
        return self.package == "stellar_tpu_torch"

    def root(self, plan):
        root = vectors.catchup_root(plan)
        return root if self.is_port else ref_root(root)

    def envelopes(self, plan, ledgers):
        """The plan's payments of ``ledgers``, signed by this package."""
        if self.is_port:
            return vectors.catchup_envelopes(plan, ledgers, NID)
        tu, rt, xtx = self.tu, self.rt, self.xtx
        return {ledger: [rt.to_bytes(xtx.TransactionEnvelope, tu.make_tx(
            tu.keypair(s), seq, [tu.payment_op(tu.keypair(d), amount)],
            network_id=NID).envelope) for s, d, seq, amount in rows]
            for ledger, rows in plan["payments"].items() if ledger in ledgers}

    def frames(self, envs):
        return [self.tf.make_transaction_frame(NID, self.rt.from_bytes(
            self.xtx.TransactionEnvelope, e)) for e in envs]

    def close(self, lm, envs, upgrades=()):
        """Nominate ``envs`` over ``lm``'s LCL and close the next ledger:
        ``(result, applicable set)``. Nothing may be excluded or fail."""
        seq = lm.ledger_seq + 1
        txset, excluded = self.ts.make_tx_set_from_transactions(
            self.frames(envs), lm.last_closed_header, lm.last_closed_hash)
        assert excluded == []
        res = lm.close_ledger(self.lm.LedgerCloseData(
            ledger_seq=seq, tx_set=txset,
            close_time=vectors.catchup_close_time(seq),
            upgrades=list(upgrades)))
        assert res.failed_count == 0 and res.applied_count == len(envs)
        return res, txset

    def build(self, plan, envs, archive_dir, persistence=None):
        """Close genesis' successors to ``plan["last"]``, each close handed
        to a ``HistoryManager`` over a ``FileArchive`` at ``archive_dir``:
        ``(LedgerManager, HistoryManager)``."""
        lm = self.lm.LedgerManager(NID, self.root(plan),
                                   persistence=persistence)
        hm = self.hm.HistoryManager([self.hm.FileArchive(archive_dir)],
                                    PASSPHRASE)
        ups = vectors.catchup_upgrades()
        while lm.ledger_seq < plan["last"]:
            seq = lm.ledger_seq + 1
            res, txset = self.close(lm, envs.get(seq, []),
                                    ups if seq == 3 else ())
            hm.ledger_closed(res, txset, lm.bucket_list,
                             hot_archive=lm.hot_archive)
        return lm, hm

    def catchup(self, lm, archive, to_ledger, mode, count=0, **kw):
        """``CatchupWork`` on a fresh virtual clock's ``WorkScheduler``,
        run to its end: the work."""
        ws = self.work.WorkScheduler(self.timer.VirtualClock(
            self.timer.VIRTUAL_TIME))
        work = self.cu.CatchupWork(lm, archive, self.cu.CatchupConfiguration(
            to_ledger, mode, count=count), **kw)
        ws.schedule(work)
        assert ws.run_until_done(600)
        return work

    def fresh(self, plan=None):
        """A fresh ``LedgerManager``: over genesis when a plan is given
        (``COMPLETE``), else empty (``MINIMAL``, ``RECENT``)."""
        if plan is None:
            return self.lm.LedgerManager(NID)
        return self.lm.LedgerManager(NID, self.root(plan))

    def persistence(self, db_path, bucket_dir):
        return self.db.NodePersistence(self.db.Database(db_path),
                                       self.bm.BucketManager(bucket_dir))

    def state(self, lm):
        """What the comparisons hold equal of a node."""
        return {"seq": lm.ledger_seq, "lcl": lm.last_closed_hash,
                "header": self.rt.to_bytes(self.xl.LedgerHeader,
                                           lm.last_closed_header),
                "bucket_list": lm.bucket_list.hash(),
                "hot_archive": lm.hot_archive.hash()}


PORT = Side("stellar_tpu_torch")
REF = Side("stellar_tpu")
