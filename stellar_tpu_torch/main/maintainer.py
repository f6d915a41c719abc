"""Maintainer: GC of historical rows the node no longer needs
(reference ``src/main/Maintainer.cpp`` — deletes scphistory/txhistory
below the publish cursor on a timer or via the 'maintenance' command).

The GC floor is the publish-queue minimum — the first ledger of the
oldest checkpoint not yet present in every configured archive,
including the in-progress checkpoint — NOT the checkpoint containing
the LCL: after an archive outage longer than the maintenance window
the unpublished checkpoints' rows must survive so ``publish`` can
rebuild and drain them (reference bounds on
``getMinLedgerQueuedToPublish``)."""

from __future__ import annotations

__all__ = ["Maintainer"]


class Maintainer:
    def __init__(self, app):
        self.app = app
        # published checkpoints are append-only: remember the oldest
        # candidate so the archive probe doesn't rescan from genesis
        # every maintenance tick
        self._probe_from = 63

    def _publish_floor(self):
        """First ledger of the oldest checkpoint still owed to some
        configured archive (None = no publishing duties)."""
        history = getattr(self.app, "history", None)
        if history is None:
            return None
        archives = getattr(history, "archives", [])
        if not archives:
            return None
        from stellar_tpu_torch.history.history_manager import (
            _layered_path, checkpoint_containing, first_in_checkpoint,
        )
        cur = checkpoint_containing(self.app.lm.ledger_seq)
        cp = self._probe_from
        while cp < cur:
            # a checkpoint counts as published only when EVERY category
            # file landed in EVERY archive: publish writes them in
            # order (ledger, transactions, results), so probing just
            # the first would mark a crash-interrupted publish done and
            # GC the rows needed to finish it
            if any(a.get(_layered_path(cat, cp, "xdr.gz")) is None
                   for a in archives
                   for cat in ("ledger", "transactions", "results")):
                break
            cp += 64
            self._probe_from = cp
        # cp is the oldest unpublished checkpoint; `cur` itself is
        # in-progress and always unpublished, so the floor never
        # passes the current checkpoint's first ledger
        return first_in_checkpoint(min(cp, cur))

    @staticmethod
    def _min_cursor(db):
        """Lowest registered downstream cursor, or None."""
        from stellar_tpu_torch.database.database import PersistentState
        cursors = PersistentState(db).list_cursors()
        return min(cursors.values()) if cursors else None

    def perform_maintenance(self, count: int) -> dict:
        """Delete history rows older than LCL - count (bounded below
        the publish queue, when a history manager exists)."""
        db = getattr(self.app, "database", None)
        if db is None:
            return {"deleted": 0, "reason": "no database"}
        keep_from = max(1, self.app.lm.ledger_seq - count)
        floor = self._publish_floor()
        if floor is not None:
            # never GC rows that still await publishing
            keep_from = min(keep_from, floor)
        cursor_floor = self._min_cursor(db)
        if cursor_floor is not None:
            # nor rows a registered downstream consumer (setcursor,
            # reference ExternalQueue) has not acknowledged yet
            keep_from = min(keep_from, cursor_floor)
        deleted = 0
        with db.conn:
            for table in ("scphistory", "txhistory", "txsets"):
                cur = db.conn.execute(
                    f"DELETE FROM {table} WHERE ledgerseq < ?",
                    (keep_from,))
                deleted += cur.rowcount
        return {"deleted": deleted, "below": keep_from}
