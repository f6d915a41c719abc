"""Archive-I/O work nodes (reference ``src/historywork/``:
``GetHistoryArchiveStateWork``, ``BatchDownloadWork``,
``DownloadBucketsWork``, ``VerifyBucketWork``,
``VerifyLedgerChainWork``) — each download is its own retrying work, so
a flaky archive transport (e.g. a get-command subprocess) retries at
the granularity of one file, not the whole catchup."""

from __future__ import annotations

from typing import Dict, List, Optional

from stellar_tpu_torch.history.history_manager import HistoryManager
from stellar_tpu_torch.work.work import (
    RETRY_A_FEW, BasicWork, BatchWork, FunctionWork, State,
)

__all__ = [
    "GetHistoryArchiveStateWork", "GetCheckpointWork",
    "BatchDownloadWork", "DownloadVerifyBucketWork",
    "DownloadBucketsWork", "VerifyLedgerChainWork",
]


class GetHistoryArchiveStateWork(BasicWork):
    """Fetch + parse a HAS manifest (root ``.well-known`` when
    ``checkpoint`` is None); result in ``.has``."""

    def __init__(self, archive, checkpoint: Optional[int] = None,
                 max_retries: int = RETRY_A_FEW):
        name = f"get-has-{checkpoint if checkpoint is not None else 'root'}"
        super().__init__(name, max_retries)
        self.archive = archive
        self.checkpoint = checkpoint
        self.has = None

    def on_run(self) -> str:
        if self.checkpoint is None:
            self.has = HistoryManager.get_root_has(self.archive)
        else:
            self.has = HistoryManager.get_has(self.archive,
                                              self.checkpoint)
        return State.SUCCESS if self.has is not None else State.FAILURE


class GetCheckpointWork(BasicWork):
    """Download + parse one checkpoint's ledger/transactions/results
    category files into ``sink[checkpoint]``."""

    def __init__(self, archive, checkpoint: int, sink: Dict[int, tuple],
                 max_retries: int = RETRY_A_FEW):
        super().__init__(f"get-checkpoint-{checkpoint:08x}", max_retries)
        self.archive = archive
        self.checkpoint = checkpoint
        self.sink = sink

    def on_run(self) -> str:
        data = HistoryManager.get_checkpoint(self.archive,
                                             self.checkpoint)
        if data is None:
            return State.FAILURE
        self.sink[self.checkpoint] = data
        return State.SUCCESS


class BatchDownloadWork(BatchWork):
    """Bounded-parallel checkpoint downloads (reference
    ``BatchDownloadWork``); results land in ``.downloaded``."""

    def __init__(self, archive, checkpoints: List[int],
                 max_parallel: int = 8):
        super().__init__(f"batch-download-{len(checkpoints)}",
                         max_parallel)
        self.archive = archive
        self._todo = list(checkpoints)
        self._idx = 0
        self.downloaded: Dict[int, tuple] = {}

    def has_next(self) -> bool:
        return self._idx < len(self._todo)

    def yield_more_work(self) -> BasicWork:
        cp = self._todo[self._idx]
        self._idx += 1
        return GetCheckpointWork(self.archive, cp, self.downloaded)

    def on_reset(self):
        self._idx = 0
        self.downloaded.clear()
        super().on_reset()


class DownloadVerifyBucketWork(BasicWork):
    """Fetch one bucket by hash; ``HistoryManager.get_bucket``
    re-hashes the content against its name (the reference splits this
    into download + ``VerifyBucketWork``; the verification contract is
    identical)."""

    def __init__(self, archive, hexhash: str, sink: Dict[str, object],
                 max_retries: int = RETRY_A_FEW):
        super().__init__(f"get-bucket-{hexhash[:16]}", max_retries)
        self.archive = archive
        self.hexhash = hexhash
        self.sink = sink

    def on_run(self) -> str:
        try:
            if self.hexhash.startswith("hot:"):
                bucket = HistoryManager.get_hot_bucket(
                    self.archive, self.hexhash[4:])
            else:
                bucket = HistoryManager.get_bucket(self.archive,
                                                   self.hexhash)
        except ValueError:
            return State.FAILURE  # hash mismatch: corrupt download
        if bucket is None:
            return State.FAILURE
        self.sink[self.hexhash] = bucket
        return State.SUCCESS


class DownloadBucketsWork(BatchWork):
    """Bounded-parallel verified bucket downloads (reference
    ``DownloadBucketsWork``); results land in ``.buckets``."""

    def __init__(self, archive, hexhashes: List[str],
                 max_parallel: int = 8):
        uniq = sorted({h for h in hexhashes
                       if set(h.split(":")[-1]) != {"0"}})
        super().__init__(f"download-buckets-{len(uniq)}", max_parallel)
        self.archive = archive
        self._todo = uniq
        self._idx = 0
        self.buckets: Dict[str, object] = {}

    def has_next(self) -> bool:
        return self._idx < len(self._todo)

    def yield_more_work(self) -> BasicWork:
        h = self._todo[self._idx]
        self._idx += 1
        return DownloadVerifyBucketWork(self.archive, h, self.buckets)

    def on_reset(self):
        self._idx = 0
        self.buckets.clear()
        super().on_reset()


class VerifyLedgerChainWork(FunctionWork):
    """Backwards hash-chain verification over downloaded headers
    (reference ``VerifyLedgerChainWork``)."""

    def __init__(self, headers_provider):
        super().__init__("verify-ledger-chain", self._run)
        self._provider = headers_provider
        self.headers = []

    def _run(self) -> str:
        from stellar_tpu_torch.catchup.catchup import verify_ledger_chain
        headers = self._provider()
        # empty = nothing to verify (target at/below the LCL): a no-op
        # success, matching the old inline chain-verify behavior —
        # failed downloads already failed the sequence upstream
        if not verify_ledger_chain(headers):
            return State.FAILURE
        self.headers = headers
        return State.SUCCESS
