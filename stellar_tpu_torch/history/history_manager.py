"""History archives: checkpoint publish + retrieval (reference
``src/history/`` — ``HistoryManagerImpl``, ``CheckpointBuilder``,
``HistoryArchive``, ``StateSnapshot``; file layout per
``history/readme.md``).

Every 64 ledgers a checkpoint is cut: gzipped XDR streams of ledger
headers, tx sets, and tx results for the checkpoint range, the bucket
files referenced by the current bucket list, and a JSON
``HistoryArchiveState`` (HAS) manifest — enough for any node to rebuild
state via catchup. Archive paths are layered by the checkpoint number's
hex prefix exactly like the reference so real archive layouts round
trip. The transport here is a local filesystem archive; command-template
get/put subprocesses (curl/aws) layer on via the process manager.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from typing import Dict, List, Optional

from stellar_tpu_torch.xdr.ledger import (
    GeneralizedTransactionSet, LedgerHeaderHistoryEntry,
    TransactionHistoryEntry, TransactionHistoryResultEntry, TransactionSet,
)
from stellar_tpu_torch.xdr.results import TransactionResultSet
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes

__all__ = [
    "CHECKPOINT_FREQUENCY", "checkpoint_containing", "is_last_in_checkpoint",
    "first_in_checkpoint", "FileArchive", "HistoryArchiveState",
    "CheckpointBuilder", "HistoryManager",
]

CHECKPOINT_FREQUENCY = 64  # reference HistoryManager.h:52-58
HAS_VERSION = 1


def checkpoint_containing(ledger: int) -> int:
    """Last ledger of the checkpoint containing ``ledger`` (reference
    ``checkpointContainingLedger``). Checkpoints end at 63, 127, ..."""
    return (ledger // CHECKPOINT_FREQUENCY) * CHECKPOINT_FREQUENCY + \
        CHECKPOINT_FREQUENCY - 1


def is_last_in_checkpoint(ledger: int) -> bool:
    return ledger == checkpoint_containing(ledger)


def first_in_checkpoint(checkpoint: int) -> int:
    return max(1, checkpoint - CHECKPOINT_FREQUENCY + 1)


def _layered_path(category: str, checkpoint: int, ext: str) -> str:
    """category/ww/xx/yy/category-wwxxyyzz.ext (reference
    ``HistoryArchiveState::remoteName`` layout)."""
    hexseq = f"{checkpoint:08x}"
    return (f"{category}/{hexseq[0:2]}/{hexseq[2:4]}/{hexseq[4:6]}/"
            f"{category}-{hexseq}.{ext}")


def _records(frames: List[bytes]) -> bytes:
    return b"".join(struct.pack(">I", 0x80000000 | len(x)) + x
                    for x in frames)


def _unrecords(raw: bytes) -> List[bytes]:
    out = []
    pos = 0
    while pos < len(raw):
        (marked,) = struct.unpack_from(">I", raw, pos)
        n = marked & 0x7FFFFFFF
        pos += 4
        out.append(raw[pos:pos + n])
        pos += n
    return out


class FileArchive:
    """Local-directory archive with get/put (the reference's archives
    are get/put command templates; a directory IS the simplest one)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, rel: str, data: bytes):
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def get(self, rel: str) -> Optional[bytes]:
        path = os.path.join(self.root, rel)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()


class CommandArchive:
    """Archive reached through operator get/put command templates run
    as subprocesses (reference ``history/readme.md:5-29``:
    ``get="curl -sf {0} -o {1}"``, ``put="aws s3 cp {1} {0}"``;
    {0}=remote name, {1}=local file). The transport moves files
    VERBATIM — compression is already part of the archive format
    (``.xdr.gz`` category files), so a command archive interoperates
    byte-for-byte with a directory archive published by FileArchive,
    exactly as the reference's get/put commands do."""

    def __init__(self, get_template: str = "",
                 put_template: str = "",
                 mkdir_template: str = "",
                 process_manager=None):
        import tempfile
        from stellar_tpu_torch.process import ProcessManager
        self.get_template = get_template
        self.put_template = put_template
        self.mkdir_template = mkdir_template
        self.pm = process_manager or ProcessManager()
        self.tmp = tempfile.mkdtemp(prefix="stpu-archive-")
        self._made_dirs = set()

    def _local(self, rel: str) -> str:
        return os.path.join(self.tmp, rel.replace("/", "_"))

    def put(self, rel: str, data: bytes):
        if not self.put_template:
            raise IOError("archive has no put command (read-only)")
        # remote directory creation (reference mkdir template)
        rdir = os.path.dirname(rel)
        if self.mkdir_template and rdir and rdir not in self._made_dirs:
            if self.pm.run_sync(
                    self.mkdir_template.replace("{0}", rdir)) == 0:
                self._made_dirs.add(rdir)  # only cache success
        local = self._local(rel)
        with open(local, "wb") as f:
            f.write(data)
        cmd = self.put_template.replace("{0}", rel) \
                               .replace("{1}", local)
        rc = self.pm.run_sync(cmd)
        os.unlink(local)
        if rc != 0:
            raise IOError(f"archive put failed ({rc}): {cmd}")

    def get(self, rel: str) -> Optional[bytes]:
        if not self.get_template:
            return None
        local = self._local(rel)
        cmd = self.get_template.replace("{0}", rel) \
                               .replace("{1}", local)
        rc = self.pm.run_sync(cmd)
        if rc != 0 or not os.path.exists(local):
            return None
        try:
            with open(local, "rb") as f:
                return f.read()
        finally:
            os.unlink(local)


def archive_from_config(spec) -> "FileArchive":
    """Config HISTORY_ARCHIVES entry -> archive: a plain string is a
    local directory; a dict {"get": ..., "put": ...} is a command
    archive (reference [HISTORY.x] TOML tables)."""
    if isinstance(spec, str):
        return FileArchive(spec)
    return CommandArchive(spec.get("get", ""), spec.get("put", ""),
                          spec.get("mkdir", ""))


class HistoryArchiveState:
    """The JSON "HAS" manifest (reference ``HistoryArchiveState``)."""

    def __init__(self, current_ledger: int, network_passphrase: str,
                 bucket_hashes: List[Dict[str, str]],
                 hot_archive_hashes: Optional[List[Dict]] = None):
        self.version = HAS_VERSION
        self.current_ledger = current_ledger
        self.network_passphrase = network_passphrase
        self.bucket_hashes = bucket_hashes  # [{"curr": hex, "snap": hex}]
        # state-archival (p23+) hot-archive levels, same level shape;
        # absent/empty for pre-archival checkpoints and older HAS files
        self.hot_archive_hashes = hot_archive_hashes or []

    def to_json(self) -> str:
        doc = {
            "version": self.version,
            "server": "stellar_tpu",
            "currentLedger": self.current_ledger,
            "networkPassphrase": self.network_passphrase,
            "currentBuckets": self.bucket_hashes,
        }
        if self.hot_archive_hashes:
            doc["hotArchiveBuckets"] = self.hot_archive_hashes
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "HistoryArchiveState":
        d = json.loads(raw)
        return cls(d["currentLedger"], d.get("networkPassphrase", ""),
                   d["currentBuckets"],
                   d.get("hotArchiveBuckets"))

    @staticmethod
    def next_output(lev: Dict) -> str:
        """Hex hash of a level's pending merge, '' when none. Accepts
        both the canonical FutureBucket object form
        ({"state":0} / {"state":1,"output":hex}) and a legacy bare hex
        string, so real stellar-core HAS files parse."""
        nxt = lev.get("next", "")
        if isinstance(nxt, dict):
            return nxt.get("output", "") if nxt.get("state") else ""
        return nxt

    def all_bucket_hashes(self) -> List[str]:
        out = []
        for lev in self.bucket_hashes:
            out.append(lev["curr"])
            out.append(lev["snap"])
            nxt = self.next_output(lev)
            if nxt:
                out.append(nxt)
        return out

    def all_hot_bucket_hashes(self) -> List[str]:
        """Hot-archive bucket ids, "hot:"-prefixed so the download
        stage fetches them with the hot framing and catchup finds
        them under distinct preload keys."""
        out = []
        for lev in self.hot_archive_hashes:
            for h in (lev.get("curr", ""), lev.get("snap", ""),
                      self.next_output(lev)):
                if h:
                    out.append("hot:" + h)
        return out


class CheckpointBuilder:
    """Accumulates one checkpoint's ledgers (reference
    ``CheckpointBuilder`` — the reference streams to .dirty files for
    crash safety; we accumulate and write atomically at publish)."""

    def __init__(self):
        self.headers: List[LedgerHeaderHistoryEntry] = []
        self.tx_sets: List[TransactionHistoryEntry] = []
        self.results: List[TransactionHistoryResultEntry] = []

    def append(self, header_entry, tx_entry, result_entry):
        self.headers.append(header_entry)
        self.tx_sets.append(tx_entry)
        self.results.append(result_entry)

    def clear(self):
        self.headers.clear()
        self.tx_sets.clear()
        self.results.clear()


class HistoryManager:
    """Publish side (reference ``HistoryManagerImpl``): observe closes,
    cut checkpoints, push to archives."""

    def __init__(self, archives: List[FileArchive],
                 network_passphrase: str = "",
                 store_headers: bool = True, store_misc: bool = True,
                 publish_delay_s: int = 0, clock=None):
        self.archives = archives
        self.network_passphrase = network_passphrase
        self.builder = CheckpointBuilder()
        self.published_checkpoints: List[int] = []
        # reference MODE_STORES_HISTORY_LEDGERHEADERS / _MISC: what a
        # checkpoint records (captive nodes can skip tx sets/results)
        self.store_headers = store_headers
        self.store_misc = store_misc
        # reference PUBLISH_TO_ARCHIVE_DELAY: seconds between cutting
        # a checkpoint and uploading it; the delay follows the APP
        # clock (virtual in simulations) when one is provided
        self.publish_delay_s = publish_delay_s
        self._clock = clock
        self._deferred: List = []  # (due, files, has_json, checkpoint)

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        import time as _time
        return _time.monotonic()

    # ---------------- per-close hook ----------------

    def ledger_closed(self, close_result, tx_set, bucket_list=None,
                      hot_archive=None):
        """Record one closed ledger; publish when the checkpoint is
        full. ``close_result`` is LedgerManager's CloseLedgerResult."""
        header = close_result.header
        if not self.store_headers:
            return  # header-less node: nothing publishable accrues
        hhe = LedgerHeaderHistoryEntry(
            hash=close_result.header_hash, header=header,
            ext=LedgerHeaderHistoryEntry._types[2].make(0))
        if self.store_misc:
            the = TransactionHistoryEntry(
                ledgerSeq=header.ledgerSeq,
                txSet=TransactionSet(
                    previousLedgerHash=header.previousLedgerHash,
                    txs=[]),
                ext=TransactionHistoryEntry._types[2].make(
                    1, tx_set.xdr))
            rset = TransactionResultSet(results=[
                _pair(f, r) for f, r in zip(
                    tx_set.get_txs_in_apply_order(),
                    close_result.tx_results)])
            tre = TransactionHistoryResultEntry(
                ledgerSeq=header.ledgerSeq, txResultSet=rset,
                ext=TransactionHistoryResultEntry._types[2].make(0))
        else:
            # headers only: empty tx/result records keep checkpoint
            # shape without the misc payload
            the = TransactionHistoryEntry(
                ledgerSeq=header.ledgerSeq,
                txSet=TransactionSet(
                    previousLedgerHash=header.previousLedgerHash,
                    txs=[]),
                ext=TransactionHistoryEntry._types[2].make(0))
            tre = TransactionHistoryResultEntry(
                ledgerSeq=header.ledgerSeq,
                txResultSet=TransactionResultSet(results=[]),
                ext=TransactionHistoryResultEntry._types[2].make(0))
        self.builder.append(hhe, the, tre)
        if is_last_in_checkpoint(header.ledgerSeq):
            self.publish_checkpoint(header.ledgerSeq, bucket_list,
                                    hot_archive=hot_archive)

    # ---------------- publish ----------------

    def publish_checkpoint(self, checkpoint: int, bucket_list=None,
                           hot_archive=None):
        files = {
            _layered_path("ledger", checkpoint, "xdr.gz"): gzip.compress(
                _records([to_bytes(LedgerHeaderHistoryEntry, h)
                          for h in self.builder.headers])),
            _layered_path("transactions", checkpoint, "xdr.gz"):
                gzip.compress(_records(
                    [to_bytes(TransactionHistoryEntry, t)
                     for t in self.builder.tx_sets])),
            _layered_path("results", checkpoint, "xdr.gz"): gzip.compress(
                _records([to_bytes(TransactionHistoryResultEntry, r)
                          for r in self.builder.results])),
        }
        bucket_hashes = []
        buckets = {}
        if bucket_list is not None:
            for lev in bucket_list.levels:
                # "next" is the prepared-but-uncommitted merge — part of
                # the state sequence, so the HAS must carry it (the
                # reference stores the FutureBucket state the same way)
                nxt = lev.next
                # FutureBucket JSON form, as real archives encode it
                bucket_hashes.append({
                    "curr": lev.curr.hash.hex(),
                    "snap": lev.snap.hash.hex(),
                    "next": ({"state": 1, "output": nxt.hash.hex()}
                             if nxt is not None else {"state": 0}),
                })
                for b in (lev.curr, lev.snap, nxt):
                    if b is not None and not b.is_empty():
                        buckets[b.hash.hex()] = b
        hot_hashes = []
        if hot_archive is not None and not hot_archive.is_empty():
            for lev in hot_archive.levels:
                nxt = lev.next
                hot_hashes.append({
                    "curr": lev.curr.hash.hex(),
                    "snap": lev.snap.hash.hex(),
                    "next": ({"state": 1, "output": nxt.hash.hex()}
                             if nxt is not None else {"state": 0}),
                })
                for b in (lev.curr, lev.snap, nxt):
                    if b is not None and not b.is_empty():
                        buckets[b.hash.hex()] = b
        has = HistoryArchiveState(checkpoint, self.network_passphrase,
                                  bucket_hashes,
                                  hot_archive_hashes=hot_hashes)
        has_json = has.to_json().encode()
        files[_layered_path("history", checkpoint, "json")] = has_json
        for hexhash, bucket in buckets.items():
            rel = (f"bucket/{hexhash[0:2]}/{hexhash[2:4]}/{hexhash[4:6]}/"
                   f"bucket-{hexhash}.xdr.gz")
            files[rel] = gzip.compress(bucket.serialize())
        if self.publish_delay_s > 0:
            self._deferred.append(
                (self._now() + self.publish_delay_s, files,
                 has_json, checkpoint))
        else:
            self._upload(files, has_json, checkpoint)
        self.builder.clear()

    def _upload(self, files, has_json, checkpoint):
        for archive in self.archives:
            for rel, data in files.items():
                archive.put(rel, data)
            archive.put(".well-known/stellar-history.json", has_json)
        self.published_checkpoints.append(checkpoint)

    def poll_deferred_publishes(self):
        """Upload any checkpoint whose PUBLISH_TO_ARCHIVE_DELAY has
        elapsed (called from the externalize hook)."""
        if not self._deferred:
            return
        now = self._now()
        ready = [d for d in self._deferred if d[0] <= now]
        self._deferred = [d for d in self._deferred if d[0] > now]
        for _due, files, has_json, checkpoint in ready:
            self._upload(files, has_json, checkpoint)

    def flush_deferred_publishes(self):
        """Upload everything still deferred regardless of due time —
        a stopping node must not lose cut checkpoints."""
        deferred, self._deferred = self._deferred, []
        for _due, files, has_json, checkpoint in deferred:
            self._upload(files, has_json, checkpoint)

    # ---------------- retrieval (consumer side) ----------------

    @staticmethod
    def get_root_has(archive: FileArchive) -> Optional[HistoryArchiveState]:
        raw = archive.get(".well-known/stellar-history.json")
        return None if raw is None else \
            HistoryArchiveState.from_json(raw.decode())

    @staticmethod
    def get_has(archive: FileArchive, checkpoint: int
                ) -> Optional[HistoryArchiveState]:
        """The per-checkpoint HAS manifest (reference layered
        ``history/xx/yy/zz/history-XXXXXXXX.json``)."""
        raw = archive.get(_layered_path("history", checkpoint, "json"))
        return None if raw is None else \
            HistoryArchiveState.from_json(raw.decode())

    @staticmethod
    def get_checkpoint(archive: FileArchive, checkpoint: int):
        """(headers, tx_entries, result_entries) for one checkpoint, or
        None if absent."""
        def load(category, t):
            raw = archive.get(_layered_path(category, checkpoint, "xdr.gz"))
            if raw is None:
                return None
            return [from_bytes(t, x)
                    for x in _unrecords(gzip.decompress(raw))]
        headers = load("ledger", LedgerHeaderHistoryEntry)
        txs = load("transactions", TransactionHistoryEntry)
        results = load("results", TransactionHistoryResultEntry)
        if headers is None:
            return None
        return headers, txs or [], results or []

    @staticmethod
    def get_bucket(archive: FileArchive, hexhash: str, cls=None):
        """Content-addressed bucket download + hash verification.
        ``cls`` selects the entry framing (live ``Bucket`` by default,
        ``HotArchiveBucket`` for hot-archive files)."""
        if cls is None:
            from stellar_tpu_torch.bucket.bucket import Bucket
            cls = Bucket
        rel = (f"bucket/{hexhash[0:2]}/{hexhash[2:4]}/{hexhash[4:6]}/"
               f"bucket-{hexhash}.xdr.gz")
        raw = archive.get(rel)
        if raw is None:
            return None
        b = cls.deserialize(gzip.decompress(raw))
        if b.hash.hex() != hexhash:
            raise ValueError(
                f"{cls.__name__} hash mismatch (corrupt archive)")
        return b

    @staticmethod
    def get_hot_bucket(archive: FileArchive, hexhash: str):
        from stellar_tpu_torch.bucket.hot_archive import HotArchiveBucket
        return HistoryManager.get_bucket(archive, hexhash,
                                         cls=HotArchiveBucket)


def _pair(frame, result):
    from stellar_tpu_torch.xdr.results import TransactionResultPair
    xdr = frame.to_result_xdr(result) if hasattr(frame, "to_result_xdr") \
        else result.to_xdr()
    return TransactionResultPair(transactionHash=frame.contents_hash(),
                                 result=xdr)
