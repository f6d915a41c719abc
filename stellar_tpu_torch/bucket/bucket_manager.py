"""BucketManager: content-addressed bucket files on disk (reference
``src/bucket/BucketManager.h`` — adoption, retention/GC, and the
bucket-dir layout ``bucket/bucket-<hex>.xdr``).

Buckets are immutable and named by the SHA-256 of their contents, so
persistence is idempotent: writing is adopt-if-absent via a tmp-file +
atomic rename, restart just maps hashes back to files. The manifest of
a whole LiveBucketList — per level ``curr``/``snap``/``next`` hashes —
is what :class:`stellar_tpu_torch.database.NodePersistence` stores in SQL; a
restored list is bit-identical, including pending (``next``) merges, so
the spill cadence continues exactly where it stopped.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional

from stellar_tpu_torch.bucket.bucket import EMPTY, Bucket
from stellar_tpu_torch.bucket.bucket_list import LiveBucketList, NUM_LEVELS

__all__ = ["BucketManager"]

# durability / GC knobs (reference DISABLE_XDR_FSYNC /
# DISABLE_BUCKET_GC; set by Application from Config)
XDR_FSYNC = True
BUCKET_GC = True


class BucketManager:
    def __init__(self, bucket_dir: Optional[str]):
        """``bucket_dir=None`` keeps everything in memory (tests /
        ephemeral nodes)."""
        self.bucket_dir = bucket_dir
        if bucket_dir is not None:
            os.makedirs(bucket_dir, exist_ok=True)
        self._cache: Dict[bytes, Bucket] = {}

    # ---------------- adoption / retrieval ----------------

    def _path_for(self, h: bytes) -> str:
        return os.path.join(self.bucket_dir, f"bucket-{h.hex()}.xdr")

    def adopt(self, bucket: Bucket) -> bytes:
        """Ensure the bucket is durable; returns its hash (reference
        ``adoptFileAsBucket``)."""
        h = bucket.hash
        if h in self._cache:
            return h
        self._cache[h] = bucket
        if self.bucket_dir is not None and bucket is not EMPTY:
            path = self._path_for(h)
            if not os.path.exists(path):
                fd, tmp = tempfile.mkstemp(dir=self.bucket_dir,
                                           prefix=".tmp-bucket-")
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(bucket.serialize())
                        f.flush()
                        if XDR_FSYNC:
                            os.fsync(f.fileno())
                    os.rename(tmp, path)
                except Exception:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
        return h

    def load(self, h: bytes) -> Bucket:
        if h == EMPTY.hash:
            return EMPTY
        b = self._cache.get(h)
        if b is not None:
            return b
        if self.bucket_dir is None:
            raise KeyError(f"unknown bucket {h.hex()}")
        with open(self._path_for(h), "rb") as f:
            b = Bucket.deserialize(f.read())
        if b.hash != h:
            raise IOError(f"bucket file {h.hex()} fails its hash check")
        self._cache[h] = b
        return b

    # ---------------- whole-list persistence ----------------

    def persist_bucket_list(self, bl: LiveBucketList) -> List[dict]:
        """Write every referenced bucket to disk; return the level
        manifest. A merge still in flight is saved as its INPUTS
        (reference FutureBucket HAS state=2) rather than blocking the
        close on its output: restore restarts the merge and determinism
        makes the result bit-identical."""
        manifest = []
        for lev in bl.levels:
            entry = {"curr": self.adopt(lev.curr).hex(),
                     "snap": self.adopt(lev.snap).hex()}
            fb = lev.pending_merge()
            if fb is not None and not fb.done and fb.inputs is not None:
                base, incoming, pv, keep = fb.inputs
                entry["next_merge"] = {
                    "base": self.adopt(base).hex(),
                    "incoming": self.adopt(incoming).hex(),
                    "protocol": pv, "keep_tombstones": keep,
                }
            elif lev.next is not None:  # resolved (or instantly done)
                entry["next"] = self.adopt(lev.next).hex()
            manifest.append(entry)
        return manifest

    def restore_bucket_list(self, manifest: List[dict]) -> LiveBucketList:
        from stellar_tpu_torch.bucket.bucket import merge_buckets
        from stellar_tpu_torch.bucket.bucket_list import FutureBucket
        bl = LiveBucketList()
        for i, entry in enumerate(manifest[:NUM_LEVELS]):
            lev = bl.levels[i]
            lev.curr = self.load(bytes.fromhex(entry["curr"]))
            lev.snap = self.load(bytes.fromhex(entry["snap"]))
            if "next" in entry:
                lev.next = self.load(bytes.fromhex(entry["next"]))
            elif "next_merge" in entry:
                nm = entry["next_merge"]
                base = self.load(bytes.fromhex(nm["base"]))
                incoming = self.load(bytes.fromhex(nm["incoming"]))
                pv, keep = nm["protocol"], nm["keep_tombstones"]
                lev._next = FutureBucket.start(
                    lambda b=base, s=incoming, p=pv, k=keep:
                        merge_buckets(b, s, p, keep_tombstones=k),
                    inputs=(base, incoming, pv, keep))
        return bl

    def persist_hot_archive(self, hl) -> List[dict]:
        """Hot-archive list persistence (same content-addressed files;
        buckets carry HotArchiveBucketEntry records)."""
        manifest = []
        for lev in hl.levels:
            entry = {"curr": self.adopt(lev.curr).hex(),
                     "snap": self.adopt(lev.snap).hex()}
            fb = lev.pending_merge()
            if fb is not None and not fb.done and fb.inputs is not None:
                base, incoming, keep_live = fb.inputs
                entry["next_merge"] = {
                    "base": self.adopt(base).hex(),
                    "incoming": self.adopt(incoming).hex(),
                    "keep_live": keep_live,
                }
            elif lev.next is not None:
                entry["next"] = self.adopt(lev.next).hex()
            manifest.append(entry)
        return manifest

    def restore_hot_archive(self, manifest: List[dict]):
        from stellar_tpu_torch.bucket.hot_archive import (
            HotArchiveBucket, HotArchiveBucketList,
        )

        def load_hot(hexhash: str) -> HotArchiveBucket:
            h = bytes.fromhex(hexhash)
            if h == b"\x00" * 32:
                return HotArchiveBucket([])
            with open(self._path_for(h), "rb") as f:
                b = HotArchiveBucket.deserialize(f.read())
            if b.hash != h:
                raise IOError(
                    f"hot bucket {hexhash} fails its hash check")
            return b
        hl = HotArchiveBucketList()
        for i, entry in enumerate(manifest[:NUM_LEVELS]):
            lev = hl.levels[i]
            lev.curr = load_hot(entry["curr"])
            lev.snap = load_hot(entry["snap"])
            if "next" in entry:
                lev.next = load_hot(entry["next"])
            elif "next_merge" in entry:
                from stellar_tpu_torch.bucket.bucket_list import FutureBucket
                from stellar_tpu_torch.bucket.hot_archive import (
                    merge_hot_buckets,
                )
                nm = entry["next_merge"]
                base = load_hot(nm["base"])
                incoming = load_hot(nm["incoming"])
                keep = nm["keep_live"]
                lev._next = FutureBucket.start(
                    lambda b=base, s=incoming, k=keep:
                        merge_hot_buckets(b, s, k),
                    inputs=(base, incoming, keep))
        return hl

    # ---------------- GC ----------------

    def forget_unreferenced(self, referenced: set):
        """Drop cache entries and delete files not in ``referenced``
        (reference ``forgetUnreferencedBuckets``)."""
        if not BUCKET_GC:
            return  # reference DISABLE_BUCKET_GC: keep everything
        referenced = set(referenced) | {EMPTY.hash}
        for h in list(self._cache):
            if h not in referenced:
                del self._cache[h]
        if self.bucket_dir is None:
            return
        for name in os.listdir(self.bucket_dir):
            if not name.startswith("bucket-") or not name.endswith(".xdr"):
                continue
            h = bytes.fromhex(name[len("bucket-"):-len(".xdr")])
            if h not in referenced:
                os.unlink(os.path.join(self.bucket_dir, name))
