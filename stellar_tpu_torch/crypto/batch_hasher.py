"""Batched SHA-256 on the card — the port of
``stellar_tpu/crypto/batch_hasher.py``, the engine's second workload.

Catchup, the bucket list and TxSet handling hash thousands of small
independent messages (ledger headers, bucket levels, transaction
contents). :class:`BatchHasher` rides them on the same engine as the
verifier: the host packs and pads each message (``Sha256Workload.encode``)
and K3 (:func:`stellar_tpu_torch.ops.sha256.sha256_kernel`) compresses one
message a row.

A row's result is its (8,) uint32 digest words
(:func:`stellar_tpu_torch.ops.sha256.digest_words_to_bytes` renders the
bytes). The gate is fits-on-device: a message longer than the block
capacity (``MAX_BLOCKS * 64 - 9`` bytes) is hashed with ``hashlib`` in
``finalize`` — the reference's capacity policy — and counted under
``served["host"]``. Either way the digest is ``hashlib.sha256``'s.

:func:`hash_many` is the consumer API: ``hashlib`` below
``MIN_DEVICE_HASH_BATCH`` messages, where a device round trip costs more
than the hashing, the card at or above it. With no card it raises: the
port has no path that quietly hashes on the host instead.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from stellar_tpu_torch.ops import sha256 as sk
from stellar_tpu_torch.parallel import mesh
from stellar_tpu_torch.parallel.batch_engine import (
    BatchEngine, Workload, register_default_engine)
from stellar_tpu_torch.utils.device import resolve_device

__all__ = ["Sha256Workload", "BatchHasher", "default_hasher", "hash_many",
           "DEFAULT_HASH_BUCKET_SIZES", "MAX_BLOCKS",
           "MIN_DEVICE_HASH_BATCH"]

# A hash row carries MAX_BLOCKS * 64 bytes (verify's carries 128), so the
# ladder stops at 2,048 rows, as in the reference.
DEFAULT_HASH_BUCKET_SIZES = (128, 512, 2048)

# Blocks a row: messages up to 503 bytes (ledger headers, bucket levels,
# typical transaction contents); longer ones are hashed on the host.
MAX_BLOCKS = 8

# Below this many messages hash_many uses hashlib.
MIN_DEVICE_HASH_BATCH = 32


class Sha256Workload(Workload):
    """Host packing in ``encode``, K3 on the device, ``hashlib`` for the
    rows that do not fit."""

    metrics_ns = "crypto.hash"
    span_ns = "hash"
    libraries = ("sha256",)

    def encode(self, items: Sequence[bytes]) -> Tuple[np.ndarray, tuple]:
        words, active, fits = sk.pack_messages(items, MAX_BLOCKS)
        return fits, (words, active)

    def pad_rows(self) -> tuple:
        # no active block: a padding row's state stays H0
        return (np.zeros((1, MAX_BLOCKS, 16), dtype=np.uint32),
                np.zeros((1, MAX_BLOCKS), dtype=bool))

    def kernel_fn(self):
        return sk.sha256_kernel

    def empty_result(self, n: int) -> np.ndarray:
        return np.zeros((n, 8), dtype=np.uint32)

    def host_result(self, items: Sequence[bytes]) -> np.ndarray:
        return sk.host_digest_words(items)

    def finalize(self, gate: np.ndarray, out: np.ndarray,
                 items: Sequence[bytes]) -> np.ndarray:
        if gate.all():
            return out
        res = out.copy()
        idxs = np.flatnonzero(~gate)
        res[idxs] = self.host_result([items[i] for i in idxs])
        return res


class BatchHasher(BatchEngine):
    """Batched SHA-256: :class:`Sha256Workload` on the engine.

    Args:
      device: ``None`` for the first CUDA card (raises if there is none),
        ``"cuda[:N]"``, or ``"cpu"`` for the plain PyTorch kernel version.
      bucket_sizes: padded batch sizes, ascending.
      devices: instead of ``device``, a list of devices to split each
        bucket over; an entry may repeat.
    """

    def __init__(self, device=None, bucket_sizes=DEFAULT_HASH_BUCKET_SIZES,
                 devices=None):
        super().__init__(Sha256Workload(), device=device,
                         bucket_sizes=bucket_sizes, devices=devices)

    def hash_batch(self, msgs: Sequence[bytes]) -> List[bytes]:
        """The digests of ``msgs``, in order, equal to
        ``hashlib.sha256``'s. The call is the root span
        ``hash.blocking`` (``batch_engine.phase_attribution(...,
        span_ns="hash")``)."""
        return [sk.digest_words_to_bytes(row)
                for row in self.compute_batch(msgs)]

    def hash_words(self, msgs: Sequence[bytes]) -> np.ndarray:
        """The digest words, (n, 8) uint32: the engine's result rows."""
        return self.compute_batch(msgs)


_defaults: Dict[tuple, BatchHasher] = {}
_defaults_lock = threading.Lock()


def default_hasher(device=None) -> BatchHasher:
    """The process-wide hasher. With no ``device``, every visible card
    (split), or the one card unsplit; raises when there is none. With
    ``device``, that device alone."""
    devs = mesh.auto_devices() if device is None else None
    if devs is None:
        devs = [resolve_device(device)]
    key = tuple(str(d) for d in devs)
    with _defaults_lock:
        if key not in _defaults:
            _defaults[key] = BatchHasher(devices=list(key))
            register_default_engine(f"hash:{','.join(key)}",
                                    _defaults[key])
        return _defaults[key]


def hash_many(blobs: Sequence[bytes], device=None) -> List[bytes]:
    """SHA-256 of each blob, equal to ``hashlib.sha256(blob).digest()``.
    Fewer than ``MIN_DEVICE_HASH_BATCH`` blobs are hashed with
    ``hashlib``; more go through :func:`default_hasher` on ``device``
    (default: every visible CUDA card, the batch split over them, or the
    one card unsplit; raising when there is none)."""
    blobs = list(blobs)
    if len(blobs) < MIN_DEVICE_HASH_BATCH:
        return [hashlib.sha256(b).digest() for b in blobs]
    return default_hasher(device).hash_batch(blobs)
