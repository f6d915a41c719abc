"""Device-resident operand cache for the batch engine — the port's copy
of ``stellar_tpu/parallel/residency.py``.

A process-wide LRU of device tensors, bounded in bytes, keyed by
``(content fingerprint, shape, dtype, placement)``: the same SHA-256
content key the transfer ledger's redundancy detector uses, so the
cache removes exactly the uploads the ledger would call redundant.

The engine (:mod:`stellar_tpu_torch.parallel.batch_engine`), for each
operand of a part:

* :func:`fingerprint` gives the padded host rows' key (an operand over
  ``max_item_bytes`` gets ``None``: never cached, counted bytes-only);
* on a :meth:`DeviceResidentCache.get` hit reuses the resident tensor:
  no copy, the ledger records a ``resident_hit``;
* on a miss copies the rows to the device and
  keeps the copy with :meth:`DeviceResidentCache.put`.

A cached tensor is a whole, fresh copy that no kernel writes and that is
never a result, so a hit reads the same bytes an upload would have
placed. Eviction is by recency over the byte budget; it changes which
uploads are paid, never a result. Keys are content-derived, with no
clock and no RNG; every change holds the instance lock.

The budget and the item cap are the reference's, as module constants
(the reference's ``VERIFY_RESIDENT_*`` environment options; ROADMAP.md,
"Options"). The process-wide cache starts off, where the reference's
starts on (ROADMAP.md, divergences): a hit needs a part's whole padded
operand to repeat byte for byte, and real traffic does not send the same
rows twice. A caller whose calls repeat whole operands turns it on with
``resident_cache.configure(enabled=True)``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from stellar_tpu_torch.utils.metrics import registry

__all__ = ["DeviceResidentCache", "resident_cache", "fingerprint",
           "DEFAULT_CACHE_BYTES", "DEFAULT_MAX_ITEM_BYTES", "ENABLED"]

_NS = "crypto.resident"

# byte budget of the resident tensors (device memory on a card, host
# memory on the CPU)
DEFAULT_CACHE_BYTES = 128 << 20
# an operand's size cap, the transfer ledger's fingerprint cap: the
# SHA-256 runs inside the resolve, so its cost stays bounded, and a
# larger operand is never cached. It compares with ``>``: an operand of
# exactly 1 MiB (the hasher's words at its 2,048 bucket) is hashed and
# cached.
DEFAULT_MAX_ITEM_BYTES = 1 << 20
# the process-wide cache's switch at start
ENABLED = False


def fingerprint(arr, max_bytes: Optional[int] = None
                ) -> Optional[bytes]:
    """Content fingerprint of one host operand (a numpy array), or
    ``None`` when it is over the size cap (counted bytes-only, never
    cached). The digest covers the raw bytes; shape and dtype join the
    cache key, so two arrays sharing bytes but not layout never
    alias."""
    cap = resident_cache.max_item_bytes if max_bytes is None \
        else max_bytes
    nbytes = int(arr.nbytes)
    if nbytes > cap:
        return None
    # no copy for the engine's C-contiguous operands; tobytes() only
    # for other layouts (as the transfer ledger)
    try:
        buf = memoryview(arr)
        if not buf.c_contiguous:
            buf = arr.tobytes()
    except TypeError:
        buf = arr.tobytes()
    return hashlib.sha256(buf).digest()[:16]


class DeviceResidentCache:
    """Process-wide LRU of device tensors, bounded in bytes.

    Keys are ``(fingerprint, shape, dtype_str, placement)``, the shape
    and dtype those of the host array, ``placement`` where the bytes
    are resident: the engine passes the physical device,
    ``str(torch.device)``, so a card named four times in a split is one
    placement. The same content on another device is another entry."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES,
                 max_item_bytes: int = DEFAULT_MAX_ITEM_BYTES,
                 enabled: bool = True):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (arr, nbytes)
        self._bytes = 0
        self._max_bytes = max(0, int(max_bytes))
        self.max_item_bytes = max(0, int(max_item_bytes))
        self._enabled = bool(enabled)
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._inserts = 0

    # ---------------- knobs ----------------

    def configure(self, max_bytes: Optional[int] = None,
                  max_item_bytes: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        """Change the budget, the item cap or the switch; None keeps the
        current value. Shrinking the budget evicts at once; disabling
        clears the cache (resident tensors do not outlive the decision
        to stop keeping them)."""
        with self._lock:
            if max_bytes is not None:
                self._max_bytes = max(0, int(max_bytes))
            if max_item_bytes is not None:
                self.max_item_bytes = max(0, int(max_item_bytes))
            if enabled is not None:
                self._enabled = bool(enabled)
                if not self._enabled:
                    self._entries.clear()
                    self._bytes = 0
            self._evict_locked()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ---------------- the cache ----------------

    @staticmethod
    def key(fp: bytes, arr, placement) -> Tuple:
        return (fp, tuple(arr.shape), str(arr.dtype), placement)

    def get(self, fp: Optional[bytes], arr, placement):
        """The resident tensor for these exact bytes at this placement,
        or None (a miss, the cache off, or no fingerprint)."""
        if fp is None or not self._enabled:
            return None
        k = self.key(fp, arr, placement)
        with self._lock:
            hit = self._entries.get(k)
            if hit is None:
                self._misses += 1
                return None
            self._entries.move_to_end(k)
            self._hits += 1
        registry.counter(f"{_NS}.hits").inc()
        registry.counter(f"{_NS}.bytes_saved").inc(int(arr.nbytes))
        return hit[0]

    def put(self, fp: Optional[bytes], arr, placement,
            placed) -> bool:
        """Keep one freshly uploaded tensor ``placed``; True when it
        was kept. A kept tensor is only ever read: no kernel writes it
        and it is never a result."""
        if fp is None or not self._enabled:
            return False
        nbytes = int(arr.nbytes)
        if nbytes > self._max_bytes:
            return False
        k = self.key(fp, arr, placement)
        with self._lock:
            old = self._entries.pop(k, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[k] = (placed, nbytes)
            self._bytes += nbytes
            self._inserts += 1
            self._evict_locked()
        registry.counter(f"{_NS}.inserts").inc()
        return True

    def _evict_locked(self) -> None:
        while self._bytes > self._max_bytes and self._entries:
            _k, (_arr, nbytes) = self._entries.popitem(last=False)
            self._bytes -= nbytes
            self._evictions += 1

    # ---------------- introspection ----------------

    def snapshot(self) -> dict:
        """``dispatch_health()["resident"]``."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self._max_bytes,
                "max_item_bytes": self.max_item_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "inserts": self._inserts,
                "evictions": self._evictions,
            }

    def _reset_for_testing(self) -> None:
        """Drop every resident tensor and the tallies, as at process
        start. Cumulative registry counters are untouched, as in the
        transfer ledger's reset."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._hits = 0
            self._misses = 0
            self._evictions = 0
            self._inserts = 0


# the process-wide cache: residency is a property of the physical
# devices, shared by every engine
resident_cache = DeviceResidentCache(enabled=ENABLED)
