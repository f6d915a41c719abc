"""Transfer ledger: each resolve's host-to-device and device-to-host
bytes — the port's copy of ``stellar_tpu/utils/transfer_ledger.py``.

The engine (:mod:`stellar_tpu_torch.parallel.batch_engine`) records every
operand it places on a device and every result it accepts, so each
resolve yields:

* ``round_trips`` — accepted fetches (one a part whose result the host
  waited on);
* ``bytes_h2d`` / ``bytes_d2h`` — payload bytes each way;
* ``redundant_constant_bytes`` — uploaded bytes whose content
  fingerprint (the first 16 bytes of their SHA-256) was uploaded
  before: content shipped again. The device-resident cache
  (:mod:`stellar_tpu_torch.parallel.residency`) serves a repeated
  operand from the card instead, recorded here as a ``resident_hit``
  (bytes the engine did not move), so with the cache on this stays near
  zero;
* ``unfingerprinted_uploads`` — uploads over the fingerprint cap,
  counted bytes-only (a hot bucket's signer-table operand).

Totals surface in ``dispatch_health()["transfer"]`` and the
``crypto.transfer.*`` counters; a resolve's record rides its pipeline
record (``transfer``). The engine keeps its own shape-derived tallies
(``shipped_bytes``, ``fetched_bytes``), and the two reconcile exactly
when every transfer path is recorded. Fingerprints are content-derived
(no salt, no clock, no RNG); every change holds the instance lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Optional

from stellar_tpu_torch.utils.metrics import registry

__all__ = ["TransferLedger", "ResolveLog", "transfer_ledger"]

# the reference's defaults; configure() changes them at run time
DEFAULT_RESOLVES = 256
DEFAULT_FINGERPRINTS = 4096
# content-fingerprint size cap: the hash runs inside the resolve the
# ledger measures, so an upload larger than this is counted bytes-only
# (never falsely redundant, never an unbounded SHA-256) and tallied in
# ``unfingerprinted_uploads``, so the detector's blind spot shows. A hot
# bucket's signer-table operand (15,360 B a row) is over it from 69 rows
# on.
DEFAULT_FP_MAX_BYTES = 1 << 20

_NS = "crypto.transfer"

# sentinel: "no precomputed fingerprint passed" (None is a legitimate
# value meaning "over the size cap — count bytes-only")
_UNSET = object()


class ResolveLog:
    """Accumulator for ONE resolve's transfers (an opaque token the
    engine carries on each part; every field changes under the owning
    ledger's lock)."""

    __slots__ = ("ns", "round_trips", "bytes_h2d", "bytes_d2h",
                 "device_puts", "fetches", "redundant_constant_bytes",
                 "redundant_uploads", "resident_hits",
                 "resident_bytes", "finished")

    def __init__(self, ns: str):
        self.ns = ns
        self.round_trips = 0
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.device_puts = 0
        self.fetches = 0
        self.redundant_constant_bytes = 0
        self.redundant_uploads = 0
        self.resident_hits = 0
        self.resident_bytes = 0
        self.finished = False

    def snapshot_locked(self) -> dict:
        return {"ns": self.ns,
                "round_trips": self.round_trips,
                "bytes_h2d": self.bytes_h2d,
                "bytes_d2h": self.bytes_d2h,
                "device_puts": self.device_puts,
                "fetches": self.fetches,
                "redundant_constant_bytes":
                    self.redundant_constant_bytes,
                "redundant_uploads": self.redundant_uploads,
                "resident_hits": self.resident_hits,
                "resident_bytes": self.resident_bytes}


class TransferLedger:
    """Process-wide transfer accounting: running totals, a bounded
    ring of per-resolve records, and a bounded LRU of upload content
    fingerprints for redundancy detection."""

    def __init__(self, resolves: int = DEFAULT_RESOLVES,
                 fingerprints: int = DEFAULT_FINGERPRINTS,
                 fp_max_bytes: int = DEFAULT_FP_MAX_BYTES):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(4, int(resolves)))
        self._fp_cap = max(16, int(fingerprints))
        self._fp_max_bytes = max(0, int(fp_max_bytes))
        self._unfingerprinted_uploads = 0
        self._unfingerprinted_bytes = 0
        # fingerprint -> times uploaded (a bounded LRU: eviction forgets
        # only old content, so bytes re-shipped every bucket keep
        # counting as redundant)
        self._fingerprints: OrderedDict = OrderedDict()
        self._round_trips = 0
        self._bytes_h2d = 0
        self._bytes_d2h = 0
        self._device_puts = 0
        self._fetches = 0
        self._redundant_constant_bytes = 0
        self._redundant_uploads = 0
        self._resident_hits = 0
        self._resident_bytes = 0
        self._resolves_finished = 0

    def configure(self, resolves: Optional[int] = None,
                  fingerprints: Optional[int] = None,
                  fp_max_bytes: Optional[int] = None) -> None:
        """Resize the ring, the fingerprint LRU or the fingerprint cap;
        None keeps the current value."""
        with self._lock:
            if resolves is not None:
                cap = max(4, int(resolves))
                if cap != self._ring.maxlen:
                    self._ring = deque(self._ring, maxlen=cap)
            if fingerprints is not None:
                self._fp_cap = max(16, int(fingerprints))
                while len(self._fingerprints) > self._fp_cap:
                    self._fingerprints.popitem(last=False)
            if fp_max_bytes is not None:
                self._fp_max_bytes = max(0, int(fp_max_bytes))

    # ---------------- per-resolve recording ----------------

    def begin(self, ns: str) -> ResolveLog:
        """Open a per-resolve token (registered nowhere until
        :meth:`finish`: a resolver the caller drops is garbage-collected,
        its events already in the totals)."""
        return ResolveLog(ns)

    def record_h2d(self, tok: Optional[ResolveLog], arr, fp=_UNSET) -> int:
        """One host-to-device upload of the host array ``arr`` (a
        numpy array: an operand's padded rows). Fingerprints the
        content: a fingerprint seen before means these bytes were
        already shipped, a redundant upload. An upload over the
        fingerprint cap is counted bytes-only (a partial hash could
        convict different content) and tallied in
        ``unfingerprinted_uploads``. ``fp`` passes the fingerprint the
        engine already computed for the resident cache (one SHA-256 an
        upload, not two); omit it and the ledger hashes for itself.
        Returns the byte count."""
        nbytes = int(arr.nbytes)
        if fp is _UNSET and nbytes <= self._fp_max_bytes:
            # no copy for the engine's C-contiguous operands (axis-0
            # slices); tobytes() only for other layouts
            try:
                buf = memoryview(arr)
                if not buf.c_contiguous:
                    buf = arr.tobytes()
            except TypeError:
                buf = arr.tobytes()
            fp = hashlib.sha256(buf).digest()[:16]
        elif fp is _UNSET:
            fp = None
        with self._lock:
            if fp is not None:
                seen = self._fingerprints.pop(fp, 0)
                self._fingerprints[fp] = seen + 1
                while len(self._fingerprints) > self._fp_cap:
                    self._fingerprints.popitem(last=False)
            else:
                seen = 0
                self._unfingerprinted_uploads += 1
                self._unfingerprinted_bytes += nbytes
            self._bytes_h2d += nbytes
            self._device_puts += 1
            redundant = seen > 0
            if redundant:
                self._redundant_constant_bytes += nbytes
                self._redundant_uploads += 1
            if tok is not None:
                tok.bytes_h2d += nbytes
                tok.device_puts += 1
                if redundant:
                    tok.redundant_constant_bytes += nbytes
                    tok.redundant_uploads += 1
        registry.counter(f"{_NS}.bytes_h2d").inc(nbytes)
        registry.counter(f"{_NS}.device_puts").inc()
        if redundant:
            registry.counter(
                f"{_NS}.redundant_constant_bytes").inc(nbytes)
            registry.counter(f"{_NS}.redundant_uploads").inc()
        return nbytes

    def record_resident_hit(self, tok: Optional[ResolveLog], arr) -> int:
        """One operand served from the device-resident cache
        (:mod:`stellar_tpu_torch.parallel.residency`): no bytes moved,
        no fingerprint touched. Tallied apart from h2d, so a record
        shows both the uploads and the hits that replaced them. Returns
        the byte count the hit avoided."""
        nbytes = int(arr.nbytes)
        with self._lock:
            self._resident_hits += 1
            self._resident_bytes += nbytes
            if tok is not None:
                tok.resident_hits += 1
                tok.resident_bytes += nbytes
        registry.counter(f"{_NS}.resident_hits").inc()
        registry.counter(f"{_NS}.resident_bytes").inc(nbytes)
        return nbytes

    def record_d2h(self, tok: Optional[ResolveLog], arr) -> int:
        """One accepted device-to-host fetch of a part's whole padded
        result rows: one round trip (the host waited on this result).
        Returns bytes."""
        nbytes = int(arr.nbytes)
        with self._lock:
            self._bytes_d2h += nbytes
            self._fetches += 1
            self._round_trips += 1
            if tok is not None:
                tok.bytes_d2h += nbytes
                tok.fetches += 1
                tok.round_trips += 1
        registry.counter(f"{_NS}.bytes_d2h").inc(nbytes)
        registry.counter(f"{_NS}.fetches").inc()
        registry.counter(f"{_NS}.round_trips").inc()
        return nbytes

    def finish(self, tok: Optional[ResolveLog]) -> Optional[dict]:
        """Close a resolve's token into the per-resolve ring
        (idempotent — a resolver resolved twice records once)."""
        if tok is None:
            return None
        with self._lock:
            rec = tok.snapshot_locked()
            if not tok.finished:
                tok.finished = True
                self._ring.append(rec)
                self._resolves_finished += 1
        return rec

    # ---------------- introspection ----------------

    def totals(self) -> dict:
        """Running process totals: ``dispatch_health()["transfer"]``."""
        with self._lock:
            return {
                "round_trips": self._round_trips,
                "bytes_h2d": self._bytes_h2d,
                "bytes_d2h": self._bytes_d2h,
                "device_puts": self._device_puts,
                "fetches": self._fetches,
                "redundant_constant_bytes":
                    self._redundant_constant_bytes,
                "redundant_uploads": self._redundant_uploads,
                "resident_hits": self._resident_hits,
                "resident_bytes": self._resident_bytes,
                "resolves_recorded": self._resolves_finished,
                "fingerprints_tracked": len(self._fingerprints),
                "unfingerprinted_uploads":
                    self._unfingerprinted_uploads,
                "unfingerprinted_bytes": self._unfingerprinted_bytes,
            }

    def recent(self, limit: int = 32) -> list:
        """The most recent per-resolve records; ``limit=0`` means
        none."""
        limit = max(0, int(limit))
        with self._lock:
            return [dict(r) for r in
                    (list(self._ring)[-limit:] if limit else [])]

    def _reset_for_testing(self) -> None:
        """Fresh ledger state (per-resolve ring, fingerprints, totals).
        Cumulative registry counters are untouched, as in the dispatch
        layer's reset."""
        with self._lock:
            self._ring.clear()
            self._fingerprints.clear()
            self._unfingerprinted_uploads = 0
            self._unfingerprinted_bytes = 0
            self._round_trips = 0
            self._bytes_h2d = 0
            self._bytes_d2h = 0
            self._device_puts = 0
            self._fetches = 0
            self._redundant_constant_bytes = 0
            self._redundant_uploads = 0
            self._resident_hits = 0
            self._resident_bytes = 0
            self._resolves_finished = 0


# the process-wide ledger, like the registry and the flight recorder
transfer_ledger = TransferLedger()
