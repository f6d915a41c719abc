"""Batched device dispatch with per-device fault domains — the port of
``stellar_tpu/parallel/batch_engine.py``'s ``Workload`` / ``BatchEngine``.

It keeps the reference's plugin contract and its dispatch: a batch is
split into chunks of at most the top bucket; each chunk is encoded on the
host, padded to the smallest bucket that holds it and handed to the
plugin's kernel; a chunk whose gate is all False skips the device.
``submit(items, variant=...)`` runs another plugin, a different kernel
over the same result rows (the hot-signer path), over the same ladder.

**Devices.** With one device entry the padded bucket is one part on
that device. With two or more entries (``devices=[...]``; an entry may
repeat) each bucket that divides by their count is split into ``b // n``
sub-chunks assigned by the engine's own
:class:`stellar_tpu_torch.parallel.device_health.DeviceHealth`
(``health``) ``.assign_parts``: healthy devices round-robin, one
probation sub-chunk for a device whose backoff has expired, none for a
quarantined one. The sub-chunk shape is the same whether or not a device
is quarantined, and pure-padding tail sub-chunks are skipped. A chunk's
padded rows are filled once into pinned host memory; each part's copy,
launch and event run on its device's current stream.

**Faults.** Libraries are built and loaded (``Workload.prepare``) before
any dispatch, so a build or load failure raises. A ``RuntimeError`` of a
copy, launch or fetch counts as a device fault: a launch is retried
``DISPATCH_RETRIES`` times, then the fault is charged to the part's
device breaker and the part is launched again on another device whose
breaker is closed. When no device is left the call raises, the last
fault chained. No row is ever recomputed on the host in place of a
device: a device's work moves only to another device.

**Deadline.** A part's result is fetched on a
:class:`stellar_tpu_torch.utils.resilience.WatchdogPool` worker (the
wait on its CUDA event and the read of its rows) while the resolving
thread waits at most ``DEADLINE_MS`` for it (:func:`_resolve_budget_s`:
on a card, or on the CPU with a device fault armed; on the CPU with no
fault the fetch runs unguarded). A missed deadline is a device fault:
it charges the part's device, counts in ``deadline_misses``, dumps the
flight recorder (``watchdog-timeout:device<i>``) and moves the part. The
abandoned worker finishes on its own and writes into a box nobody
reads: every count, the audit and the timeline are written only where
the resolving thread accepts a result. A part whose device breaker is
already open is not waited on (``short_circuits``).

**Audit.** Every device-served part re-checks a sample of its
gate-passing rows (``AUDIT_RATE``, 0.02 by default; content-seeded,
:mod:`stellar_tpu_torch.crypto.audit`) against ``plugin.host_result``.
The sample's host verdicts are computed at dispatch, while the card
works, and compared at resolve. A mismatch convicts the device: it is
quarantined and never gets another part of this engine, the plugin's
``on_audit_conviction`` drops what it derived from the part, and the
part (and every later part the device was given) is launched again on
another device. When none is left the call raises: wrong bits never
reach a caller.

**Tracing.** Every phase of a call is a span
(:mod:`stellar_tpu_torch.utils.tracing`) named ``<ns>.<phase>``
(``PHASE_SUFFIXES``; ``ns`` is the plugin's ``span_ns``, ``verify`` or
``hash``): ``prep`` (encode), ``bucket`` (the bucket and the parts,
padding and the pinned fill),
``dispatch`` (copy and launch), ``fetch`` (the guarded wait; the worker
opens ``<ns>.fetch.device`` under it), ``audit`` (the sample and its
comparison). :meth:`BatchEngine.compute_batch` is the root
``<ns>.blocking`` that collects them, and :func:`phase_attribution`
splits a blocking call's wall time by phase. Each resolve also leaves a
record of device busy and idle time in
:data:`stellar_tpu_torch.utils.timeline.pipeline_timeline`.

**Transfers and residency.** Each operand of a part is placed through
:data:`stellar_tpu_torch.parallel.residency.resident_cache`: its padded
host rows are fingerprinted, and while the cache is on (it starts off) a
hit reuses the tensor already on the part's device (``resident_hits``)
and a miss copies the rows and keeps the copy; while it is off every
operand is copied. :data:`stellar_tpu_torch.utils.transfer_ledger.transfer_ledger`
records each upload (with the fingerprint), each hit, and each accepted
result's whole padded rows; the engine keeps its own shape-derived
tallies beside it (``shipped_bytes``, ``fetched_bytes``), and a
resolve's ledger record rides its pipeline record. The reference's
coalesced sharded upload and donated operands have no counterpart here
(ROADMAP.md, divergences): each part's slice of one pinned fill is one
copy an operand on its device's stream, and the caching allocator reuses
a freed operand's block.

**Probe.** :func:`device_available` answers whether a card is reachable
from a daemon probe thread with a deadline and a breaker of its own; it
feeds :func:`dispatch_health` and sends nothing to the CPU.

**Service hooks.** The resident verify service
(:mod:`stellar_tpu_torch.crypto.verify_service`) registers its snapshot
(:func:`register_service_health`, read back under ``dispatch_health()
["service"]``; the fleet router likewise through
:func:`register_fleet_health` under ``["fleet"]``), dumps the flight
recorder on its first shed (:func:`note_shed_onset`) and reads
:func:`dispatch_degraded` as the pressure input of its shed ladder. The reference answers that from its
process-wide breaker and host-only flag, which the port has not; the
port's answer is the probe's ``dead`` or a default ``verify`` engine with
no device that admits work (ROADMAP.md, divergences).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stellar_tpu_torch.crypto import audit
from stellar_tpu_torch.ops import _build
from stellar_tpu_torch.parallel import device_health, residency
from stellar_tpu_torch.utils import faults, resilience, tracing
from stellar_tpu_torch.utils.device import resolve_device
from stellar_tpu_torch.utils.metrics import registry
from stellar_tpu_torch.utils.timeline import pipeline_timeline
from stellar_tpu_torch.utils.transfer_ledger import transfer_ledger

__all__ = ["DEFAULT_BUCKET_SIZES", "Workload", "BatchEngine",
           "configure_dispatch", "device_available", "start_device_probe",
           "dispatch_health", "served_counts", "phase_names",
           "phase_attribution", "dispatch_attribution", "trace_ranges",
           "note_trace_event", "register_default_engine",
           "register_service_health", "service_health_snapshot",
           "register_fleet_health", "fleet_health_snapshot",
           "note_shed_onset", "dispatch_degraded",
           "PHASE_SUFFIXES", "RESOLVE_PHASES", "RESOLVE_ROOT"]

_log = logging.getLogger("stellar_tpu_torch.dispatch")

# The production bucket ladder (the reference's DEFAULT_BUCKET_SIZES).
DEFAULT_BUCKET_SIZES = (128, 512, 2048, 4096, 8192, 16384)

# The longest a resolve waits on one part's result, ms (<= 0: no guard).
DEADLINE_MS = 8000.0
# Fresh launch attempts on the same device after a failed one.
DISPATCH_RETRIES = 1
# Share of each device-served part's gate-passing rows re-checked on the
# host (at least one row a part; <= 0 turns the audit off).
AUDIT_RATE = 0.02

# The phases of a blocking call, disjoint spans under its root: the sum
# of their times attributes the root's. ``host_fallback`` is never
# opened (the port has no host failover) but keeps the reference's keys.
PHASE_SUFFIXES = ("prep", "bucket", "dispatch", "fetch", "audit",
                  "host_fallback")
RESOLVE_PHASES = tuple(f"verify.{s}" for s in PHASE_SUFFIXES)
RESOLVE_ROOT = "verify.blocking"


def phase_names(span_ns: str) -> Tuple[str, ...]:
    return tuple(f"{span_ns}.{s}" for s in PHASE_SUFFIXES)


def trace_ranges(ids) -> list:
    """Per-row trace IDs compressed into ``[lo, hi)`` pairs, the form
    span and event records carry (``attrs["traces"]``): a run of
    consecutive IDs is one pair."""
    out: list = []
    for t in ids:
        t = int(t)
        if out and t == out[-1][1]:
            out[-1][1] = t + 1
        else:
            out.append([t, t + 1])
    return out


def _with_traces(traces, **attrs) -> dict:
    """Span or event attrs, with a part's ``traces`` ranges when it has
    any."""
    if traces:
        attrs["traces"] = traces
    return attrs


def note_trace_event(name: str, **attrs) -> None:
    """A flight-recorder instant event on a caller's behalf."""
    tracing.flight_recorder.note(name, **attrs)


def phase_attribution(before: dict, after: dict, reps: int = 1,
                      span_ns: str = "verify") -> dict:
    """Per-phase attribution of the blocking calls made between two
    :func:`stellar_tpu_torch.utils.tracing.span_totals` snapshots.

    Every phase is reported, zero-count ones included. The phases read
    the ``span.attr.<phase>`` timers, which a blocking root flushes when
    it completes, so a call still in flight adds nothing. ``coverage``
    is the phases' sum over the root's time: at 0.95 or more the
    breakdown explains the headline."""
    def delta(name, prefix="span.attr."):
        key = f"{prefix}{name}"
        b = before.get(key, {"count": 0, "sum_ms": 0.0})
        a = after.get(key, {"count": 0, "sum_ms": 0.0})
        return a["count"] - b["count"], a["sum_ms"] - b["sum_ms"]

    reps = max(1, int(reps))
    phases = {}
    phase_sum = 0.0
    for name in phase_names(span_ns):
        c, s = delta(name)
        phases[name] = {"count": c, "total_ms": round(s, 3),
                        "per_rep_ms": round(s / reps, 4)}
        phase_sum += s
    root_count, root_sum = delta(f"{span_ns}.blocking", prefix="span.")
    coverage = (phase_sum / root_sum) if root_sum > 0 else None
    return {
        "phases": phases,
        "span_sum_per_rep_ms": round(phase_sum / reps, 4),
        "blocking_span_per_rep_ms": round(root_sum / reps, 4),
        "blocking_span_count": root_count,
        "coverage": round(coverage, 4) if coverage is not None else None,
        "reps": reps,
    }


def dispatch_attribution(before: dict, after: dict, reps: int = 1) -> dict:
    """The verify workload's :func:`phase_attribution`."""
    return phase_attribution(before, after, reps, span_ns="verify")


def _on_probe_transition(old: str, new: str) -> None:
    _log.warning("device-probe breaker %s -> %s", old, new)
    if new == resilience.OPEN:
        tracing.flight_recorder.dump("breaker-open:device-probe")


# The device probe's breaker. The reference's process-wide breaker also
# gates its dispatch; the port's dispatch state is per engine, so this
# one paces only the probe (ROADMAP.md, divergences).
_probe_breaker = resilience.CircuitBreaker(
    name="device-probe", failure_threshold=3, backoff_min_s=1.0,
    backoff_max_s=120.0, on_transition=_on_probe_transition)


def configure_dispatch(deadline_ms: Optional[float] = None,
                       dispatch_retries: Optional[int] = None,
                       failure_threshold: Optional[int] = None,
                       backoff_min_s: Optional[float] = None,
                       backoff_max_s: Optional[float] = None,
                       audit_rate: Optional[float] = None) -> None:
    """Push the dispatch knobs for every engine in the process; None
    keeps the current value. ``deadline_ms <= 0`` turns the resolve
    watchdog off, ``audit_rate <= 0`` the audit; the breaker knobs shape
    the device probe's breaker (each engine's per-device breakers are
    its ``health.configure``)."""
    global DEADLINE_MS, DISPATCH_RETRIES, AUDIT_RATE
    if deadline_ms is not None:
        DEADLINE_MS = float(deadline_ms)
    if dispatch_retries is not None:
        DISPATCH_RETRIES = max(0, int(dispatch_retries))
    if audit_rate is not None:
        AUDIT_RATE = float(audit_rate)
    _probe_breaker.configure(failure_threshold=failure_threshold,
                             backoff_min_s=backoff_min_s,
                             backoff_max_s=backoff_max_s)


def _resolve_budget_s(device: torch.device) -> Optional[float]:
    """The deadline of one fetch from ``device``, or None (unguarded).
    Guarded on a card, whose failure is a hang, and whenever a device
    fault is armed; unguarded on the CPU otherwise, where the plain
    versions are slow but cannot hang and a false trip would only move
    parts in a test."""
    if DEADLINE_MS <= 0:
        return None
    if device.type == "cuda" or faults.is_active(faults.RESOLVE) or \
            faults.is_active(faults.DISPATCH) or \
            faults.is_active(faults.TRANSFER):
        return DEADLINE_MS / 1000.0
    return None


_engines_lock = threading.Lock()
_default_engines: Dict[str, "BatchEngine"] = {}


def register_default_engine(name: str, engine: "BatchEngine") -> None:
    """List a process-wide engine (``default_verifier``,
    ``default_hasher``) in :func:`dispatch_health` and
    :func:`served_counts`."""
    with _engines_lock:
        _default_engines[name] = engine


def _default_engine_items() -> List[tuple]:
    with _engines_lock:
        return sorted(_default_engines.items())


def served_counts() -> dict:
    """Each default engine's ``served`` tally (rows a device served, rows
    the host gate decided, rows of each variant)."""
    return {name: eng.health_snapshot()["served"]
            for name, eng in _default_engine_items()}


# ---------------- resident verify service hooks ----------------

_service_lock = threading.Lock()
_service_health_provider: Optional[Callable[[], dict]] = None


def register_service_health(provider: Optional[Callable[[], dict]]
                            ) -> None:
    """Install the resident verify service's snapshot callable, so
    :func:`dispatch_health` carries its queue depths and shed and reject
    counts beside the breakers. ``None`` unregisters (tests)."""
    global _service_health_provider
    with _service_lock:
        _service_health_provider = provider


def service_health_snapshot() -> dict:
    """The registered service's snapshot, or ``{"running": False}`` when
    no service ever started."""
    with _service_lock:
        provider = _service_health_provider
    return provider() if provider is not None else {"running": False}


_fleet_health_provider: Optional[Callable[[], dict]] = None


def register_fleet_health(provider: Optional[Callable[[], dict]]
                          ) -> None:
    """Install the replicated fleet's snapshot callable, so
    :func:`dispatch_health` carries its replicas' states and the fleet's
    conservation law beside the single service's. ``None`` unregisters
    (tests)."""
    global _fleet_health_provider
    with _service_lock:
        _fleet_health_provider = provider


def fleet_health_snapshot() -> dict:
    """The registered fleet's snapshot, or ``{"enabled": False}`` when no
    fleet ever started."""
    with _service_lock:
        provider = _fleet_health_provider
    return provider() if provider is not None else {"enabled": False}


def note_shed_onset(reason: str) -> None:
    """The service's first shed: dump the flight recorder, so the spans
    and queue events that led into the overload can be read."""
    registry.counter("crypto.verify.service.shed_onsets").inc()
    tracing.flight_recorder.dump(f"service-shed:{reason}")


def _admits_work(eng: "BatchEngine") -> bool:
    """Does any device index of ``eng`` take a part: not convicted and
    its breaker not open? Reads the breakers without moving them."""
    n = len(eng._devs)
    shut = set(eng.health.quarantined(n)) | eng.convicted
    return not set(range(n)) <= shut


def dispatch_degraded() -> bool:
    """True when the card path is unavailable to new work: the probe
    reads ``dead``, or a default ``verify`` engine has no device that
    admits work (every breaker open or every device quarantined). The
    verify service's shed ladder reads it as pressure level 2."""
    if _device_state == "dead":
        return True
    return any(name.split(":", 1)[0] == "verify" and not _admits_work(eng)
               for name, eng in _default_engine_items())


def dispatch_health() -> dict:
    """The dispatch layer's state: the probe, the knobs, the process's
    deadline, retry, short-circuit and audit counts, each default
    engine's fault domains (:meth:`BatchEngine.health_snapshot`), the
    watchdog pool, the flight recorder's accounting, the transfer
    ledger's totals, the resident cache, the verify service's snapshot
    and the fleet's."""
    return {
        "device_state": _device_state or "unprobed",
        "probe_breaker": _probe_breaker.snapshot(),
        "deadline_ms": DEADLINE_MS,
        "dispatch_retries": DISPATCH_RETRIES,
        "deadline_misses": registry.counter(
            "crypto.verify.dispatch.deadline_miss").count,
        "retries": registry.counter("crypto.verify.dispatch.retry").count,
        "short_circuits": registry.counter(
            "crypto.verify.dispatch.short_circuit").count,
        "audit": {
            "rate": AUDIT_RATE,
            "sampled": registry.counter("crypto.verify.audit.sampled").count,
            "mismatches": registry.counter(
                "crypto.verify.audit.mismatch").count,
        },
        "engines": {name: eng.health_snapshot()
                    for name, eng in _default_engine_items()},
        "watchdog": resilience.watchdog_stats(),
        "flight_recorder": tracing.flight_recorder.stats(),
        "transfer": transfer_ledger.totals(),
        "resident": residency.resident_cache.snapshot(),
        "service": service_health_snapshot(),
        "fleet": fleet_health_snapshot(),
    }


class Workload:
    """What a batch workload provides to ride the engine.

    * every array of ``encode``'s tuple (and of ``pad_rows``) carries the
      batch on its LEADING axis;
    * ``kernel_fn``'s callable takes the encoded tensors, padded and on
      one device, and returns ONE tensor, batch axis leading;
    * ``host_result`` must equal the device rows for gate-passing rows:
      it is the audit's oracle;
    * ``finalize`` composes the caller-visible result from the gate and
      the rows;
    * ``libraries`` names the kernel libraries ``kernel_fn`` launches;
      ``prepare`` builds and loads them for a card before any dispatch;
    * ``variant_name`` names a plugin passed as ``variant=`` to
      :meth:`BatchEngine.submit`: the engine counts the rows it serves
      under that key of ``served``;
    * ``metrics_ns`` prefixes the engine's metrics and pipeline records
      (``crypto.verify``), ``span_ns`` its spans (``verify``); an
      engine takes both from its primary plugin.
    """

    metrics_ns = "workload"
    span_ns = "workload"
    variant_name = None
    libraries: Tuple[str, ...] = ()

    def prepare(self, device: torch.device) -> None:
        """Build and load this workload's kernel libraries for ``device``
        (nothing for the CPU). Raises on a build or load failure."""
        if device.type == "cuda":
            for name in self.libraries:
                _build.library(name, device)

    def encode(self, items: Sequence) -> Tuple[np.ndarray, tuple]:
        """Host prep: ``items`` -> ``(gate, arrays)``; ``gate`` is True
        where the device result decides the row."""
        raise NotImplementedError

    def pad_rows(self) -> tuple:
        """One valid padding row per encoded array, shape ``(1, ...)``."""
        raise NotImplementedError

    def kernel_fn(self) -> Callable:
        raise NotImplementedError

    def empty_result(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def host_result(self, items: Sequence) -> np.ndarray:
        """The rows computed on the host, equal to the device's for
        gate-passing rows."""
        raise NotImplementedError

    def audit_material(self, encoded: tuple, lo: int, hi: int) -> bytes:
        """The bytes that seed the audit sample of rows ``lo:hi``: the
        rows the device received."""
        return b"".join(x[lo:hi].tobytes() for x in encoded)

    def on_audit_conviction(self, items: Sequence) -> None:
        """Hook: the audit convicted the device that served these items.
        A plugin that holds state derived from them drops it here."""

    def finalize(self, gate: np.ndarray, out: np.ndarray,
                 items: Sequence) -> np.ndarray:
        raise NotImplementedError


class _Part:
    """One part of a dispatched chunk: rows ``lo:hi``, padded to ``size``
    on device index ``dev``; its resolve's transfer-ledger token
    ``ttok``; its launch ``(host_rows, event, refs)`` (``refs`` keeps
    the operands alive while the card may still read or write them);
    the audit's sampled rows with their host verdicts."""

    __slots__ = ("lo", "hi", "size", "dev", "ttok", "launched", "sample",
                 "want")

    def __init__(self, lo: int, hi: int, size: int, dev: Optional[int],
                 ttok):
        self.lo, self.hi, self.size, self.dev = lo, hi, size, dev
        self.ttok = ttok
        self.launched = None
        self.sample: List[int] = []
        self.want = None


class BatchEngine:
    """Batched dispatcher over a bucket ladder and one or more devices.

    Args:
      plugin: the :class:`Workload`.
      device: ``None`` (the first CUDA card; raises if there is none),
        ``"cuda[:N]"`` or ``"cpu"`` (the plain PyTorch versions).
      bucket_sizes: padded batch sizes, ascending.
      devices: instead of ``device``, a list of devices of one type; with
        two or more entries each bucket that divides by their count is
        split into per-device sub-chunks. An entry may repeat.
    """

    def __init__(self, plugin: Workload, device=None,
                 bucket_sizes=DEFAULT_BUCKET_SIZES, devices=None):
        buckets = tuple(sorted(int(b) for b in bucket_sizes))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"bad bucket sizes {bucket_sizes!r}")
        if devices is None:
            devs = [resolve_device(device)]
        elif device is not None:
            raise ValueError("pass device or devices, not both")
        else:
            devs = [resolve_device(d) for d in devices]
            if not devs or len({d.type for d in devs}) != 1:
                raise ValueError(f"devices must be a non-empty list of one "
                                 f"device type; got {devices!r}")
        self._plugin = plugin
        self._ns = plugin.metrics_ns
        self._span_ns = plugin.span_ns
        self._buckets = buckets
        self.device = devs[0]
        #: the split's devices, or None for unsplit dispatch on ``device``
        self.devices = devs if len(devs) >= 2 else None
        # index i is device i of the breakers and faults (0: ``device``)
        self._devs = devs
        #: this engine's fault domains: one breaker a device index
        self.health = device_health.DeviceHealth()
        #: device indices the audit caught returning wrong bits; they get
        #: no further part of this engine
        self.convicted: set = set()
        self._prepared: set = set()
        self._stats_lock = threading.Lock()
        #: "device": rows (padding excluded) whose device result was
        #: accepted, whichever plugin ran them; a variant's name: the rows
        #: that variant's kernel served, of those; "host": rows whose gate
        #: was False, so the host decided them (the verifier's rejections,
        #: the hasher's oversize messages)
        self.served = {"device": 0, "host": 0}
        #: device index of the split -> rows it served
        self.device_served: dict = {}
        #: launch attempts repeated on the same device
        self.retries = 0
        #: fetches that missed the deadline (each charged to its device)
        self.deadline_misses = 0
        #: parts moved without a wait because their device's breaker was
        #: open when the resolve reached them
        self.short_circuits = 0
        #: operands served from the resident cache instead of a copy
        self.resident_hits = 0
        #: bytes copied to a device and bytes of accepted results,
        #: counted from the shapes, apart from the transfer ledger, which
        #: must agree with them
        self.shipped_bytes = 0
        self.fetched_bytes = 0
        #: the last audit verdicts (``audit.verdict_record``), oldest first
        self.audit_verdicts: deque = deque(maxlen=256)

    @property
    def audit_mismatches(self) -> int:
        """Parts whose audit sample disagreed with the host."""
        return sum(t["mismatch"]
                   for t in self.health.snapshot()["audits"].values())

    def health_snapshot(self) -> dict:
        """This engine's devices, serving tallies, fault counts and
        breakers (the per-engine part of :func:`dispatch_health`)."""
        with self._stats_lock:
            out = {"devices": [str(d) for d in self._devs],
                   "served": dict(self.served),
                   "device_served": dict(self.device_served),
                   "retries": self.retries,
                   "deadline_misses": self.deadline_misses,
                   "short_circuits": self.short_circuits,
                   "resident_hits": self.resident_hits,
                   "shipped_bytes": self.shipped_bytes,
                   "fetched_bytes": self.fetched_bytes,
                   "convicted": sorted(self.convicted)}
        out["device_health"] = self.health.snapshot()
        return out

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(f"chunk of {n} rows exceeds the top bucket")

    def _prepare(self, plugin: Workload) -> None:
        """Build and load the plugin's libraries for every device: a build
        or load failure raises to the caller."""
        for dev in dict.fromkeys(self._devs):
            key = (type(plugin), dev)
            with self._stats_lock:
                done = key in self._prepared
            if not done:
                # the build runs outside the lock: _build serializes it
                # and keeps the library, so a racing second prepare of the
                # same key only finds it built
                plugin.prepare(dev)
                with self._stats_lock:
                    self._prepared.add(key)

    def _fill(self, plugin: Workload, encoded: tuple, chunk: int,
              rows: int) -> tuple:
        """The chunk's rows padded to ``rows``, one host tensor an
        encoded array, in pinned memory for a card."""
        pinned = self.device.type == "cuda"
        hosts = []
        for arr, pad in zip(encoded, plugin.pad_rows()):
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            host = torch.empty((rows,) + arr.shape[1:], dtype=dtype,
                               pin_memory=pinned)
            hv = host.numpy()
            hv[:chunk] = arr
            hv[chunk:] = pad
            hosts.append(host)
        return tuple(hosts)

    def _place_operands(self, hosts: tuple, rows: slice,
                        dev: torch.device, part: _Part) -> list:
        """The part's operands on ``dev``, through the resident cache
        keyed by the physical device: a hit reuses the tensor already
        there; a miss (every operand while the cache is off) copies the
        padded host rows (``non_blocking``, on the device's current
        stream), records the upload with its fingerprint, and offers the
        copy to the cache. A kept tensor is a whole fresh copy that
        kernels only read."""
        cache = residency.resident_cache
        pkey = str(dev)
        ops = []
        for h in hosts:
            host = h[rows]
            arr = host.numpy()
            fp = residency.fingerprint(arr)
            hit = cache.get(fp, arr, pkey)
            if hit is not None:
                transfer_ledger.record_resident_hit(part.ttok, arr)
                with self._stats_lock:
                    self.resident_hits += 1
                ops.append(hit)
                continue
            placed = host.to(dev, non_blocking=True)
            # an operand over the cache's cap is fingerprinted under the
            # ledger's own cap
            if fp is not None:
                transfer_ledger.record_h2d(part.ttok, arr, fp=fp)
            else:
                transfer_ledger.record_h2d(part.ttok, arr)
            with self._stats_lock:
                self.shipped_bytes += int(np.prod(arr.shape)) * \
                    arr.dtype.itemsize
            cache.put(fp, arr, pkey, placed)
            ops.append(placed)
        return ops

    def _launch_part(self, plugin: Workload, hosts: tuple, part: _Part):
        """The part's padded rows (its slice of ``hosts``): placed on its
        device through the resident cache, the plugin's kernel and the
        copy of the result back, on the device's current stream. Returns
        ``(host_rows, event, refs)`` (event None on the CPU); a copy or
        launch fault raises its ``RuntimeError`` after
        ``DISPATCH_RETRIES`` fresh launches. A transfer fault is
        injected before the cache is asked, so it charges a device whose
        operands would have been hits."""
        dev = self._devs[part.dev]
        cuda = dev.type == "cuda"
        scope = torch.cuda.device(dev) if cuda else contextlib.nullcontext()
        rows = slice(part.lo, part.lo + part.size)
        with scope:
            faults.inject(faults.TRANSFER, device=part.dev)
            ops = self._place_operands(hosts, rows, dev, part)
        for attempt in range(1 + DISPATCH_RETRIES):
            try:
                with scope:
                    faults.inject(faults.DISPATCH, device=part.dev)
                    out_dev = plugin.kernel_fn()(*ops)
                    if not cuda:
                        return out_dev, None, ()
                    out_host = torch.empty(out_dev.shape,
                                           dtype=out_dev.dtype,
                                           pin_memory=True)
                    out_host.copy_(out_dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    return out_host, event, (hosts, ops, out_dev)
            except RuntimeError:
                if attempt == DISPATCH_RETRIES:
                    raise
                registry.counter("crypto.verify.dispatch.retry").inc()
                with self._stats_lock:
                    self.retries += 1

    def _device_fault(self, part: _Part, stage: str,
                      exc: BaseException) -> None:
        """Charge a copy, launch or fetch fault to the part's device; a
        quarantine onset dumps the flight recorder."""
        if self.health.record_failure(part.dev):
            tracing.flight_recorder.dump(f"quarantine:device{part.dev}")
        _log.warning("device %d %s failed (%s: %s); its rows move to "
                     "another device", part.dev, stage,
                     type(exc).__name__, exc)

    def _place(self, plugin: Workload, hosts: tuple, part: _Part,
               tried: set, exc: Optional[BaseException], ptok) -> None:
        """Launch the part on its device, or after a fault on another
        device whose breaker is closed and that has not failed this part;
        raises when none is left (``exc``: the fault that moved it)."""
        while True:
            if part.dev is not None and part.dev not in tried:
                try:
                    part.launched = self._launch_part(plugin, hosts, part)
                    pipeline_timeline.note_dispatch(ptok, part.dev)
                    return
                except RuntimeError as e:
                    self._device_fault(part, "launch", e)
                    tried.add(part.dev)
                    exc = e
            left = [i for i in range(len(self._devs))
                    if i not in tried and i not in self.convicted and
                    self.health.breaker(i).state == resilience.CLOSED]
            if not left:
                raise RuntimeError(
                    f"no device left to serve rows {part.lo}:{part.hi} "
                    f"(devices {[str(d) for d in self._devs]}, failed or "
                    f"convicted {sorted(tried | self.convicted)}, "
                    f"quarantined {self.health.quarantined(len(self._devs))})"
                ) from exc
            part.dev = left[0]

    def _dispatch(self, plugin: Workload, encoded: tuple, chunk: int,
                  ptok, ttok, traces) -> Tuple[tuple, List[_Part]]:
        """Dispatch one encoded chunk without blocking: one part, or with
        a split one sub-chunk a device. Returns the padded host rows and
        the parts."""
        with tracing.span(f"{self._span_ns}.bucket"), \
                pipeline_timeline.host_phase(ptok, "prep"):
            b = self._bucket(chunk)
            n_dev = len(self._devs)
            if n_dev < 2 or b % n_dev:
                size, n_parts = b, 1
            else:
                size = b // n_dev
                # sub-chunks that carry real rows: pure-padding tails
                # skipped
                n_parts = min(n_dev, -(-chunk // size))
            assignment = self.health.assign_parts(n_dev, n_parts,
                                                  exclude=self.convicted)
            if n_parts > 1 and assignment != list(range(n_parts)):
                tracing.flight_recorder.note(
                    f"{self._span_ns}.reshard", **_with_traces(
                        traces, assignment=list(assignment),
                        parts=n_parts, devices=n_dev))
            hosts = self._fill(plugin, encoded, chunk, n_parts * size)
        parts = []
        with tracing.span(f"{self._span_ns}.dispatch",
                          **_with_traces(traces)):
            for j, di in enumerate(assignment):
                part = _Part(j * size, min(j * size + size, chunk), size, di,
                             ttok)
                self._place(plugin, hosts, part, set(), None, ptok)
                parts.append(part)
        return hosts, parts

    def _sample(self, plugin: Workload, part: _Part, gate_c: np.ndarray,
                encoded_c: tuple, items_c: Sequence, ptok, traces) -> None:
        """The audit's content-seeded sample of the part's gate-passing
        rows and their host verdicts (computed while the card works)."""
        if AUDIT_RATE <= 0 or not gate_c[part.lo:part.hi].any():
            return
        with tracing.span(f"{self._span_ns}.audit",
                          **_with_traces(traces, device=part.dev)), \
                pipeline_timeline.host_phase(ptok, "audit"):
            eligible = np.flatnonzero(gate_c[part.lo:part.hi]).tolist()
            part.sample = audit.sample_rows(
                plugin.audit_material(encoded_c, part.lo, part.hi),
                eligible, AUDIT_RATE)
            if part.sample:
                registry.counter(self._ns + ".audit.sampled").inc(
                    len(part.sample))
                part.want = np.asarray(plugin.host_result(
                    [items_c[part.lo + i] for i in part.sample]))

    def _fetch(self, launched: tuple, dev: int, traces) -> np.ndarray:
        """A launch's whole padded result rows; runs on a watchdog worker
        (or the caller's thread when unguarded). Writes no count, the
        transfer ledger included: a fetch whose deadline passed finishes
        here unread."""
        host, event, _refs = launched
        with tracing.span(f"{self._span_ns}.fetch.device",
                          **_with_traces(traces, device=dev)):
            faults.inject(faults.RESOLVE, device=dev)
            if event is not None:
                event.synchronize()
            return faults.corrupt_verdicts(faults.RESOLVE, dev, host.numpy())

    def _wait(self, part: _Part, ptok, traces):
        """The part's rows, fetched under the deadline: ``(rows, None)``,
        or ``(None, fault)`` after charging a fetch fault or a missed
        deadline to the part's device."""
        attrs = _with_traces(traces, device=part.dev)
        with tracing.span(f"{self._span_ns}.fetch", **attrs), \
                pipeline_timeline.host_phase(ptok, "fetch"):
            try:
                full = resilience.call_with_deadline(
                    functools.partial(self._fetch, part.launched, part.dev,
                                      traces),
                    _resolve_budget_s(self._devs[part.dev]),
                    name=f"{self._span_ns}-resolve")
                # the one point where a result is accepted: the ledger,
                # the engine's tally and the timeline count it here only
                transfer_ledger.record_d2h(part.ttok, full)
                with self._stats_lock:
                    self.fetched_bytes += int(np.prod(full.shape)) * \
                        full.dtype.itemsize
                pipeline_timeline.note_delivery(ptok, part.dev)
                return full[:part.hi - part.lo], None
            except resilience.DeadlineExceeded as e:
                registry.counter(
                    "crypto.verify.dispatch.deadline_miss").inc()
                with self._stats_lock:
                    self.deadline_misses += 1
                self._device_fault(part, "fetch deadline", e)
                # while the fetch spans are open: the dump shows where
                # the wait is parked
                tracing.flight_recorder.dump(
                    f"watchdog-timeout:device{part.dev}")
                exc = e
            except RuntimeError as e:
                self._device_fault(part, "fetch", e)
                exc = e
            pipeline_timeline.note_delivery(ptok, part.dev,
                                            delivered=False)
            return None, exc

    def _audit(self, part: _Part, vals: np.ndarray, offset: int, ptok,
               traces) -> bool:
        """Compare the part's sampled rows with their host verdicts. True
        when clean or when nothing was sampled."""
        if not part.sample:
            return True
        with tracing.span(f"{self._span_ns}.audit",
                          **_with_traces(traces, device=part.dev)), \
                pipeline_timeline.host_phase(ptok, "audit"):
            clean = bool((part.want == vals[part.sample]).all())
            self.health.note_audit(part.dev, ok=clean,
                                   sampled=len(part.sample))
            record = audit.verdict_record(part.dev, offset + part.lo,
                                          offset + part.hi,
                                          len(part.sample), clean)
            with self._stats_lock:
                self.audit_verdicts.append(record)
            tracing.flight_recorder.note(
                f"{self._span_ns}.audit.verdict",
                **_with_traces(traces, **record))
        return clean

    def _convict(self, plugin: Workload, part: _Part, items: Sequence,
                 offset: int) -> None:
        """The audit caught wrong bits: quarantine the device for good and
        let the plugin drop what it derived from the part's items."""
        registry.counter(self._ns + ".audit.mismatch").inc()
        with self._stats_lock:
            self.convicted.add(part.dev)
        self.health.quarantine(part.dev, reason="audit-mismatch")
        tracing.flight_recorder.dump(f"audit-mismatch:device{part.dev}")
        plugin.on_audit_conviction(items)
        _log.error("audit mismatch: device %d returned wrong bits for rows "
                   "%d:%d; it serves this engine no more", part.dev,
                   offset + part.lo, offset + part.hi)

    def _resolve_part(self, plugin: Workload, part: _Part, hosts: tuple,
                      chunk: Sequence, offset: int, ptok,
                      traces) -> np.ndarray:
        """The part's accepted rows: fetched and audited, or after a
        fault, a missed deadline, an open breaker or a conviction
        launched again on another device."""
        tried: set = set()
        while True:
            exc = None
            if part.dev in self.convicted:
                pipeline_timeline.note_delivery(ptok, part.dev,
                                                delivered=False)
            elif self.health.breaker(part.dev).state == resilience.OPEN:
                registry.counter(
                    "crypto.verify.dispatch.short_circuit").inc()
                with self._stats_lock:
                    self.short_circuits += 1
                pipeline_timeline.note_delivery(ptok, part.dev,
                                                delivered=False)
                exc = RuntimeError(f"device {part.dev}'s breaker is open")
            else:
                vals, exc = self._wait(part, ptok, traces)
                if exc is None:
                    if self._audit(part, vals, offset, ptok, traces):
                        self.health.record_success(part.dev)
                        return vals
                    self._convict(plugin, part, chunk[part.lo:part.hi],
                                  offset)
            tried.add(part.dev)
            with tracing.span(f"{self._span_ns}.dispatch",
                              **_with_traces(traces)):
                self._place(plugin, hosts, part, tried, exc, ptok)

    def _mark_served(self, plugin: Workload, n: int, dev_idx: int) -> None:
        with self._stats_lock:
            self.served["device"] += n
            if plugin is not self._plugin:
                self.served[plugin.variant_name] = \
                    self.served.get(plugin.variant_name, 0) + n
            if self.devices is not None:
                self.device_served[dev_idx] = \
                    self.device_served.get(dev_idx, 0) + n
        registry.meter(self._ns + ".serve.device").mark(n)

    def submit(self, items: Sequence, trace_ids=None,
               variant: Optional[Workload] = None
               ) -> Callable[[], np.ndarray]:
        """Host prep and non-blocking device dispatch, chunk by top
        bucket, then the audit's host verdicts while the card works.
        Returns a zero-argument resolver that waits for the device and
        returns the per-item results. ``trace_ids`` (one per item) ride
        every span and recorder event of a part as ``trace_ranges``;
        ``variant`` replaces the engine's plugin for this call."""
        plugin = self._plugin if variant is None else variant
        items = list(items)
        n = len(items)
        if n == 0:
            return lambda: plugin.empty_result(0)
        trace_ids = list(trace_ids) if trace_ids is not None else None

        def traces_of(lo: int, hi: int):
            return trace_ranges(trace_ids[lo:hi]) if trace_ids else None

        self._prepare(plugin)
        ptok = pipeline_timeline.begin(self._ns)
        ttok = transfer_ledger.begin(self._ns)
        top = self._buckets[-1]
        pending = []
        for start in range(0, n, top):
            chunk = items[start:start + top]
            with tracing.span(f"{self._span_ns}.prep"), \
                    pipeline_timeline.host_phase(ptok, "prep"):
                gate, encoded = plugin.encode(chunk)
                with self._stats_lock:
                    self.served["host"] += int((~gate).sum())
            hosts, parts = self._dispatch(
                plugin, encoded, len(chunk), ptok, ttok,
                traces_of(start, start + len(chunk))) \
                if gate.any() else (None, [])
            pending.append((start, chunk, gate, encoded, hosts, parts))
        for start, chunk, gate, encoded, _hosts, parts in pending:
            for part in parts:
                self._sample(plugin, part, gate, encoded, chunk, ptok,
                             traces_of(start + part.lo, start + part.hi))
        # a batch the gate decided whole leaves no pipeline record
        dispatched = any(p[5] for p in pending)

        def resolve() -> np.ndarray:
            with tracing.span(f"{self._span_ns}.resolve"):
                try:
                    results = []
                    for start, chunk, gate, _enc, hosts, parts in pending:
                        out = plugin.empty_result(len(chunk))
                        for part in parts:
                            out[part.lo:part.hi] = self._resolve_part(
                                plugin, part, hosts, chunk, start, ptok,
                                traces_of(start + part.lo,
                                          start + part.hi))
                            self._mark_served(plugin, part.hi - part.lo,
                                              part.dev)
                        results.append(plugin.finalize(gate, out, chunk))
                    return results[0] if len(results) == 1 else \
                        np.concatenate(results)
                finally:
                    # both idempotent; the ledger's record rides the
                    # pipeline record
                    transfer = transfer_ledger.finish(ttok)
                    if dispatched:
                        pipeline_timeline.close(ptok, transfer=transfer)

        return resolve

    def compute_batch(self, items: Sequence, trace_ids=None) -> np.ndarray:
        """Blocking :meth:`submit` under the root span ``<ns>.blocking``,
        which collects its phases (:func:`phase_attribution`)."""
        with tracing.span(f"{self._span_ns}.blocking",
                          _collect=phase_names(self._span_ns)):
            return self.submit(items, trace_ids=trace_ids)()


# ---------------- the device probe ----------------

# None: not probed; "cuda": a card answered; "cpu": no CUDA device in
# this torch (configuration, never probed again); "dead": the probe
# failed or hung (probed again when the probe breaker allows)
_device_state: Optional[str] = None
_device_probe_lock = threading.Lock()
# the current attempt: {"thread", "box", "started", "accounted"}
_probe: Optional[dict] = None


def _launch_probe_locked() -> dict:
    """Start a probe attempt (with ``_device_probe_lock`` held). A probe
    that hangs is abandoned once accounted; the breaker's backoff bounds
    the leak to one thread a half-open window."""
    global _probe
    box: dict = {}

    def probe():
        try:
            faults.inject(faults.PROBE)
            if not torch.cuda.is_available():
                box["platform"] = "cpu"
                return
            # a tiny op read back: only a real round trip proves the card
            x = torch.ones(2, dtype=torch.int32, device="cuda:0")
            if int((x + 1).sum().item()) != 4:
                raise RuntimeError("the probe's op on cuda:0 returned a "
                                   "wrong value")
            box["platform"] = "cuda"
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=probe, daemon=True, name="device-probe")
    _probe = {"thread": t, "box": box, "started": time.monotonic(),
              "accounted": False}
    t.start()
    return _probe


def _account_probe_locked(cur: dict, hung: bool, timeout_s: float) -> None:
    """Turn a finished or overdue attempt into the device state and the
    probe breaker's accounting (with the lock held; once per attempt)."""
    global _device_state
    if cur["accounted"]:
        return
    cur["accounted"] = True
    box = cur["box"]
    if hung:
        _device_state = "dead"
        _probe_breaker.record_failure()
        _log.warning("device probe hung > %ss (probe breaker: %s)",
                     timeout_s, _probe_breaker.state)
    elif "platform" in box:
        _device_state = box["platform"]
        _probe_breaker.record_success()
    else:
        _device_state = "dead"
        _probe_breaker.record_failure()
        _log.warning("device probe failed (%s) (probe breaker: %s)",
                     box.get("error", "no answer"), _probe_breaker.state)


def start_device_probe() -> None:
    """Start the device probe without waiting for it (idempotent), so its
    cost is paid at start-up and not in the first call."""
    with _device_probe_lock:
        if _probe is None and _device_state is None:
            _launch_probe_locked()


def device_available(timeout_s: float = 30.0, block: bool = True) -> bool:
    """True when a card answered the probe and the probe breaker is
    closed. The probe runs on a daemon thread: ``faults.inject(PROBE)``,
    ``torch.cuda.is_available()``, one tiny op on ``cuda:0`` read back.

    * A torch with no CUDA device answers ``"cpu"``: False, for good.
    * A probe that fails, or hangs past ``timeout_s``, is ``"dead"``:
      False, charged to the probe breaker, and probed again once its
      backoff expires.
    * ``block=False`` never waits: a pending probe answers False and
      caches nothing, unless it is older than ``timeout_s``, when it is
      accounted hung.

    Nothing runs on the CPU because of the answer: it feeds
    :func:`dispatch_health` only."""
    start_device_probe()
    with _device_probe_lock:
        cur = _probe
        if cur is None or cur["accounted"]:
            if _device_state == "cpu":
                return False
            if _device_state == "cuda" and \
                    _probe_breaker.state == resilience.CLOSED:
                return True
            if _probe_breaker.allow():
                cur = _launch_probe_locked()
            else:
                return False
    t = cur["thread"]
    if block:
        # outside the lock: a blocking caller never holds up a
        # non-blocking one
        t.join(timeout_s)
    with _device_probe_lock:
        if not cur["accounted"]:
            if not t.is_alive():
                _account_probe_locked(cur, hung=False, timeout_s=timeout_s)
            elif block or time.monotonic() - cur["started"] > timeout_s:
                _account_probe_locked(cur, hung=True, timeout_s=timeout_s)
            else:
                return False
        return _device_state == "cuda" and \
            _probe_breaker.state == resilience.CLOSED


def _reset_dispatch_state_for_testing() -> None:
    """The probe, its breaker, the pipeline timeline, the transfer ledger
    and the resident cache as at process start (tests and
    ``chip_smoke.py``). Engines keep their own state; cumulative metrics
    are untouched."""
    global _device_state, _probe
    with _device_probe_lock:
        _device_state = None
        _probe = None
    _probe_breaker.record_success()
    pipeline_timeline._reset_for_testing()
    transfer_ledger._reset_for_testing()
    residency.resident_cache._reset_for_testing()
