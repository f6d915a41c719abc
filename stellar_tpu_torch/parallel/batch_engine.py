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
is quarantined, and pure-padding tail sub-chunks are skipped. Each part's
pinned copy, launch and event run on its device's current stream; the
resolve waits on each part's event, not on the whole card.

**Faults.** Libraries are built and loaded (``Workload.prepare``) before
any dispatch, so a build or load failure raises. Only a ``RuntimeError``
of a copy, launch or fetch counts as a device fault: a launch is retried
``DISPATCH_RETRIES`` times, then the fault is charged to the part's
device breaker and the part is launched again on another device whose
breaker is closed. When no device is left the call raises. No row is
ever recomputed on the host in place of a device: a device's work moves
only to another device.

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

Not in this slice (ROADMAP.md): the deadline-guarded resolve and its
watchdog, tracing spans, the transfer ledger, the coalesced upload,
donation and the resident constant cache.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stellar_tpu_torch.crypto import audit
from stellar_tpu_torch.ops import _build
from stellar_tpu_torch.parallel import device_health
from stellar_tpu_torch.utils import faults, resilience
from stellar_tpu_torch.utils.device import resolve_device

__all__ = ["DEFAULT_BUCKET_SIZES", "Workload", "BatchEngine",
           "configure_dispatch"]

_log = logging.getLogger("stellar_tpu_torch.dispatch")

# The production bucket ladder (the reference's DEFAULT_BUCKET_SIZES).
DEFAULT_BUCKET_SIZES = (128, 512, 2048, 4096, 8192, 16384)

# Fresh launch attempts on the same device after a failed one.
DISPATCH_RETRIES = 1
# Share of each device-served part's gate-passing rows re-checked on the
# host (at least one row a part; <= 0 turns the audit off).
AUDIT_RATE = 0.02


def configure_dispatch(audit_rate: Optional[float] = None) -> None:
    """Push the audit rate for every engine in the process; None keeps
    the current value, ``<= 0`` turns the audit off."""
    global AUDIT_RATE
    if audit_rate is not None:
        AUDIT_RATE = float(audit_rate)


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
      under that key of ``served``.
    """

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
    on device index ``dev``, its launch ``(host_rows, event)``, and the
    audit's sampled rows with their host verdicts."""

    __slots__ = ("lo", "hi", "size", "dev", "launched", "sample", "want")

    def __init__(self, lo: int, hi: int, size: int, dev: Optional[int]):
        self.lo, self.hi, self.size, self.dev = lo, hi, size, dev
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
        #: the last audit verdicts (``audit.verdict_record``), oldest first
        self.audit_verdicts: deque = deque(maxlen=256)

    @property
    def audit_mismatches(self) -> int:
        """Parts whose audit sample disagreed with the host."""
        return sum(t["mismatch"]
                   for t in self.health.snapshot()["audits"].values())

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
            if key not in self._prepared:
                plugin.prepare(dev)
                self._prepared.add(key)

    def _launch_part(self, plugin: Workload, encoded: tuple, part: _Part):
        """The part's rows, padded to its size: pinned copy to its
        device, the plugin's kernel and the copy of the result back, on
        the device's current stream. Returns ``(host_rows, event)``
        (event None on the CPU); a copy or launch fault raises its
        ``RuntimeError`` after ``DISPATCH_RETRIES`` fresh launches."""
        dev = self._devs[part.dev]
        cuda = dev.type == "cuda"
        scope = torch.cuda.device(dev) if cuda else contextlib.nullcontext()
        lo, hi = part.lo, part.hi
        with scope:
            faults.inject(faults.TRANSFER, device=part.dev)
            ops = []
            for arr, pad in zip(encoded, plugin.pad_rows()):
                dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
                host = torch.empty((part.size,) + arr.shape[1:],
                                   dtype=dtype, pin_memory=cuda)
                hv = host.numpy()
                hv[:hi - lo] = arr[lo:hi]
                hv[hi - lo:] = pad
                ops.append(host.to(dev, non_blocking=True))
        for attempt in range(1 + DISPATCH_RETRIES):
            try:
                with scope:
                    faults.inject(faults.DISPATCH, device=part.dev)
                    out_dev = plugin.kernel_fn()(*ops)
                    if not cuda:
                        return out_dev, None
                    out_host = torch.empty(out_dev.shape,
                                           dtype=out_dev.dtype,
                                           pin_memory=True)
                    out_host.copy_(out_dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    return out_host, event
            except RuntimeError:
                if attempt == DISPATCH_RETRIES:
                    raise
                with self._stats_lock:
                    self.retries += 1

    def _device_fault(self, part: _Part, stage: str,
                      exc: BaseException) -> None:
        """Charge a copy, launch or fetch fault to the part's device."""
        self.health.record_failure(part.dev)
        _log.warning("device %d %s failed (%s: %s); its rows move to "
                     "another device", part.dev, stage,
                     type(exc).__name__, exc)

    def _place(self, plugin: Workload, encoded: tuple, part: _Part,
               tried: set, exc: Optional[BaseException]) -> None:
        """Launch the part on its device, or after a fault on another
        device whose breaker is closed and that has not failed this part;
        raises when none is left (``exc``: the fault that moved it)."""
        while True:
            if part.dev is not None and part.dev not in tried:
                try:
                    part.launched = self._launch_part(plugin, encoded, part)
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

    def _dispatch(self, plugin: Workload, encoded: tuple,
                  chunk: int) -> List[_Part]:
        """Dispatch one encoded chunk without blocking: one part, or with
        a split one sub-chunk a device."""
        b = self._bucket(chunk)
        n_dev = len(self._devs)
        if n_dev < 2 or b % n_dev:
            size, n_parts = b, 1
        else:
            size = b // n_dev
            # sub-chunks that carry real rows: pure-padding tails skipped
            n_parts = min(n_dev, -(-chunk // size))
        parts = []
        for j, di in enumerate(self.health.assign_parts(
                n_dev, n_parts, exclude=self.convicted)):
            part = _Part(j * size, min(j * size + size, chunk), size, di)
            self._place(plugin, encoded, part, set(), None)
            parts.append(part)
        return parts

    def _sample(self, plugin: Workload, part: _Part, gate_c: np.ndarray,
                encoded_c: tuple, items_c: Sequence) -> None:
        """The audit's content-seeded sample of the part's gate-passing
        rows and their host verdicts (computed while the card works)."""
        if AUDIT_RATE <= 0:
            return
        eligible = np.flatnonzero(gate_c[part.lo:part.hi]).tolist()
        if not eligible:
            return
        part.sample = audit.sample_rows(
            plugin.audit_material(encoded_c, part.lo, part.hi), eligible,
            AUDIT_RATE)
        if part.sample:
            part.want = np.asarray(plugin.host_result(
                [items_c[part.lo + i] for i in part.sample]))

    def _fetch(self, part: _Part) -> np.ndarray:
        """The result rows of a launched part; a wait or copy fault
        raises its ``RuntimeError``."""
        host, event = part.launched
        faults.inject(faults.RESOLVE, device=part.dev)
        if event is not None:
            event.synchronize()
        vals = host[:part.hi - part.lo].numpy()
        return faults.corrupt_verdicts(faults.RESOLVE, part.dev, vals)

    def _audit(self, part: _Part, vals: np.ndarray, offset: int) -> bool:
        """Compare the part's sampled rows with their host verdicts. True
        when clean or when nothing was sampled."""
        if not part.sample:
            return True
        clean = bool((part.want == vals[part.sample]).all())
        self.health.note_audit(part.dev, ok=clean, sampled=len(part.sample))
        with self._stats_lock:
            self.audit_verdicts.append(audit.verdict_record(
                part.dev, offset + part.lo, offset + part.hi,
                len(part.sample), clean))
        return clean

    def _convict(self, plugin: Workload, part: _Part, items: Sequence,
                 offset: int) -> None:
        """The audit caught wrong bits: quarantine the device for good and
        let the plugin drop what it derived from the part's items."""
        self.convicted.add(part.dev)
        self.health.quarantine(part.dev, reason="audit-mismatch")
        plugin.on_audit_conviction(items)
        _log.error("audit mismatch: device %d returned wrong bits for rows "
                   "%d:%d; it serves this engine no more", part.dev,
                   offset + part.lo, offset + part.hi)

    def _resolve_part(self, plugin: Workload, part: _Part, encoded: tuple,
                      chunk: Sequence, offset: int) -> np.ndarray:
        """The part's accepted rows: fetched and audited, or after a
        fault or a conviction launched again on another device."""
        tried: set = set()
        while True:
            exc = None
            if part.dev not in self.convicted:
                try:
                    vals = self._fetch(part)
                except RuntimeError as e:
                    self._device_fault(part, "fetch", e)
                    exc = e
                else:
                    if self._audit(part, vals, offset):
                        self.health.record_success(part.dev)
                        return vals
                    self._convict(plugin, part, chunk[part.lo:part.hi],
                                  offset)
            tried.add(part.dev)
            self._place(plugin, encoded, part, tried, exc)

    def _mark_served(self, plugin: Workload, n: int, dev_idx: int) -> None:
        with self._stats_lock:
            self.served["device"] += n
            if plugin is not self._plugin:
                self.served[plugin.variant_name] = \
                    self.served.get(plugin.variant_name, 0) + n
            if self.devices is not None:
                self.device_served[dev_idx] = \
                    self.device_served.get(dev_idx, 0) + n

    def submit(self, items: Sequence,
               variant: Optional[Workload] = None
               ) -> Callable[[], np.ndarray]:
        """Host prep and non-blocking device dispatch, chunk by top
        bucket, then the audit's host verdicts while the card works.
        Returns a zero-argument resolver that waits for the device and
        returns the per-item results. ``variant`` replaces the engine's
        plugin for this call."""
        plugin = self._plugin if variant is None else variant
        items = list(items)
        n = len(items)
        if n == 0:
            return lambda: plugin.empty_result(0)
        self._prepare(plugin)
        top = self._buckets[-1]
        pending = []
        for start in range(0, n, top):
            chunk = items[start:start + top]
            gate, encoded = plugin.encode(chunk)
            with self._stats_lock:
                self.served["host"] += int((~gate).sum())
            parts = self._dispatch(plugin, encoded, len(chunk)) \
                if gate.any() else []
            pending.append((start, chunk, gate, encoded, parts))
        for _start, chunk, gate, encoded, parts in pending:
            for part in parts:
                self._sample(plugin, part, gate, encoded, chunk)

        def resolve() -> np.ndarray:
            results = []
            for start, chunk, gate, encoded, parts in pending:
                out = plugin.empty_result(len(chunk))
                for part in parts:
                    out[part.lo:part.hi] = self._resolve_part(
                        plugin, part, encoded, chunk, start)
                    self._mark_served(plugin, part.hi - part.lo, part.dev)
                results.append(plugin.finalize(gate, out, chunk))
            return results[0] if len(results) == 1 else \
                np.concatenate(results)

        return resolve

    def compute_batch(self, items: Sequence) -> np.ndarray:
        """Blocking :meth:`submit`."""
        return self.submit(items)()
