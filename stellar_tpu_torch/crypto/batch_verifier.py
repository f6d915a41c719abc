"""Batch ed25519 verification on the card — the port of
``stellar_tpu/crypto/batch_verifier.py``.

Callers hand over (pubkey, message, signature) triples and get back one
bool per triple, with libsodium's ``crypto_sign_verify_detached``
decisions. The work splits as in the reference:

* host (byte-level): lengths, canonical s (s < L), canonical A (y < p),
  the small-order blocklist for R and A — numpy; h = SHA-512(R||A||M)
  mod L — multithreaded C++ (:mod:`stellar_tpu_torch.crypto.native_prep`);
* device: decompression, the double scalar multiplication and the
  encode-compare in one CUDA kernel (:mod:`stellar_tpu_torch.ops.verify`).

The verdict is the host gate AND the device bit. As in the reference,
:meth:`BatchVerifier.submit` partitions each batch by the process-wide
signer-table cache (:mod:`stellar_tpu_torch.parallel.signer_tables`, on
by default): a signer's first sight rides the cold kernel K1 and installs
its table, every repeat rides the hot kernel K2
(:class:`Ed25519HotWorkload`) with that table as an operand. With the
cache off every row rides cold. The split never changes a verdict.

Both workloads ride the engine's fault domains: a part whose copy, launch
or fetch fails moves to another device, and a sample of every
device-served part (the audit) is verified on the host by
:func:`stellar_tpu_torch.crypto.native_verify.host_verify`, the
libsodium-exact host oracle. :func:`default_verifier`
spans every visible card (:func:`stellar_tpu_torch.parallel.mesh.
auto_devices`), and one card unsplit when there is one.

The engine's dispatch surface is re-exported here, as from the reference
module: :func:`configure_dispatch`, :func:`device_available`,
:func:`start_device_probe`, :func:`dispatch_health`,
:func:`dispatch_attribution` over the ``verify.*`` spans, and the verify
service's hooks (:func:`register_service_health`,
:func:`service_health_snapshot`, :func:`note_shed_onset`,
:func:`dispatch_degraded`) and the fleet router's
(:func:`register_fleet_health`, :func:`fleet_health_snapshot`).

:meth:`BatchVerifier.install` makes a verifier the backend of the port's
node cache (:mod:`stellar_tpu_torch.crypto.keys`), optionally behind a
:class:`TrickleBatcher`, the micro-batch window for lone verifies.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import native_prep, native_verify
from stellar_tpu_torch.ops import verify as vk
from stellar_tpu_torch.parallel import mesh, signer_tables
from stellar_tpu_torch.parallel.batch_engine import (  # noqa: F401
    DEFAULT_BUCKET_SIZES, RESOLVE_PHASES, RESOLVE_ROOT, BatchEngine,
    Workload, configure_dispatch, device_available, dispatch_attribution,
    dispatch_degraded, dispatch_health, fleet_health_snapshot,
    note_shed_onset, note_trace_event, register_default_engine,
    register_fleet_health, register_service_health,
    service_health_snapshot, start_device_probe, trace_ranges)
from stellar_tpu_torch.utils import resilience, tracing
from stellar_tpu_torch.utils.device import resolve_device
from stellar_tpu_torch.utils.metrics import registry

__all__ = ["BatchVerifier", "Ed25519Workload", "Ed25519HotWorkload",
           "TrickleBatcher", "default_verifier", "configure_dispatch",
           "device_available", "start_device_probe", "dispatch_health",
           "dispatch_attribution", "dispatch_degraded", "note_shed_onset",
           "note_trace_event", "trace_ranges", "register_service_health",
           "service_health_snapshot", "register_fleet_health",
           "fleet_health_snapshot", "RESOLVE_PHASES", "RESOLVE_ROOT"]

# libsodium's blocklist, as a (14, 32) uint8 matrix for a vectorized compare.
_SMALL_ORDER = np.stack([np.frombuffer(e, dtype=np.uint8)
                         for e in sorted(ref.SMALL_ORDER_ENCODINGS)])
_L_BYTES = np.frombuffer(ref.L.to_bytes(32, "little"), dtype=np.uint8)
_P_BYTES = np.frombuffer(ref.P.to_bytes(32, "little"), dtype=np.uint8)


def _lt_le_bytes(vals: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """Per-row little-endian comparison vals < bound (vals (B, 32) uint8)."""
    v = vals[:, ::-1].astype(np.int16)
    b = bound[::-1].astype(np.int16)
    diff = v - b[None, :]
    nz = diff != 0
    first = np.argmax(nz, axis=1)
    picked = diff[np.arange(len(vals)), first]
    return np.where(nz.any(axis=1), picked < 0, False)  # equal: not less


def _small_order_mask(enc: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 -> (B,) bool, True where the encoding is small-order
    with the sign bit masked (libsodium ge25519_has_small_order)."""
    masked = enc.copy()
    masked[:, 31] &= 0x7F
    return (masked[:, None, :] == _SMALL_ORDER[None, :, :]).all(-1).any(-1)


class Ed25519Workload(Workload):
    """Host policy gates and SHA-512 prep in ``encode``, the cold verify
    kernel on the device; ``finalize`` ANDs the gate into the device bits,
    so a gate-rejected row is False whatever the device said."""

    metrics_ns = "crypto.verify"
    span_ns = "verify"
    libraries = ("verify_cold",)

    def encode(self, items: Sequence[tuple]) -> Tuple[np.ndarray, tuple]:
        n = len(items)
        ok = np.ones(n, dtype=bool)
        msgs, pk_parts, sig_parts = [], [], []
        z32, z64 = bytes(32), bytes(64)
        for i, (pk, msg, sig) in enumerate(items):
            if len(pk) != 32 or len(sig) != 64:
                ok[i] = False
                pk_parts.append(z32)
                sig_parts.append(z64)
                msgs.append(b"")
            else:
                pk_parts.append(pk)
                sig_parts.append(sig)
                msgs.append(msg)
        a = np.frombuffer(b"".join(pk_parts), dtype=np.uint8).reshape(n, 32)
        sig_mat = np.frombuffer(b"".join(sig_parts),
                                dtype=np.uint8).reshape(n, 64)
        r = np.ascontiguousarray(sig_mat[:, :32])
        s = np.ascontiguousarray(sig_mat[:, 32:])
        h = native_prep.prep_batch(r, a, msgs)
        # libsodium's order: s canonical, small-order R and A, canonical A
        ok &= _lt_le_bytes(s, _L_BYTES)
        ok &= ~_small_order_mask(r)
        ok &= ~_small_order_mask(a)
        a_masked = a.copy()
        a_masked[:, 31] &= 0x7F
        ok &= _lt_le_bytes(a_masked, _P_BYTES)
        return ok, (a, r, s, h)

    def pad_rows(self) -> tuple:
        return (_PAD_A, _PAD_R, _PAD_S, _PAD_H)

    def kernel_fn(self):
        return vk.verify_kernel

    def host_result(self, items: Sequence[tuple]) -> np.ndarray:
        return native_verify.host_verify(items)

    def empty_result(self, n: int) -> np.ndarray:
        return np.zeros(n, dtype=bool)

    def finalize(self, gate: np.ndarray, out: np.ndarray,
                 items: Sequence[tuple]) -> np.ndarray:
        return gate & out


class Ed25519HotWorkload(Ed25519Workload):
    """The hot-signer variant of the verify workload: rows whose pubkey has
    a cached 128-entry table of -A run K2 (:func:`stellar_tpu_torch.ops.
    verify.verify_kernel_hot`) with the table as an operand, skipping
    decompression and the table build.

    Items are ``((pk, msg, sig), table)`` pairs: the triple and the cache
    entry the partitioning :meth:`BatchVerifier.submit` looked up for it.
    ``encode`` runs the cold workload's host gates over the triples
    unchanged, then puts the stacked tables in place of the pubkeys."""

    variant_name = "hot"
    libraries = ("verify_hot",)

    def encode(self, items: Sequence[tuple]) -> Tuple[np.ndarray, tuple]:
        ok, (_a, r, s, h) = super().encode([it for it, _t in items])
        tables = np.stack([t for _it, t in items])
        return ok, (tables, r, s, h)

    def pad_rows(self) -> tuple:
        return (_PAD_TABLE, _PAD_R, _PAD_S, _PAD_H)

    def kernel_fn(self):
        return vk.verify_kernel_hot

    def host_result(self, items: Sequence[tuple]) -> np.ndarray:
        return native_verify.host_verify([it for it, _t in items])

    def audit_material(self, encoded: tuple, lo: int, hi: int) -> bytes:
        """R, s and h of the rows: the tables (15,360 bytes a row, a
        function of the pubkey) are left out of the hash that seeds the
        sample, which stays a function of the batch's content."""
        return b"".join(x[lo:hi].tobytes() for x in encoded[1:])

    def on_audit_conviction(self, items: Sequence[tuple]) -> None:
        """A conviction over a hot-served part evicts every table that
        served it: a poisoned table must not outlive the audit that caught
        it (the next sight rebuilds it from the pubkey)."""
        for (pk, _m, _s), _t in items:
            signer_tables.signer_table_cache.evict(pk)


class BatchVerifier(BatchEngine):
    """Batched libsodium-exact ed25519 verifier: :class:`Ed25519Workload`
    on the engine, with the hot-signer partition in :meth:`submit`.

    Args:
      device: ``None`` for the first CUDA card (raises if there is none),
        ``"cuda[:N]"``, or ``"cpu"`` for the plain PyTorch kernel versions.
      bucket_sizes: padded batch sizes, ascending; the reference's
        constructor default, where :func:`default_verifier` takes the
        full ladder.
      devices: instead of ``device``, a list of devices to split each
        bucket over (per-device sub-chunks and fault domains); an entry
        may repeat.
    """

    def __init__(self, device=None, bucket_sizes=(128, 512, 2048),
                 devices=None):
        super().__init__(Ed25519Workload(), device=device,
                         bucket_sizes=bucket_sizes, devices=devices)
        self._hot = Ed25519HotWorkload()
        self.served["hot"] = 0

    def submit(self, items: Sequence[tuple], trace_ids=None,
               variant: Optional[Workload] = None
               ) -> Callable[[], np.ndarray]:
        """Partitioning submit: rows whose signer has a cached table ride
        K2, the rest ride K1. A signer's first sight builds and installs
        its table at once, so a repeat later in the same batch already
        rides hot; the first row still rides cold, since its verdict needs
        the decompression K1 carries. The split depends on the cache alone
        (content-keyed: two replicas fed the same traffic split alike) and
        never changes a verdict. With the cache off every row rides
        cold. The partition (lookups and first-sight table builds) is host
        prep: it runs under the ``verify.prep`` span, so a blocking call's
        attribution covers it. ``trace_ids`` follow their rows into both
        submits."""
        cache = signer_tables.signer_table_cache
        if variant is not None or not cache.enabled or not len(items):
            return super().submit(items, trace_ids=trace_ids,
                                  variant=variant)
        hot_idx, hot_items = [], []
        cold_idx, cold_items = [], []
        with tracing.span(f"{self._span_ns}.prep"):
            try:
                for i, it in enumerate(items):
                    pk = it[0]
                    tab = cache.lookup(pk, mark=False) \
                        if len(pk) == 32 else None
                    if tab is not None:
                        hot_idx.append(i)
                        hot_items.append((it, tab))
                        continue
                    cold_idx.append(i)
                    cold_items.append(it)
                    if len(pk) == 32:
                        built = signer_tables.build_signer_table(pk)
                        if built is not None:
                            cache.install(pk, built)
            finally:
                # the registry's hit and miss counters, once a batch
                cache.flush_marks()
            hot_ix = np.asarray(hot_idx, dtype=np.intp)
            cold_ix = np.asarray(cold_idx, dtype=np.intp)
        if not hot_items:
            return super().submit(items, trace_ids=trace_ids)
        hot_tr = [trace_ids[i] for i in hot_idx] if trace_ids else None
        cold_tr = [trace_ids[i] for i in cold_idx] if trace_ids else None
        resolve_hot = super().submit(hot_items, trace_ids=hot_tr,
                                     variant=self._hot)
        resolve_cold = super().submit(cold_items, trace_ids=cold_tr) \
            if cold_items else None
        n = len(items)

        def resolve() -> np.ndarray:
            out = np.zeros(n, dtype=bool)
            out[hot_ix] = resolve_hot()
            if resolve_cold is not None:
                out[cold_ix] = resolve_cold()
            return out

        return resolve

    def verify_batch(self, items: Sequence[tuple],
                     trace_ids=None) -> np.ndarray:
        """items: (pk, msg, sig) bytes triples -> (n,) bool, libsodium's
        decision per item, through the partition, under the root span
        ``verify.blocking``."""
        return self.compute_batch(items, trace_ids=trace_ids)

    def verify_sig(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        """One verification, uncached; the signature of a node's verify
        backend (:func:`stellar_tpu_torch.crypto.keys.
        set_verifier_backend`)."""
        return bool(self.verify_batch([(pk, msg, sig)])[0])

    def install(self, trickle_window_ms: Optional[float] = None
                ) -> "BatchVerifier":
        """Make this verifier the backend of the port's
        :func:`stellar_tpu_torch.crypto.keys.verify_sig`, so every
        single-signature call site asks the shared cache first, then the
        card. ``trickle_window_ms`` puts a :class:`TrickleBatcher` in
        front: worth it when verify callers are concurrent; in a
        single-threaded loop it only adds the window to each miss, so it
        stays opt-in."""
        from stellar_tpu_torch.crypto import keys
        if trickle_window_ms is not None:
            batcher = TrickleBatcher(self, window_ms=trickle_window_ms)
            keys.set_verifier_backend(batcher.verify_sig)
        else:
            keys.set_verifier_backend(self.verify_sig)
        return self


class TrickleBatcher:
    """Micro-batch window for single-signature verifies: bulk paths batch
    explicitly, but lone verifies (overlay auth handshakes, single SCP
    envelopes) would each pay a whole dispatch. Concurrent arrivals
    collect for up to ``window_ms`` (or ``max_batch`` items) and ride one
    ``verify_batch``; the synchronous bool API is kept by parking callers
    on futures. The first caller of a window is its leader: it waits the
    window out, dispatches everything queued and resolves every future;
    the others block on theirs. A leader whose dispatch fails sets the
    failure on every parked future, so nobody hangs.

    The queue is bounded (``max_pending``): a caller arriving when it is
    full gets a typed :class:`~stellar_tpu_torch.utils.resilience.
    Overloaded` (lane ``"trickle"``, reason ``"queue-depth"``) instead of
    growing the pending list while a leader is stuck behind a slow
    dispatch."""

    def __init__(self, verifier: BatchVerifier, window_ms: float = 1.0,
                 max_batch: int = 64, max_pending: int = 4096):
        self._verifier = verifier
        self._window = window_ms / 1000.0
        self._max = max_batch
        self._max_pending = max(1, int(max_pending))
        self._cv = threading.Condition()
        self._pending: list = []  # ((pk, msg, sig), Future)
        self._leader_active = False
        self._flush_asap = False
        self.dispatches = 0  # verify_batch calls made
        self.rejected = 0    # ingress Overloaded count

    def _dispatch_batch(self, batch: list) -> None:
        """Resolve one claimed batch through the verifier; a failure is
        set on every parked future before it is raised."""
        try:
            results = self._verifier.verify_batch(
                [item for item, _f in batch])
        except BaseException as e:
            for _item, f in batch:
                f.set_exception(e)
            raise
        for (_item, f), ok in zip(batch, results):
            f.set_result(bool(ok))

    def verify_sig(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        fut: Future = Future()
        with self._cv:
            if len(self._pending) >= self._max_pending:
                self.rejected += 1
                registry.counter("crypto.verify.trickle.rejected").inc()
                raise resilience.Overloaded(
                    f"trickle window full ({self._max_pending} pending)",
                    kind="rejected", lane="trickle",
                    reason="queue-depth")
            self._pending.append(((pk, msg, sig), fut))
            if self._leader_active:
                if len(self._pending) >= self._max:
                    self._cv.notify_all()  # wake the leader early
                lead = False
            else:
                self._leader_active = True
                lead = True
        if lead:
            deadline = time.perf_counter() + self._window
            with self._cv:
                while len(self._pending) < self._max and \
                        not self._flush_asap:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch = self._pending
                self._pending = []
                self._leader_active = False
                self._flush_asap = False
                # counted under the lock: the next window's leader may
                # already run when this one dispatches
                self.dispatches += 1
            self._dispatch_batch(batch)
        return fut.result()

    def flush(self) -> int:
        """Dispatch everything queued now instead of waiting the window
        out (drain and shutdown). Every queue and leader transition
        happens under the window lock, so an item is owned by exactly one
        dispatcher: with a leader active it owns the pending list (flush
        wakes it early and returns 0); otherwise flush claims the batch
        itself, and an enqueue after the claim elects itself the next
        leader. Returns how many items this call dispatched."""
        with self._cv:
            if self._leader_active:
                self._flush_asap = True
                self._cv.notify_all()
                return 0
            batch = self._pending
            self._pending = []
            if batch:
                self.dispatches += 1
        if not batch:
            return 0
        self._dispatch_batch(batch)
        return len(batch)


# Padding rows: the base point with zero scalars and R = the identity.
# Both scalars recode to all-zero digits, so s*B + h*(-A) is the identity
# and a padding row's device bit is True; padding results are sliced off.
_PAD_A = np.frombuffer(ref.point_compress(ref.BASE), np.uint8).copy()[None]
_PAD_R = np.frombuffer(ref.point_compress(ref.IDENTITY),
                       np.uint8).copy()[None]
_PAD_S = np.zeros((1, 32), dtype=np.uint8)
_PAD_H = np.zeros((1, 32), dtype=np.uint8)
# The hot path's padding table: the base point's signer table (zero
# scalars select no entry, so any valid table would do).
_PAD_TABLE = signer_tables.build_signer_table(_PAD_A.tobytes())[None]

_defaults: Dict[tuple, BatchVerifier] = {}
_defaults_lock = threading.Lock()


def default_verifier(device=None) -> BatchVerifier:
    """The process-wide verifier over the full bucket ladder. With no
    ``device``, every visible card (split, as the reference's default
    mesh spans every local device), or the one card unsplit; raises when
    there is none. With ``device``, that device alone."""
    devs = mesh.auto_devices() if device is None else None
    if devs is None:
        devs = [resolve_device(device)]
    key = tuple(str(d) for d in devs)
    with _defaults_lock:
        if key not in _defaults:
            _defaults[key] = BatchVerifier(
                devices=list(key), bucket_sizes=DEFAULT_BUCKET_SIZES)
            register_default_engine(f"verify:{','.join(key)}",
                                    _defaults[key])
        return _defaults[key]
