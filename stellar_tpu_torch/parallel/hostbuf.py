"""Reusable host receive buffers of the wire ingress — the port's copy
of ``stellar_tpu/parallel/hostbuf.py``.

The ingress server reads every frame body with ``recv_into`` into a
buffer leased from this pool and decodes items in place: messages stay
:class:`memoryview` slices of the lease (``wire.decode_submit``) and go
into the verify service's queues as they are, one kernel-to-user copy a
frame. Receive buffers are plain ``bytearray`` s: the engine packs each
submit's operands into a fresh pinned host tensor of its own
(``BatchEngine._fill``), so nothing here needs pinned memory.

Because decoded views alias the lease, a lease is refcounted: the reader
retains it once a frame decoded from it, and the responder releases it
when that frame's tickets reached a terminal and the response is on the
wire. A buffer returns to the free list only at refcount zero, so reuse
never overwrites message bytes a queued ticket still references. The
pool is bounded: when every buffer is leased a fresh bytearray is
allocated instead (counted in ``misses``, never a stall) and dropped at
release.

Lease state changes from reader and responder threads, so all of it lives
under the pool's one lock.
"""

from __future__ import annotations

import threading
from typing import List

__all__ = ["HostBufferPool", "Lease", "DEFAULT_BUF_BYTES",
           "DEFAULT_POOL_BUFFERS"]

# sized for the wire: a handful of MAX_FRAME_BYTES frames per buffer,
# a handful of buffers per connection's working set
DEFAULT_BUF_BYTES = 1 << 20
DEFAULT_POOL_BUFFERS = 8


class Lease:
    """One leased buffer. ``buf``/``mv`` are stable for the lease's
    lifetime; ``retain``/``release`` go through the pool's lock. This
    class owns no lock of its own — every
    mutation of its refcount happens inside the pool's ``_locked``
    helpers."""

    __slots__ = ("buf", "mv", "refs", "pooled")

    def __init__(self, buf: bytearray, pooled: bool):
        self.buf = buf
        self.mv = memoryview(buf)
        self.refs = 1           # the lease itself holds one ref
        self.pooled = pooled


class HostBufferPool:
    """Bounded free-list of reusable receive buffers."""

    def __init__(self, buffers: int = DEFAULT_POOL_BUFFERS,
                 buf_bytes: int = DEFAULT_BUF_BYTES):
        self._lock = threading.Lock()
        self.buf_bytes = max(1, int(buf_bytes))
        self._free: List[bytearray] = [
            bytearray(self.buf_bytes)
            for _ in range(max(0, int(buffers)))]
        self._capacity = len(self._free)
        self._leases = 0
        self._misses = 0
        self._outstanding = 0

    def lease(self) -> Lease:
        """A buffer to ``recv_into`` — pooled when one is free, a
        fresh (counted) allocation otherwise."""
        with self._lock:
            self._leases += 1
            self._outstanding += 1
            if self._free:
                return Lease(self._free.pop(), pooled=True)
            self._misses += 1
        return Lease(bytearray(self.buf_bytes), pooled=False)

    def retain(self, lease: Lease) -> None:
        """One more frame's decoded views alias ``lease``."""
        with self._lock:
            self._retain_locked(lease)

    def release(self, lease: Lease) -> None:
        """Drop one ref; at zero the buffer rejoins the free list
        (pooled leases only — overflow allocations are dropped)."""
        with self._lock:
            self._release_locked(lease)

    def _retain_locked(self, lease: Lease) -> None:
        if lease.refs <= 0:
            raise RuntimeError("retain after final release")
        lease.refs += 1

    def _release_locked(self, lease: Lease) -> None:
        if lease.refs <= 0:
            raise RuntimeError("double release")
        lease.refs -= 1
        if lease.refs == 0:
            self._outstanding -= 1
            if lease.pooled and len(self._free) < self._capacity:
                self._free.append(lease.buf)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "buf_bytes": self.buf_bytes,
                "free": len(self._free),
                "leases": self._leases,
                "misses": self._misses,
                "outstanding": self._outstanding,
            }
