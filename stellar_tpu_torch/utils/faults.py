"""Fault injection for the engine's device points — the port's copy of
the device part of ``stellar_tpu/utils/faults.py``.

The engine plants named injection points (:func:`inject`) where a device
interaction can fail: the operand copy to the card (``TRANSFER``), the
kernel launch (``DISPATCH``), the result fetch (``RESOLVE``, run on a
watchdog worker under the deadline) and the device probe (``PROBE``).
With no fault armed a point is one dict test; with one armed it
misbehaves in a controlled way, so the tests and ``chip_smoke.py``
drive the breakers, the deadline, the moves to another device and the
audit without a broken card.

Faults are armed from code only (:func:`set_fault`; :func:`clear`
disarms). Modes (``mode`` and its argument):

* ``raise``            — raise :class:`FaultInjected` on every call;
* ``hang`` (s)         — sleep ``s`` seconds (default 30) on every call:
  a card that blocks instead of failing;
* ``flake`` (k)        — raise on every k-th call (default 2);
* ``failn`` (n)        — raise on the first n calls (default 1);
* ``fail-device`` (i)  — raise on every call attributed to device index i;
* ``flaky-device`` (i) — raise on every second call attributed to i;
* ``corrupt-device`` (i) — never raises: the verdict rows fetched from
  device i come back bit-flipped (:func:`corrupt_verdicts`), the shape
  only the result-integrity audit can catch;
* ``stall-device`` (i) — never raises: sleeps :data:`STALL_DEVICE_SECONDS`
  (``set_fault(..., seconds=)`` overrides) before every call attributed
  to i, a delay the pipeline timeline must show as a bubble and nothing
  may charge;
* ``stall-transfer`` (i) — the same sleep, armed at the operand copy
  (``TRANSFER``): a slow copy rather than a slow launch.

A call is attributed to a device with ``inject(point, device=i)``, ``i``
its index in the engine's device list (0 for a single device).

Wire modes: the misbehaving-client shapes of the ingress
(:mod:`stellar_tpu_torch.crypto.ingress`). They are armed at client-side
points (by convention ``wire.client.<shape>``) and fire through
:func:`wire_plan` / :func:`send_mangled`, never through ``inject``: they
mangle what a client puts on the wire, not what the server does.

* ``torn-frame``           — split every send at deterministic byte
  offsets derived from the call count (each fragment is a legal TCP
  segmentation the server must reassemble);
* ``slow-client`` (bytes/s) — trickle the send in small chunks with
  pacing sleeps, the slow-loris shape the read deadline must bound;
* ``disconnect-mid-batch`` — send about half the frame, then close the
  connection;
* ``garbage-prefix``       — prepend junk bytes that are not a frame
  type (the server must refuse typed and drop the connection);
* ``oversize-frame``       — send a header declaring a length over the
  server's frame ceiling (refused without buffering).

Every plan is a function of the fault's own call counter, never of a
random number, so a chaos run's byte stream replays. The reference's
``STELLAR_TPU_FAULTS`` environment spec is not read: faults are armed
from code.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, Optional

__all__ = ["FaultInjected", "inject", "corrupt_verdicts", "is_active",
           "set_fault", "clear", "counters", "wire_plan", "send_mangled",
           "WIRE_MODES", "PROBE", "TRANSFER", "DISPATCH", "RESOLVE",
           "STALL_DEVICE_SECONDS"]

PROBE = "device.probe"
TRANSFER = "device.transfer"
DISPATCH = "device.dispatch"
RESOLVE = "device.resolve"

WIRE_MODES = ("torn-frame", "slow-client", "disconnect-mid-batch",
              "garbage-prefix", "oversize-frame")
_MODES = ("raise", "hang", "flake", "failn", "fail-device",
          "flaky-device", "corrupt-device", "stall-device",
          "stall-transfer") + WIRE_MODES
_DEVICE_MODES = ("fail-device", "flaky-device", "corrupt-device",
                 "stall-device", "stall-transfer")

# the stall modes' sleep (set_fault's ``seconds`` overrides)
STALL_DEVICE_SECONDS = 0.05

_lock = threading.Lock()
_active: Dict[str, "_Fault"] = {}


class FaultInjected(RuntimeError):
    """What an armed fault raises: a ``RuntimeError``, as a failed CUDA
    launch, copy or fetch is, so it takes the engine's device-fault
    path."""


class _Fault:
    def __init__(self, point: str, mode: str, arg: Optional[float],
                 seconds: Optional[float] = None):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(one of {_MODES})")
        if mode in _DEVICE_MODES and arg is None:
            raise ValueError(f"{mode} needs a device index")
        self.point = point
        self.mode = mode
        self.arg = arg
        self.seconds = seconds
        self.calls = 0   # times the point was reached
        self.fired = 0   # times it misbehaved

    def trip(self, device: Optional[int] = None) -> None:
        if self.mode in WIRE_MODES:
            # wire faults mangle client sends (wire_plan); they never
            # fire at an inject() site
            return
        if self.mode in _DEVICE_MODES:
            # device faults see (and count) only calls attributed to
            # their device; corruption never raises
            if device is None or int(device) != int(self.arg) or \
                    self.mode == "corrupt-device":
                return
        with _lock:
            self.calls += 1
            n = self.calls
        if self.mode in ("raise", "hang", "fail-device", "stall-device",
                         "stall-transfer"):
            fire = True
        elif self.mode in ("flake", "flaky-device"):
            k = 2 if self.mode == "flaky-device" else \
                int(self.arg if self.arg else 2)
            fire = n % k == 0
        else:  # failn
            fire = n <= int(self.arg if self.arg is not None else 1)
        if not fire:
            return
        with _lock:
            self.fired += 1
        if self.mode == "hang":
            time.sleep(float(self.arg) if self.arg is not None else 30.0)
            return
        if self.mode in ("stall-device", "stall-transfer"):
            # a delay, not a failure: the call goes on after it
            time.sleep(self.seconds if self.seconds is not None
                       else STALL_DEVICE_SECONDS)
            return
        raise FaultInjected(f"injected fault at {self.point} "
                            f"({self.mode}, call #{n})")


def inject(point: str, device: Optional[int] = None) -> None:
    """Trip the fault armed at ``point``; nothing when none is armed.
    ``device`` attributes the call to one device index."""
    if not _active:
        return
    f = _active.get(point)
    if f is not None:
        f.trip(device=device)


def corrupt_verdicts(point: str, device: Optional[int], arr):
    """With ``corrupt-device`` armed at ``point`` for ``device``, the
    fetched verdict rows bit-flipped (a fire is counted); else ``arr``
    unchanged."""
    if not _active:
        return arr
    f = _active.get(point)
    if f is None or f.mode != "corrupt-device" or device is None or \
            int(device) != int(f.arg):
        return arr
    with _lock:
        f.calls += 1
        f.fired += 1
    return ~arr


def is_active(point: str) -> bool:
    """Is a fault armed at ``point``?"""
    return point in _active


def set_fault(point: str, mode: str, arg: Optional[float] = None,
              seconds: Optional[float] = None) -> None:
    """Arm ``point`` with ``mode`` (see the module docstring);
    ``seconds`` overrides the stall modes' sleep."""
    f = _Fault(point, mode, arg, seconds=seconds)
    with _lock:
        _active[point] = f


def clear(point: Optional[str] = None) -> None:
    """Disarm one point, or every point when ``point`` is None."""
    with _lock:
        if point is None:
            _active.clear()
        else:
            _active.pop(point, None)


def counters() -> Dict[str, dict]:
    """Per armed point: its mode, how often it was reached and how often
    it misbehaved."""
    with _lock:
        return {p: {"mode": f.mode, "calls": f.calls, "fired": f.fired}
                for p, f in _active.items()}


def wire_plan(point: str, nbytes: int) -> Optional[dict]:
    """The mangling plan for one client send of ``nbytes`` at
    ``point`` — None when no wire fault is armed there. Plans are
    pure functions of the fault's own call counter (no RNG, no
    clock), so a chaos run's byte stream is replayable. Counts a
    call AND a fire per consult — every armed send misbehaves."""
    if not _active:  # fast path: chaos off
        return None
    f = _active.get(point)
    if f is None or f.mode not in WIRE_MODES:
        return None
    with _lock:
        f.calls += 1
        f.fired += 1
        n = f.calls
    if f.mode == "torn-frame":
        span = max(1, nbytes - 1)
        splits = sorted({1 + (n * 7) % span,
                         1 + (n * 13 + 3) % span,
                         1 + (n * 29 + 11) % span})
        return {"mode": "torn-frame", "splits": splits}
    if f.mode == "slow-client":
        rate = float(f.arg) if f.arg else 4096.0
        chunk = 16
        return {"mode": "slow-client", "chunk": chunk,
                "sleep_s": chunk / max(1.0, rate)}
    if f.mode == "disconnect-mid-batch":
        return {"mode": "disconnect-mid-batch",
                "cut": max(1, nbytes // 2)}
    if f.mode == "garbage-prefix":
        junk = bytes(16 + (n * 31 + i * 7) % 224 for i in range(8))
        return {"mode": "garbage-prefix", "junk": junk}
    # oversize-frame: a header declaring arg (default 2x the codec
    # ceiling) payload bytes, plus a little filler so the server's
    # reject provably fires on the DECLARATION, not a read timeout
    declared = int(f.arg) if f.arg else 2 * (1 << 20)
    return {"mode": "oversize-frame", "declared": declared}


def send_mangled(sock, data, point: str) -> bool:
    """Send ``data`` on ``sock`` through the wire fault armed at
    ``point`` (plain ``sendall`` when none is). Returns False when
    the plan deliberately closed the connection (the
    disconnect-mid-batch shape), True otherwise. Never called with a
    lock held — sends and pacing sleeps block."""
    plan = wire_plan(point, len(data))
    if plan is None:
        sock.sendall(data)
        return True
    mode = plan["mode"]
    if mode == "torn-frame":
        pos = 0
        for cut in plan["splits"] + [len(data)]:
            if cut > pos:
                sock.sendall(data[pos:cut])
                pos = cut
        return True
    if mode == "slow-client":
        for off in range(0, len(data), plan["chunk"]):
            sock.sendall(data[off:off + plan["chunk"]])
            time.sleep(plan["sleep_s"])
        return True
    if mode == "disconnect-mid-batch":
        sock.sendall(data[:plan["cut"]])
        # shutdown acts on the connection itself (close alone leaves
        # the kernel description alive while a reader thread is
        # blocked in recv — no FIN would reach the server)
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        return False
    if mode == "garbage-prefix":
        sock.sendall(plan["junk"] + bytes(data))
        return True
    # oversize-frame: bogus SUBMIT header + filler instead of data
    sock.sendall(struct.pack(">BI", 0x01, plan["declared"])
                 + b"\x00" * 16)
    return True
