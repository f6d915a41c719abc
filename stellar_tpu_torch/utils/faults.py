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
its index in the engine's device list (0 for a single device). The wire
modes wait for the ingress (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["FaultInjected", "inject", "corrupt_verdicts", "is_active",
           "set_fault", "clear", "counters", "PROBE", "TRANSFER",
           "DISPATCH", "RESOLVE", "STALL_DEVICE_SECONDS"]

PROBE = "device.probe"
TRANSFER = "device.transfer"
DISPATCH = "device.dispatch"
RESOLVE = "device.resolve"

_MODES = ("raise", "hang", "flake", "failn", "fail-device",
          "flaky-device", "corrupt-device", "stall-device",
          "stall-transfer")
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
