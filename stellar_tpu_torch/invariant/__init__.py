"""Invariant subsystem. The active manager is process-global (one node
per process in production; tests swap it per fixture).

The port's copy of ``stellar_tpu/invariant/__init__.py``, with the port's
imports."""

from typing import Optional

from stellar_tpu_torch.invariant.invariants import (  # noqa: F401
    InvariantDoesNotHold, InvariantManager,
)

_active: Optional[InvariantManager] = None


def set_active_manager(mgr: Optional[InvariantManager]):
    global _active
    _active = mgr


def get_active_manager() -> Optional[InvariantManager]:
    return _active
