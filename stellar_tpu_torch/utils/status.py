"""Human-readable node status lines by category (reference
``src/util/StatusManager.h``: per-category message set/cleared by the
owning subsystem, surfaced in the ``info`` admin response)."""

from __future__ import annotations

from typing import Dict, List

__all__ = ["StatusManager", "StatusCategory"]


class StatusCategory:
    HISTORY_CATCHUP = "history-catchup"
    HISTORY_PUBLISH = "history-publish"
    REQUIRES_UPGRADES = "requires-upgrades"
    # verify dispatch degraded: breaker open/half-open, signatures
    # served by the host oracle (set/cleared via Application.info)
    VERIFY_DEVICE = "verify-device"
    # (reference also has NTP; no time-sync subsystem here)


class StatusManager:
    def __init__(self):
        self._messages: Dict[str, str] = {}

    def set_status(self, category: str, message: str) -> None:
        self._messages[category] = message

    def remove_status(self, category: str) -> None:
        self._messages.pop(category, None)

    def get_status(self, category: str) -> str:
        return self._messages.get(category, "")

    def status_lines(self) -> List[str]:
        """Insertion-ordered status messages (the info payload form)."""
        return [m for m in self._messages.values() if m]
