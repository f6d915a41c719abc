"""In-memory peer transport for tests/simulation (reference
``overlay/test/LoopbackPeer.h``: duplex queues with injectable damage,
drop, and reordering)."""

from __future__ import annotations

import random
from typing import Optional

from stellar_tpu_torch.overlay.peer import Peer

__all__ = ["LoopbackPeer", "connect_loopback"]


class LoopbackPeer(Peer):
    """Delivers frames to its twin via the shared clock's action queue
    (async like a socket, deterministic under VIRTUAL_TIME)."""

    def __init__(self, app, we_called: bool):
        super().__init__(app, we_called)
        self.twin: Optional["LoopbackPeer"] = None
        # fault injection (reference LoopbackPeer damage/drop knobs)
        self.drop_probability = 0.0
        self.damage_probability = 0.0
        self.rng = random.Random(0)
        self.sent_count = 0
        self.dropped_count = 0

    def send_bytes(self, raw: bytes):
        twin = self.twin
        if twin is None:
            return
        self.sent_count += 1
        if self.rng.random() < self.drop_probability:
            self.dropped_count += 1
            return
        if self.rng.random() < self.damage_probability:
            i = self.rng.randrange(len(raw))
            raw = raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]
        self.app.clock.post_to_main(
            lambda: twin.receive_bytes(raw), name="loopback-delivery")


def connect_loopback(app_a, app_b) -> tuple:
    """Wire two nodes with a loopback pair and run the auth handshake
    (completes as the shared clock cranks)."""
    pa = LoopbackPeer(app_a, we_called=True)
    pb = LoopbackPeer(app_b, we_called=False)
    pa.twin, pb.twin = pb, pa
    app_a.overlay.add_pending(pa)
    app_b.overlay.add_pending(pb)
    pa.start_handshake()
    return pa, pb
