"""SCP facade: slot registry + public API (reference ``src/scp/SCP.h:23``
/ ``SCP.cpp``)."""

from __future__ import annotations

from typing import Dict, List, Optional

from stellar_tpu_torch.scp.quorum import node_key
from stellar_tpu_torch.scp.slot import Slot
from stellar_tpu_torch.xdr.scp import SCPEnvelope, SCPQuorumSet, quorum_set_hash
from stellar_tpu_torch.xdr.types import PublicKey, PublicKeyType

__all__ = ["SCP", "EnvelopeState"]


class EnvelopeState:
    INVALID = 0
    VALID = 1


class SCP:
    """One consensus participant: local node identity + quorum set +
    slot map, driven by a :class:`SCPDriver`."""

    def __init__(self, driver, node_id: bytes, is_validator: bool,
                 qset: SCPQuorumSet):
        self.driver = driver
        self.local_node_id = bytes(node_id)
        self.local_node_xdr = PublicKey.make(
            PublicKeyType.PUBLIC_KEY_TYPE_ED25519, self.local_node_id)
        self.local_is_validator = is_validator
        self.local_qset = qset
        self.local_qset_hash = quorum_set_hash(qset)
        self.known_slots: Dict[int, Slot] = {}

    # ---------------- slots ----------------

    def get_slot(self, slot_index: int, create: bool = True
                 ) -> Optional[Slot]:
        slot = self.known_slots.get(slot_index)
        if slot is None and create:
            slot = Slot(slot_index, self)
            self.known_slots[slot_index] = slot
        return slot

    def purge_slots(self, max_slot_index: int, slot_to_keep: int = 0):
        """Drop slots below ``max_slot_index`` except ``slot_to_keep``
        (reference ``purgeSlots``)."""
        for idx in [i for i in self.known_slots
                    if i < max_slot_index and i != slot_to_keep]:
            del self.known_slots[idx]

    # ---------------- protocol entry points ----------------

    def receive_envelope(self, env: SCPEnvelope) -> int:
        """Main entry: feed a (already signature-verified) envelope
        (reference ``SCP::receiveEnvelope``)."""
        return self.get_slot(env.statement.slotIndex).process_envelope(
            env, self_env=False)

    def nominate(self, slot_index: int, value: bytes,
                 previous_value: bytes) -> bool:
        assert self.local_is_validator
        return self.get_slot(slot_index).nominate(value, previous_value)

    def stop_nomination(self, slot_index: int):
        slot = self.get_slot(slot_index, create=False)
        if slot is not None:
            slot.stop_nomination()

    def abandon_ballot(self, slot_index: int, n: int = 0) -> bool:
        slot = self.get_slot(slot_index, create=False)
        return slot.abandon_ballot(n) if slot is not None else False

    def set_state_from_envelope(self, slot_index: int, env: SCPEnvelope):
        self.get_slot(slot_index).set_state_from_envelope(env)

    # ---------------- introspection ----------------

    def get_latest_messages_send(self, slot_index: int
                                 ) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_latest_messages_send() if slot is not None else []

    def get_current_state(self, slot_index: int) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_current_state() if slot is not None else []

    def get_externalizing_state(self, slot_index: int
                                ) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_externalizing_state() if slot is not None else []

    def externalized_value(self, slot_index: int) -> Optional[bytes]:
        slot = self.get_slot(slot_index, create=False)
        return slot.externalized_value if slot is not None else None

    def got_v_blocking(self, slot_index: int) -> bool:
        slot = self.get_slot(slot_index, create=False)
        return slot.got_v_blocking if slot is not None else False

    def empty(self) -> bool:
        return not self.known_slots

    def low_slot_index(self) -> int:
        return min(self.known_slots) if self.known_slots else 0

    def high_slot_index(self) -> int:
        return max(self.known_slots) if self.known_slots else 0
