"""SCP wire types (``Stellar-SCP.x``): ballots, statements, envelopes,
quorum sets. The abstract SCP kernel (the JAX package's ``scp``,
not yet ported) operates on
these; values are opaque byte strings to the kernel (reference
``src/scp/readme.md:3-12``).

The port's copy of ``stellar_tpu/xdr/scp.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.runtime import (
    Enum, Opaque, Option, Struct, Uint32, Uint64, Union, VarArray,
    VarOpaque,
)
from stellar_tpu_torch.xdr.types import Hash, NodeID, Signature

Value = VarOpaque()


class SCPBallot(Struct):
    FIELDS = [("counter", Uint32), ("value", Value)]


SCPStatementType = Enum("SCPStatementType", {
    "SCP_ST_PREPARE": 0,
    "SCP_ST_CONFIRM": 1,
    "SCP_ST_EXTERNALIZE": 2,
    "SCP_ST_NOMINATE": 3,
})


class SCPNomination(Struct):
    FIELDS = [("quorumSetHash", Hash),
              ("votes", VarArray(Value)),
              ("accepted", VarArray(Value))]


class SCPStatementPrepare(Struct):
    FIELDS = [("quorumSetHash", Hash),
              ("ballot", SCPBallot),
              ("prepared", Option(SCPBallot)),
              ("preparedPrime", Option(SCPBallot)),
              ("nC", Uint32),
              ("nH", Uint32)]


class SCPStatementConfirm(Struct):
    FIELDS = [("ballot", SCPBallot),
              ("nPrepared", Uint32),
              ("nCommit", Uint32),
              ("nH", Uint32),
              ("quorumSetHash", Hash)]


class SCPStatementExternalize(Struct):
    FIELDS = [("commit", SCPBallot),
              ("nH", Uint32),
              ("commitQuorumSetHash", Hash)]


SCPStatementPledges = Union("SCPStatement.pledges", SCPStatementType, {
    SCPStatementType.SCP_ST_PREPARE: SCPStatementPrepare,
    SCPStatementType.SCP_ST_CONFIRM: SCPStatementConfirm,
    SCPStatementType.SCP_ST_EXTERNALIZE: SCPStatementExternalize,
    SCPStatementType.SCP_ST_NOMINATE: SCPNomination,
})


class SCPStatement(Struct):
    FIELDS = [("nodeID", NodeID),
              ("slotIndex", Uint64),
              ("pledges", SCPStatementPledges)]


class SCPEnvelope(Struct):
    FIELDS = [("statement", SCPStatement), ("signature", Signature)]


class _QuorumSetLazy:
    """Recursive innerSets."""

    def _real(self):
        return SCPQuorumSet

    def pack(self, p, v):
        SCPQuorumSet.pack(p, v)

    def unpack(self, u):
        return SCPQuorumSet.unpack(u)

    def copy(self, v):
        return SCPQuorumSet.copy(v)


class SCPQuorumSet(Struct):
    FIELDS = [("threshold", Uint32),
              ("validators", VarArray(NodeID)),
              ("innerSets", VarArray(_QuorumSetLazy()))]


def quorum_set_hash(qset: SCPQuorumSet) -> bytes:
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return sha256(to_bytes(SCPQuorumSet, qset))
