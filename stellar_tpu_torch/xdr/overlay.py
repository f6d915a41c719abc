"""Overlay wire protocol (``Stellar-overlay.x``): peer addresses, auth
certs, HELLO/AUTH handshake, flow control, flooding, surveys, and the
StellarMessage + AuthenticatedMessage frame every byte on the wire uses.

The port's copy of ``stellar_tpu/xdr/overlay.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.ledger import (
    GeneralizedTransactionSet, TransactionSet,
)
from stellar_tpu_torch.xdr.runtime import (
    Bool, Enum, FixedArray, Int32, Opaque, Struct, Uint32, Uint64, Union,
    VarArray, VarOpaque, Void, XdrString,
)
from stellar_tpu_torch.xdr.scp import SCPEnvelope, SCPQuorumSet
from stellar_tpu_torch.xdr.tx import TransactionEnvelope
from stellar_tpu_torch.xdr.types import (
    Curve25519Public, Hash, HmacSha256Mac, NodeID, Signature, Uint256,
)

MAX_TX_ADVERT_VECTOR = 1000
MAX_TX_DEMAND_VECTOR = 1000

ErrorCode = Enum("ErrorCode", {
    "ERR_MISC": 0, "ERR_DATA": 1, "ERR_CONF": 2, "ERR_AUTH": 3,
    "ERR_LOAD": 4,
})


class ErrorMsg(Struct):
    FIELDS = [("code", ErrorCode), ("msg", XdrString(100))]


class AuthCert(Struct):
    """Node-signed ephemeral ECDH key (reference ``PeerAuth.cpp:21-68``)."""
    FIELDS = [("pubkey", Curve25519Public),
              ("expiration", Uint64),
              ("sig", Signature)]


IPAddrType = Enum("IPAddrType", {"IPv4": 0, "IPv6": 1})

_PeerIP = Union("PeerAddress.ip", IPAddrType, {
    IPAddrType.IPv4: Opaque(4),
    IPAddrType.IPv6: Opaque(16),
})


class PeerAddress(Struct):
    FIELDS = [("ip", _PeerIP), ("port", Uint32), ("numFailures", Uint32)]


class Hello(Struct):
    FIELDS = [("ledgerVersion", Uint32),
              ("overlayVersion", Uint32),
              ("overlayMinVersion", Uint32),
              ("networkID", Hash),
              ("versionStr", XdrString(100)),
              ("listeningPort", Int32),
              ("peerID", NodeID),
              ("cert", AuthCert),
              ("nonce", Uint256)]


AUTH_MSG_FLAG_FLOW_CONTROL_BYTES_REQUESTED = 200


class Auth(Struct):
    FIELDS = [("flags", Int32)]


class DontHave(Struct):
    FIELDS = [("type", Uint32), ("reqHash", Uint256)]


class SendMore(Struct):
    FIELDS = [("numMessages", Uint32)]


class SendMoreExtended(Struct):
    FIELDS = [("numMessages", Uint32), ("numBytes", Uint32)]


TxAdvertVector = VarArray(Hash, MAX_TX_ADVERT_VECTOR)


class FloodAdvert(Struct):
    FIELDS = [("txHashes", TxAdvertVector)]


TxDemandVector = VarArray(Hash, MAX_TX_DEMAND_VECTOR)


class FloodDemand(Struct):
    FIELDS = [("txHashes", TxDemandVector)]


# ---------------- time-sliced surveys ----------------

SurveyMessageCommandType = Enum("SurveyMessageCommandType", {
    "SURVEY_TOPOLOGY": 0,
    "TIME_SLICED_SURVEY_TOPOLOGY": 1,
})

EncryptedBody = VarOpaque(64000)


class TimeSlicedSurveyStartCollectingMessage(Struct):
    FIELDS = [("surveyorID", NodeID),
              ("nonce", Uint32),
              ("ledgerNum", Uint32)]


class SignedTimeSlicedSurveyStartCollectingMessage(Struct):
    FIELDS = [("signature", Signature),
              ("startCollecting", TimeSlicedSurveyStartCollectingMessage)]


class TimeSlicedSurveyStopCollectingMessage(Struct):
    FIELDS = [("surveyorID", NodeID),
              ("nonce", Uint32),
              ("ledgerNum", Uint32)]


class SignedTimeSlicedSurveyStopCollectingMessage(Struct):
    FIELDS = [("signature", Signature),
              ("stopCollecting", TimeSlicedSurveyStopCollectingMessage)]


class SurveyRequestMessage(Struct):
    FIELDS = [("surveyorPeerID", NodeID),
              ("surveyedPeerID", NodeID),
              ("ledgerNum", Uint32),
              ("encryptionKey", Curve25519Public),
              ("commandType", SurveyMessageCommandType)]


class TimeSlicedSurveyRequestMessage(Struct):
    FIELDS = [("request", SurveyRequestMessage),
              ("nonce", Uint32),
              ("inboundPeersIndex", Uint32),
              ("outboundPeersIndex", Uint32)]


class SignedTimeSlicedSurveyRequestMessage(Struct):
    FIELDS = [("requestSignature", Signature),
              ("request", TimeSlicedSurveyRequestMessage)]


class SurveyResponseMessage(Struct):
    FIELDS = [("surveyorPeerID", NodeID),
              ("surveyedPeerID", NodeID),
              ("ledgerNum", Uint32),
              ("commandType", SurveyMessageCommandType),
              ("encryptedBody", EncryptedBody)]


class TimeSlicedSurveyResponseMessage(Struct):
    FIELDS = [("response", SurveyResponseMessage),
              ("nonce", Uint32)]


class SignedTimeSlicedSurveyResponseMessage(Struct):
    FIELDS = [("responseSignature", Signature),
              ("response", TimeSlicedSurveyResponseMessage)]


class TimeSlicedNodeData(Struct):
    FIELDS = [("addedAuthenticatedPeers", Uint32),
              ("droppedAuthenticatedPeers", Uint32),
              ("totalInboundPeerCount", Uint32),
              ("totalOutboundPeerCount", Uint32),
              ("p75SCPFirstToSelfLatencyMs", Uint32),
              ("p75SCPSelfToOtherLatencyMs", Uint32),
              ("lostSyncCount", Uint32),
              ("isValidator", Bool),
              ("maxInboundPeerCount", Uint32),
              ("maxOutboundPeerCount", Uint32)]


class TimeSlicedPeerData(Struct):
    FIELDS = [("peerId", NodeID),
              ("messagesRead", Uint64),
              ("messagesWritten", Uint64),
              ("bytesRead", Uint64),
              ("bytesWritten", Uint64)]


TimeSlicedPeerDataList = VarArray(TimeSlicedPeerData, 25)


class TopologyResponseBodyV2(Struct):
    FIELDS = [("inboundPeers", TimeSlicedPeerDataList),
              ("outboundPeers", TimeSlicedPeerDataList),
              ("nodeData", TimeSlicedNodeData)]


SurveyResponseBody = Union("SurveyResponseBody", Int32, {
    2: TopologyResponseBodyV2,
})


MessageType = Enum("MessageType", {
    "ERROR_MSG": 0,
    "AUTH": 2,
    "DONT_HAVE": 3,
    "PEERS": 5,
    "GET_TX_SET": 6,
    "TX_SET": 7,
    "TRANSACTION": 8,
    "GET_SCP_QUORUMSET": 9,
    "SCP_QUORUMSET": 10,
    "SCP_MESSAGE": 11,
    "GET_SCP_STATE": 12,
    "HELLO": 13,
    "SURVEY_REQUEST": 14,
    "SURVEY_RESPONSE": 15,
    "SEND_MORE": 16,
    "SEND_MORE_EXTENDED": 20,
    "FLOOD_ADVERT": 18,
    "FLOOD_DEMAND": 19,
    "GENERALIZED_TX_SET": 17,
    "TIME_SLICED_SURVEY_REQUEST": 21,
    "TIME_SLICED_SURVEY_RESPONSE": 22,
    "TIME_SLICED_SURVEY_START_COLLECTING": 23,
    "TIME_SLICED_SURVEY_STOP_COLLECTING": 24,
})

StellarMessage = Union("StellarMessage", MessageType, {
    MessageType.TIME_SLICED_SURVEY_START_COLLECTING:
        SignedTimeSlicedSurveyStartCollectingMessage,
    MessageType.TIME_SLICED_SURVEY_STOP_COLLECTING:
        SignedTimeSlicedSurveyStopCollectingMessage,
    MessageType.TIME_SLICED_SURVEY_REQUEST:
        SignedTimeSlicedSurveyRequestMessage,
    MessageType.TIME_SLICED_SURVEY_RESPONSE:
        SignedTimeSlicedSurveyResponseMessage,
    MessageType.ERROR_MSG: ErrorMsg,
    MessageType.HELLO: Hello,
    MessageType.AUTH: Auth,
    MessageType.DONT_HAVE: DontHave,
    MessageType.PEERS: VarArray(PeerAddress, 100),
    MessageType.GET_TX_SET: Uint256,
    MessageType.TX_SET: TransactionSet,
    MessageType.GENERALIZED_TX_SET: GeneralizedTransactionSet,
    MessageType.TRANSACTION: TransactionEnvelope,
    MessageType.GET_SCP_QUORUMSET: Uint256,
    MessageType.SCP_QUORUMSET: SCPQuorumSet,
    MessageType.SCP_MESSAGE: SCPEnvelope,
    MessageType.GET_SCP_STATE: Uint32,
    MessageType.SEND_MORE: SendMore,
    MessageType.SEND_MORE_EXTENDED: SendMoreExtended,
    MessageType.FLOOD_ADVERT: FloodAdvert,
    MessageType.FLOOD_DEMAND: FloodDemand,
})


class AuthenticatedMessageV0(Struct):
    FIELDS = [("sequence", Uint64),
              ("message", StellarMessage),
              ("mac", HmacSha256Mac)]


AuthenticatedMessage = Union("AuthenticatedMessage", Uint32, {
    0: AuthenticatedMessageV0,
})
