"""Protocol version constants (reference ``src/main/Config.cpp:31`` and
``src/util/ProtocolVersion.h``).

The framework implements current-protocol semantics and gates historical
behavior switches on these constants the way the reference's
``protocolVersionStartsFrom`` checks do. Versions below
:data:`MIN_SUPPORTED_PROTOCOL_VERSION` are not replayable here.

The port's copy of ``stellar_tpu/protocol.py``, with the port's imports.
"""

CURRENT_LEDGER_PROTOCOL_VERSION = 23
SOROBAN_PROTOCOL_VERSION = 20
PARALLEL_SOROBAN_PHASE_PROTOCOL_VERSION = 23

# The earliest protocol this re-implementation applies faithfully. The
# reference keeps bug-for-bug compatibility back to protocol 1 for
# history replay; we target the modern era (generalized tx sets,
# PRECOND_V2, sponsorship).
MIN_SUPPORTED_PROTOCOL_VERSION = 19


def starts_from(ledger_version: int, v: int) -> bool:
    return ledger_version >= v


def is_before(ledger_version: int, v: int) -> bool:
    return ledger_version < v
