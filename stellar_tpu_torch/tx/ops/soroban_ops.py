"""Soroban operations, the config half: the process-wide
``SorobanNetworkConfig`` that ``ledger_txn.soroban_config_of`` and
``herder.tx_set.make_tx_set_from_transactions`` fall back on.

The port's copy of ``stellar_tpu/tx/ops/soroban_ops.py`` keeps only
``_DEFAULT_CONFIG`` and ``default_soroban_config``. The three operation
frames (InvokeHostFunction, ExtendFootprintTTL, RestoreFootprint) and
their helpers marshal entries through the Soroban host, which the port
does not have yet: they come with the Soroban slice. Until then their
operation types are not registered, so ``op_frame.make_op_frame`` raises
``NotImplementedError`` for them, as it does for any unregistered type.
"""

from __future__ import annotations

__all__ = ["default_soroban_config"]

_DEFAULT_CONFIG = None


def default_soroban_config():
    """Process-wide SorobanNetworkConfig (stand-in for CONFIG_SETTING
    entries; the LedgerManager will own this once config upgrades
    land)."""
    global _DEFAULT_CONFIG
    if _DEFAULT_CONFIG is None:
        from stellar_tpu_torch.ledger.network_config import (
            SorobanNetworkConfig,
        )
        _DEFAULT_CONFIG = SorobanNetworkConfig()
    return _DEFAULT_CONFIG
