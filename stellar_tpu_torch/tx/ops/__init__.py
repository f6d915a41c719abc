"""Operation frame implementations. Importing this package populates the
op registry used by ``make_op_frame``.

The port's copy of ``stellar_tpu/tx/ops/__init__.py``, with the port's
imports. The port's ``soroban_ops`` is the config half alone, so the
Soroban operation types stay unregistered.
"""

from stellar_tpu_torch.tx.ops import account_ops  # noqa: F401
from stellar_tpu_torch.tx.ops import claimable_balances  # noqa: F401
from stellar_tpu_torch.tx.ops import create_account  # noqa: F401
from stellar_tpu_torch.tx.ops import liquidity_pool_ops  # noqa: F401
from stellar_tpu_torch.tx.ops import misc  # noqa: F401
from stellar_tpu_torch.tx.ops import offers  # noqa: F401
from stellar_tpu_torch.tx.ops import payment  # noqa: F401
from stellar_tpu_torch.tx.ops import soroban_ops  # noqa: F401
from stellar_tpu_torch.tx.ops import sponsorship_ops  # noqa: F401
from stellar_tpu_torch.tx.ops import trust_ops  # noqa: F401
