"""The port's copy of ``stellar_tpu/soroban/__init__.py``, with the port's
imports."""

from stellar_tpu_torch.soroban.host import (  # noqa: F401
    HostError, InvokeOutput, invoke_host_function,
)
