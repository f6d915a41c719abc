"""Abstract SCP consensus kernel (reference ``src/scp``): a pure state
machine driven by ``receive_envelope`` + driver callbacks — no I/O, no
threads, values are opaque bytes."""

from stellar_tpu_torch.scp.driver import SCPDriver, ValidationLevel  # noqa
from stellar_tpu_torch.scp.scp import SCP, EnvelopeState  # noqa
