from stellar_tpu_torch.process.process_manager import (  # noqa: F401
    ProcessManager,
)
