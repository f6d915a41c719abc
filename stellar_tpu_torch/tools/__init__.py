"""Command-line tools of the port, each run as ``python -m
stellar_tpu_torch.tools.<name>``: ``analyze`` (the static-analysis gate),
``kernel_cost`` (the kernels' cost ledger) and ``device_probe``."""
