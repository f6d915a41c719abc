"""Command-line tools of the port, each run as ``python -m
stellar_tpu_torch.tools.<name>``: ``analyze`` (the static-analysis gate),
``kernel_cost`` (the kernels' cost ledger), ``device_probe``,
``run_benchmarks`` (the five BASELINE scenarios), ``trace_kernel_time``
(device busy time from a ``torch.profiler`` trace), ``trace_export``
(the flight recorder as a Chrome trace) and the engine's four
self-checks, ``metrics_selfcheck``, ``transfer_selfcheck``,
``pipeline_selfcheck`` and ``hot_signer_selfcheck``."""
