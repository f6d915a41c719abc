"""The port's Soroban package. So far it holds only ``cost_model``; the
reference's ``__init__`` also re-exports the host's ``HostError``,
``InvokeOutput`` and ``invoke_host_function``, which come with the Soroban
slice (ROADMAP.md)."""
