"""Device lists for the batch crypto engine — the counterpart of
``stellar_tpu/parallel/mesh.py``.

The reference shards the signature batch over a 1-D JAX mesh; the port
takes a list of CUDA devices. Position ``i`` in the list is "device
``i``" everywhere: sub-chunk assignment in the engine, the breakers of
:mod:`stellar_tpu_torch.parallel.device_health` and per-device faults.
A list may name one device several times; the CPU tests and
``chip_smoke.py`` exercise the split that way, as the reference's tests
do with virtual CPU devices.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["device_count", "batch_devices", "auto_devices"]


def device_count() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def batch_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` (default: every) CUDA card, in index order."""
    count = device_count()
    n = count if n is None else n
    if n > count:
        raise RuntimeError(f"{n} CUDA device(s) requested but {count} "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def auto_devices() -> Optional[List[torch.device]]:
    """Every card, or None below two: the counterpart of the reference's
    ``_auto_mesh``, under which a one-card host dispatches unsplit."""
    devs = batch_devices()
    return devs if len(devs) >= 2 else None
