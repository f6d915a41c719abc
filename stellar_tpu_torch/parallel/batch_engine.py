"""Batched device dispatch — the slim port of
``stellar_tpu/parallel/batch_engine.py``'s ``Workload`` / ``BatchEngine``.

It keeps the reference's plugin contract and the chunk-by-top-bucket loop
of ``submit``: a batch is split into chunks of at most the top bucket, each
chunk is encoded on the host, padded to the smallest bucket that holds it,
copied to the device and handed to the plugin's kernel; a chunk whose gate
is all False skips the device. ``submit(items, variant=...)`` runs another
plugin, a different kernel over the same result rows (the hot-signer
path), over the same bucket ladder. On CUDA the encoded rows go through
pinned host tensors and a ``non_blocking`` copy, the kernel launches on
the current stream, the result rows come back the same way and a
``torch.cuda.Event`` marks them; ``submit`` returns a resolver that waits
on the events. A build or launch failure reaches the caller as an exception.

Not in this slice (see ROADMAP.md): breakers, the sampled audit, host
failover, per-device sub-chunks and tracing spans.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from stellar_tpu_torch.utils.device import resolve_device

__all__ = ["DEFAULT_BUCKET_SIZES", "Workload", "BatchEngine"]

# The production bucket ladder (the reference's DEFAULT_BUCKET_SIZES).
DEFAULT_BUCKET_SIZES = (128, 512, 2048, 4096, 8192, 16384)


class Workload:
    """What a batch workload provides to ride the engine.

    * every array of ``encode``'s tuple (and of ``pad_rows``) carries the
      batch on its LEADING axis;
    * ``kernel_fn``'s callable takes the encoded tensors, padded to a
      bucket and on the engine's device, and returns ONE tensor, batch
      axis leading;
    * ``finalize`` composes the caller-visible result from the gate and
      the device rows;
    * ``variant_name`` names a plugin passed as ``variant=`` to
      :meth:`BatchEngine.submit`: the engine counts the rows it serves
      under that key of ``served``.
    """

    variant_name = None

    def encode(self, items: Sequence) -> Tuple[np.ndarray, tuple]:
        """Host prep: ``items`` -> ``(gate, arrays)``; ``gate`` is True
        where the device result decides the row."""
        raise NotImplementedError

    def pad_rows(self) -> tuple:
        """One valid padding row per encoded array, shape ``(1, ...)``."""
        raise NotImplementedError

    def kernel_fn(self) -> Callable:
        raise NotImplementedError

    def empty_result(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def finalize(self, gate: np.ndarray, out: np.ndarray,
                 items: Sequence) -> np.ndarray:
        raise NotImplementedError


class BatchEngine:
    """Generic batched dispatcher over a bucket ladder.

    Args:
      plugin: the :class:`Workload`.
      device: ``None`` (the first CUDA card; raises if there is none),
        ``"cuda[:N]"`` or ``"cpu"`` (the plain PyTorch versions).
      bucket_sizes: padded batch sizes, ascending.
    """

    def __init__(self, plugin: Workload, device=None,
                 bucket_sizes=DEFAULT_BUCKET_SIZES):
        buckets = tuple(sorted(int(b) for b in bucket_sizes))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"bad bucket sizes {bucket_sizes!r}")
        self._plugin = plugin
        self._buckets = buckets
        self.device = resolve_device(device)
        #: "device": rows (padding excluded) of the chunks launched on the
        #: device, whichever plugin ran them; a variant's name: the rows
        #: that variant's kernel ran, of those; "host": rows whose gate was
        #: False, so the host decided them (the verifier's rejections, the
        #: hasher's oversize messages)
        self.served = {"device": 0, "host": 0}

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(f"chunk of {n} rows exceeds the top bucket")

    def _launch(self, plugin: Workload, encoded: tuple, n: int):
        """Pad one chunk to its bucket, copy it to the device, launch the
        plugin's kernel and start the copy of the result back. Returns
        ``(host_result, event)``; ``event`` is None on the CPU."""
        bucket = self._bucket(n)
        cuda = self.device.type == "cuda"
        dev_ops = []
        for arr, pad in zip(encoded, plugin.pad_rows()):
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            host = torch.empty((bucket,) + arr.shape[1:], dtype=dtype,
                               pin_memory=cuda)
            hv = host.numpy()
            hv[:n] = arr
            hv[n:] = pad
            dev_ops.append(host.to(self.device, non_blocking=True))
        out_dev = plugin.kernel_fn()(*dev_ops)
        self.served["device"] += n
        if plugin is not self._plugin:
            self.served[plugin.variant_name] = \
                self.served.get(plugin.variant_name, 0) + n
        if not cuda:
            return out_dev, None
        out_host = torch.empty(out_dev.shape, dtype=out_dev.dtype,
                               pin_memory=True)
        out_host.copy_(out_dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out_host, event

    def submit(self, items: Sequence,
               variant: Optional[Workload] = None
               ) -> Callable[[], np.ndarray]:
        """Host prep and non-blocking device dispatch, chunk by top
        bucket. Returns a zero-argument resolver that waits for the device
        and returns the per-item results. ``variant`` replaces the
        engine's plugin for this call."""
        plugin = self._plugin if variant is None else variant
        items = list(items)
        n = len(items)
        if n == 0:
            return lambda: plugin.empty_result(0)
        top = self._buckets[-1]
        pending = []
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card \
                else contextlib.nullcontext():
            for start in range(0, n, top):
                chunk = items[start:start + top]
                gate, encoded = plugin.encode(chunk)
                self.served["host"] += int((~gate).sum())
                launched = (self._launch(plugin, encoded, len(chunk))
                            if gate.any() else None)
                pending.append((chunk, gate, launched))

        def resolve() -> np.ndarray:
            parts = []
            for chunk, gate, launched in pending:
                out = plugin.empty_result(len(chunk))
                if launched is not None:
                    host, event = launched
                    if event is not None:
                        event.synchronize()
                    out = host[:len(chunk)].numpy()
                parts.append(plugin.finalize(gate, out, chunk))
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

        return resolve

    def compute_batch(self, items: Sequence) -> np.ndarray:
        """Blocking :meth:`submit`."""
        return self.submit(items)()

