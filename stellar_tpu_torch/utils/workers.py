"""Process-wide background worker pool for off-crank ledger work —
bucket merges, eviction-scan enumeration, and other deferred
computation (reference: the worker thread pool behind
``Application::postOnBackgroundThread``, ``src/main/Application.h`` —
FutureBucket merges, the background eviction scan, and overlay
pre-verification all ride it).

Everything submitted here must be a PURE computation over immutable
inputs: results are resolved at deterministic points in the crank, so
scheduling can never change consensus state — only when the work
happens. ``set_background(False)`` turns the pool into synchronous
inline execution (tests pin result-identity between the two modes).

The port's copy of ``stellar_tpu/utils/workers.py``, with the port's
imports."""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

__all__ = ["run_async", "set_background", "background_enabled",
           "shutdown"]

_pool: Optional[ThreadPoolExecutor] = None
_lock = threading.Lock()
_background = True


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _lock:
        if _pool is None:
            workers = min(4, max(2, (os.cpu_count() or 2) - 1))
            _pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="bg-work")
        return _pool


def set_background(enabled: bool) -> None:
    """Toggle background execution (False = run submissions inline;
    used by determinism tests and the ARTIFICIALLY_* config knobs)."""
    global _background
    with _lock:
        _background = enabled


def background_enabled() -> bool:
    return _background


def run_async(fn: Callable, *args) -> Future:
    """Submit a pure computation; returns a Future. In synchronous
    mode the call runs inline and the Future is already resolved."""
    if not _background:
        f: Future = Future()
        try:
            f.set_result(fn(*args))
        except BaseException as e:  # deferred, raised at .result()
            f.set_exception(e)
        return f
    return _get_pool().submit(fn, *args)


def shutdown() -> None:
    global _pool
    with _lock:
        pool, _pool = _pool, None
    if pool is not None:
        # outside _lock: waiting for in-flight work while holding the
        # submission lock would wedge any concurrent run_async caller
        pool.shutdown(wait=True)
