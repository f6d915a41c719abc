"""Partitioned logging.

The reference's spdlog setup has 13 compile-time partitions
(``src/util/LogPartitions.def``) each independently leveled at runtime via
the ``ll`` admin endpoint. Same model here on top of :mod:`logging`:
``get_logger(partition)`` and ``set_log_level(partition_or_None, level)``.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

PARTITIONS = [
    "Fs", "SCP", "Bucket", "Database", "History", "Process", "Ledger",
    "Overlay", "Herder", "Tx", "LoadGen", "Work", "Invariant", "Perf",
]

_configured = False


def _configure():
    global _configured
    if _configured:
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(asctime)s [%(name)s %(levelname)s] %(message)s"))
    root = logging.getLogger("stellar_tpu")
    root.addHandler(h)
    root.setLevel(logging.WARNING)
    root.propagate = False
    _configured = True


_COLORS = {"DEBUG": "\x1b[36m", "INFO": "\x1b[32m",
           "WARNING": "\x1b[33m", "ERROR": "\x1b[31m",
           "CRITICAL": "\x1b[35m"}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        out = super().format(record)
        c = _COLORS.get(record.levelname)
        return f"{c}{out}\x1b[0m" if c else out


def set_log_color(enabled: bool) -> None:
    """Colorized console output (reference LOG_COLOR)."""
    _configure()
    fmt = "%(asctime)s [%(name)s %(levelname)s] %(message)s"
    for h in logging.getLogger("stellar_tpu").handlers:
        if isinstance(h, logging.StreamHandler) and \
                not isinstance(h, logging.FileHandler):
            h.setFormatter(_ColorFormatter(fmt) if enabled
                           else logging.Formatter(fmt))


def get_logger(partition: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"stellar_tpu.{partition}")


def set_log_level(partition: Optional[str], level) -> None:
    """``partition=None`` sets every partition (the ``ll`` endpoint
    semantics)."""
    _configure()
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    if partition is None:
        logging.getLogger("stellar_tpu").setLevel(level)
        for p in PARTITIONS:
            logging.getLogger(f"stellar_tpu.{p}").setLevel(level)
    else:
        logging.getLogger(f"stellar_tpu.{partition}").setLevel(level)


def append_jsonl_capped(path: str, rec: dict,
                        max_bytes: int = 4_000_000,
                        keep: int = 1) -> None:
    """Size-bounded JSONL append with rotation: when ``path`` would
    grow past ``max_bytes``, shift ``path`` → ``path.1`` → ... →
    ``path.<keep>`` (the oldest generation is dropped) before
    appending. Evidence streams written by unattended daemons
    (``DEVICE_PROBES.jsonl`` from ``tools/device_watch.py``) keep the
    recent history without ever filling the disk."""
    import json
    import os
    line = json.dumps(rec) + "\n"
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size and size + len(line) > max_bytes:
        for g in range(keep, 0, -1):
            src = path if g == 1 else f"{path}.{g - 1}"
            try:
                os.replace(src, f"{path}.{g}")
            except OSError:
                pass  # missing generation: nothing to shift
    with open(path, "a") as f:
        f.write(line)
