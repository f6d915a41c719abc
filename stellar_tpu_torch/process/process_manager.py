"""ProcessManager: run external commands for history archive get/put
(reference ``src/process/ProcessManagerImpl.cpp`` — posix_spawn'd
subprocesses whose exit events are posted back to the main thread,
bounded by MAX_CONCURRENT_SUBPROCESSES, with kill-on-timeout).

The crank integration matches the framework's single-threaded design:
``poll()`` reaps finished children and fires their completion handlers;
the Application's crank (or a Work step) calls it. ``run_sync`` is the
blocking form used by offline CLI commands.
"""

from __future__ import annotations

import shlex
import subprocess
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ProcessManager"]

MAX_CONCURRENT_SUBPROCESSES = 16  # reference Config default


class _Handle:
    __slots__ = ("proc", "cmdline", "on_exit", "deadline")

    def __init__(self, proc, cmdline, on_exit, deadline):
        self.proc = proc
        self.cmdline = cmdline
        self.on_exit = on_exit
        self.deadline = deadline


class ProcessManager:
    def __init__(self,
                 max_concurrent: int = MAX_CONCURRENT_SUBPROCESSES):
        self.max_concurrent = max_concurrent
        self.running: List[_Handle] = []
        self.pending: List[tuple] = []

    # ---------------- async (crank-driven) ----------------

    def run_process(self, cmdline: str,
                    on_exit: Callable[[int], None],
                    timeout: Optional[float] = None):
        """Queue a command; ``on_exit(returncode)`` fires from poll()."""
        self.pending.append((cmdline, on_exit, timeout))
        self._launch_pending()

    def _launch_pending(self):
        while self.pending and len(self.running) < self.max_concurrent:
            cmdline, on_exit, timeout = self.pending.pop(0)
            proc = subprocess.Popen(
                shlex.split(cmdline),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            deadline = time.monotonic() + timeout if timeout else None
            self.running.append(_Handle(proc, cmdline, on_exit, deadline))

    def poll(self) -> int:
        """Reap finished children; returns handlers fired."""
        fired = 0
        now = time.monotonic()
        for h in list(self.running):
            rc = h.proc.poll()
            if rc is None and h.deadline is not None and now > h.deadline:
                h.proc.kill()
                rc = h.proc.wait()
            if rc is not None:
                self.running.remove(h)
                fired += 1
                h.on_exit(rc)
        self._launch_pending()
        return fired

    def shutdown(self):
        for h in self.running:
            h.proc.kill()
        self.running.clear()
        self.pending.clear()

    # ---------------- sync (offline commands) ----------------

    @staticmethod
    def run_sync(cmdline: str, timeout: Optional[float] = 60) -> int:
        try:
            return subprocess.run(
                shlex.split(cmdline), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            return -1
