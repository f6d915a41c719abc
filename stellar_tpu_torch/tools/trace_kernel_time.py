"""Device busy time from a ``torch.profiler`` Chrome trace.

Reads the trace that ``torch.profiler.profile(activities=
[ProfilerActivity.CUDA]).export_chrome_trace`` writes (gzipped or not)
and prints one JSON line: the device's busy time (the union of its
events' intervals, so overlapping and nested events count once) divided
by ``n_iters``, each process's busy time and event count, and the top 8
device ops by total time. A device event is a complete event whose
``cat`` is a GPU kind (``kernel``, ``gpu_memcpy``, ``gpu_memset``); the
CUDA runtime calls the host makes are not. The caller reads the idle
share as ``1 - busy / wall``, with its own wall around the traced calls.

A trace with no device event raises: a profiler that recorded no CUDA
activity (no CUPTI, no card) never reads as 0 ms busy.

    python -m stellar_tpu_torch.tools.trace_kernel_time TRACE [n_iters]

:func:`capture` writes such a trace of any callable.
"""

from __future__ import annotations

import collections
import gzip
import json
import sys
import time

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


class NoDeviceEvents(RuntimeError):
    """The trace holds no device event."""


def union_ms(intervals):
    """Total covered time of [start, end) intervals, in ms."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total / 1000.0  # trace ts/dur are microseconds


def load_events(path):
    """The trace's events, from a plain or gzipped JSON file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace if isinstance(trace, list) else \
        trace.get("traceEvents", [])


def is_device_event(ev) -> bool:
    return ev.get("ph") == "X" and "dur" in ev and \
        ev.get("cat") in DEVICE_CATS


def analyze(path, n_iters):
    events = load_events(path)
    pid_names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
    per_pid = {}
    device = collections.defaultdict(list)
    top_events = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        pid = ev.get("pid")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        per_pid.setdefault(pid, []).append(span)
        if not is_device_event(ev):
            continue
        device[pid].append(span)
        rec = top_events.setdefault(ev.get("name", ""), [0, 0.0])
        rec[0] += 1
        rec[1] += float(ev["dur"]) / 1000.0
    if not device:
        raise NoDeviceEvents(f"{path}: no device event (cat in "
                             f"{sorted(DEVICE_CATS)}) in the trace")
    out = {"trace": str(path), "n_iters": n_iters, "processes": {}}
    for pid, ivals in per_pid.items():
        name = pid_names.get(pid, f"pid{pid}")
        busy = union_ms(ivals)
        out["processes"][name] = {
            "busy_ms_total": round(busy, 3),
            "busy_ms_per_iter": round(busy / max(1, n_iters), 3),
            "n_events": len(ivals),
        }
    # each device's own union, summed over devices
    device_busy = sum(union_ms(ivals) for ivals in device.values())
    out["device_busy_ms_per_iter"] = round(
        device_busy / max(1, n_iters), 3)
    # top 8 device ops by total duration: where the device time goes
    dev_ops = sorted(((n, c, d) for n, (c, d) in top_events.items()),
                     key=lambda t: -t[2])
    out["top_device_ops"] = [
        {"name": n[:80], "count": c, "total_ms": round(d, 3)}
        for n, c, d in dev_ops[:8]]
    return out


def capture(fn, n_iters, path):
    """Run ``fn()`` once untimed, then ``n_iters`` times under
    ``torch.profiler`` with CUDA activities only, and write the Chrome
    trace to ``path``. Returns :func:`analyze`'s record with
    ``wall_ms_per_iter``, the host's ``perf_counter`` time of a traced
    call (the card synchronised before the clock stops). Raises
    :class:`NoDeviceEvents` when the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    if ProfilerActivity.CUDA not in supported_activities():
        raise NoDeviceEvents("this PyTorch's profiler records no CUDA "
                             "activity")
    cuda = torch.cuda.is_available()
    fn()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    prof.export_chrome_trace(str(path))
    out = analyze(path, n_iters)
    out["wall_ms_per_iter"] = wall_s * 1e3 / n_iters
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    n_iters = int(argv[1]) if len(argv) > 1 else 3
    print(json.dumps(analyze(argv[0], n_iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
