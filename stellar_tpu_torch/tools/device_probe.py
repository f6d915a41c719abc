"""Timestamped CUDA device-availability probe.

Runs ``x + 1`` on every visible card in a subprocess with a hard timeout
(a wedged card can hang the first CUDA call instead of raising), and
appends one JSON line a run to ``build/torch_device_probes.jsonl`` under
the repository root: the time, the platform, each device's ``ok`` and
``probe_s``, and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. With no card visible it records ``ok: false`` and exits 3: it never
probes the CPU in the card's place.

    python -m stellar_tpu_torch.tools.device_probe [timeout_s]
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOG = os.path.join(REPO, "build", "torch_device_probes.jsonl")

PROBE_SRC = r"""
import json, time
t0 = time.perf_counter()
import torch
n = torch.cuda.device_count() if torch.cuda.is_available() else 0
per_dev = []
for i in range(n):
    t1 = time.perf_counter()
    try:
        x = torch.ones((8, 8), device=f"cuda:{i}")
        y = (x + 1).sum().item()
        ok = y == 128.0
        per_dev.append({"index": i, "device": f"cuda:{i}", "ok": ok,
                        "name": torch.cuda.get_device_name(i),
                        "probe_s": round(time.perf_counter() - t1, 3)}
                       | ({} if ok else {"error": f"x + 1 summed to {y}"}))
    except Exception as e:
        per_dev.append({"index": i, "device": f"cuda:{i}", "ok": False,
                        "error": f"{type(e).__name__}: {e}"[:200]})
print(json.dumps({"platform": "cuda" if n else None, "n_devices": n,
                  "probe_s": round(time.perf_counter() - t0, 3),
                  "devices": per_dev}))
"""


def _run_group(cmd, timeout_s):
    """``subprocess.run``-alike that kills the whole process group on a
    timeout, so a hung child holding the pipes cannot block the wait."""
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         process_group=0)
    try:
        stdout, stderr = p.communicate(timeout=timeout_s)
        return p.returncode, stdout, stderr
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        raise


def card_name_and_power() -> str | None:
    """``nvidia-smi``'s name and power limit of the cards, or None where
    there is no nvidia-smi or it fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def probe(timeout_s: float = 90) -> dict:
    """One probe record; ``ok`` is True only when at least one card is
    visible and every visible card answered."""
    rec = {"ts": datetime.datetime.now(datetime.timezone.utc).isoformat()}
    try:
        rc, so, se = _run_group([sys.executable, "-u", "-c", PROBE_SRC],
                                timeout_s)
        if rc == 0:
            try:
                rec.update(json.loads(so.strip().splitlines()[-1]))
            except (IndexError, ValueError):
                rec["rc"] = "bad-output"
                rec["stdout_tail"] = so[-300:]
        else:
            rec["rc"] = rc
            rec["stderr_tail"] = se[-500:]
    except subprocess.TimeoutExpired:
        rec["rc"] = "timeout"
        rec["timeout_s"] = timeout_s
    devices = rec.get("devices") or []
    rec["ok"] = bool(devices) and all(d["ok"] for d in devices)
    rec["card"] = card_name_and_power()
    return rec


def append(rec: dict, path: str | None = None) -> None:
    from stellar_tpu_torch.utils.logging import append_jsonl_capped
    path = path or LOG
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # size-capped: a probe loop never fills the disk
    append_jsonl_capped(path, rec)


def main(argv) -> int:
    rec = probe(float(argv[0]) if argv else 90)
    append(rec)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
