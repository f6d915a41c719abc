"""The port's pipeline self-check (``stellar_tpu_torch/tools/
pipeline_selfcheck.py``) passes on ``["cpu"] * 4``: K3's plain version
over four entries, both stalls classed ``queue_wait``, a 6-chunk
resolve's ``overlap_frac`` gated as on the card, the time-series ring
hammered throughout with the reference's 2 ms rest. Its constants and
corpus are held to the reference's in ``tests/test_torch_selfchecks.py``.
About 30 s in one process."""

from tests.test_torch_selfchecks import _run_tool
from stellar_tpu_torch.tools import pipeline_selfcheck as pps


def test_pipeline_selfcheck_passes_on_cpu():
    rc, rec = _run_tool("pipeline_selfcheck", "--device", "cpu",
                        timeout=300)
    assert rc == 0 and rec["ok"], rec["problems"]
    assert (rec["device"], rec["devices"], rec["chunks"]) == ("cpu", 4, 6)
    assert rec["overlap_gated"] is True
    assert rec["overlap_frac"] >= pps.MIN_OVERLAP
    assert rec["stall"]["largest_bubble_class"] == "queue_wait"
    assert rec["stall_transfer"]["largest_bubble_class"] == "queue_wait"
    assert rec["stall_transfer"]["queue_wait_excess_ms"] >= \
        pps.MIN_STALL_ATTRIBUTED * pps.STALL_S * 1000.0
    assert rec["reconciliation"] >= pps.MIN_RECONCILE
    assert rec["timeseries"]["ticks"] > 0
