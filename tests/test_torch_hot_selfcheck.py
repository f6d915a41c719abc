"""The port's hot-signer self-check (``stellar_tpu_torch/tools/
hot_signer_selfcheck.py``) passes on ``["cpu"] * 4`` at 12 signers (two
batches, more tables than the 10-table pressure budget): K1's and K2's
plain versions, replicas equal, every launch at the sub-chunk's 2 rows,
zero redundant bytes on the cached head's re-dispatch with the resident
cache on. Its corpus and batch stream are held to the reference's in
``tests/test_torch_selfchecks.py``. About 50 s in one process, nearly
all of it the plain K1 and K2 (about 1.4 s and 0.8 s a call at any
size)."""

from tests.test_torch_selfchecks import _run_tool


def test_hot_signer_selfcheck_passes_on_cpu():
    rc, rec = _run_tool("hot_signer_selfcheck", "--device", "cpu",
                        "--signers", "12", timeout=300)
    assert rc == 0 and rec["ok"], rec["problems"]
    assert (rec["device"], rec["devices"], rec["distinct_signers"]) == \
        ("cpu", 4, 12)
    assert rec["replica_a"] == rec["replica_b"]
    assert rec["replica_a"]["hot_rows"] > 0
    assert rec["replica_a"]["installs"] >= 12
    assert rec["kernel_shapes"] == {"cold": [2], "hot": [2], "donate": []}
    assert rec["libraries"] == []        # the CPU loads no kernel library
    assert rec["steady_state"]["redundant_constant_bytes"] == 0
    assert rec["steady_state"]["resident_hits"] > 0
    assert rec["resident_cache"] == {"on_in_window": True,
                                     "restored_to": False}
    assert rec["pressure"]["evictions"] > 0
    assert rec["pressure"]["entries"] <= 10
    assert rec["dsm_macs"]["savings_frac"] >= 0.2


def test_hot_signer_refuses_too_few_signers():
    """Below 12 signers the pressure check could not evict: the tool
    refuses to run, exit 1 with no record."""
    import subprocess
    import sys
    from tests._torch_port import ROOT
    proc = subprocess.run(
        [sys.executable, "-m",
         "stellar_tpu_torch.tools.hot_signer_selfcheck", "--device", "cpu",
         "--signers", "11"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "at least 12" in proc.stderr
