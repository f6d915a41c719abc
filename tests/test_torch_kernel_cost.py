"""``stellar_tpu_torch.tools.kernel_cost``: the plain versions' executed
multiply ledger against the reference's pins, and the CUDA kernels'
multiply-adds and bounds that ``chip_smoke.py`` computes every kernel's
bound with.

The reference's pins (``tests/test_kernel_cost.py``, batch 128, 5%
slack each): dsm executed multiply elements 115,124,540, ``batch_inv``
3,237,180, the hot arm 87,439,360, the hot arm at least 20% below cold.
The port's plain versions are the reference's op for op but for one
place: the reference's ``inv_scan`` computes ``mul(acc, z)`` on each of
the 254 exponent bits and selects, the port's multiplies on the 252 set
bits only, 2 x 20 x 20 = 800 elements fewer, in ``batch_inv`` and so in
``dsm`` (pinned exactly below). The reference's "static" count (each
``scan`` body once) has no eager counterpart.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from stellar_tpu_torch.ops import field25519 as fe
from stellar_tpu_torch.tools import kernel_cost as kc
from tests._torch_port import ROOT

# the reference's pins at batch 128
REF_DSM_MACS = 115_124_540
REF_BATCH_INV = 3_237_180
REF_HOT_MACS = 87_439_360
# the inversion's two multiplies the port does not make (zero exponent
# bits of p - 2 after its leading 1): 2 multiplies of (20, 1) limbs, 20
# products of 20 elements each
INV_SCAN_SKIPPED = 2 * fe.NLIMBS * fe.NLIMBS


@pytest.fixture(scope="module")
def report():
    return kc.trace_stages(batch=128)


@pytest.fixture(scope="module")
def sweep():
    return kc.radix_sweep(batch=128)


def test_inv_scan_multiplies_on_set_bits_only():
    assert fe._INV_EXP_BITS.count(0) == 2
    assert len(fe._INV_EXP_BITS) == 254


def test_dsm_executed_macs_meet_the_pin(report):
    got = report["dsm"]["executed_macs_per_call"]
    assert got == report["dsm_weighted_mul_elems"]
    assert got == REF_DSM_MACS - INV_SCAN_SKIPPED == 115_123_740
    assert abs(got - REF_DSM_MACS) <= 0.05 * REF_DSM_MACS


def test_batch_inv_meets_the_pin(report):
    got = report["affine_table"]["batch_inv_weighted_mul_elems"]
    assert got == REF_BATCH_INV - INV_SCAN_SKIPPED == 3_236_380
    assert abs(got - REF_BATCH_INV) <= 0.05 * REF_BATCH_INV


def test_hot_arm_meets_the_pin_and_saves_20pct(report):
    hot = report["dsm"]["hot"]["executed_macs_per_call"]
    cold = report["dsm"]["cold"]["executed_macs_per_call"]
    assert hot == REF_HOT_MACS
    assert hot <= 0.80 * cold, (hot, cold)
    assert report["signer_table"]["hot_savings_frac"] >= 0.20
    assert report["dsm"]["hot"]["vs_cold_frac"] == round(hot / cold, 4)


def test_batch_inv_is_one_inversion_per_call(report):
    """The Montgomery chain's volume stays near ONE inversion a call: a
    decay to per-lane inversions would cost what compress_compare's
    single fe.inv a lane measures."""
    chain = report["affine_table"]["batch_inv_weighted_mul_elems"]
    per_lane = report["stages"]["compress_compare"]["weighted_mul_elems"]
    assert chain < 0.5 * per_lane, (chain, per_lane)


def test_selects_off_the_multiply_units(report):
    assert report["select_macs_per_verify"] == 0
    assert report["select_logic_elems_per_verify"] == 2 * 52 * 15 * 3 * 20
    assert (report["table_entries"], report["windows"],
            report["radix"]) == (16, 52, 32)


def test_radix_sweep_decision(sweep, report):
    """Both arms counted, radix 32 wins the executed volume by more than
    5%, and each arm's analytic shape is the reference's."""
    assert sweep["decision"] == "radix32"
    r16 = sweep["arms"]["radix16"]["weighted_mul_elems"]
    r32 = sweep["arms"]["radix32"]["weighted_mul_elems"]
    assert r32 < 0.95 * r16, (r32, r16)
    assert r32 == report["dsm"]["executed_macs_per_call"]
    assert sweep["arms"]["radix16"]["table_entries"] == 8
    assert sweep["arms"]["radix16"]["select_macs"] == 81_920
    assert sweep["arms"]["radix32"]["doublings"] == 255
    assert sweep["arms"]["radix32"]["cached_adds"] == 103


def test_signer_table_geometry_pinned(report):
    st = report["signer_table"]
    assert (st["radix"], st["windows"], st["entries"]) == (256, 32, 128)
    assert st["table_dtype"] == "int16"
    assert st["bytes_per_signer"] == 128 * 3 * 20 * 2
    assert (st["doublings"], st["cached_adds"]) == (248, 63)


def test_hot_stage_has_no_decompress(report):
    """No in-kernel decompression and no table build: the hot kernel's
    multiply ops a call stay under half the cold kernel's."""
    hot = report["stages"]["kernel_hot_total"]["weighted_mul_ops"]
    cold = report["stages"]["kernel_total"]["weighted_mul_ops"]
    assert hot < 0.5 * cold, (hot, cold)


def test_stage_sum_equals_total(report):
    """The three stages account for the whole kernel: negate and the
    final AND multiply nothing."""
    s = report["stages"]
    for key in ("weighted_mul_ops", "weighted_mul_elems"):
        parts = (s["decompress"][key] + s["dsm"][key]
                 + s["compress_compare"][key])
        assert s["kernel_total"][key] == parts, key
    assert s["kernel_hot_total"]["weighted_mul_elems"] == \
        s["dsm_hot"]["weighted_mul_elems"] + \
        s["compress_compare"]["weighted_mul_elems"]


def test_counts_are_exact():
    """Counting each (function, shapes) pair once gives exactly what
    counting every op gives (decompress at 2 rows, 87,714 ops)."""
    from stellar_tpu_torch.ops import edwards as ed

    class Every(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = self.el = self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            if func._overloadpacket in (torch.ops.aten.mul,
                                        torch.ops.aten.mul_):
                self.n += 1
                self.el += out.numel()
            return out

    b = torch.zeros((2, 32), dtype=torch.uint8)
    every = Every()
    with every:
        ed.decompress(b)
    got = kc.count(ed.decompress, (b,))
    assert (got["mul_ops"], got["mul_elems"], got["ops"]) == \
        (every.n, every.el, every.ops)


def test_sha256_plain_volume():
    rec = kc.trace_sha256(batch=4)
    # the reference's masked half-word adds: a sum of k words is 2k adds
    # (k - 1 a half, the carry and the recombine). 8 blocks of 64 rounds
    # of 22 (T1 of 5 words, T2, a and e of 2), 48 schedule words of 4
    # words, and the feed-forward's 8 sums of 2
    assert rec["add_weighted_ops"] == 8 * (64 * 22 + 48 * 8 + 8 * 4)
    assert rec["add_weighted_elems"] == 4 * rec["add_weighted_ops"]
    assert rec["logic_weighted_ops"] > rec["add_weighted_ops"]


# ---------------- the CUDA kernels' work and bounds ----------------

def test_cold_kernel_multiplies_counts_the_op_sequence():
    zero = torch.zeros((2, 32), dtype=torch.uint8)
    fixed = 513 * 55 + 165 * 100
    assert kc.cold_kernel_multiplies(zero, zero) == 2 * fixed
    one = zero.clone()
    one[0, 0] = 1
    assert kc.cold_kernel_multiplies(one, zero) == 2 * fixed + 700
    assert kc.cold_kernel_executed(2) == 2 * (1533 * 55 + 1965 * 100)


def test_cuda_ledger_per_row():
    led = kc.cuda_ledger()
    assert led["verify_cold"]["executed_multiply_adds_per_row"] == \
        1533 * 55 + 1965 * 100
    assert led["verify_hot"]["executed_multiply_adds_per_row"] == \
        kc.hot_kernel_executed(1)
    assert led["verify_r16"]["executed_multiply_adds_per_row"] == \
        1521 * 55 + 2061 * 100
    assert led["sha256"]["operations_per_block"] == 1384 == \
        kc.sha_ops_per_block()


def test_bound_is_the_larger_time():
    info = {"sms": 132, "clock_hz": 1.98e9}
    ms, by = kc.bound(info, 132 * 1.98e9 * 64 / 1e3, 64, 1)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = kc.bound(info, 1, 64, kc.HBM_BYTES_PER_S / 1e3)
    assert by == "bytes" and ms == pytest.approx(1.0)


def _records(rng):
    s = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    h = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    return [{"kernel": "verify_cold", "label": "2048", "s": s, "h": h,
             "bytes": 8 * kc.ROW_BYTES},
            {"kernel": "verify_hot", "label": "2048", "s": s, "h": h,
             "bytes": 8 * 100},
            {"kernel": "verify_r16", "label": "2048", "s": s, "h": h,
             "bytes": 8 * kc.ROW_BYTES},
            {"kernel": "sha256", "label": "2048", "blocks": 9,
             "bytes": 4 * (8 * 65 + 32)}]


def test_measured_rows_round_trip(tmp_path):
    """The rows file chip_smoke.py writes, read back, gives the cost the
    kernel phases computed on the same rows."""
    info = {"sms": 132, "clock_hz": 1.98e9}
    recs = _records(np.random.default_rng(7))
    path = str(tmp_path / "rows.npz")
    kc.save_rows(path, recs)
    back = kc.load_rows(path)
    for want, got in zip(recs, back):
        a, b = kc.measured_row_cost(info, want), \
            kc.measured_row_cost(info, got)
        assert a == b
    cold = kc.measured_row_cost(info, recs[0])
    s, h = torch.as_tensor(recs[0]["s"]), torch.as_tensor(recs[0]["h"])
    assert cold["multiply_adds"] == kc.cold_kernel_multiplies(s, h)
    assert cold["executed_multiply_adds"] == kc.cold_kernel_executed(8)
    assert (cold["bound_ms"], cold["bound_by"]) == kc.bound(
        info, cold["multiply_adds"], kc.IMAD_PER_CLOCK_PER_SM,
        8 * kc.ROW_BYTES)
    sha = kc.measured_row_cost(info, recs[3])
    assert sha["operations"] == 9 * 1384


def test_cli_json_with_card_figures(tmp_path):
    """``python -m stellar_tpu_torch.tools.kernel_cost --json`` with the
    card's SM count and clock and a rows file: one JSON line with the
    plain ledger and each row's cost."""
    path = str(tmp_path / "rows.npz")
    kc.save_rows(path, _records(np.random.default_rng(8)))
    proc = subprocess.run(
        [sys.executable, "-m", "stellar_tpu_torch.tools.kernel_cost",
         "--json", "--batch=4", "--sms=132", "--clock-hz=1.98e9",
         f"--rows={path}"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["card"] == {"sms": 132, "clock_hz": 1.98e9}
    assert [r["kernel"] for r in out["rows"]] == [
        "verify_cold", "verify_hot", "verify_r16", "sha256"]
    info = {"sms": 132, "clock_hz": 1.98e9}
    for got, rec in zip(out["rows"], kc.load_rows(path)):
        want = kc.measured_row_cost(info, rec)
        assert {k: got[k] for k in want} == want
    assert out["plain"]["batch"] == 4
    assert out["radix_sweep"]["decision"] == "radix32"
