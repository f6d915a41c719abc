#!/usr/bin/env python3
"""On-card smoke run of ``stellar_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It needs the CUDA toolkit (``nvcc``) and ``g++``: the kernels and the host
prep library are built from the repository's sources at first use. Phases,
in order; each one fails loudly (a message on stderr, exit code 1):

1. device  — the card's name, count, and ``nvidia-smi``'s name and power
   limit;
2. build   — K1 (``csrc/verify_cold.cu``), K2 (``csrc/verify_hot.cu``)
   and K3 (``csrc/sha256.cu``) with nvcc and the SHA-512 prep library with
   g++, the four builds started together; build seconds, registers and
   spills;
3. kernel against plain — K1 and its plain PyTorch version on the same
   CUDA tensors (edge corpus, good signatures, rows whose device bit is
   True for arbitrary 256-bit scalars, random bytes): equal bits on every
   row;
4. main path, cold TxSet — the signer-table cache off;
   ``default_verifier().verify_batch`` on 2,000 signatures from 2,000
   signers over 32-byte messages, 2% corrupted; every verdict equal to the
   port's oracle; p50 and p90 of 20 calls;
5. main path, cold catchup — the cache off; 16,384 signatures (2,048
   signers x 8 messages, 2% corrupted) in one call, checked against the
   oracle on a seeded sample and on every corrupted row; one untimed call
   first, then p50 and p90 of 10 calls;
6. K1 at the main path's shapes — at B = 2,048 and 16,384, the buckets the
   two calls pad to: the main path's own padded rows with the edge corpus,
   matching rows and random bytes written over their head; K1 and its
   plain version give equal bits on every row, and K1's time (CUDA events)
   stands beside the plain version's and the bound; after phase 8 the same
   at the buckets the hot paths give K1, on the operands those calls sent
   it (B = 128: a steady hot TxSet or catchup call's uncacheable rows;
   B = 4,096: the first hot catchup call's first sights);
7. main path, hot TxSet — the cache on and empty, phase 4's items: the
   first call (every signer a first sight: cold, one table build each)
   timed alone, then p50 and p90 of 20 calls in which every row with a
   cacheable key rides K2; verdicts equal to the oracle and to phase 4's;
   the host part (partition, encode with the table stack, the stack
   alone, the pinned copy of the table operand) timed apart;
8. main path, hot catchup — the cache on and empty, phase 5's items: the
   first call (one K1 and one K2 launch) timed alone, then p50 and p90 of
   10 calls; checked against the oracle on a sample and on every
   corrupted row, and against phase 5's verdicts on every row;
9. K2 at the hot path's shapes — at B = 2,048 and 16,384: the hot path's
   own padded rows with edge rows, matching rows whose top digit
   saturates the 128-entry select, and random R, s, h over real tables
   written over their head; K2 and its plain version give equal bits on
   every row; K2's time, the plain version's and the bound;
10. hashing — ``default_hasher().hash_batch`` on 2,048 messages (0-503
   bytes, 2% oversize at 504-2,000 bytes), every digest equal to
   hashlib's; p50 and p90 of 20 calls beside hashlib's time for the same
   messages; then K3 against its plain version on the call's own rows at
   B = 2,048, and timed; one ``{"kernels": [...]}`` line.

Each kernel's launch count is set to 0 just before its main path runs and
read just after: K1 over phases 4-5 and again over phases 7-8, K2 over
phases 7-8, K3 over phase 10's calls. The last line is ``{"ok": true, "device": {...}}``. With no
card, or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

try:
    import numpy as np
    import torch

    from stellar_tpu_torch.crypto import ed25519_ref as ref
    from stellar_tpu_torch.crypto import native_prep, vectors
    from stellar_tpu_torch.crypto.batch_hasher import (MAX_BLOCKS,
                                                       default_hasher)
    from stellar_tpu_torch.crypto.batch_verifier import (
        Ed25519HotWorkload, Ed25519Workload, default_verifier)
    from stellar_tpu_torch.ops import _build
    from stellar_tpu_torch.ops import sha256 as sk
    from stellar_tpu_torch.ops import verify as vk
    from stellar_tpu_torch.parallel.signer_tables import (
        TABLE_ENTRIES, build_signer_table, signer_table_cache)
    from stellar_tpu_torch.utils.device import resolve_device
except ImportError as e:  # run outside the repository
    _IMPORT_ERROR = e
else:
    _IMPORT_ERROR = None

SEED = 20260917
TXSET_SIGS = 2000
CATCHUP_SIGNERS, CATCHUP_MSGS = 2048, 8
CORRUPT_SHARE = 0.02
TIMED_CALLS = 20
CATCHUP_CALLS = 10
KERNEL_BATCHES = (2048, 16384)  # the buckets of the TxSet and catchup calls
KERNEL_REPS = 50
HASH_MSGS = 2048
HASH_OVERSIZE_SHARE = 0.02
HASH_CALLS = 20
HASH_KERNEL_REPS = 200
# H100 figures for the bound: 32-bit integer multiply-adds, and 32-bit
# integer add, logic and shift operations, per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table) and HBM3 bandwidth (NVIDIA's data sheet).
IMAD_PER_CLOCK_PER_SM = 64
INT_OPS_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 4 * 32 + 1  # A, R, s, h read once, one bool written
HOT_ENTRY_BYTES = 3 * 20 * 2  # one int16 affine cached entry
# K3's operations per compressed block are counted from the built
# kernel's SASS (sha_ops_per_block): these instructions of its block loop,
# the 32-bit integer add, logic and shift work of the compression.
SHA_SASS_OPS = ("SHF", "LOP3", "IADD3", "IMAD.IADD")
_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?"
                        r"([A-Z0-9_.]+)\s*([^;]*);")

# Field multiplies of the CUDA kernel's op sequence, for the operations
# bound. A ``fe_mul`` is 100 32x32->64 multiply-adds, an ``fe_sq`` 55
# (csrc/fe25519.cuh). (squarings, multiplies) per row, from
# csrc/verify_cold.cu:
FE_MUL_MACS = 100
FE_SQ_MACS = 55
# fe_invert / fe_pow22523 (ref10 chains): 254 / 251 squarings, 11 multiplies
_INVERT = (254, 11)
_POW22523 = (251, 11)
# decompress: 4 sq + 7 mul around pow22523, +1 mul for the sqrt(-1) fix
# (taken always), +1 mul for T
_DECOMPRESS = (4 + _POW22523[0], 9 + _POW22523[1])
# A-table: 1 doubling (4 sq, 4 mul to extended), 14 mixed adds (3 mul +
# 4 to extended), the precomp of -A (1 mul); normalisation: 15 prefix
# muls, one inversion, 30 back-substitution muls, 32 for x and y, 32 for
# 2d*x*y
_TABLE = (4 + _INVERT[0], 4 + 14 * 7 + 1 + 15 + _INVERT[1] + 30 + 32 + 32)
# 51 windows of 5 doublings: 4 sq each, 3 muls to projective (4 to
# extended for the last of the window)
_DOUBLINGS = (51 * 5 * 4, 51 * (4 * 3 + 4))
# one mixed add (3 mul) + conversion to extended (4 mul) per nonzero digit
_ADD_MULS = 7
# encode: one inversion and two multiplies
_ENCODE = (_INVERT[0], _INVERT[1] + 2)
# K2 (csrc/verify_hot.cuh): 31 windows of 8 doublings, 4 sq each, with 3
# muls to projective after 7 of them and 4 to extended after the 8th
_HOT_DOUBLINGS = (31 * 8 * 4, 31 * (7 * 3 + 4))


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def corrupt(items, rng, share):
    """Flip one bit of the message, R, s or the key in ``share`` of the
    items; returns the indices changed."""
    n = len(items)
    idx = np.sort(rng.choice(n, size=max(1, int(n * share)), replace=False))
    for k, i in enumerate(idx):
        pk, msg, sig = items[i]
        which = k % 4
        if which == 0:
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        elif which in (1, 2):
            b = bytearray(sig)
            b[int(rng.integers(0, 32)) + 32 * (which - 1)] ^= 1 << int(
                rng.integers(0, 8))
            sig = bytes(b)
        else:
            b = bytearray(pk)
            b[int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
            pk = bytes(b)
        items[i] = (pk, msg, sig)
    return idx


def signed_items(rng, signers, per_signer, msg_len=32):
    """``signers`` keys, each signing ``per_signer`` random messages."""
    items = []
    for _ in range(signers):
        seed = rng.bytes(32)
        pk = ref.secret_to_public(seed)
        for _ in range(per_signer):
            msg = rng.bytes(msg_len)
            items.append((pk, msg, ref.sign(seed, msg)))
    return items


def cold_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds that K1 executes for these rows (the kernel
    skips the add of a zero digit, so the count depends on the scalars).
    (batch, 32) uint8 CPU tensors in, a Python int out."""
    nonzero = int((vk.signed_digits32(s_bytes) != 0).sum()
                  + (vk.signed_digits32(h_bytes) != 0).sum())
    fixed = [_DECOMPRESS, _TABLE, _DOUBLINGS, _ENCODE]
    sq = sum(f[0] for f in fixed)
    mul = sum(f[1] for f in fixed)
    rows = s_bytes.shape[0]
    return (rows * (sq * FE_SQ_MACS + mul * FE_MUL_MACS)
            + nonzero * _ADD_MULS * FE_MUL_MACS)


def hot_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds that K2 executes for these rows: the fixed
    doublings and encode, and one mixed add for each nonzero radix-256
    digit. (batch, 32) uint8 CPU tensors in, a Python int out."""
    nonzero = int((vk.signed_digits256(s_bytes) != 0).sum()
                  + (vk.signed_digits256(h_bytes) != 0).sum())
    sq = _HOT_DOUBLINGS[0] + _ENCODE[0]
    mul = _HOT_DOUBLINGS[1] + _ENCODE[1]
    return (s_bytes.shape[0] * (sq * FE_SQ_MACS + mul * FE_MUL_MACS)
            + nonzero * _ADD_MULS * FE_MUL_MACS)


def bound(info, ops, ops_per_clock_per_sm, nbytes):
    """(least ms, what bounds it): the larger of the operations over the
    card's rate and the bytes over its memory rate."""
    ops_ms = ops / (ops_per_clock_per_sm * info["sms"]
                    * info["clock_hz"]) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def sha_ops_per_block():
    """K3's 32-bit integer operations per compressed block, from
    ``cuobjdump -sass`` of the built library: the instructions between
    the kernel's one backward branch and its target (the loop over a
    row's blocks), of the kinds in ``SHA_SASS_OPS`` (``.X`` carry forms,
    moves, loads, compares and branches left out). Returns (count, the
    count by opcode)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", _build.library_path("sha256")],
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    code = []
    for ln in proc.stdout.split("Function : ")[-1].splitlines():
        m = _SASS_LINE.match(ln)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    back = [(int(arg, 16), addr) for addr, op, arg in code
            if op == "BRA" and re.fullmatch(r"0x[0-9a-f]+", arg.strip())
            and int(arg, 16) < addr]
    check(len(back) == 1, f"K3's SASS has {len(back)} backward branches, "
          "not the one block loop")
    lo, hi = back[0]
    body = [op for addr, op, _arg in code if lo <= addr <= hi]
    loads = sum(op.startswith("LDG.E.128") for op in body)
    check(loads == 4, f"K3's block loop makes {loads} 16-byte loads, not "
          "one block's 4")
    kinds = collections.Counter(_sass_kind(op) for op in body)
    counts = {k: kinds[k] for k in SHA_SASS_OPS}
    return sum(counts.values()), counts


def _sass_kind(op):
    """The ``SHA_SASS_OPS`` entry an opcode counts under, or None."""
    if op in SHA_SASS_OPS:
        return op
    base, *mods = op.split(".")
    return base if base in SHA_SASS_OPS and "X" not in mods else None


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    print(f"[device] {name}, {count} card(s); nvidia-smi: {smi}")
    print(smi)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {sms} SMs, max SM clock {clock_mhz} MHz; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"name": name, "count": count, "smi": smi,
            "clock_hz": clock_mhz * 1e6, "sms": sms}


def phase_build(dev):
    """K1, K2 and K3 with nvcc and the prep library with g++, all four
    builds started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_build.LIBRARIES) + 1) as pool:
        jobs = [pool.submit(_build.library, name, dev)
                for name in _build.LIBRARIES]
        jobs.append(pool.submit(native_prep._load))
        for job in jobs:
            job.result()
    secs = time.perf_counter() - t0
    print(f"[build] K1, K2, K3 and the prep library built in {secs:.1f} s")
    for name in _build.LIBRARIES:
        log = _build.build_log(_build.library_path(name))
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name} ptxas: {ln.strip()}")
    return secs


def timed_ms(fn, reps):
    """Host-clock milliseconds of each of ``reps`` calls of ``fn``, each
    ended by a synchronise."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def rows_to(dev, rows):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in rows)


def phase_kernel_vs_plain(dev, rng):
    wl = Ed25519Workload()
    _, edge = wl.encode(vectors.edge_corpus(rng))
    _, good = wl.encode(vectors.valid_items(rng, 96))
    match = vectors.matching_rows(rng, 64)
    n_rand = 1024 - len(edge[0]) - len(good[0]) - len(match[0])
    rand = vectors.random_rows(rng, n_rand)
    rows = tuple(np.concatenate([edge[k], good[k], match[k], rand[k]])
                 for k in range(4))
    ops = rows_to(dev, rows)
    got = vk.verify_kernel(*ops)
    torch.cuda.synchronize()
    want = vk.verify_kernel_plain(*ops)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    check(bad == 0, f"kernel and plain differ on {bad} of {len(rows[0])} "
          "rows")
    print(f"[kernel-vs-plain] {len(rows[0])} rows, {int(got.sum())} True, "
          f"0 differ (tolerance 0: bits)")
    return len(rows[0]), err


def phase_txset(rng):
    signer_table_cache.configure(enabled=False)
    t0 = time.perf_counter()
    items = signed_items(rng, TXSET_SIGS, 1)
    bad = corrupt(items, rng, CORRUPT_SHARE)
    gen = time.perf_counter() - t0
    want = np.array([ref.verify(*it) for it in items])
    check(not want[bad].any() and want.sum() == TXSET_SIGS - len(bad),
          "corrupted TxSet rows do not fail the oracle as planned")
    v = default_verifier()
    check(v.device.type == "cuda", f"default verifier on {v.device}")
    got = v.verify_batch(items)
    torch.cuda.synchronize()
    check(np.array_equal(got, want),
          f"TxSet verdicts differ from the oracle on "
          f"{int((got != want).sum())} rows")
    check(v.served["device"] == TXSET_SIGS,
          f"device served {v.served['device']} of {TXSET_SIGS} rows")
    times = []
    for _ in range(TIMED_CALLS):
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, want), "a timed TxSet call differs")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    # the host layer alone: gates and SHA-512 mod L, no device work
    enc = []
    for _ in range(TIMED_CALLS):
        t = time.perf_counter()
        Ed25519Workload().encode(items)
        enc.append((time.perf_counter() - t) * 1e3)
    enc50 = np.percentile(enc, 50)
    print(f"[txset] {TXSET_SIGS} sigs ({len(bad)} corrupted), generated in "
          f"{gen:.1f} s; verify_batch p50 {p50:.3f} ms, p90 {p90:.3f} ms "
          f"over {TIMED_CALLS} calls; {TXSET_SIGS / p50 * 1e3:.0f} sigs/s "
          f"at p50; host encode alone p50 {enc50:.3f} ms")
    return ({"p50_ms": p50, "p90_ms": p90, "encode_p50_ms": enc50}, items,
            want)


def phase_catchup(rng):
    signer_table_cache.configure(enabled=False)
    t0 = time.perf_counter()
    items = signed_items(rng, CATCHUP_SIGNERS, CATCHUP_MSGS)
    bad = corrupt(items, rng, CORRUPT_SHARE)
    gen = time.perf_counter() - t0
    n = len(items)
    v = default_verifier()
    served = v.served["device"]
    # the first call at this bucket pays one-time costs: checked, not timed
    got = v.verify_batch(items)
    torch.cuda.synchronize()
    check(v.served["device"] - served == n, "catchup rows not all served "
          "by the device")
    sample = np.union1d(rng.choice(n, size=min(n, 512), replace=False), bad)
    want = np.array([ref.verify(*items[i]) for i in sample])
    check(np.array_equal(got[sample], want),
          f"catchup verdicts differ from the oracle on "
          f"{int((got[sample] != want).sum())} checked rows")
    check(not got[bad].any() and got.sum() == n - len(bad),
          "catchup: corrupted rows accepted or good rows rejected")
    times = []
    for _ in range(CATCHUP_CALLS):
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, got), "a timed catchup call differs")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    print(f"[catchup] {n} sigs ({len(bad)} corrupted), generated in "
          f"{gen:.1f} s; {len(sample)} rows checked; after one untimed call, "
          f"verify_batch p50 {p50:.3f} ms, p90 {p90:.3f} ms over "
          f"{CATCHUP_CALLS} calls ({n / p50 * 1e3:.0f} sigs/s at p50)")
    return {"p50_ms": p50, "p90_ms": p90}, items, got, bad


def _event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_rows(rng, items, b):
    """The ``b`` rows K1 gets on the main path for ``items`` (encoded, then
    padded as the engine pads), with the edge corpus, 64 matching rows
    (arbitrary 256-bit s and h, bit True) and 256 random-byte rows written
    over their head."""
    wl = Ed25519Workload()
    _, enc = wl.encode(items)
    rows = [np.concatenate([e, np.repeat(p, b - len(e), axis=0)])
            for e, p in zip(enc, wl.pad_rows())]
    _, edge = wl.encode(vectors.edge_corpus(rng))
    head = [np.concatenate(parts) for parts in zip(
        edge, vectors.matching_rows(rng, 64), vectors.random_rows(rng, 256))]
    for k in range(4):
        rows[k][:len(head[k])] = head[k]
    return tuple(rows)


def k1_against_plain(info, ops, label):
    """K1 and its plain version on the CUDA operands ``ops``: equal bits
    on every row, both timed, and the bound. Returns ``(entry, err)``."""
    b = ops[0].shape[0]
    got = vk.verify_kernel(*ops)
    want = vk.verify_kernel_plain(*ops)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    check(bad == 0, f"{label}: kernel and plain differ on {bad} rows")
    err = float((got.int() - want.int()).abs().max())
    ms = _event_ms(lambda: vk.verify_kernel(*ops), KERNEL_REPS)
    plain_ms = _event_ms(lambda: vk.verify_kernel_plain(*ops), 1)
    macs = cold_kernel_multiplies(ops[2].cpu(), ops[3].cpu())
    bound_ms, bound_by = bound(info, macs, IMAD_PER_CLOCK_PER_SM,
                               b * ROW_BYTES)
    print(f"[kernel-times] {label}: {b} rows ({int(got.sum())} True), "
          f"kernel = plain on every row; K1 {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
          f"({macs} 32x32->64 multiply-adds)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "multiply_adds": macs,
            "rows_true": int(got.sum())}, err


def phase_kernel_times(dev, rng, info, main_items):
    """K1 against its plain version, and both timed, at each bucket of the
    main path on rows built from that call's items."""
    per_batch, compared, err = {}, 0, 0.0
    for b in KERNEL_BATCHES:
        ops = rows_to(dev, main_path_rows(rng, main_items[b], b))
        per_batch[str(b)], e = k1_against_plain(info, ops, f"B={b}")
        compared += b
        err = max(err, e)
    return per_batch, compared, err


@contextlib.contextmanager
def cold_operands(v, into):
    """While open, keep a copy of the operands of every K1 launch that
    ``v``'s cold plugin makes: the rows a hot-path call really sends to
    K1. The launch itself still goes through ``vk.verify_kernel``."""
    plugin = v._plugin

    def kernel(*ops):
        into.append(tuple(o.clone() for o in ops))
        return vk.verify_kernel(*ops)

    plugin.kernel_fn = lambda: kernel
    try:
        yield into
    finally:
        del plugin.kernel_fn


def phase_hot_k1_times(info, recorded):
    """K1 against its plain version at the buckets the hot paths give it,
    on the operands those calls sent (``recorded``: label -> the launches
    of one call)."""
    per_batch, compared, err = {}, 0, 0.0
    for label, launches in recorded.items():
        check(len(launches) == 1, f"{label}: {len(launches)} K1 launches, "
              "not 1")
        ops = launches[0]
        key = f"{label}:{ops[0].shape[0]}"
        per_batch[key], e = k1_against_plain(info, ops, key)
        compared += ops[0].shape[0]
        err = max(err, e)
    return per_batch, compared, err


def cacheable_rows(items) -> int:
    """Rows whose key has a signer table: the rows the hot path serves
    once every signer has been seen."""
    return sum(len(pk) == 32 and ref.point_decompress(pk) is not None
               for pk, _m, _s in items)


def hot_path_rows(items, b):
    """The ``b`` padded rows K2 gets on the main path for ``items``: the
    rows whose signer the cache holds, encoded by the hot workload and
    padded as the engine pads."""
    hot = [(it, signer_table_cache.lookup(it[0])) for it in items
           if len(it[0]) == 32]
    wl = Ed25519HotWorkload()
    _, enc = wl.encode([(it, t) for it, t in hot if t is not None])
    return tuple(np.concatenate([e, np.repeat(p, b - len(e), axis=0)])
                 for e, p in zip(enc, wl.pad_rows()))


def hot_host_parts(dev, items, b):
    """The host part of one hot call, timed apart (p50 of 5, ms): the
    partition's cache lookups, the hot workload's encode (gates, SHA-512,
    table stack), the table stack alone, and the engine's padding and
    pinned copy of the table operand to the card. No kernel runs. The
    lookups, padding and copy are a replica of what ``BatchVerifier.
    submit`` and ``BatchEngine._launch`` do, timed outside the call: it
    must follow the engine when the engine changes, until the engine
    times its own parts."""
    def lookups():
        return [(it, signer_table_cache.lookup(it[0])) for it in items
                if len(it[0]) == 32]

    hot = [(it, t) for it, t in lookups() if t is not None]
    wl = Ed25519HotWorkload()
    tables = wl.encode(hot)[1][0]
    pad = wl.pad_rows()[0]

    def copy():
        host = torch.empty((b,) + tables.shape[1:], dtype=torch.int16,
                           pin_memory=True)
        hv = host.numpy()
        hv[:len(tables)] = tables
        hv[len(tables):] = pad
        host.to(dev, non_blocking=True)

    parts = {"partition_ms": lookups, "encode_ms": lambda: wl.encode(hot),
             "stack_ms": lambda: np.stack([t for _it, t in hot]),
             "copy_ms": copy}
    return {k: float(np.percentile(timed_ms(fn, 5), 50))
            for k, fn in parts.items()}


def phase_hot_txset(dev, items, want, k1_ops):
    """The TxSet with the cache on, from empty. ``want`` is the oracle's
    verdicts, which phase 4's cold calls equalled. One more call after the
    timed ones keeps its K1 operands in ``k1_ops["hot_txset"]``."""
    signer_table_cache._reset_for_testing()
    signer_table_cache.configure(enabled=True)
    v = default_verifier()
    cacheable = cacheable_rows(items)
    t = time.perf_counter()
    got = v.verify_batch(items)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    check(np.array_equal(got, want), "hot TxSet: first call differs from "
          "the oracle")
    check(signer_table_cache.snapshot()["installs"] == cacheable,
          "hot TxSet: a first sight did not install its table")
    times = []
    for _ in range(TIMED_CALLS):
        hot0 = v.served["hot"]
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, want), "hot TxSet: a timed call "
              "differs from the oracle and the cold verdicts")
        check(v.served["hot"] - hot0 == cacheable,
              f"hot TxSet: K2 served {v.served['hot'] - hot0} rows, not "
              f"{cacheable}")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    with cold_operands(v, k1_ops.setdefault("hot_txset", [])):
        check(np.array_equal(v.verify_batch(items), want),
              "hot TxSet: the recorded call differs from the oracle")
    parts = hot_host_parts(dev, items, KERNEL_BATCHES[0])
    print(f"[hot-txset] first call (all first sights, {cacheable} table "
          f"builds) {first_ms:.1f} ms; then {cacheable} of {len(items)} "
          f"rows hot each call; verify_batch p50 {p50:.3f} ms, p90 "
          f"{p90:.3f} ms over {TIMED_CALLS} calls; host parts p50: "
          + ", ".join(f"{k} {v_:.3f}" for k, v_ in parts.items()))
    return ({"first_ms": first_ms, "p50_ms": p50, "p90_ms": p90,
             "hot_rows": cacheable, **parts},
            hot_path_rows(items, KERNEL_BATCHES[0]))


def phase_hot_catchup(dev, rng, items, cold, bad, k1_ops):
    """The catchup call with the cache on, from empty. The K1 operands of
    the first call (its timing includes their copy on the card, a few
    microseconds) and of one more call after the timed ones go into
    ``k1_ops``."""
    signer_table_cache._reset_for_testing()
    signer_table_cache.configure(enabled=True)
    v = default_verifier()
    n = len(items)
    cacheable = cacheable_rows(items)
    k1, k2, hot0 = (vk.verify_kernel.launches, vk.verify_kernel_hot.launches,
                    v.served["hot"])
    with cold_operands(v, k1_ops.setdefault("hot_catchup_first", [])):
        t = time.perf_counter()
        got = v.verify_batch(items)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
    first_hot = v.served["hot"] - hot0
    check(vk.verify_kernel.launches - k1 == 1 and
          vk.verify_kernel_hot.launches - k2 == 1,
          "hot catchup: the first call is not one K1 and one K2 launch")
    check(np.array_equal(got, cold), "hot catchup: verdicts differ from "
          "the cold call's")
    sample = np.union1d(rng.choice(n, size=min(n, 512), replace=False), bad)
    want = np.array([ref.verify(*items[i]) for i in sample])
    check(np.array_equal(got[sample], want), "hot catchup: verdicts differ "
          "from the oracle on checked rows")
    times = []
    for _ in range(CATCHUP_CALLS):
        hot0 = v.served["hot"]
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, got), "hot catchup: a timed call differs")
        check(v.served["hot"] - hot0 == cacheable,
              "hot catchup: a timed call did not serve every cacheable "
              "row hot")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    with cold_operands(v, k1_ops.setdefault("hot_catchup", [])):
        check(np.array_equal(v.verify_batch(items), got),
              "hot catchup: the recorded call differs")
    parts = hot_host_parts(dev, items, KERNEL_BATCHES[1])
    print(f"[hot-catchup] first call {first_ms:.1f} ms ({first_hot} rows "
          f"hot, {n - first_hot} cold); then {cacheable} of {n} rows hot "
          f"each call; verify_batch p50 {p50:.3f} ms, p90 {p90:.3f} ms over "
          f"{CATCHUP_CALLS} calls ({n / p50 * 1e3:.0f} sigs/s at p50); "
          f"{len(sample)} rows checked; host parts p50: "
          + ", ".join(f"{k} {v_:.3f}" for k, v_ in parts.items()))
    return ({"first_ms": first_ms, "first_hot_rows": first_hot,
             "p50_ms": p50, "p90_ms": p90, "hot_rows": cacheable, **parts},
            hot_path_rows(items, KERNEL_BATCHES[1]))


def phase_hot_kernel_times(dev, rng, info, main_rows):
    """K2 against its plain version, and both timed, at each bucket of the
    hot path, on that call's padded rows with edge, saturating matching
    and random rows written over their head."""
    wl = Ed25519HotWorkload()
    # the table, R, s, h read once, one bool written
    row_bytes = TABLE_ENTRIES * HOT_ENTRY_BYTES + 3 * 32 + 1
    per_batch, compared, err = {}, 0, 0.0
    for b in KERNEL_BATCHES:
        rows = [x.copy() for x in main_rows[b]]
        edge = vectors.edge_corpus(rng)
        table = build_signer_table(edge[0][0])
        _, edge_rows = wl.encode([(it, table) for it in edge])
        rand = (rows[0][:256].copy(),) + vectors.random_rows(rng, 256)[1:]
        head = [np.concatenate(parts) for parts in zip(
            edge_rows, vectors.hot_matching_rows(rng, 64), rand)]
        for k in range(4):
            rows[k][:len(head[k])] = head[k]
        ops = rows_to(dev, rows)
        got = vk.verify_kernel_hot(*ops)
        want = vk.verify_kernel_hot_plain(*ops)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"B={b}: K2 and plain differ on {bad} rows")
        s_cpu, h_cpu = torch.from_numpy(rows[2]), torch.from_numpy(rows[3])
        top = torch.stack([vk.signed_digits256(s_cpu)[0],
                           vk.signed_digits256(h_cpu)[0]])
        saturated = int((top > TABLE_ENTRIES).any(0).sum())
        check(saturated >= 32, f"B={b}: only {saturated} rows saturate")
        compared += b
        err = max(err, float((got.int() - want.int()).abs().max()))
        ms = _event_ms(lambda: vk.verify_kernel_hot(*ops), KERNEL_REPS)
        plain_ms = _event_ms(lambda: vk.verify_kernel_hot_plain(*ops), 1)
        macs = hot_kernel_multiplies(s_cpu, h_cpu)
        bound_ms, bound_by = bound(info, macs, IMAD_PER_CLOCK_PER_SM,
                                   b * row_bytes)
        selected = int((vk.signed_digits256(h_cpu) != 0).sum()) * \
            HOT_ENTRY_BYTES
        per_batch[str(b)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "multiply_adds": macs,
            "rows_true": int(got.sum()), "rows_saturated": saturated,
            "bytes_shipped": b * row_bytes,
            "table_bytes_selected": selected}
        print(f"[hot-kernel-times] B={b}: {b} rows ({int(got.sum())} True, "
              f"{saturated} with a top digit above 128), K2 = plain on "
              f"every row; K2 {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {macs} 32x32->64 "
              f"multiply-adds; {b * row_bytes} B shipped, "
              f"{selected / b:.0f} B a row of table entries selected)")
    return per_batch, compared, err


def phase_hashing(dev, rng, info):
    """BatchHasher's main path on 2,048 messages, then K3 against its plain
    version on the call's own packed rows."""
    n_over = int(HASH_MSGS * HASH_OVERSIZE_SHARE)
    lens = np.concatenate([rng.integers(0, sk.max_message_bytes(MAX_BLOCKS)
                                        + 1, HASH_MSGS - n_over),
                           rng.integers(504, 2001, n_over)])
    msgs = [rng.bytes(int(n)) for n in rng.permutation(lens)]
    want = [hashlib.sha256(m).digest() for m in msgs]
    h = default_hasher()
    check(h.device.type == "cuda", f"default hasher on {h.device}")
    sk.sha256_kernel.launches = 0
    host0 = h.served["host"]
    check(h.hash_batch(msgs) == want, "hash_batch differs from hashlib")
    check(h.served["host"] - host0 == n_over, "oversize rows not hashed "
          "on the host")
    times = []
    for _ in range(HASH_CALLS):
        t = time.perf_counter()
        out = h.hash_batch(msgs)
        times.append((time.perf_counter() - t) * 1e3)
        check(out == want, "a timed hash_batch call differs from hashlib")
    launches = sk.sha256_kernel.launches
    check(launches > 0, "the hashing main path launched no K3 kernel")
    host = []
    for _ in range(HASH_CALLS):
        t = time.perf_counter()
        for m in msgs:
            hashlib.sha256(m).digest()
        host.append((time.perf_counter() - t) * 1e3)
    words, active, _fits = sk.pack_messages(msgs, MAX_BLOCKS)
    w, a = rows_to(dev, (words, active))
    got = sk.sha256_kernel(w, a).cpu().numpy().astype(np.int64)
    plain = sk.sha256_kernel_plain(w, a).cpu().numpy().astype(np.int64)
    torch.cuda.synchronize()
    bad = int((got != plain).any(1).sum())
    check(bad == 0, f"K3 and plain differ on {bad} rows")
    ms = _event_ms(lambda: sk.sha256_kernel(w, a), HASH_KERNEL_REPS)
    plain_ms = _event_ms(lambda: sk.sha256_kernel_plain(w, a), 1)
    blocks = int(active.sum())
    ops_per_block, by_op = sha_ops_per_block()
    # the words and active flags read once, eight digest words written
    row_bytes = MAX_BLOCKS * (64 + 1) + 32
    bound_ms, bound_by = bound(info, blocks * ops_per_block,
                               INT_OPS_PER_CLOCK_PER_SM,
                               HASH_MSGS * row_bytes)
    res = {"p50_ms": np.percentile(times, 50),
           "p90_ms": np.percentile(times, 90),
           "hashlib_p50_ms": np.percentile(host, 50),
           "hashlib_p90_ms": np.percentile(host, 90), "oversize": n_over,
           "launches": launches, "rows_compared": HASH_MSGS,
           "max_abs_err": float(np.abs(got - plain).max()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "active_blocks": blocks, "ops_per_block": ops_per_block,
           "ops_by_opcode": by_op}
    print(f"[hashing] {HASH_MSGS} messages ({n_over} oversize, hashed on "
          f"the host), every digest = hashlib; hash_batch p50 "
          f"{res['p50_ms']:.3f} ms, p90 {res['p90_ms']:.3f} ms over "
          f"{HASH_CALLS} calls; hashlib p50 {res['hashlib_p50_ms']:.3f} ms; "
          f"K3 = plain on {HASH_MSGS} rows; K3 {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
          f"{blocks} active blocks x {ops_per_block} operations, from "
          f"the SASS: {by_op})")
    return res


def kernel_entry(name, source, replaces, jax_function, launches,
                 rows_compared, err, per_batch, batch, card, **extra):
    main = per_batch[str(batch)]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "jax_function": jax_function,
        "launches": launches, "max_abs_err": err,
        "rows_compared": rows_compared, "match_plain": err == 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "batch": batch, "by_batch": per_batch,
        "card": card, **extra}


def main() -> int:
    info = phase_device()
    dev = resolve_device(None)
    rng = np.random.default_rng(SEED)
    phase_build(dev)
    rows_compared, err = phase_kernel_vs_plain(dev, rng)
    vk.verify_kernel.launches = 0
    txset, txset_items, txset_want = phase_txset(rng)
    catchup, catchup_items, catchup_got, catchup_bad = phase_catchup(rng)
    launches = vk.verify_kernel.launches
    check(launches > 0, "the main path launched no K1 kernel")
    print(f"[main-path] verify_cold launches: {launches}")
    per_batch, compared, err6 = phase_kernel_times(
        dev, rng, info, dict(zip(KERNEL_BATCHES, (txset_items,
                                                  catchup_items))))
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    k1_ops = {}
    hot_txset, txset_rows = phase_hot_txset(dev, txset_items, txset_want,
                                            k1_ops)
    hot_catchup, catchup_rows = phase_hot_catchup(
        dev, rng, catchup_items, catchup_got, catchup_bad, k1_ops)
    hot_launches = vk.verify_kernel_hot.launches
    hot_k1_launches = vk.verify_kernel.launches
    check(hot_launches > 0, "the hot main path launched no K2 kernel")
    check(hot_k1_launches > 0, "the hot main path launched no K1 kernel")
    print(f"[main-path] verify_hot launches: {hot_launches}; verify_cold "
          f"launches on the hot paths: {hot_k1_launches}")
    k1_hot, k1_hot_compared, k1_hot_err = phase_hot_k1_times(info, k1_ops)
    per_batch.update(k1_hot)
    del k1_ops
    hot_batch, hot_compared, hot_err = phase_hot_kernel_times(
        dev, rng, info, dict(zip(KERNEL_BATCHES, (txset_rows,
                                                  catchup_rows))))
    del txset_rows, catchup_rows
    hashing = phase_hashing(dev, rng, info)
    k2_txset = hot_batch[str(KERNEL_BATCHES[0])]["ms"]
    print(f"[hot-txset] K2 at B={KERNEL_BATCHES[0]} is {k2_txset:.4f} ms, "
          f"{k2_txset / hot_txset['p50_ms']:.1%} of the hot TxSet p50")
    kernels = [
        kernel_entry("verify_cold", "stellar_tpu_torch/csrc/verify_cold.cu",
                     "stellar_tpu/ops/verify.py:155", "verify_kernel",
                     launches, rows_compared + compared + k1_hot_compared,
                     max(err, err6, k1_hot_err), per_batch,
                     KERNEL_BATCHES[0], info["smi"],
                     launches_hot_paths=hot_k1_launches),
        kernel_entry("verify_hot", "stellar_tpu_torch/csrc/verify_hot.cu",
                     "stellar_tpu/ops/verify.py:188", "verify_kernel_hot",
                     hot_launches, hot_compared, hot_err, hot_batch,
                     KERNEL_BATCHES[0], info["smi"]),
        kernel_entry("sha256", "stellar_tpu_torch/csrc/sha256.cu",
                     "stellar_tpu/ops/sha256.py:171", "sha256_kernel",
                     hashing["launches"], hashing["rows_compared"],
                     hashing["max_abs_err"],
                     {str(HASH_MSGS): {k: hashing[k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "active_blocks", "ops_per_block")}}, HASH_MSGS, info["smi"])]
    print("[metrics] " + json.dumps({
        "txset_sigs": TXSET_SIGS, "txset_p50_ms": txset["p50_ms"],
        "txset_p90_ms": txset["p90_ms"],
        "txset_encode_p50_ms": txset["encode_p50_ms"],
        "catchup_sigs": CATCHUP_SIGNERS * CATCHUP_MSGS,
        "catchup_p50_ms": catchup["p50_ms"],
        "catchup_p90_ms": catchup["p90_ms"],
        "hot_txset": hot_txset, "hot_catchup": hot_catchup,
        "hashing": {k: hashing[k] for k in (
            "p50_ms", "p90_ms", "hashlib_p50_ms", "hashlib_p90_ms",
            "oversize")},
        "card": info["smi"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    if _IMPORT_ERROR is not None:
        print(f"FAIL: cannot import the port ({_IMPORT_ERROR}); run from "
              "the repository root", file=sys.stderr)
        sys.exit(1)
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
