#!/usr/bin/env python3
"""On-card smoke run of ``stellar_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It needs the CUDA toolkit (``nvcc``) and ``g++``: the kernels and the host
prep library are built from the repository's sources at first use. Phases,
in order; each one fails loudly (a message on stderr, exit code 1):

1. device  — the card's name, count, and ``nvidia-smi``'s name and power
   limit;
2. build   — K1 (``csrc/verify_cold.cu``), K2 (``csrc/verify_hot.cu``),
   K3 (``csrc/sha256.cu``) and K5 (``csrc/verify_r16.cu``) with nvcc, the
   SHA-512 prep library and the native host oracle with g++, the six
   builds started together; build seconds, registers and spills (K1's,
   K2's, K3's and K5's entry functions parsed apart), the four-lane
   kernels' SASS loops with shuffles and the instructions of one squaring
   in their exponent chains, and K3's block loop counted from its SASS;
3. kernel against plain — K1 (four threads a row) and its plain PyTorch
   version on the same CUDA tensors (edge corpus, good signatures, rows
   whose device bit is True for arbitrary 256-bit scalars, random bytes):
   equal bits on every row; then at the ragged sizes 1, 5, 127, 129 and
   2,047 rows (rows past n inside a group of four lanes, partial warps);
4. main path, cold TxSet — the signer-table cache off;
   ``default_verifier().verify_batch`` on 2,000 signatures from 2,000
   signers over 32-byte messages, 2% corrupted; every verdict equal to the
   port's oracle; p50 and p90 of 20 calls; the engine's own attribution
   of those calls (``tracing.span_totals()`` before and after,
   ``batch_engine.dispatch_attribution``): ms a call of prep, bucket,
   dispatch, fetch and audit and their coverage of the root span, which
   must be at least 0.95; and the mean over their pipeline records
   (``pipeline_timeline.recent``) of busy_frac, overlap_frac and
   reconciliation with the commonest largest bubble class: the host's
   view of device occupancy, launch to delivery, not a profiler trace;
   and the transfer ledger's deltas a call (bytes each way, round trips,
   resident hits and bytes, unfingerprinted uploads), equal to the
   engine's own tallies and to the bytes of the operands and results that
   the kernel launches were handed and returned (a tap on the workloads);
   the resident cache is off, as by default, in every main-path phase:
   each call ships the four operands, 262,144 B, and a repeat counts them
   redundant. Phases 5, 7, 8, 10 and 13 print and check the same deltas
   over their timed calls (phase 7: the table operand one unfingerprinted
   upload a call);
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
   B = 4,096: the first hot catchup call's first sights); then K1's
   block-size sweep: 32, 64 and 128 threads a block at 128, 2,048 and
   16,384 rows, launched past the wrapper on the same operands, equal to
   the plain bits already taken, timed;
7. main path, hot TxSet — the cache on and empty, phase 4's items: the
   first call (every signer a first sight: cold, one table build each)
   timed alone, then p50 and p90 of 20 calls in which every row with a
   cacheable key rides K2; verdicts equal to the oracle and to phase 4's;
   the engine's attribution (coverage at least 0.95) and pipeline records
   of those calls as in phase 4, and the tables' ``np.stack`` alone;
8. main path, hot catchup — the cache on and empty, phase 5's items: the
   first call (one K1 and one K2 launch) timed alone, then p50 and p90 of
   10 calls and the engine's attribution of them; checked against the
   oracle on a sample and on every corrupted row, and against phase 5's
   verdicts on every row;
9. K2 at the hot path's shapes — at B = 2,048 and 16,384: the hot path's
   own padded rows with edge rows, matching rows whose top digit
   saturates the 128-entry select, and random R, s, h over real tables
   written over their head; K2 and its plain version give equal bits on
   every row; K2's time, the plain version's and the bound; K2 against
   plain at the ragged sizes 1, 5, 127, 129 and 2,047 rows; then K2's
   block-size sweep: 32, 64 and 128 threads a block at both buckets,
   launched past the wrapper, equal to plain's bits, timed;
10. hashing — ``default_hasher().hash_batch`` on 2,048 messages (0-503
   bytes, 2% oversize at 504-2,000 bytes), every digest equal to
   hashlib's; p50 and p90 of 20 calls beside hashlib's time for the same
   messages, and the engine's ``hash.*`` attribution of them; then K3 against its plain version and hashlib on the call's
   own rows at B = 2,048 and on 16,384 new messages of the same length
   mix, timed as the host issues the launches and queued behind a spin
   (K3 runs shorter than a launch from Python), beside its bound (the
   standard's 1,384 operations a block) and its SASS count;
11. the radix sweep — K5 (``csrc/verify_r16.cu``, the radix-16 arm) on the
   main path's own padded rows at B = 2,048 and 16,384, with the edge
   corpus, radix-16 matching rows, rows whose scalar overflows the top
   radix-16 window (R = 0 on half of them) and random bytes written over
   their head; K5 and its plain version give equal bits on every row;
   then K1 and K5 timed on the same rows, one line with both times and
   their ratio (both four lanes a row on one row function: radix 16
   against radix 32), and K5's registers and spills;
12. K4 — ``verify_kernel_sharded`` over every visible card, and over the
   one card named 4 times, at B = 2,048 and 16,384 on phase 6's rows:
   equal to K1 on every row, and timed;
13. the split main path — a ``BatchVerifier`` over the card named 4
   times on the cold TxSet (cache off) and the hot TxSet (cache on, from
   empty): verdicts equal to the oracle, every index serves, p50 and p90
   beside the one-device ones;
14. the audit's cost — the cold TxSet p50 at the reference's audit rate
   0.02 (the rate every main-path phase runs at) and at 0, in turns, the
   host oracle's backend (native libcrypto or pure Python), and its cost
   part by part (policy gate, native batch at its own thread count and
   on one thread) for a TxSet's and a catchup call's audit;
15. the transfer ledger's and the resident cache's cost — the default
   verifier in four modes in turns, p50 and p90 of each: the cold TxSet
   with the resident cache on and its items repeated (the only mode here
   whose traffic it serves: 0 B copied, 4 hits), with the cache on and
   fresh content every call, with the cache off (the default), with it
   off and the ledger counting bytes only (no fingerprint), and a hot
   TxSet repeat with the cache off, each mode's ledger deltas checked; the fingerprint alone a call and an
   operand (and of the hasher's 1 MiB operand), the four copies a hit
   saves and the hot table operand's copy (CUDA events, GB/s); one cold
   call's ``to_chrome_trace()`` written to ``build/`` and lines of
   ``to_prometheus()``;
16. the deadline on the card — the cold TxSet at a 200 ms deadline on a
   one-card verifier of its own, behind a 2.5 s ``torch.cuda._sleep``
   spin on the card's stream: the call raises within 1.0 s while the spin
   still runs, the card's breaker charged once, one deadline miss, a
   ``watchdog-timeout:device0`` dump holding the open ``verify.fetch``
   span; after the spin no count moved by the abandoned fetch's late
   completion, and the next call equals the oracle with the breaker
   closed. Then the same on a verifier over the card named 4 times: the
   indices share the stream, so each misses in turn and the call raises
   within 4 x 200 ms + 0.5 s, each index charged once; no count of the
   transfer ledger moved by the late completions;
17. the probe on the card — ``device_available()`` True from a fresh
   state; under a 2 s probe hang False within 0.6 s (timeout 0.3 s),
   accounted dead, and a non-blocking ask answers at once caching
   nothing; after ``faults.clear()`` and the backoff True again;
18. the verify service on the card — one-card verifiers of its own (the
   default paths of (d) excepted), the signer-table cache on: (a) three threads submit to one started
   ``VerifyService`` at once, 200 scp submissions of 3 signatures by 20
   validator keys, 100 auth submissions of one signature from fresh keys
   (2% corrupted), phase 4's TxSet in 20 bulk submissions of 100: every
   verdict equal to the oracle, nothing shed, rejected or failed, the
   conservation gap 0, K1 and K2 both launched; the wall time,
   signatures a second, dispatches, items a dispatch and each lane's
   wait p50, p90 and p99, with the waits and the dispatcher's
   ``service.dispatch`` and ``service.resolve`` spans read from the
   flight recorder; then a steady pass, every table built: a bulk
   backlog of 160 submissions of 500 TxSet rows queued first, the scp
   and auth submissions in bursts of 20, 40 ms apart, while it drains, the same checks,
   and scp's wait p99 under bulk's wait p50; (b) two services fed one arrival order (a
   flooding tenant over its depth quota of 16, a bulk backlog past the
   high-water mark of a 64-deep lane, scp interleaved), their resolvers
   held on one event until every arrival is admitted: equal decision
   logs, journals (trace IDs rebased), tenant snapshots and ingress
   refusals, every verified row equal to the oracle, no scp item shed;
   (c) 64 threads through one ``TrickleBatcher`` (1 ms window): verdicts
   equal to the oracle in fewer than 64 dispatches; then 16 callers of a
   window on a second verifier under ``fail-device``: every one raises
   within 2 s, none hangs; (d) ``keys.batch_verify_into_cache`` on the
   TxSet with a verifier installed, timed, then ``keys.verify_sig`` on
   each item: 2,000 cache hits, no K1 or K2 launch; then the default
   paths on ``default_verifier()``: the same prefetch with no backend
   installed, 2,000 hits equal to the oracle, and
   ``verify_service.default_service()`` (``VerifyService()`` with no
   verifier) on one submission a lane, equal to the oracle, each with
   K1 or K2 launches and every row served by the default verifier; (e)
   the service
   behind a 2.5 s spin at a 200 ms deadline: the bulk ticket raises
   within 1.0 s, its items count failed, the conservation gap stays 0,
   and an scp submission after the spin equals the oracle;
19. the fleet and the wire on the card — a one-card verifier of its own,
   the signer-table cache on, phase 18's arrivals: one replica's first
   dispatch of 100 bulk rows with the cache empty timed apart, then one
   untimed call that builds every signer's table; (a) a started
   ``FleetRouter`` of 3 replicas over the verifier (one
   ``SharedVerifier``), three threads submitting the scp, auth and bulk
   lanes at once (bulk over 8 tenants), then a bulk backlog of 40
   submissions of 500 TxSet rows, and the replica holding the most queued
   bulk rows killed while they are queued: items handed off, every
   ticket equal to the oracle, the fleet's conservation gap 0 at every
   10 ms poll and after, the dead replica in ``dispatch_health()
   ["fleet"]``, no conviction, a router built apart routing a grid of
   (lane, tenant) keys alike, the handed-off traces stitched seamless;
   wall time, signatures a second, items handed off, each lane's wait
   p50 and p99 from the flight recorder, and each replica's and lane's
   wait on the shared engine's lock (from its dispatch span to the
   engine's first span inside it); (b) an ``IngressServer`` over
   that fleet, five ``WireClient`` s on loopback, each on its own thread
   (four send a quarter of the TxSet as 5 submissions of 100, one of them
   with ``torn-frame`` on its sends; one sends the scp submissions):
   every verdict equal to the oracle, the wire's gap 0; then a client
   under ``disconnect-mid-batch`` beside a clean one: killed with the
   typed reason, the clean one served, the gap 0; after ``stop()``
   nothing pending; signatures a second, frames, bytes and the client
   side p50 and p99 of a submission; (c) the journal of the drained fleet
   and ingress: the completeness law exact, two collects merged without
   divergence, every wire trace stitched wire -> route -> enqueue ->
   terminal; K1 and K2 must launch in (a) and in (b);
20. the node's transactions — ``BASELINE.json`` config 2's TxSet at full
   width: ``vectors.node_txset`` builds 1,000 signed v1
   ``TransactionEnvelope`` s (single-key, 2-of-3 multisig, two-operation
   and pre-auth/hashX/signed-payload accounts, about 1,900 ed25519
   signatures and 50 hashX preimages, 2% of the signatures corrupted) and
   their account table, the build timed apart. A pass: flush the node's
   verify cache, decode every envelope (``xdr.runtime.from_bytes``), make
   every ``transaction_sig_payload``, hash them with ``hash_many`` (K3),
   collect the candidate signatures (``vectors.collect_candidates``),
   prefetch them with ``keys.batch_verify_into_cache`` and no backend
   installed (``default_verifier()``), then run ``SignatureChecker`` on
   every transaction (``vectors.check_transaction``: the source at its
   low threshold, each operation's source at its medium one,
   ``check_all_signatures_used``). Gates: every digest equal to
   ``transaction_hash`` (hashlib), no ``keys.verify_sig`` cache miss in
   the checker, every verdict and ``used`` flag equal to the same checker
   over the pure-Python oracle (``keys.set_verifier_backend(
   ed25519_ref.verify)``, cache flushed), K1 and K3 launched in the cold
   passes (signer-table cache off) and K2 and K3 in the hot ones (on,
   after one untimed pass builds the tables), the dispatch clean. p50 and
   p90 of 10 passes each, cold and hot, and the ms a pass of each step
   (hashlib on the same payloads beside the hashing), the accepted and
   rejected counts. ``metrics.timeseries`` samples every 50 ms through
   the phase (its prefixes widened to take ``frame.`` beside
   ``crypto.``), ``tracing.frame_mark()`` once a pass, the verify cache's
   hits and misses published as ``crypto.verify.cache.*`` gauges: its
   snapshot must hold those series with no series dropped, and its thread
   must stop; the anomalies that fired are printed, not gated;
21. the node's TxSet — phase 20's 1,000 transactions through the node's
   own objects: ``vectors.node_ledger`` (a ``LedgerTxnRoot`` holding the
   accounts, each sequence number one below its transaction's, protocol
   23, ``maxTxSetSize`` 1,150) and a ``make_transaction_frame`` a
   transaction, both timed apart; admission once (``prefetch_contents_
   hashes``, one ``prefetch_signature_batch``, then every frame's
   ``check_valid`` over a ``LedgerTxn``), which must accept exactly the
   transactions phase 20's checker accepted; nomination of the accepted
   ones (``make_tx_set_from_transactions``: nothing excluded) and its
   bytes, and of the accepted plus one rejected transaction (within
   ``maxTxSetSize``); ``collect_signature_triples`` on the accepted
   frames equal to ``vectors.collect_candidates`` on the same
   transactions. A pass: flush the verify cache, ``TxSetXDRFrame.
   from_bytes`` and ``prepare_for_apply``, ``prefetch_contents_hashes``
   (K3), ``check_valid`` on a ``LedgerTxn`` over the root, rolled back
   (one ``prefetch_signature_batch``: K1 or K2), ``get_txs_in_apply_
   order``. Gates: ``check_valid`` True on every pass and False for the
   set with a rejected transaction; every contents hash hashlib's; the
   verify cache's misses over a pass equal to the keyed triples the
   set collected (no per-transaction check missed); one pass with the
   pure-Python oracle as the verify backend gives the same admission
   verdicts, ``check_valid`` answers and apply order (by full hash); K1
   and K3 launched in the cold passes (signer-table cache off) and K2 and
   K3 in the hot ones (on, after one untimed pass builds the tables); the
   dispatch clean. p50 and p90 of 10 passes each, cold and hot; the ms of
   each public call in a pass, and inside ``check_valid`` the verify
   engine's blocking span (a ``tracing.span_totals()`` delta); the
   setup's, admission's and nomination's times and the accepted and
   rejected counts;
22. fault domains, last — on the 4-index verifier: ``fail-device`` on
   index 1 quarantines only index 1 and its parts move to the survivors;
   after the backoff one probation sub-chunk heals it; ``corrupt-device``
   on index 2 is caught by the audit, which quarantines 2 for good and
   moves its parts; every verdict equals the oracle and every row is
   served by a card; then a launch fault on every index, and on a
   one-card verifier, raises.

Each kernel's launch count is set to 0 just before its path runs and read
just after: K1 over phases 4-5 and again over phases 7-8, K2 over phases
7-8, K3 over phase 10's calls, K5 over phase 11's sweep calls, K4 over
phase 12's calls, K1 and K2 again over phase 13, K1 over phase 16, K1
and K2 over phase 18 (``launches_service``; (a) alone
``launches_service_mixed``), K1 and K2 over phase 19 (a) and (b)
(``launches_fleet``, ``launches_wire``), K1 and K3 over phase 20's cold
passes and K2 and K3 over its hot ones (``launches_node``,
``launches_node_hot``), K1 and K3 over phase 21's cold passes and K2 and
K3 over its hot ones (``launches_txset``, ``launches_txset_hot``). After
every main-path phase the dispatch must be clean: no device fault (no
retry, every breaker closed and never opened), no audit mismatch, no
conviction; only phases 16, 18 (c) and (e), and 22 expect otherwise. The
engine has no host failover, so no row of a card is ever served by the
host. Before the last line, one ``{"kernels": [...]}`` line holds every
kernel's launches, times, bound and build; the last line is ``{"ok":
true, "device": {...}}``. With no card, or outside the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

try:
    import numpy as np
    import torch

    import stellar_tpu_torch.tx.ops  # noqa: F401 (fills the op registry)
    from stellar_tpu_torch.crypto import ed25519_ref as ref
    from stellar_tpu_torch.crypto import (fleet, ingress, keys, native_prep,
                                          native_verify, tenant, vectors,
                                          verify_service)
    from stellar_tpu_torch.crypto.batch_hasher import (MAX_BLOCKS,
                                                       default_hasher,
                                                       hash_many)
    from stellar_tpu_torch.crypto.batch_verifier import (
        BatchVerifier, Ed25519HotWorkload, Ed25519Workload, TrickleBatcher,
        default_verifier)
    from stellar_tpu_torch.herder import tx_set
    from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
    from stellar_tpu_torch.ops import _build
    from stellar_tpu_torch.ops import sha256 as sk
    from stellar_tpu_torch.ops import verify as vk
    from stellar_tpu_torch.parallel import batch_engine, mesh, residency
    from stellar_tpu_torch.parallel.batch_engine import DEFAULT_BUCKET_SIZES
    from stellar_tpu_torch.parallel.signer_tables import (
        TABLE_ENTRIES, build_signer_table, signer_table_cache)
    from stellar_tpu_torch.utils import (faults, journal, metrics,
                                         resilience, tracing)
    from stellar_tpu_torch.utils.device import resolve_device
    from stellar_tpu_torch.utils.metrics import registry
    from stellar_tpu_torch.utils.timeline import pipeline_timeline
    from stellar_tpu_torch.utils.transfer_ledger import (
        DEFAULT_FP_MAX_BYTES, transfer_ledger)
    from stellar_tpu_torch.tx.transaction_frame import make_transaction_frame
    from stellar_tpu_torch.xdr import ledger as xledger
    from stellar_tpu_torch.xdr import results as xresults
    from stellar_tpu_torch.xdr import tx as xtx
    from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
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
# K1 and K2 against plain at ragged sizes too: rows past n inside a group
# of four lanes, and shuffles in a partial warp
RAGGED_ROWS = (1, 5, 127, 129, 2047)
# the block sizes (threads a block, four a row) K1 and K2 are swept over,
# and the row counts: for K1 the hot paths' bucket and the two cold
# buckets, for K2 the two hot buckets
BLOCK_THREADS = (32, 64, 128)
SWEEP_ROWS = {"verify_cold": (128,) + KERNEL_BATCHES,
              "verify_hot": KERNEL_BATCHES}
HASH_MSGS = 2048
HASH_OVERSIZE_SHARE = 0.02
# K3 against plain and timed at the hashing call's size and at the top
# bucket (new messages with the same length mix)
HASH_KERNEL_BATCHES = (HASH_MSGS, 16384)
HASH_CALLS = 20
HASH_KERNEL_REPS = 200
# H100 figures for the bound: 32-bit integer multiply-adds, and 32-bit
# integer add, logic and shift operations, per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table) and HBM3 bandwidth (NVIDIA's data sheet).
IMAD_PER_CLOCK_PER_SM = 64
INT_OPS_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# cycles of torch.cuda._sleep a second: at least the card's SM clock, so
# that a spin lasts at least as long as asked (queued_ms checks it did)
SLEEP_CYCLES_PER_S = 2e9
ROW_BYTES = 4 * 32 + 1  # A, R, s, h read once, one bool written
HOT_ENTRY_BYTES = 3 * 20 * 2  # one int16 affine cached entry
# the cold TxSet's operands at its 2,048 bucket (A, R, s, h) and the hot
# TxSet's table operand, over the resident cache's 1 MiB cap
TXSET_OPERAND_BYTES = 4 * KERNEL_BATCHES[0] * 32
HOT_TABLE_BYTES = KERNEL_BATCHES[0] * 128 * HOT_ENTRY_BYTES
# K3's bound counts the function's work, FIPS 180-4's operations on
# 32-bit words a 64-byte block, a three-input add or logic operation as
# one: a round is Sigma0 and Sigma1 (3 rotations and a three-way XOR
# each), Ch and Maj (one logic operation each) and 4 adds (2 for T1, one
# for e, one for a); a schedule word sigma0 and sigma1 (2 rotations, a
# shift and a three-way XOR each) and 2 adds; the feed-forward 8 adds.
SHA_ROUND_OPS = 2 * (3 + 1) + 2 + 4
SHA_SCHEDULE_OPS = 2 * (2 + 1 + 1) + 2
SHA_FEED_FORWARD_OPS = 8
# The instructions of the built K3 that do that work, counted from its
# SASS beside the bound (hash_kernel_executed): 32-bit integer add, logic
# and shift.
SHA_SASS_OPS = ("SHF", "LOP3", "IADD3", "IMAD.IADD")
_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?"
                        r"([A-Z0-9_.]+)\s*([^;]*);")

# Field multiplies of the CUDA kernels' op sequences, for the operations
# bound. A ``fe_mul`` is 100 32x32->64 multiply-adds, an ``fe_sq`` 55
# (csrc/fe25519.cuh). (squarings, multiplies) per row:
FE_MUL_MACS = 100
FE_SQ_MACS = 55
# fe_invert / fe_pow22523 (ref10 chains): 254 / 251 squarings, 11 multiplies
_INVERT = (254, 11)
_POW22523 = (251, 11)
# decompress: 4 sq + 7 mul around pow22523, +1 mul for the sqrt(-1) fix
# (taken always), +1 mul for T
_DECOMPRESS = (4 + _POW22523[0], 9 + _POW22523[1])
# an addition: a mixed add of an affine entry (3 mul) or a cached add of a
# projective one (4 mul), and 4 mul to extended coordinates. (K1's count
# charges the 4th, T, to the operation before the add, the one that must
# make it; the sum is the same.)
_ADD_MULS = 7
_CACHED_ADD_MULS = 8
# encode: one inversion and two multiplies
_ENCODE = (_INVERT[0], _INVERT[1] + 2)
# K1 (csrc/verify_cold.cu): the function's work. The A-table: 16 cached
# forms (1 mul for 2dT), 1 doubling (4 sq + 4 mul), 14 cached adds (8 mul),
# no inversion (the entries stay projective)
_X4_TABLE = (4, 16 + 4 + 14 * 8)
# a doubling whose T is not read: 4 sq + 3 mul
_DOUBLING = (4, 3)
# What the four-lane kernel executes beyond that (its overhead, for the
# record, not the bound): every doubling's round 2 makes T (lane 3), and
# every one of the 52 windows adds an entry of B and one of -A, a zero
# digit adding the identity, whatever the scalars
_X4_DOUBLINGS = (51 * 5 * 4, 51 * 5 * 4)
_X4_ADDS = (0, 52 * (_ADD_MULS + _CACHED_ADD_MULS))
# K2 (csrc/verify_hot.cuh): the function's work is 8 doublings a window
# below the most significant nonzero radix-256 digit of s or h, a mixed
# add (7 mul, as above) for each nonzero digit, and encode. What the
# four-lane kernel executes beyond that: all 31 windows of 8 doublings,
# each making T, and both adds in every one of the 32 windows (lane 2's
# product by the constant 2 not counted, as for K1)
_HOT_WINDOW_DOUBLINGS = 8
_X4_HOT_DOUBLINGS = (31 * 8 * 4, 31 * 8 * 4)
_X4_HOT_ADDS = (0, 32 * 2 * _ADD_MULS)
# K5 (csrc/verify_r16.cu): the A-table, 1 doubling (4 sq, 4 mul to
# extended), 6 cached adds (4 mul + 4 to extended), 8 to-cached (1 mul);
# 63 windows of 4 doublings, 3 muls to projective after 3 of them and 4 to
# extended after the 4th; a mixed B add (3 mul + 4) per nonzero digit of
# s, a cached A add (4 mul + 4) per nonzero digit of h, a top digit above
# 8 included (it adds the zero entry)
_TABLE16 = (4, 4 + 6 * 8 + 8)
_R16_DOUBLINGS = (63 * 4 * 4, 63 * (3 * 3 + 4))
# What the four-lane K5 executes beyond that, as for K1: all 63 windows of
# 4 doublings making T, and both adds in each of the 64 windows
_X4_R16_DOUBLINGS = (63 * 4 * 4, 63 * 4 * 4)
_X4_R16_ADDS = (0, 64 * (_ADD_MULS + _CACHED_ADD_MULS))
# the split phases' device list: the one card named this many times
SPLIT = 4
# phase 22's per-device backoff: far longer than a TxSet call (tens of
# ms), so the degraded call finds index 1 still open
FAULT_BACKOFF_S = 1.0
# phase 14's host-oracle breakdown: rows re-verified by one TxSet audit
# and by one catchup call's
AUDIT_ROWS = (40, 320)
# the engine's phases printed a call, and the share of the blocking root
# span they must cover on the cold and hot TxSet
ATTRIBUTED_PHASES = ("prep", "bucket", "dispatch", "fetch", "audit")
MIN_COVERAGE = 0.95
# phase 16: the resolve deadline, ms, and the spin queued ahead of the
# call, s; the one-card call must raise within RAISE_ONE_S and the split
# one within SPLIT x the deadline plus RAISE_SLACK_S
DEADLINE_PHASE_MS = 200
STALL_S = 2.5
RAISE_ONE_S = 1.0
RAISE_SLACK_S = 0.5
# phase 17: the probe's hang, s, its timeout and the answer's limit
PROBE_HANG_S = 2.0
PROBE_TIMEOUT_S = 0.3
PROBE_ANSWER_S = 0.6
# phase 18, the verify service: (a) scp submissions of SCP_SIGS
# signatures by VALIDATORS keys, single-signature auth submissions from
# fresh keys, the TxSet in BULK_SUBS bulk submissions; (b) the replicas'
# lane depth, the flooding tenant's depth quota, the arrivals and the
# rows a bulk arrival; (c) the trickle callers, and the callers, window
# and limit of the failing window; (e) the wedged card's deadline (the
# spin is STALL_S, the raise limit RAISE_ONE_S) and its bulk rows
VALIDATORS = 20
SCP_SUBS, SCP_SIGS = 200, 3
AUTH_SUBS = 100
BULK_SUBS = 20
# (a)'s steady pass: a bulk backlog of STEADY_BULK_SUBS submissions of
# STEADY_BULK_ROWS TxSet rows (40 TxSets, about 40 full dispatches, under
# the bulk lane's high-water mark and byte budget) queued first, then the
# scp and auth submissions in bursts of STEADY_BURST, STEADY_GAP_S apart,
# while it drains (bursts keep the flight recorder's ring, 4,096 records,
# holding the whole pass)
STEADY_BULK_SUBS, STEADY_BULK_ROWS = 160, 500
STEADY_BURST, STEADY_GAP_S = 20, 0.04
REPLICA_LANE_DEPTH = 64
FLOOD_QUOTA = 16
REPLICA_ARRIVALS = 112
REPLICA_BULK_ROWS = 8
TRICKLE_CALLERS = 64
TRICKLE_FAIL_CALLERS = 16
TRICKLE_FAIL_WINDOW_MS = 100.0
TRICKLE_FAIL_S = 2.0
WEDGED_BULK_ROWS = 200
# phase 19, the fleet and the wire: (a) FLEET_REPLICAS replicas, phase
# 18's scp and auth submissions and the TxSet in BULK_SUBS submissions
# over FLEET_TENANTS tenants, then a bulk backlog of FLEET_BACKLOG_SUBS
# submissions of FLEET_BACKLOG_ROWS TxSet rows, one replica killed while
# it is queued; (b) WIRE_CLIENTS clients on loopback, each sending a
# quarter of the TxSet in WIRE_SUBS submissions, and one the scp
# submissions; the fleet's gap polled every GAP_POLL_S during (a)
FLEET_REPLICAS = 3
FLEET_TENANTS = 8
FLEET_BACKLOG_SUBS, FLEET_BACKLOG_ROWS = 40, 500
WIRE_CLIENTS, WIRE_SUBS = 4, 5
GAP_POLL_S = 0.01
# phase 20, the node's transactions: the transactions vectors.node_txset
# builds by default, timed passes cold and hot, the time-series ring's
# interval, s
NODE_TXS = 1000
NODE_PASSES = 10
NODE_SAMPLE_S = 0.05
NODE_STEPS = ("decode", "payload", "hash", "collect", "prefetch", "check")
# phase 21, the node's TxSet: timed passes cold and hot over phase 20's
# transactions, the previous ledger's hash the set names, and the steps of
# a pass (each a public call of herder/tx_set.py)
TXSET_PASSES = 10
TXSET_LCL = hashlib.sha256(b"chip_smoke.py phase 21").digest()
TXSET_STEPS = ("decode_prepare", "hash", "check_valid", "apply_order")
# the transfer ledger's deltas printed a call, and checked against the
# engines' own tallies
TRANSFER_KEYS = ("bytes_h2d", "bytes_d2h", "round_trips", "resident_hits",
                 "resident_bytes", "unfingerprinted_uploads",
                 "unfingerprinted_bytes", "redundant_constant_bytes")
# phase 15: turns of the four modes, calls a mode a turn; fingerprint and
# copy repetitions
TRANSFER_MODES = ("repeated", "fresh", "cache_off", "bytes_only",
                  "hot_repeat")
TRANSFER_TURNS = 4
TRANSFER_CALLS = 10
FINGERPRINT_REPS = 50
COPY_REPS = 20
# phase 15 writes one cold TxSet call's Chrome trace here (``build/`` is
# ignored by git)
CHROME_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chrome_trace_cold_txset.json")


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
    """32x32->64 multiply-adds of K1's function on these rows, for its
    bound: decompress, the A-table and encode; from the most significant
    nonzero digit of s or h down, 5 doublings a window; and an addition
    for each nonzero digit (7 multiplies for s, 8 for h). (batch, 32)
    uint8 CPU tensors in, a Python int out."""
    s_nz = vk.signed_digits32(s_bytes) != 0  # (52, batch), top first
    h_nz = vk.signed_digits32(h_bytes) != 0
    any_nz = s_nz | h_nz
    top = torch.where(any_nz.any(0), 51 - any_nz.int().argmax(0), 0)
    doublings = 5 * int(top.sum())
    fixed = [_DECOMPRESS, _X4_TABLE, _ENCODE]
    rows = s_bytes.shape[0]
    sq = rows * sum(f[0] for f in fixed) + doublings * _DOUBLING[0]
    mul = (rows * sum(f[1] for f in fixed)
           + doublings * _DOUBLING[1] + int(s_nz.sum()) * _ADD_MULS
           + int(h_nz.sum()) * _CACHED_ADD_MULS)
    return sq * FE_SQ_MACS + mul * FE_MUL_MACS


def cold_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K1 executes for ``rows`` rows,
    each round's four products counted once: the function's work plus the
    dead T products and the identity adds. Does not depend on the data."""
    fixed = [_DECOMPRESS, _X4_TABLE, _X4_DOUBLINGS, _X4_ADDS, _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def hot_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds of K2's function on these rows, for its
    bound: encode; from the most significant nonzero radix-256 digit of s
    or h down, 8 doublings a window; and a mixed add (7 multiplies) for
    each nonzero digit. (batch, 32) uint8 CPU tensors in, a Python int
    out."""
    s_nz = vk.signed_digits256(s_bytes) != 0  # (32, batch), top first
    h_nz = vk.signed_digits256(h_bytes) != 0
    any_nz = s_nz | h_nz
    top = torch.where(any_nz.any(0), 31 - any_nz.int().argmax(0), 0)
    doublings = _HOT_WINDOW_DOUBLINGS * int(top.sum())
    rows = s_bytes.shape[0]
    sq = rows * _ENCODE[0] + doublings * _DOUBLING[0]
    mul = (rows * _ENCODE[1] + doublings * _DOUBLING[1]
           + int(s_nz.sum() + h_nz.sum()) * _ADD_MULS)
    return sq * FE_SQ_MACS + mul * FE_MUL_MACS


def hot_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K2 executes for ``rows`` rows,
    each round's products counted once: every window adds both entries
    (a zero digit the identity) and every doubling makes T. Does not
    depend on the data."""
    fixed = [_X4_HOT_DOUBLINGS, _X4_HOT_ADDS, _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def r16_kernel_multiplies(s_bytes, h_bytes) -> int:
    """32x32->64 multiply-adds of K5's function on these rows, for its
    bound: the fixed decompress, table, doublings and encode, and one add
    for each nonzero radix-16 digit (7 multiplies for s, 8 for h).
    (batch, 32) uint8 CPU tensors in, a Python int out."""
    nz_s = int((vk.signed_digits16(s_bytes) != 0).sum())
    nz_h = int((vk.signed_digits16(h_bytes) != 0).sum())
    fixed = [_DECOMPRESS, _TABLE16, _R16_DOUBLINGS, _ENCODE]
    sq = sum(f[0] for f in fixed)
    mul = sum(f[1] for f in fixed)
    return (s_bytes.shape[0] * (sq * FE_SQ_MACS + mul * FE_MUL_MACS)
            + (nz_s * _ADD_MULS + nz_h * _CACHED_ADD_MULS) * FE_MUL_MACS)


def r16_kernel_executed(rows: int) -> int:
    """32x32->64 multiply-adds the four-lane K5 executes for ``rows`` rows,
    each round's products counted once: every doubling makes T and every
    window adds both entries (a zero digit the identity, a top digit above
    8 the zero entry). Does not depend on the data."""
    fixed = [_DECOMPRESS, _TABLE16, _X4_R16_DOUBLINGS, _X4_R16_ADDS,
             _ENCODE]
    return rows * (sum(f[0] for f in fixed) * FE_SQ_MACS
                   + sum(f[1] for f in fixed) * FE_MUL_MACS)


def sha_ops_per_block() -> int:
    """K3's function: 32-bit operations a compressed block by FIPS 180-4
    (64 rounds, 48 schedule words, the feed-forward), 1,384."""
    return (64 * SHA_ROUND_OPS + 48 * SHA_SCHEDULE_OPS
            + SHA_FEED_FORWARD_OPS)


def bound(info, ops, ops_per_clock_per_sm, nbytes):
    """(least ms, what bounds it): the larger of the operations over the
    card's rate and the bytes over its memory rate."""
    ops_ms = ops / (ops_per_clock_per_sm * info["sms"]
                    * info["clock_hz"]) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def sass_code(name, function):
    """(address, opcode, operands) of each instruction of the function
    whose (mangled) name contains ``function`` in ``cuobjdump -sass`` of
    kernel library ``name``."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", _build.library_path(name)],
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    found = [part for part in proc.stdout.split("Function : ")[1:]
             if function in part.splitlines()[0]]
    check(len(found) == 1, f"{name}: {len(found)} SASS functions named "
          f"like {function}")
    code = []
    for ln in found[0].splitlines():
        m = _SASS_LINE.match(ln)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return code


def sass_loops(code):
    """(first, last) address of each loop: a backward branch and its
    target."""
    return [(int(arg, 16), addr) for addr, op, arg in code
            if op == "BRA" and re.fullmatch(r"0x[0-9a-f]+", arg.strip())
            and int(arg, 16) < addr]


def hash_kernel_executed():
    """What the built K3 executes a block, from ``cuobjdump -sass``: the
    instructions of its block loop (of the loops between a backward
    branch and its target, the one with the most compression work) and
    of them those of the kinds in ``SHA_SASS_OPS`` (``.X`` carry forms,
    moves, loads, compares and branches left out). A diagnostic beside
    the bound, which counts the function."""
    code = sass_code("sha256", "sha256_kernel")
    back = sass_loops(code)
    check(back, "K3's SASS has no loop")
    best = None
    for lo, hi in back:
        body = [op for addr, op, _arg in code if lo <= addr <= hi]
        kinds = collections.Counter(_sass_kind(op) for op in body)
        by_op = {k: kinds[k] for k in SHA_SASS_OPS}
        if best is None or sum(by_op.values()) > best["ops"]:
            best = {"instructions": len(body), "ops": sum(by_op.values()),
                    "ops_by_opcode": by_op, "loops": len(back)}
    return best


def shuffle_loops(name, kernel):
    """The loops of a four-lane kernel that gather across lanes (K1 and
    K5: the table build, a doubling, an addition, the window; K2: a
    doubling, an addition, the window), from its SASS: instructions a
    lane for one pass, and of them IMAD.WIDE and SHFL."""
    code = sass_code(name, kernel)
    out = []
    for lo, hi in sass_loops(code):
        body = [op for addr, op, _arg in code if lo <= addr <= hi]
        shfl = sum(op.startswith("SHFL") for op in body)
        if shfl:
            out.append({"instructions": len(body), "shfl": shfl,
                        "imad_wide": sum(op.startswith("IMAD.WIDE")
                                         for op in body)})
    check(out, f"{name}'s SASS has no loop with shuffles")
    return out


def chain_squarings(name, kernel):
    """Instructions a lane in each pass of the exponent chains' squaring
    loops of kernel library ``name`` (``fe_sqn``: one ``fe_sq`` a pass, no
    shuffle, 55 products), from its SASS, sorted."""
    code = sass_code(name, kernel)
    out = []
    for lo, hi in sass_loops(code):
        body = [op for addr, op, _arg in code if lo <= addr <= hi]
        wide = sum(op.startswith("IMAD.WIDE") for op in body)
        if 50 <= wide <= 60 and not any(op.startswith("SHFL")
                                        for op in body):
            out.append(len(body))
    check(out, f"{name}'s SASS has no squaring loop")
    return sorted(out)


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
    """K1, K2, K3 and K5 with nvcc, the prep library and the host oracle
    with g++, all six builds started together. Returns K1's, K2's and
    K5's registers, spills, lanes a row and shuffle loops, and K3's
    registers and SASS block loop, by library name."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_build.LIBRARIES) + 2) as pool:
        jobs = [pool.submit(_build.library, name, dev)
                for name in _build.LIBRARIES]
        jobs.append(pool.submit(native_prep._load))
        jobs.append(pool.submit(native_verify._load))
        for job in jobs:
            job.result()
    secs = time.perf_counter() - t0
    print(f"[build] K1, K2, K3, K5, the prep library and the host oracle "
          f"built in {secs:.1f} s; host oracle backend "
          f"{native_verify.backend()}")
    for name in _build.LIBRARIES:
        log = _build.build_log(_build.library_path(name))
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name} ptxas: {ln.strip()}")
    out = {}
    for label, name in (("K1", "verify_cold"), ("K2", "verify_hot"),
                        ("K5", "verify_r16")):
        kernel = f"{name}_kernel"
        info = out[name] = {
            "ptxas": ptxas_usage(name, kernel),
            "shuffle_loops": shuffle_loops(name, kernel),
            "chain_squaring_instructions": chain_squarings(name, kernel),
            "lanes_per_row": getattr(_build.library(name, dev),
                                     f"{name}_lanes_per_row")()}
        print(f"[build] {label} entry function: {info['ptxas']}; "
              f"{info['lanes_per_row']} lanes a row; its loops with "
              f"shuffles, one pass a lane: {info['shuffle_loops']}; the "
              f"exponent chains' squaring loops, instructions a pass (one "
              f"squaring): {info['chain_squaring_instructions']}, beside "
              f"the ladder's doubling pass above (one squaring, one "
              f"multiply, the shuffles)")
    info = out["sha256"] = {"ptxas": ptxas_usage("sha256", "sha256_kernel"),
                            "executed": hash_kernel_executed()}
    print(f"[build] K3 entry function: {info['ptxas']}; one thread a "
          f"message; its block loop, from the SASS: {info['executed']}")
    return out


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


def launch_past_wrapper(name, ops, threads):
    """Kernel library ``name`` (K1 or K2) on the CUDA operands ``ops`` at
    ``threads`` a block, launched past its wrapper (the sweep's launches
    are not the main path's)."""
    out = torch.empty((ops[0].shape[0],), dtype=torch.bool,
                      device=ops[0].device)
    _build.launch(name, ops, out, ops[0].shape[0], threads)
    return out


def ptxas_usage(name, kernel):
    """Registers, stack frame, spill bytes and static shared memory of the
    entry function ``kernel`` of library ``name``, from its ``-Xptxas -v``
    log."""
    log = _build.build_log(_build.library_path(name))
    entry = re.search(r"Compiling entry function '(\w*" + kernel
                      + r"\w*)'", log)
    check(entry is not None, f"{name}: no entry function {kernel} in the "
          "ptxas log")
    sym = re.escape(entry.group(1))
    props = re.search(r"Function properties for " + sym + r"\s+(\d+) bytes "
                      r"stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", log)
    regs = re.search(r"Compiling entry function '" + sym
                      + r"'.*?Used (\d+) registers([^\n]*)", log, re.S)
    check(props is not None and regs is not None,
          f"{name}: no register or spill line for {kernel}")
    smem = re.search(r"(\d+) bytes smem", regs.group(2))
    return {"registers": int(regs.group(1)),
            "stack_bytes": int(props.group(1)),
            "spill_store_bytes": int(props.group(2)),
            "spill_load_bytes": int(props.group(3)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0}


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
    compared, n_true = len(rows[0]), int(got.sum())
    for n in RAGGED_ROWS:
        ops = rows_to(dev, tuple(np.concatenate([x, x])[:n] for x in rows))
        got = vk.verify_kernel(*ops)
        want = vk.verify_kernel_plain(*ops)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"kernel and plain differ on {bad} of {n} rows")
        compared += n
    print(f"[kernel-vs-plain] {len(rows[0])} rows, {n_true} True, "
          f"0 differ (tolerance 0: bits); and at the ragged sizes "
          f"{RAGGED_ROWS} rows, 0 differ")
    return compared, err


def engine_phases(before, after, reps, ns, label, min_coverage=None):
    """The engine's own attribution of ``reps`` blocking calls between two
    ``tracing.span_totals()`` snapshots: ms a call of each phase and the
    phases' coverage of the root span (``batch_engine.
    phase_attribution``); fails below ``min_coverage`` when one is
    given."""
    att = batch_engine.phase_attribution(before, after, reps, ns)
    ms = {s: att["phases"][f"{ns}.{s}"]["per_rep_ms"]
          for s in ATTRIBUTED_PHASES}
    check(att["blocking_span_count"] == reps, f"{label}: "
          f"{att['blocking_span_count']} blocking spans over {reps} calls")
    print(f"[{label}] engine phases, ms a call over {reps} calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; root {att['blocking_span_per_rep_ms']:.3f}, coverage "
          f"{att['coverage']}")
    if min_coverage is not None:
        check(att["coverage"] is not None and
              att["coverage"] >= min_coverage, f"{label}: the engine's "
              f"phases cover {att['coverage']} of the call, under "
              f"{min_coverage}")
    return {"phases_ms": ms, "root_ms": att["blocking_span_per_rep_ms"],
            "coverage": att["coverage"]}


def pipeline_view(resolves0, ns, label):
    """Mean over the pipeline records written since ``resolves0`` (the
    timeline's resolve count before the timed calls) of ``busy_frac``,
    ``overlap_frac`` and ``reconciliation``, and the commonest largest
    bubble class: the host's view of device occupancy, launch to
    delivery, not a profiler trace."""
    n = pipeline_timeline.totals()["resolves"] - resolves0
    recs = [r for r in pipeline_timeline.recent(n) if r["ns"] == ns]
    check(recs, f"{label}: no pipeline record")

    def mean(key):
        vals = [r[key] for r in recs if r[key] is not None]
        return float(np.mean(vals)) if vals else None

    classes = collections.Counter(r["largest_bubble_class"] for r in recs)
    cls, k = classes.most_common(1)[0]
    out = {"resolves": len(recs), "busy_frac": mean("busy_frac"),
           "overlap_frac": mean("overlap_frac"),
           "reconciliation": mean("reconciliation"),
           "largest_bubble_class": cls, "largest_bubble_share":
           k / len(recs), "largest_bubble_ms": mean("largest_bubble_ms")}
    print(f"[{label}] pipeline timeline (the host's view of device "
          f"occupancy, launch to delivery; not a profiler trace), mean over "
          f"{len(recs)} resolves: busy_frac {out['busy_frac']:.4f}, "
          f"overlap_frac {out['overlap_frac']}, reconciliation "
          f"{out['reconciliation']:.4f}; largest bubble {cls} in {k} of "
          f"{len(recs)} ({out['largest_bubble_ms']:.3f} ms mean)")
    return out


def transfer_mark(engines):
    """The transfer ledger's totals and ``engines``' own tallies (bytes
    copied, bytes fetched, resident hits), before the calls that
    :func:`transfer_view` reads; and a tap on the engines' workloads,
    which sums the bytes of the operand tensors each kernel launch is
    handed and of the result it returns: a count taken at the kernels,
    apart from the ledger and the tallies. :func:`transfer_view` takes
    the tap off."""
    tap = {"in": 0, "out": 0}
    plugins = list({id(p): p for e in engines
                    for p in (e._plugin, getattr(e, "_hot", None))
                    if p is not None}.values())
    for p in plugins:
        def kernel(*ops, _fn=p.kernel_fn()):
            out = _fn(*ops)
            tap["in"] += sum(o.nbytes for o in ops)
            tap["out"] += out.nbytes
            return out
        p.kernel_fn = lambda _k=kernel: _k
    return transfer_ledger.totals(), [
        (e.shipped_bytes, e.fetched_bytes, e.resident_hits)
        for e in engines], tap, plugins


def transfer_view(mark, engines, calls, label, quiet=False):
    """The ledger's deltas since ``mark``, a call over ``calls`` calls;
    fails unless its bytes each way and resident hits equal the deltas of
    ``engines``' own shape-derived tallies, and unless the bytes it
    counts each way equal the tap's (every launch accepted: h2d plus
    resident bytes are the operands the kernels were handed, d2h their
    results). Returns the totals and the deltas a call."""
    before, tallies, tap, plugins = mark
    for p in plugins:
        del p.kernel_fn
    after = transfer_ledger.totals()
    d = {k: after[k] - before[k] for k in TRANSFER_KEYS}
    own = [sum(e.shipped_bytes for e in engines) - sum(t[0] for t in tallies),
           sum(e.fetched_bytes for e in engines) - sum(t[1] for t in tallies),
           sum(e.resident_hits for e in engines) - sum(t[2] for t in tallies)]
    check([d["bytes_h2d"], d["bytes_d2h"], d["resident_hits"]] == own,
          f"{label}: the transfer ledger's h2d, d2h and resident hits "
          f"{[d['bytes_h2d'], d['bytes_d2h'], d['resident_hits']]} differ "
          f"from the engines' own {own}")
    check(d["bytes_h2d"] + d["resident_bytes"] == tap["in"] and
          d["bytes_d2h"] == tap["out"],
          f"{label}: the transfer ledger's h2d + resident bytes "
          f"{d['bytes_h2d'] + d['resident_bytes']} and d2h "
          f"{d['bytes_d2h']} differ from the kernels' operands "
          f"{tap['in']} and results {tap['out']}")
    per = {k: v / calls for k, v in d.items()}
    if not quiet:
        print(f"[{label}] transfer ledger a call over {calls} calls, equal "
              f"to the engine's own tallies and to the kernels' operand "
              f"and result bytes: " + ", ".join(
                  f"{k} {v:g}" for k, v in per.items()))
    return {"total": d, "per_call": per}


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
    mark = transfer_mark([v])
    got = v.verify_batch(items)
    torch.cuda.synchronize()
    check(np.array_equal(got, want),
          f"TxSet verdicts differ from the oracle on "
          f"{int((got != want).sum())} rows")
    check(v.served["device"] == TXSET_SIGS,
          f"device served {v.served['device']} of {TXSET_SIGS} rows")
    first = transfer_view(mark, [v], 1, "txset first call")
    check(first["total"]["bytes_h2d"] == TXSET_OPERAND_BYTES and
          first["total"]["resident_hits"] == 0, "txset: the first call did "
          f"not ship {TXSET_OPERAND_BYTES} B: {first['total']}")
    times = []
    before, resolves0 = tracing.span_totals(), \
        pipeline_timeline.totals()["resolves"]
    mark = transfer_mark([v])
    for _ in range(TIMED_CALLS):
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, want), "a timed TxSet call differs")
    transfer = transfer_view(mark, [v], TIMED_CALLS, "txset")
    check(transfer["total"]["bytes_h2d"] ==
          transfer["total"]["redundant_constant_bytes"] ==
          TIMED_CALLS * TXSET_OPERAND_BYTES and
          transfer["total"]["resident_hits"] == 0,
          f"txset: a repeated call, the resident cache off, does not ship "
          f"its {TXSET_OPERAND_BYTES} B again, redundant: "
          f"{transfer['total']}")
    phases = engine_phases(before, tracing.span_totals(), TIMED_CALLS,
                           "verify", "txset", MIN_COVERAGE)
    pipeline = pipeline_view(resolves0, "crypto.verify", "txset")
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
    return ({"p50_ms": p50, "p90_ms": p90, "encode_p50_ms": enc50,
             "engine_phases": phases, "pipeline": pipeline,
             "transfer_first_call": first["per_call"],
             "transfer": transfer["per_call"]}, items, want)


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
    mark = transfer_mark([v])
    for _ in range(CATCHUP_CALLS):
        t = time.perf_counter()
        out = v.verify_batch(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(np.array_equal(out, got), "a timed catchup call differs")
    transfer = transfer_view(mark, [v], CATCHUP_CALLS, "catchup")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    print(f"[catchup] {n} sigs ({len(bad)} corrupted), generated in "
          f"{gen:.1f} s; {len(sample)} rows checked; after one untimed call, "
          f"verify_batch p50 {p50:.3f} ms, p90 {p90:.3f} ms over "
          f"{CATCHUP_CALLS} calls ({n / p50 * 1e3:.0f} sigs/s at p50)")
    return ({"p50_ms": p50, "p90_ms": p90, "transfer": transfer["per_call"]},
            items, got, bad)


def queued_ms(fn, reps):
    """Milliseconds a call of ``fn``, a kernel launch, keeps the card busy
    when the card runs ``reps`` calls back to back (``_event_ms`` times
    them as the host issues them, which for K3 is the host's launch rate:
    a launch from Python costs more than K3 runs). The calls are issued
    once untimed; then the stream spins (``torch.cuda._sleep``) for four
    times the host time that took, and the timed calls are queued behind the
    spin. Fails if the spin ended before they were all queued."""
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4 * host_s * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not start.query(), "queued_ms: the spin ended before the timed "
          "launches were queued")
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    on every row, both timed, and the bound. Returns ``(entry, err,
    plain's bits)``."""
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
    executed = cold_kernel_executed(b)
    bound_ms, bound_by = bound(info, macs, IMAD_PER_CLOCK_PER_SM,
                               b * ROW_BYTES)
    print(f"[kernel-times] {label}: {b} rows ({int(got.sum())} True), "
          f"kernel = plain on every row; K1 {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({macs} 32x32->64 "
          f"multiply-adds of the function; the kernel executes {executed}, "
          f"{executed / macs:.4f}x)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "multiply_adds": macs,
            "executed_multiply_adds": executed,
            "rows_true": int(got.sum())}, err, want


def phase_kernel_times(dev, rng, info, main_items):
    """K1 against its plain version, and both timed, at each bucket of the
    main path on rows built from that call's items. Returns the operands
    too (bucket -> CUDA tensors), for phase 12, and plain's bits on them
    (bucket -> bits), for the block sweep."""
    per_batch, compared, err, all_ops, bits = {}, 0, 0.0, {}, {}
    for b in KERNEL_BATCHES:
        ops = all_ops[b] = rows_to(dev, main_path_rows(rng, main_items[b], b))
        per_batch[str(b)], e, bits[b] = k1_against_plain(info, ops, f"B={b}")
        compared += b
        err = max(err, e)
    return per_batch, compared, err, all_ops, bits


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
    of one call). Returns plain's bits too (label -> bits)."""
    per_batch, compared, err, bits = {}, 0, 0.0, {}
    for label, launches in recorded.items():
        check(len(launches) == 1, f"{label}: {len(launches)} K1 launches, "
              "not 1")
        ops = launches[0]
        key = f"{label}:{ops[0].shape[0]}"
        per_batch[key], e, bits[label] = k1_against_plain(info, ops, key)
        compared += ops[0].shape[0]
        err = max(err, e)
    return per_batch, compared, err, bits


def phase_block_sweep(name, rows, wrapper_threads):
    """Kernel ``name`` (K1 or K2) timed at each block size of
    ``BLOCK_THREADS`` on the rows of ``SWEEP_ROWS[name]`` (``rows``: row
    count -> (CUDA operands, plain's bits on them, from the phases that
    held the kernel against plain)), its bits equal to plain's at every
    block size."""
    sizes = SWEEP_ROWS[name]
    check(sorted(rows) == sorted(sizes) and all(
        ops[0].shape[0] == b for b, (ops, _) in rows.items()),
        f"{name}: the sweep's rows are not {sizes}")
    ms = {}
    for threads in BLOCK_THREADS:
        for b in sizes:
            ops, want = rows[b]
            got = launch_past_wrapper(name, ops, threads)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} at {threads} threads a "
                  f"block differs from plain at B={b}")
            ms[f"{threads}:{b}"] = _event_ms(
                lambda: launch_past_wrapper(name, ops, threads), KERNEL_REPS)
    best = {b: min(BLOCK_THREADS, key=lambda t: ms[f"{t}:{b}"])
            for b in sizes}
    print(f"[block-sweep] {name} ms by threads a block (rows: "
          f"{', '.join(map(str, sizes))}); the wrapper's "
          f"{wrapper_threads}: "
          + "; ".join(f"{t} threads " + " / ".join(
              f"{ms[f'{t}:{b}']:.4f}" for b in sizes)
              for t in BLOCK_THREADS)
          + f"; fastest {best}; bits equal to plain at every size")
    return {"ms": ms, "wrapper_threads": wrapper_threads,
            "fastest": {str(b): t for b, t in best.items()}}


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


def table_stack_ms(items):
    """p50 of 5, ms: ``np.stack`` of the cached tables of ``items``' rows,
    alone (no engine code: the hot encode's share that stacks 15 KB a
    row)."""
    tables = [t for t in (signer_table_cache.lookup(it[0]) for it in items
                          if len(it[0]) == 32) if t is not None]
    return float(np.percentile(timed_ms(lambda: np.stack(tables), 5), 50))


def phase_hot_txset(items, want, k1_ops):
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
    before, resolves0 = tracing.span_totals(), \
        pipeline_timeline.totals()["resolves"]
    mark = transfer_mark([v])
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
    transfer = transfer_view(mark, [v], TIMED_CALLS, "hot-txset")
    check(transfer["total"]["unfingerprinted_uploads"] == TIMED_CALLS and
          transfer["total"]["unfingerprinted_bytes"] ==
          TIMED_CALLS * HOT_TABLE_BYTES, f"hot TxSet: the table operand is "
          f"not one unfingerprinted upload of {HOT_TABLE_BYTES} B a call: "
          f"{transfer['total']}")
    phases = engine_phases(before, tracing.span_totals(), TIMED_CALLS,
                           "verify", "hot-txset", MIN_COVERAGE)
    pipeline = pipeline_view(resolves0, "crypto.verify", "hot-txset")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    with cold_operands(v, k1_ops.setdefault("hot_txset", [])):
        check(np.array_equal(v.verify_batch(items), want),
              "hot TxSet: the recorded call differs from the oracle")
    stack_ms = table_stack_ms(items)
    print(f"[hot-txset] first call (all first sights, {cacheable} table "
          f"builds) {first_ms:.1f} ms; then {cacheable} of {len(items)} "
          f"rows hot each call; verify_batch p50 {p50:.3f} ms, p90 "
          f"{p90:.3f} ms over {TIMED_CALLS} calls; the tables' np.stack "
          f"alone p50 {stack_ms:.3f} ms")
    return ({"first_ms": first_ms, "p50_ms": p50, "p90_ms": p90,
             "hot_rows": cacheable, "stack_ms": stack_ms,
             "engine_phases": phases, "pipeline": pipeline,
             "transfer": transfer["per_call"]},
            hot_path_rows(items, KERNEL_BATCHES[0]))


def phase_hot_catchup(rng, items, cold, bad, k1_ops):
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
    before = tracing.span_totals()
    mark = transfer_mark([v])
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
    transfer = transfer_view(mark, [v], CATCHUP_CALLS, "hot-catchup")
    phases = engine_phases(before, tracing.span_totals(), CATCHUP_CALLS,
                           "verify", "hot-catchup")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    with cold_operands(v, k1_ops.setdefault("hot_catchup", [])):
        check(np.array_equal(v.verify_batch(items), got),
              "hot catchup: the recorded call differs")
    stack_ms = table_stack_ms(items)
    print(f"[hot-catchup] first call {first_ms:.1f} ms ({first_hot} rows "
          f"hot, {n - first_hot} cold); then {cacheable} of {n} rows hot "
          f"each call; verify_batch p50 {p50:.3f} ms, p90 {p90:.3f} ms over "
          f"{CATCHUP_CALLS} calls ({n / p50 * 1e3:.0f} sigs/s at p50); "
          f"{len(sample)} rows checked; the tables' np.stack alone p50 "
          f"{stack_ms:.3f} ms")
    return ({"first_ms": first_ms, "first_hot_rows": first_hot,
             "p50_ms": p50, "p90_ms": p90, "hot_rows": cacheable,
             "stack_ms": stack_ms, "engine_phases": phases,
             "transfer": transfer["per_call"]},
            hot_path_rows(items, KERNEL_BATCHES[1]))


def phase_hot_kernel_times(dev, rng, info, main_rows):
    """K2 against its plain version, and both timed, at each bucket of the
    hot path, on that call's padded rows with edge, saturating matching
    and random rows written over their head; then at the ragged sizes,
    on the head of the first bucket's rows. Returns the operands and
    plain's bits at each bucket too, for the block sweep."""
    wl = Ed25519HotWorkload()
    # the table, R, s, h read once, one bool written
    row_bytes = TABLE_ENTRIES * HOT_ENTRY_BYTES + 3 * 32 + 1
    per_batch, compared, err, swept = {}, 0, 0.0, {}
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
        executed = hot_kernel_executed(b)
        bound_ms, bound_by = bound(info, macs, IMAD_PER_CLOCK_PER_SM,
                                   b * row_bytes)
        selected = int((vk.signed_digits256(h_cpu) != 0).sum()) * \
            HOT_ENTRY_BYTES
        per_batch[str(b)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "multiply_adds": macs,
            "executed_multiply_adds": executed,
            "rows_true": int(got.sum()), "rows_saturated": saturated,
            "bytes_shipped": b * row_bytes,
            "table_bytes_selected": selected}
        print(f"[hot-kernel-times] B={b}: {b} rows ({int(got.sum())} True, "
              f"{saturated} with a top digit above 128), K2 = plain on "
              f"every row; K2 {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {macs} 32x32->64 "
              f"multiply-adds of the function; the kernel executes "
              f"{executed}, {executed / macs:.4f}x; {b * row_bytes} B "
              f"shipped, {selected / b:.0f} B a row of table entries "
              f"selected)")
        swept[b] = (ops, want)
    first = swept[KERNEL_BATCHES[0]][0]
    for n in RAGGED_ROWS:
        part = tuple(x[:n] for x in first)
        got = vk.verify_kernel_hot(*part)
        want = vk.verify_kernel_hot_plain(*part)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"K2 and plain differ on {bad} of {n} rows")
        compared += n
    print(f"[hot-kernel-times] and at the ragged sizes {RAGGED_ROWS} rows "
          f"(rows past n inside a group of four lanes, partial warps), "
          f"0 differ")
    return per_batch, compared, err, swept


def hash_messages(rng, n):
    """``n`` messages of uniform length up to the 8-block capacity (503
    bytes), 2% oversize at 504-2,000 bytes; the oversize count too."""
    n_over = int(n * HASH_OVERSIZE_SHARE)
    lens = np.concatenate([rng.integers(0, sk.max_message_bytes(MAX_BLOCKS)
                                        + 1, n - n_over),
                           rng.integers(504, 2001, n_over)])
    return [rng.bytes(int(k)) for k in rng.permutation(lens)], n_over


def k3_against_plain(dev, info, msgs):
    """K3 and its plain version on ``msgs`` packed as the hasher packs
    them: equal words on every row, equal to hashlib on every row that
    fits (an oversize row has no active block and gives H0), both timed,
    and the bound. Returns ``(entry, max abs err)``."""
    words, active, fits = sk.pack_messages(msgs, MAX_BLOCKS)
    w, a = rows_to(dev, (words, active))
    got = sk.sha256_kernel(w, a).cpu().numpy().astype(np.int64)
    plain = sk.sha256_kernel_plain(w, a).cpu().numpy().astype(np.int64)
    torch.cuda.synchronize()
    n = len(msgs)
    bad = int((got != plain).any(1).sum())
    check(bad == 0, f"K3 and plain differ on {bad} of {n} rows")
    fit = [m for m, f in zip(msgs, fits) if f]
    check(np.array_equal(got[fits], sk.host_digest_words(fit)),
          f"K3 differs from hashlib at B={n}")
    check((got[~fits] == np.array(sk.H0)).all(), "an oversize row is not H0")
    ms = _event_ms(lambda: sk.sha256_kernel(w, a), HASH_KERNEL_REPS)
    ms_queued = queued_ms(lambda: sk.sha256_kernel(w, a), HASH_KERNEL_REPS)
    plain_ms = _event_ms(lambda: sk.sha256_kernel_plain(w, a), 1)
    blocks = int(active.sum())
    # the words and active flags read once, eight digest words written
    row_bytes = MAX_BLOCKS * (64 + 1) + 32
    bound_ms, bound_by = bound(info, blocks * sha_ops_per_block(),
                               INT_OPS_PER_CLOCK_PER_SM, n * row_bytes)
    return {"ms": ms, "ms_queued": ms_queued, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "active_blocks": blocks,
            "ops_per_block": sha_ops_per_block(),
            "rows_hashlib": len(fit)}, float(np.abs(got - plain).max())


def phase_hashing(dev, rng, info, executed):
    """BatchHasher's main path on 2,048 messages, then K3 against its plain
    version and hashlib on the call's own packed rows and on 16,384 new
    messages of the same length mix, timed beside the bound; ``executed``
    is phase 2's SASS count of the built K3, printed beside it."""
    msgs, n_over = hash_messages(rng, HASH_MSGS)
    want = [hashlib.sha256(m).digest() for m in msgs]
    h = default_hasher()
    check(h.device.type == "cuda", f"default hasher on {h.device}")
    sk.sha256_kernel.launches = 0
    host0 = h.served["host"]
    check(h.hash_batch(msgs) == want, "hash_batch differs from hashlib")
    check(h.served["host"] - host0 == n_over, "oversize rows not hashed "
          "on the host")
    times = []
    before = tracing.span_totals()
    mark = transfer_mark([h])
    for _ in range(HASH_CALLS):
        t = time.perf_counter()
        out = h.hash_batch(msgs)
        times.append((time.perf_counter() - t) * 1e3)
        check(out == want, "a timed hash_batch call differs from hashlib")
    transfer = transfer_view(mark, [h], HASH_CALLS, "hashing")
    phases = engine_phases(before, tracing.span_totals(), HASH_CALLS,
                           "hash", "hashing")
    launches = sk.sha256_kernel.launches
    check(launches > 0, "the hashing main path launched no K3 kernel")
    host = []
    for _ in range(HASH_CALLS):
        t = time.perf_counter()
        for m in msgs:
            hashlib.sha256(m).digest()
        host.append((time.perf_counter() - t) * 1e3)
    per_batch, err = {}, 0.0
    for b in HASH_KERNEL_BATCHES:
        rows = msgs if b == HASH_MSGS else hash_messages(rng, b)[0]
        per_batch[str(b)], e = k3_against_plain(dev, info, rows)
        err = max(err, e)
    res = {"p50_ms": np.percentile(times, 50),
           "p90_ms": np.percentile(times, 90),
           "hashlib_p50_ms": np.percentile(host, 50),
           "hashlib_p90_ms": np.percentile(host, 90), "oversize": n_over,
           "engine_phases": phases, "transfer": transfer["per_call"],
           "launches": launches, "rows_compared": sum(HASH_KERNEL_BATCHES),
           "max_abs_err": err, "by_batch": per_batch}
    print(f"[hashing] {HASH_MSGS} messages ({n_over} oversize, hashed on "
          f"the host), every digest = hashlib; hash_batch p50 "
          f"{res['p50_ms']:.3f} ms, p90 {res['p90_ms']:.3f} ms over "
          f"{HASH_CALLS} calls; hashlib p50 {res['hashlib_p50_ms']:.3f} ms")
    ratio = executed["ops"] / sha_ops_per_block()
    for b, k in per_batch.items():
        print(f"[hashing] B={b}: K3 = plain on every row, = hashlib on "
              f"the {k['rows_hashlib']} that fit; K3 {k['ms']:.4f} ms as "
              f"issued, {k['ms_queued']:.4f} ms queued, "
              f"plain {k['plain_ms']:.1f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}; {k['active_blocks']} active blocks x "
              f"{k['ops_per_block']} operations of the function; the "
              f"kernel's block loop does {executed['ops']}, "
              f"{ratio:.4f}x, in {executed['instructions']} instructions)")
    return res


def check_dispatch_clean(engines, label):
    """After a main-path phase: no device fault (no launch retried, every
    breaker closed and never opened), no audit mismatch, no device
    convicted. The engine has no host failover (a fault moves a part to
    another device or raises), so every row was served by a card or
    decided by the host gate. Returns the parts audited clean."""
    audited = 0
    for eng in engines:
        snap = eng.health.snapshot()
        check(eng.audit_mismatches == 0 and not eng.convicted,
              f"{label}: audit mismatch, convicted {sorted(eng.convicted)}")
        faulted = {i: d for i, d in snap["devices"].items()
                   if d["state"] != resilience.CLOSED or d["opened_total"]
                   or d["consecutive_failures"]}
        check(not faulted and eng.retries == 0,
              f"{label}: a device faulted: {faulted}, {eng.retries} "
              "launches retried")
        audited += sum(t["ok"] for t in snap["audits"].values())
    return audited


def sweep_rows(rng, items, b):
    """Phase 11's rows: the main path's ``b`` padded rows with the edge
    corpus, 64 radix-16 matching rows, 64 overflow rows (top digit above
    8; R = 0 on even ones) and 256 random rows written over their head."""
    rows = list(main_path_rows(rng, items, b))
    _, edge = Ed25519Workload().encode(vectors.edge_corpus(rng))
    head = [np.concatenate(parts) for parts in zip(
        edge, vectors.r16_matching_rows(rng, 64),
        vectors.r16_overflow_rows(rng, 64), vectors.random_rows(rng, 256))]
    for k in range(4):
        rows[k][:len(head[k])] = head[k]
    return tuple(rows), len(edge[0])


def phase_radix_sweep(dev, rng, info, main_items, build):
    """K5 on the main path's rows at each bucket (the sweep's calls, the
    launches counted), then K5 against its plain version, K5 and K1 timed
    on the same rows, and the ratio: radix 16 against radix 32, one row
    function on four lanes. ``build`` is phase 2's K5 entry."""
    all_ops, n_edge = {}, 0
    for b in KERNEL_BATCHES:
        rows, n_edge = sweep_rows(rng, main_items[b], b)
        all_ops[b] = rows_to(dev, rows)
    vk.verify_kernel_r16.launches = 0
    swept = {b: vk.verify_kernel_r16(*ops) for b, ops in all_ops.items()}
    torch.cuda.synchronize()
    launches = vk.verify_kernel_r16.launches
    check(launches == len(KERNEL_BATCHES), f"the sweep launched K5 "
          f"{launches} times, not {len(KERNEL_BATCHES)}")
    per_batch, compared, err = {}, 0, 0.0
    for b, ops in all_ops.items():
        got = swept[b]
        want = vk.verify_kernel_r16_plain(*ops)
        k1_bits = vk.verify_kernel(*ops)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"B={b}: K5 and plain differ on {bad} rows")
        head = got[n_edge:n_edge + 128].tolist()
        check(head == [True] * 64 + [True, False] * 32,
              f"B={b}: K5 misses the matching or overflow rows")
        s_cpu, h_cpu = ops[2].cpu(), ops[3].cpu()
        top = torch.stack([vk.signed_digits16(s_cpu)[0],
                           vk.signed_digits16(h_cpu)[0]])
        overflow = int((top > 8).any(0).sum())
        differ_k1 = int((got != k1_bits).sum())
        compared += b
        err = max(err, float((got.int() - want.int()).abs().max()))
        ms = _event_ms(lambda: vk.verify_kernel_r16(*ops), KERNEL_REPS)
        k1_ms = _event_ms(lambda: vk.verify_kernel(*ops), KERNEL_REPS)
        plain_ms = _event_ms(lambda: vk.verify_kernel_r16_plain(*ops), 1)
        macs = r16_kernel_multiplies(s_cpu, h_cpu)
        executed = r16_kernel_executed(b)
        bound_ms, bound_by = bound(info, macs, IMAD_PER_CLOCK_PER_SM,
                                   b * ROW_BYTES)
        per_batch[str(b)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "multiply_adds": macs,
            "executed_multiply_adds": executed,
            "rows_true": int(got.sum()), "rows_overflow": overflow,
            "rows_differing_from_k1": differ_k1, "k1_ms": k1_ms,
            "k5_over_k1": ms / k1_ms}
        print(f"[radix-sweep] B={b}: K5 = plain on every row ({overflow} "
              f"rows with a top radix-16 digit above 8; {differ_k1} rows "
              f"whose bit differs from K1's, all of them overflow rows); "
              f"K5 {ms:.4f} ms, K1 {k1_ms:.4f} ms on the same rows, both "
              f"four lanes a row on one row function, K5/K1 "
              f"{ms / k1_ms:.3f}: radix 16 against radix 32; plain "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{macs} 32x32->64 multiply-adds of the function; the kernel "
              f"executes {executed}, {executed / macs:.4f}x)")
        check(differ_k1 <= overflow, f"B={b}: K5 and K1 differ on rows "
              "that do not overflow")
    print(f"[radix-sweep] K5 entry function: {build['ptxas']}; "
          f"{build['lanes_per_row']} lanes a row")
    return per_batch, compared, err, launches


def phase_sharded(dev, k1_ops, k1_times):
    """K4 over every visible card (at B = 2,048) and over the card named
    SPLIT times (at each bucket), on phase 6's rows: the calls counted,
    then equal to K1 on every row, and timed beside K1."""
    cards = mesh.batch_devices()
    layouts = [("every card", cards, KERNEL_BATCHES[0])] + [
        (f"card x {SPLIT}", [dev] * SPLIT, b) for b in KERNEL_BATCHES]
    layouts = [(label, devs, b) for label, devs, b in layouts
               if b % len(devs) == 0]
    vk.verify_kernel_sharded.launches = 0
    outs = [vk.verify_kernel_sharded(devs)(*k1_ops[b])
            for _label, devs, b in layouts]
    torch.cuda.synchronize()
    launches = vk.verify_kernel_sharded.launches
    check(launches == len(layouts), f"K4 counted {launches} calls, not "
          f"{len(layouts)}")
    per_batch, compared = {}, 0
    for (label, devs, b), got in zip(layouts, outs):
        ops = k1_ops[b]
        want = vk.verify_kernel(*ops)
        torch.cuda.synchronize()
        bad = int((got.to(want.device) != want).sum())
        check(bad == 0, f"K4 over {label} differs from K1 on {bad} rows "
              f"at B={b}")
        compared += b
        fn = vk.verify_kernel_sharded(devs)
        ms = _event_ms(lambda: fn(*ops), KERNEL_REPS)
        k1 = k1_times[str(b)]
        key = f"{label}:{b}"
        per_batch[key] = {
            "ms": ms, "k1_ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "devices": len(devs), "rows_true": int(got.sum())}
        print(f"[sharded] {key}: K4 over {len(devs)} device entries = K1 "
              f"on every row; K4 {ms:.4f} ms, K1 {k1['ms']:.4f} ms "
              f"(one launch), bound {k1['bound_ms']:.4f} ms")
    return per_batch, compared, launches


def phase_split(dev, txset_items, txset_want):
    """The TxSet on a verifier over the card named SPLIT times: cold
    (cache off) and hot (cache on, from empty); every index serves,
    verdicts equal the oracle, nothing fails over."""
    v = BatchVerifier(devices=[dev] * SPLIT,
                      bucket_sizes=DEFAULT_BUCKET_SIZES)
    res = {}
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    for mode in ("cold", "hot"):
        signer_table_cache._reset_for_testing()
        signer_table_cache.configure(enabled=mode == "hot")
        t = time.perf_counter()
        got = v.verify_batch(txset_items)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        check(np.array_equal(got, txset_want), f"split {mode} TxSet: "
              "first call differs from the oracle")
        served0 = dict(v.device_served)
        hot0 = v.served["hot"]
        times = []
        mark = transfer_mark([v])
        for _ in range(TIMED_CALLS):
            t = time.perf_counter()
            out = v.verify_batch(txset_items)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            check(np.array_equal(out, txset_want), f"split {mode} TxSet: "
                  "a timed call differs from the oracle")
        transfer = transfer_view(mark, [v], TIMED_CALLS, f"split {mode}")
        per_index = {i: v.device_served.get(i, 0) - served0.get(i, 0)
                     for i in range(SPLIT)}
        check(all(n > 0 for n in per_index.values()),
              f"split {mode} TxSet: an index served nothing: {per_index}")
        hot_rows = (v.served["hot"] - hot0) // TIMED_CALLS
        check(hot_rows == (cacheable_rows(txset_items) if mode == "hot"
                           else 0), f"split {mode} TxSet: {hot_rows} rows "
              "hot a call")
        res[mode] = {"first_ms": first_ms,
                     "p50_ms": float(np.percentile(times, 50)),
                     "p90_ms": float(np.percentile(times, 90)),
                     "hot_rows_per_call": hot_rows,
                     "transfer": transfer["per_call"],
                     "rows_per_index_per_call": {
                         str(i): n // TIMED_CALLS
                         for i, n in per_index.items()}}
    k1, k2 = vk.verify_kernel.launches, vk.verify_kernel_hot.launches
    check(k1 > 0 and k2 > 0, f"the split path launched K1 {k1} and K2 {k2} "
          "times")
    res["launches"] = {"verify_cold": k1, "verify_hot": k2}
    audited = check_dispatch_clean([v], "split TxSet")
    signer_table_cache._reset_for_testing()
    print(f"[split] TxSet on {SPLIT} indices of one card: cold p50 "
          f"{res['cold']['p50_ms']:.3f} ms, p90 {res['cold']['p90_ms']:.3f} "
          f"ms; hot p50 {res['hot']['p50_ms']:.3f} ms, p90 "
          f"{res['hot']['p90_ms']:.3f} ms (first call "
          f"{res['hot']['first_ms']:.1f} ms); rows per index per call "
          f"{res['cold']['rows_per_index_per_call']}; K1 {k1} and K2 {k2} "
          f"launches; no device fault, {audited} parts audited clean")
    return res, v


def _host_oracle_parts(items):
    """The host oracle's cost, part by part, on the first gate-passing
    rows of ``items``: the policy gate, then the native batch at the
    thread count it picks and on one thread, for an audit of each of
    ``AUDIT_ROWS``. Median of 20 calls each, ms."""
    def med(fn):
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    passing = [it for it in items if ref._policy_gate(it[0], it[2])]
    out = {}
    for n in AUDIT_ROWS:
        rows = passing[:n]
        cols = [list(c) for c in zip(*rows)]
        rec = {"rows": len(rows),
               "gate_ms": med(lambda: [ref._policy_gate(pk, sig)
                                       for pk, _m, sig in rows]),
               "host_verify_ms": med(lambda: native_verify.host_verify(
                   rows))}
        if native_verify.available():
            # the C++ batch runs min(8, ceil(n / 32)) threads
            rec["threads"] = 1 if len(rows) < 32 else \
                min(8, -(-len(rows) // 32))
            rec["eq_ms"] = med(lambda: native_verify.verify_eq_batch(*cols))
            rec["eq_1_thread_ms"] = med(
                lambda: native_verify.verify_eq_batch(*cols, nthreads=1))
            rec["us_per_verify_1_thread"] = \
                rec["eq_1_thread_ms"] * 1e3 / len(rows)
            # the same rows as 8 slices on 8 Python threads (each slice
            # runs one C++ thread; ctypes drops the GIL): does the oracle
            # scale over threads at a TxSet audit's size?
            k = -(-len(rows) // 8)
            slices = [[c[i:i + k] for c in cols]
                      for i in range(0, len(rows), k)]
            with ThreadPoolExecutor(8) as pool:
                rec["eq_8_slices_ms"] = med(lambda: list(pool.map(
                    lambda sl: native_verify.verify_eq_batch(*sl), slices)))
        out[str(n)] = rec
    return out


def phase_audit_cost(items, want):
    """The cold TxSet on the default verifier at the audit rate 0.02 and
    at 0, in turns (0.02, 0, 0, 0.02), 10 calls each, and the host
    oracle's cost part by part."""
    signer_table_cache.configure(enabled=False)
    v = default_verifier()
    rate0 = batch_engine.AUDIT_RATE
    times = {0.02: [], 0.0: []}
    try:
        for rate in (0.02, 0.0, 0.0, 0.02):
            batch_engine.configure_dispatch(audit_rate=rate)
            for _ in range(TIMED_CALLS // 2):
                t = time.perf_counter()
                out = v.verify_batch(items)
                torch.cuda.synchronize()
                times[rate].append((time.perf_counter() - t) * 1e3)
                check(np.array_equal(out, want), "audit-cost TxSet call "
                      "differs from the oracle")
    finally:
        batch_engine.configure_dispatch(audit_rate=rate0)
    check_dispatch_clean([v], "audit cost")
    res = {"backend": native_verify.backend(),
           "p50_ms_rate_0.02": float(np.percentile(times[0.02], 50)),
           "p50_ms_rate_0": float(np.percentile(times[0.0], 50)),
           "host_oracle": _host_oracle_parts(items)}
    print(f"[audit] cold TxSet p50 at audit rate 0.02 "
          f"{res['p50_ms_rate_0.02']:.3f} ms, at 0 "
          f"{res['p50_ms_rate_0']:.3f} ms ({TIMED_CALLS} calls each, in "
          f"turns; the sample's host verdicts are computed at dispatch, "
          f"while the card works); host oracle backend {res['backend']}; "
          f"its parts: {json.dumps(res['host_oracle'])}")
    return res


def _add_totals(acc, before, after):
    """Add the ``span_totals`` deltas between ``before`` and ``after`` to
    ``acc``, a pair of totals (``acc[1] - acc[0]`` is the sum of the
    deltas), for :func:`engine_phases`."""
    for name, a in after.items():
        b = before.get(name, {"count": 0, "sum_ms": 0.0})
        acc[0].setdefault(name, {"count": 0, "sum_ms": 0.0})
        tot = acc[1].setdefault(name, {"count": 0, "sum_ms": 0.0})
        tot["count"] += a["count"] - b["count"]
        tot["sum_ms"] += a["sum_ms"] - b["sum_ms"]


def _fingerprint_ms(arr):
    """Median ms of :func:`residency.fingerprint` over one host operand."""
    return float(np.median(timed_ms(lambda: residency.fingerprint(arr),
                                    FINGERPRINT_REPS)))


def _copy_ms(dev, hosts):
    """Median over ``COPY_REPS`` of the copies of pinned ``hosts`` to
    ``dev`` as the engine issues them (``non_blocking``), ms: CUDA events
    around the copies, and the host's wall time to issue them and
    synchronise."""
    card, wall = [], []
    for _ in range(COPY_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        for h in hosts:
            h.to(dev, non_blocking=True)
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        card.append(start.elapsed_time(end))
    return float(np.median(card)), float(np.median(wall))


def _pinned(arr):
    host = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                       pin_memory=True)
    host.numpy()[:] = arr
    return host


def phase_transfer_cost(dev, rng, items, want):
    """The cost of the transfer ledger and the resident cache. The
    default verifier runs four modes in turns, TRANSFER_CALLS timed calls
    each after one untimed call, TRANSFER_TURNS times: the cold TxSet
    with the resident cache on and the items repeated (4 resident hits a
    call: the one mode whose traffic the cache serves), with the cache on
    and fresh content every call (the items rotated by a new offset:
    every operand's bytes new, 4 copies), with the cache off (the
    default, as the main-path phases run: 4 copies, redundant), with the
    cache off and both fingerprint caps at 0 (the ledger counting bytes
    only, no SHA-256: what the ledger's fingerprint costs end to end),
    and a hot TxSet repeat with the cache off (the table operand counted
    bytes-only). Each mode's ledger deltas are
    checked a turn. Then the fingerprint alone a call and an operand (and
    of the hasher's 1 MiB words operand at its 2,048 bucket), the four
    cold copies a hit saves and the hot table operand's copy by CUDA
    events, with its GB/s; last one cold call's Chrome trace written
    under ``build/`` and a few lines of the Prometheus text."""
    v = default_verifier()
    n = len(items)
    times = {m: [] for m in TRANSFER_MODES}
    per_turn = {m: [] for m in TRANSFER_MODES}
    # each mode's engine phases, summed over its turns
    spans = {m: [{}, {}] for m in TRANSFER_MODES}
    offsets = iter(range(1, n))

    def call(mode):
        its, exp = items, want
        if mode == "fresh":
            k = next(offsets)
            its, exp = items[k:] + items[:k], np.roll(want, -k)
        t = time.perf_counter()
        out = v.verify_batch(its)
        torch.cuda.synchronize()
        check(np.array_equal(out, exp), f"transfer cost, {mode}: a call "
              "differs from the oracle")
        return (time.perf_counter() - t) * 1e3

    expect = {
        "repeated": {"bytes_h2d": 0, "resident_hits": 4},
        "fresh": {"bytes_h2d": TXSET_OPERAND_BYTES, "resident_hits": 0},
        "cache_off": {"bytes_h2d": TXSET_OPERAND_BYTES, "resident_hits": 0,
                      "redundant_constant_bytes": TXSET_OPERAND_BYTES},
        "bytes_only": {"bytes_h2d": TXSET_OPERAND_BYTES,
                       "unfingerprinted_uploads": 4,
                       "unfingerprinted_bytes": TXSET_OPERAND_BYTES,
                       "redundant_constant_bytes": 0},
        "hot_repeat": {"unfingerprinted_uploads": 1,
                       "unfingerprinted_bytes": HOT_TABLE_BYTES}}
    # the signer tables, kept across the cold modes' turns (turning the
    # signer-table cache off clears it) and installed again for the hot
    tables = {}
    try:
        for _ in range(TRANSFER_TURNS):
            for mode in TRANSFER_MODES:
                signer_table_cache.configure(enabled=mode == "hot_repeat")
                bytes_only = mode == "bytes_only"
                residency.resident_cache.configure(
                    enabled=mode in ("repeated", "fresh"),
                    max_item_bytes=0 if bytes_only
                    else residency.DEFAULT_MAX_ITEM_BYTES)
                transfer_ledger.configure(
                    fp_max_bytes=0 if bytes_only else DEFAULT_FP_MAX_BYTES)
                if mode == "hot_repeat":
                    for pk, table in tables.items():
                        signer_table_cache.install(pk, table)
                call(mode)  # first sights, or the cache refilled
                if mode == "hot_repeat" and not tables:
                    tables = {pk: signer_table_cache.lookup(pk)
                              for pk, _m, _s in items
                              if signer_table_cache.lookup(pk) is not None}
                mark = transfer_mark([v])
                before = tracing.span_totals()
                times[mode] += [call(mode) for _ in range(TRANSFER_CALLS)]
                _add_totals(spans[mode], before, tracing.span_totals())
                got = transfer_view(mark, [v], TRANSFER_CALLS,
                                    f"transfer-cost {mode}", quiet=True)
                for k, x in expect[mode].items():
                    check(got["total"][k] == x * TRANSFER_CALLS,
                          f"transfer cost, {mode}: {k} "
                          f"{got['total'][k]}, not {x} a call")
                per_turn[mode].append(got["per_call"])
    finally:
        residency.resident_cache.configure(
            enabled=residency.ENABLED,
            max_item_bytes=residency.DEFAULT_MAX_ITEM_BYTES)
        transfer_ledger.configure(fp_max_bytes=DEFAULT_FP_MAX_BYTES)
        signer_table_cache.configure(enabled=False)
    check_dispatch_clean([v], "transfer cost")
    res = {"modes": {m: {"p50_ms": float(np.percentile(times[m], 50)),
                         "p90_ms": float(np.percentile(times[m], 90)),
                         "calls": len(times[m]),
                         "transfer_per_call": per_turn[m][-1],
                         "engine_phases": engine_phases(
                             *spans[m], len(times[m]), "verify",
                             f"transfer-cost {m}")}
                     for m in TRANSFER_MODES}}
    for m, r in res["modes"].items():
        t = r["transfer_per_call"]
        print(f"[transfer-cost] {m}: p50 {r['p50_ms']:.3f} ms, p90 "
              f"{r['p90_ms']:.3f} ms over {r['calls']} calls in "
              f"{TRANSFER_TURNS} turns; a call: h2d {t['bytes_h2d']:g} B, "
              f"resident hits {t['resident_hits']:g} "
              f"({t['resident_bytes']:g} B), unfingerprinted "
              f"{t['unfingerprinted_uploads']:g} "
              f"({t['unfingerprinted_bytes']:g} B), redundant "
              f"{t['redundant_constant_bytes']:g} B, d2h "
              f"{t['bytes_d2h']:g} B, round trips {t['round_trips']:g}")
    # the fingerprint alone, on the cold TxSet call's padded operands
    wl = Ed25519Workload()
    _, enc = wl.encode(items)
    ops = [np.concatenate([e, np.repeat(p, KERNEL_BATCHES[0] - len(e), 0)])
           for e, p in zip(enc, wl.pad_rows())]
    fp_ops = [_fingerprint_ms(a) for a in ops]
    words, _active, _fits = sk.pack_messages(
        hash_messages(rng, HASH_MSGS)[0], MAX_BLOCKS)
    check(words.nbytes == residency.DEFAULT_MAX_ITEM_BYTES and
          residency.fingerprint(words) is not None, "the hasher's words "
          "operand is not exactly at the cap, fingerprinted")
    res["fingerprint"] = {"per_operand_ms": fp_ops,
                          "per_call_ms": float(sum(fp_ops)),
                          "operand_bytes": int(ops[0].nbytes),
                          "hash_words_1mib_ms": _fingerprint_ms(words)}
    copy4_card, copy4_wall = _copy_ms(dev, [_pinned(a) for a in ops])
    table = _pinned(rng.integers(-2 ** 12, 2 ** 12, size=(
        KERNEL_BATCHES[0], 128, 3, 20), dtype=np.int16))
    check(table.numpy().nbytes == HOT_TABLE_BYTES, "table operand size")
    table_card, table_wall = _copy_ms(dev, [table])
    res["copies"] = {"cold_four_card_ms": copy4_card,
                     "cold_four_wall_ms": copy4_wall,
                     "hot_table_card_ms": table_card,
                     "hot_table_wall_ms": table_wall,
                     "hot_table_gb_s": HOT_TABLE_BYTES / table_card / 1e6}
    f = res["fingerprint"]
    c = res["copies"]
    print(f"[transfer-cost] fingerprint alone (SHA-256 of the host rows): "
          f"{f['per_call_ms']:.4f} ms a cold TxSet call, "
          + " / ".join(f"{x:.4f}" for x in fp_ops)
          + f" ms an operand of {f['operand_bytes']} B; the hasher's 1 MiB "
          f"words operand {f['hash_words_1mib_ms']:.4f} ms. The four cold "
          f"copies a hit saves: {copy4_card:.4f} ms on the card, "
          f"{copy4_wall:.4f} ms host wall to issue and synchronise. The hot "
          f"table operand ({HOT_TABLE_BYTES} B, pinned): "
          f"{table_card:.4f} ms by CUDA events, "
          f"{c['hot_table_gb_s']:.2f} GB/s ({table_wall:.4f} ms wall)")
    # one cold call's Chrome trace and the Prometheus text
    signer_table_cache.configure(enabled=False)
    tracing.flight_recorder.clear()
    pipeline_timeline._reset_for_testing()
    check(np.array_equal(v.verify_batch(items), want), "the traced call "
          "differs from the oracle")
    trace = tracing.flight_recorder.to_chrome_trace()
    events = trace["traceEvents"]
    kinds = collections.Counter(e["ph"] for e in events)
    check(any(e["name"] == "span.verify.blocking" and e["ph"] == "B"
              for e in events) and
          any(e["name"] == "transfer.bytes" for e in events),
          "the Chrome trace lacks the call's root span or its transfer "
          "counter")
    os.makedirs(os.path.dirname(CHROME_TRACE), exist_ok=True)
    with open(CHROME_TRACE, "w") as fh:
        json.dump(trace, fh)
    prom = [line for line in registry.to_prometheus().splitlines()
            if line.startswith(("crypto_transfer_", "crypto_resident_hits",
                                'span_verify_blocking_ms{'))]
    res["chrome_trace"] = {"path": os.path.relpath(CHROME_TRACE),
                           "events": len(events), "by_phase": dict(kinds)}
    print(f"[transfer-cost] one cold TxSet call's Chrome trace: "
          f"{len(events)} events {dict(kinds)}, written to "
          f"{res['chrome_trace']['path']}; Prometheus text, "
          f"{len(prom)} lines of the ledger and the root span:")
    for line in prom:
        print(f"[transfer-cost]   {line}")
    return res


def _stalled_call(v, items, want, label, limit_s):
    """Queue a spin of STALL_S on the card's current stream, then call
    ``v.verify_batch(items)``: it must raise within ``limit_s`` of wall
    time, while the spin still runs, every index charged once by a missed
    deadline and a ``watchdog-timeout`` dump holding the open
    ``verify.fetch`` span. Then, after the spin and the abandoned
    fetches' late completions, no count has moved, and the next call
    equals the oracle with every breaker closed. Returns the record."""
    n_idx = len(v.devices or [v.device])
    dumps0 = tracing.flight_recorder.stats()["dumps_total"]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(STALL_S * SLEEP_CYCLES_PER_S))
    spin = torch.cuda.Event()
    spin.record()
    t = time.perf_counter()
    try:
        v.verify_batch(items)
    except RuntimeError as e:
        raised_s = time.perf_counter() - t
        spinning = not spin.query()
        err = e
    else:
        raise PhaseFailed(f"{label}: the call did not raise behind a "
                          f"{STALL_S} s spin")
    check(spinning, f"{label}: the spin had ended when the call raised "
          f"({raised_s:.3f} s)")
    check(raised_s <= limit_s, f"{label}: raised after {raised_s:.3f} s, "
          f"over {limit_s} s")
    check(isinstance(err.__cause__, resilience.DeadlineExceeded),
          f"{label}: the raise is not a missed deadline: {err!r}")
    failures = {i: d["consecutive_failures"]
                for i, d in v.health.snapshot()["devices"].items()}
    check(v.deadline_misses == n_idx and
          failures == {str(i): 1 for i in range(n_idx)},
          f"{label}: {v.deadline_misses} deadline misses, failures "
          f"{failures}, not one an index")
    new_dumps = tracing.flight_recorder.dumps()[
        -(tracing.flight_recorder.stats()["dumps_total"] - dumps0):]
    reasons = [d["reason"] for d in new_dumps]
    check(reasons == [f"watchdog-timeout:device{i}" for i in range(n_idx)],
          f"{label}: dumps {reasons}")
    open_names = [r["name"] for r in new_dumps[0]["open_spans"]]
    check("span.verify.fetch" in open_names and
          "span.verify.fetch.device" in open_names,
          f"{label}: the dump's open spans are {open_names}")
    counts = (dict(v.served), v.deadline_misses, v.retries,
              v.audit_mismatches, len(v.audit_verdicts),
              pipeline_timeline.totals(), transfer_ledger.totals(),
              v.fetched_bytes)
    torch.cuda.synchronize()
    spin_end_s = time.perf_counter() - t
    time.sleep(0.5)  # the abandoned fetches finish meanwhile
    check(counts == (dict(v.served), v.deadline_misses, v.retries,
                     v.audit_mismatches, len(v.audit_verdicts),
                     pipeline_timeline.totals(), transfer_ledger.totals(),
                     v.fetched_bytes),
          f"{label}: a late completion moved a count (the transfer "
          "ledger's included)")
    time.sleep(max(v.health.breaker(i).seconds_until_retry()
                   for i in range(n_idx)))
    got = v.verify_batch(items)
    torch.cuda.synchronize()
    check(np.array_equal(got, want), f"{label}: the call after the stall "
          "differs from the oracle")
    states = {i: (d["state"], d["consecutive_failures"])
              for i, d in v.health.snapshot()["devices"].items()}
    check(all(st == (resilience.CLOSED, 0) for st in states.values()),
          f"{label}: breakers not closed after the stall: {states}")
    print(f"[deadline] {label}: raised after {raised_s:.3f} s (limit "
          f"{limit_s} s) with the {STALL_S} s spin still running "
          f"(it ended {spin_end_s:.3f} s into the call); {n_idx} deadline "
          f"misses, each index charged once; dumps {reasons}; after the "
          f"spin no count moved, and the next call equals the oracle with "
          f"every breaker closed")
    return {"raised_s": raised_s, "limit_s": limit_s,
            "spin_end_s": spin_end_s, "deadline_misses": v.deadline_misses,
            "dumps": reasons}


def phase_deadline(dev, items, want):
    """The resolve's deadline on the card, cache off, deadline
    DEADLINE_PHASE_MS: a one-card verifier and one over the card named
    SPLIT times, each called behind a spin (``_stalled_call``). The split's
    indices share one stream, so the moved part waits behind the same
    spin: each index misses in turn, then the call raises. Returns the
    records and K1's launches over the phase."""
    signer_table_cache.configure(enabled=False)
    deadline0 = batch_engine.DEADLINE_MS
    vk.verify_kernel.launches = 0
    out = {}
    try:
        batch_engine.configure_dispatch(deadline_ms=DEADLINE_PHASE_MS)
        out["one_card"] = _stalled_call(
            BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES),
            items, want, "one card", RAISE_ONE_S)
        out["split"] = _stalled_call(
            BatchVerifier(devices=[dev] * SPLIT,
                          bucket_sizes=DEFAULT_BUCKET_SIZES),
            items, want, f"card x {SPLIT}",
            SPLIT * DEADLINE_PHASE_MS / 1000 + RAISE_SLACK_S)
    finally:
        batch_engine.configure_dispatch(deadline_ms=deadline0)
    out["launches"] = vk.verify_kernel.launches
    return out


def phase_probe():
    """The device probe on the card: True from a fresh state; under a
    probe hang False within PROBE_ANSWER_S, charged to the probe's
    breaker, and a non-blocking ask answers at once and caches nothing;
    after ``faults.clear()`` and the backoff, True again."""
    batch_engine._reset_dispatch_state_for_testing()
    t = time.perf_counter()
    check(batch_engine.device_available(), "the probe found no card")
    probe_s = time.perf_counter() - t
    batch_engine._reset_dispatch_state_for_testing()
    faults.set_fault(faults.PROBE, "hang", PROBE_HANG_S)
    try:
        t = time.perf_counter()
        hung = batch_engine.device_available(timeout_s=PROBE_TIMEOUT_S)
        hung_s = time.perf_counter() - t
        check(not hung and hung_s <= PROBE_ANSWER_S, f"probe hang: "
              f"answered {hung} after {hung_s:.3f} s")
        check(batch_engine._device_state == "dead" and
              batch_engine._probe_breaker.snapshot()[
                  "consecutive_failures"] == 1,
              "probe hang: not accounted dead and charged")
        t = time.perf_counter()
        pending = batch_engine.device_available(timeout_s=PROBE_TIMEOUT_S,
                                                block=False)
        pending_s = time.perf_counter() - t
        check(not pending and pending_s < PROBE_TIMEOUT_S and
              batch_engine._device_state == "dead",
              "probe hang: a non-blocking ask waited or cached a verdict")
    finally:
        faults.clear()
    time.sleep(batch_engine._probe_breaker.seconds_until_retry())
    t = time.perf_counter()
    healed = batch_engine.device_available()
    healed_s = time.perf_counter() - t
    check(healed and batch_engine._device_state == "cuda",
          "the probe did not heal after the fault cleared")
    res = {"probe_s": probe_s, "hung_answer_s": hung_s,
           "pending_answer_s": pending_s, "healed_s": healed_s}
    print(f"[probe] device_available() True in {probe_s:.3f} s; under a "
          f"{PROBE_HANG_S} s probe hang False in {hung_s:.3f} s (limit "
          f"{PROBE_ANSWER_S} s, timeout {PROBE_TIMEOUT_S} s), accounted "
          f"dead; a non-blocking ask False in {pending_s * 1e3:.2f} ms, "
          f"nothing cached; after the fault cleared True again in "
          f"{healed_s:.3f} s (it waits out the hung attempt)")
    return res


class _Gated:
    """A verifier whose resolvers wait on ``gate`` before resolving: the
    replicas' dispatchers hold still until every arrival is admitted."""

    def __init__(self, verifier, gate):
        self.verifier, self.gate, self.calls = verifier, gate, 0

    def submit(self, items, trace_ids=None):
        self.calls += 1
        resolve = self.verifier.submit(items, trace_ids=trace_ids)

        def resolver():
            if not self.gate.wait(60):
                raise RuntimeError("the replicas' gate never opened")
            return resolve()
        return resolver


def _outcomes(tickets, want):
    """Each ticket's outcome: its verdicts (checked against ``want``, the
    oracle's rows for its items) or its Overloaded's kind, lane, reason
    and tenant."""
    out = []
    for tkt, rows in tickets:
        try:
            got = tkt.result(timeout=60)
        except verify_service.Overloaded as e:
            out.append((e.kind, e.lane, e.reason, e.tenant))
            continue
        check(np.array_equal(got, want[rows]), f"a {tkt.lane} ticket's "
              "verdicts differ from the oracle")
        out.append("verified")
    return out


def _flight_since(name):
    """The flight recorder's records from the last note ``name`` on
    (``flight_recorder.note(name)``), by start; fails when the ring no
    longer holds the note (records lost)."""
    cap = tracing.flight_recorder.stats()["capacity"]
    recs = tracing.flight_recorder.snapshot(limit=cap)["recent"]
    marks = [r["start_ms"] for r in recs if r["name"] == name]
    check(marks, f"the flight recorder's ring lost the mark {name}")
    return sorted((r for r in recs if r["start_ms"] >= marks[-1]),
                  key=lambda r: (r["start_ms"], r["id"]))


def _service_trace(recs):
    """From the flight recorder's records of one run: each submission's
    wait, its ``service.enqueue`` event to the ``service.verdict`` event
    that holds its first trace id, by lane (ms); and the dispatcher's
    ``service.dispatch`` and ``service.resolve`` spans in order, each
    with its lane, items, start (ms after the first record) and ms."""
    t0 = recs[0]["start_ms"]
    enq = sorted((r["attrs"]["traces"][0][0], r["start_ms"],
                  r["attrs"]["lane"]) for r in recs
                 if r["name"] == "service.enqueue")
    los = [e[0] for e in enq]
    waits = {ln: [] for ln in verify_service.LANES}
    for r in recs:
        if r["name"] != "service.verdict":
            continue
        for lo, hi in r["attrs"]["traces"]:
            i = bisect.bisect_left(los, lo)
            while i < len(los) and los[i] < hi:
                waits[enq[i][2]].append(r["start_ms"] - enq[i][1])
                i += 1
    spans = [{"span": r["name"].rsplit(".", 1)[1],
              "lane": r["attrs"]["lane"], "items": r["attrs"].get("items"),
              "at_ms": round(r["start_ms"] - t0, 3), "ms": r["dur_ms"]}
             for r in recs
             if r["name"] in ("span.service.dispatch", "span.service.resolve")]
    return waits, spans


def _wait_quantiles(waits):
    return {ln: {f"p{q}": round(float(np.percentile(w, q)), 3)
                 for q in (50, 90, 99)} for ln, w in waits.items() if w}


def _service_lanes(v, lanes, want, label, lead=None):
    """One started service on ``v`` fed ``lanes`` ((lane, subs) pairs),
    a thread a lane; with ``lead``, that lane's submissions are all
    queued first, and the other threads then submit theirs in bursts of
    ``STEADY_BURST``, ``STEADY_GAP_S`` apart.
    Every verdict equals the oracle, nothing is shed, rejected or failed,
    the conservation gap is 0, and every submission's wait is found in
    the flight recorder. Returns the run's numbers, the flight recorder's
    waits (ms by lane) and the dispatcher's spans."""
    svc = verify_service.VerifyService(verifier=v).start()
    tickets = {ln: [] for ln, _subs in lanes}

    def submit(lane, subs, burst):
        for k, rows in enumerate(subs, 1):
            tickets[lane].append(
                (svc.submit([want["items"][i] for i in rows], lane=lane),
                 rows))
            if burst and k % burst == 0:
                time.sleep(STEADY_GAP_S)

    mark = f"smoke.service.{label}"
    k1, k2 = vk.verify_kernel.launches, vk.verify_kernel_hot.launches
    tracing.flight_recorder.note(mark)
    t = time.perf_counter()
    rest = [(ln, subs) for ln, subs in lanes if ln != lead]
    if lead is not None:
        submit(lead, dict(lanes)[lead], 0)
    with ThreadPoolExecutor(len(rest)) as pool:
        for f in [pool.submit(submit, ln, subs, STEADY_BURST if lead else 0)
                  for ln, subs in rest]:
            f.result()
    outcomes = {ln: _outcomes(tickets[ln], want["ok"]) for ln, _ in lanes}
    wall_s = time.perf_counter() - t
    torch.cuda.synchronize()
    snap = svc.snapshot()
    svc.stop(drain=True, timeout=30)
    recs = _flight_since(mark)
    waits, spans = _service_trace(recs)
    k1 = vk.verify_kernel.launches - k1
    k2 = vk.verify_kernel_hot.launches - k2
    sigs = sum(len(r) for _ln, subs in lanes for r in subs)
    tot = snap["totals"]
    check(all(o == "verified" for os_ in outcomes.values() for o in os_),
          f"service ({label}): a ticket was not verified")
    check(snap["conservation_gap"] == 0 and tot["verified"] == sigs and
          tot["shed"] == tot["rejected"] == tot["failed"] == 0,
          f"service ({label}): totals {tot}, gap "
          f"{snap['conservation_gap']}")
    check(all(len(waits[ln]) == len(subs) for ln, subs in lanes) and
          sum(sp["span"] == "dispatch" for sp in spans) == snap["batches"],
          f"service ({label}): the flight recorder holds "
          f"{ {ln: len(w) for ln, w in waits.items()} } waits and "
          f"{len(spans)} dispatcher spans for {snap['batches']} dispatches")
    check_dispatch_clean([v], f"service ({label})")
    return {"wall_s": wall_s, "sigs": sigs, "sigs_per_s": sigs / wall_s,
            "dispatches": snap["batches"],
            "items_per_dispatch": sigs / snap["batches"],
            "launches": {"verify_cold": k1, "verify_hot": k2},
            "trace_wait_ms": _wait_quantiles(waits),
            "recorder_records": len(recs)}, waits, spans


def _service_mixed(dev, scp_subs, auth_subs, bulk_subs, steady_subs, want):
    """(a): three threads submit the scp, auth and bulk lanes at once to
    one started service on a one-card verifier, every signer a first
    sight: every verdict equals the oracle, nothing shed, rejected or
    failed, the conservation gap 0, and K1 and K2 launched. Then the
    steady pass, every signer's table built: the bulk backlog
    ``steady_subs`` queued first, scp and auth arriving in bursts while
    it drains; the same checks, and scp's wait p99 under
    bulk's wait p50 (the lanes' priority). Each pass's waits and the
    dispatcher's spans are read from the flight recorder."""
    v = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    res, _waits, spans = _service_lanes(
        v, (("scp", scp_subs), ("auth", auth_subs), ("bulk", bulk_subs)),
        want, "a")
    k1, k2 = res["launches"]["verify_cold"], res["launches"]["verify_hot"]
    check(k1 > 0 and k2 > 0, f"service (a): K1 launched {k1} and K2 {k2} "
          "times")
    lat = verify_service.lane_latencies()
    sigs = res["sigs"]
    res["lane_latency_ms"] = {ln: {q: lat[ln][f"{q}_ms"]
                                   for q in ("p50", "p90", "p99")}
                              for ln in verify_service.LANES}
    res["dispatcher_spans"] = spans
    print(f"[service] (a) mixed lanes: {sigs} sigs ({len(scp_subs)} scp x "
          f"{SCP_SIGS}, {len(auth_subs)} auth x 1, {len(bulk_subs)} bulk x "
          f"{len(bulk_subs[0])}) from 3 threads in {res['wall_s']:.3f} s, "
          f"{res['sigs_per_s']:.0f} sigs/s; {res['dispatches']} dispatches, "
          f"{res['items_per_dispatch']:.1f} items a dispatch; K1 {k1}, K2 "
          f"{k2} launches; every verdict equal to the oracle, nothing shed, "
          f"rejected or failed, conservation gap 0")
    for ln in verify_service.LANES:
        print(f"[service] (a) {ln} lane wait p50 {lat[ln]['p50_ms']} ms, "
              f"p90 {lat[ln]['p90_ms']} ms, p99 {lat[ln]['p99_ms']} ms over "
              f"{lat[ln]['count']} submissions (flight recorder: "
              f"{res['trace_wait_ms'][ln]})")
    print("[service] (a) dispatcher spans (flight recorder, s after the "
          "first submit): " + "; ".join(
              f"{sp['span']} {sp['lane']}"
              + (f" {sp['items']} items" if sp["items"] else "")
              + f" at {sp['at_ms'] / 1e3:.3f} for {sp['ms'] / 1e3:.3f}"
              for sp in spans))
    steady, waits, spans = _service_lanes(
        v, (("bulk", steady_subs), ("scp", scp_subs), ("auth", auth_subs)),
        want, "a-steady", lead="bulk")
    q = steady["trace_wait_ms"]
    check(q["scp"]["p99"] < q["bulk"]["p50"],
          f"service (a, steady): scp wait p99 {q['scp']['p99']} ms is not "
          f"under bulk's p50 {q['bulk']['p50']} ms")
    by_lane = {}
    for sp in spans:
        d = by_lane.setdefault(f"{sp['span']} {sp['lane']}", [])
        d.append(sp["ms"])
    steady["dispatcher_ms"] = {
        k: {"n": len(d), "sum": round(sum(d), 3),
            "p50": round(float(np.median(d)), 3), "max": max(d)}
        for k, d in by_lane.items()}
    res["steady"] = steady
    print(f"[service] (a) steady pass, every table built: {len(steady_subs)} "
          f"bulk x {len(steady_subs[0])} queued first, then {len(scp_subs)} "
          f"scp and {len(auth_subs)} auth submissions in bursts of "
          f"{STEADY_BURST} {STEADY_GAP_S * 1e3:g} ms apart: {steady['sigs']} sigs in {steady['wall_s']:.3f} s, "
          f"{steady['sigs_per_s']:.0f} sigs/s; {steady['dispatches']} "
          f"dispatches, {steady['items_per_dispatch']:.1f} items a dispatch; "
          f"K1 {steady['launches']['verify_cold']}, K2 "
          f"{steady['launches']['verify_hot']} launches; every verdict equal "
          f"to the oracle, nothing shed, rejected or failed, conservation "
          f"gap 0; waits (flight recorder, {steady['recorder_records']} "
          f"records) {q}: scp p99 under bulk p50; dispatcher spans ms "
          f"{steady['dispatcher_ms']}")
    return res


def _replica_run(svc, gated, arrivals, want):
    """Park the replica's dispatcher (one scp submission, its resolver
    held by the gate), then feed the arrivals; returns the tickets and
    the ingress refusals."""
    park = [0]
    tickets = [(svc.submit([want["items"][0]], lane="scp"), park)]
    deadline = time.monotonic() + 10
    while not (gated.calls == 1 and svc.snapshot()["lanes"]["scp"][
            "queued_submissions"] == 0):
        check(time.monotonic() < deadline, "service (b): a replica's "
              "dispatcher never parked")
        time.sleep(0.002)
    refusals = []
    for lane, who, rows in arrivals:
        try:
            tickets.append((svc.submit([want["items"][i] for i in rows],
                                       lane=lane, tenant=who), rows))
        except verify_service.Overloaded as e:
            refusals.append((e.kind, e.lane, e.reason, e.tenant))
    return tickets, refusals


def _rebased(journal):
    base = min(r["trace_lo"] for r in journal)
    return [dict(r, trace_lo=r["trace_lo"] - base) for r in journal]


def _service_replicas(dev, scp_subs, bulk_rows, want):
    """(b): two services, each on a one-card verifier of its own, fed one
    arrival order (a flooding tenant over its depth quota, a bulk backlog
    past the high-water mark, scp interleaved) while their resolvers
    wait on one event; the decision logs, journals, tenant snapshots and
    ingress refusals are equal, every verified row equals the oracle and
    no scp item is shed."""
    tenant.clear_tenant_policies()
    tenant.set_tenant_policy("flood", depth=FLOOD_QUOTA)
    arrivals = []
    for k in range(REPLICA_ARRIVALS):
        who = ("flood", "flood", "alpha", "beta")[k % 4]
        lo = (k * REPLICA_BULK_ROWS) % (len(bulk_rows) - REPLICA_BULK_ROWS)
        arrivals.append(("bulk", who, bulk_rows[lo:lo + REPLICA_BULK_ROWS]))
        if k % 4 == 3:
            arrivals.append(("scp", None, scp_subs[k % len(scp_subs)]))
    gate = threading.Event()
    replicas = []
    try:
        for _ in range(2):
            gated = _Gated(BatchVerifier(device=dev,
                                         bucket_sizes=DEFAULT_BUCKET_SIZES),
                           gate)
            svc = verify_service.VerifyService(
                verifier=gated, lane_depth=REPLICA_LANE_DEPTH,
                pipeline_depth=1).start()
            replicas.append((svc,) + _replica_run(svc, gated, arrivals,
                                                  want))
        t = time.perf_counter()
        gate.set()
        outs = [_outcomes(tickets, want["ok"])
                for _svc, tickets, _r in replicas]
        drain_s = time.perf_counter() - t
        for svc, _t, _r in replicas:
            svc.stop(drain=True, timeout=30)
    finally:
        gate.set()
        tenant.clear_tenant_policies()
    views = [{"decisions": svc.decision_log(),
              "journal": _rebased(svc.journal_log()),
              "tenants": svc.tenant_snapshot(), "refusals": refusals,
              "outcomes": out, "snapshot": svc.snapshot()}
             for (svc, _t, refusals), out in zip(replicas, outs)]
    a, b = views
    for key in ("decisions", "journal", "tenants", "refusals", "outcomes"):
        check(a[key] == b[key], f"service (b): the replicas' {key} differ")
    snap = a["snapshot"]
    reasons = collections.Counter(r[2] for r in a["refusals"])
    shed = collections.Counter((o[1], o[3]) for o in a["outcomes"]
                               if o != "verified")
    check(snap["conservation_gap"] == 0 and b["snapshot"][
        "conservation_gap"] == 0, "service (b): conservation gap")
    check(snap["lanes"]["scp"]["shed"] == 0 and
          snap["lanes"]["bulk"]["shed"] > 0,
          f"service (b): shed {shed} (scp must never shed, bulk must)")
    check(reasons["tenant-depth"] > 0 and reasons["queue-depth"] > 0,
          f"service (b): ingress refusals {dict(reasons)}")
    res = {"arrivals": len(arrivals) + 1, "refusals": dict(reasons),
           "shed": {f"{ln}/{who}": n for (ln, who), n in shed.items()},
           "decisions": len(a["decisions"]), "journal_rows": len(a["journal"]),
           "drain_s": drain_s}
    print(f"[service] (b) replicas: {res['arrivals']} arrivals each; "
          f"refused at ingress {dict(reasons)}; shed {res['shed']}; "
          f"{res['decisions']} decisions and {res['journal_rows']} journal "
          f"rows, equal between the two, as are their tenant snapshots and "
          f"refusals; every verified row equal to the oracle; both drained "
          f"in {drain_s:.3f} s after the gate opened")
    return res


def _callers(batcher, items, n):
    """``n`` threads released together, each calling
    ``batcher.verify_sig`` on its item once; returns each result or
    exception with its seconds, and the threads still alive after 10 s."""
    start = threading.Barrier(n)
    out = [None] * n

    def call(i):
        start.wait()
        t = time.perf_counter()
        try:
            r = batcher.verify_sig(*items[i])
        except Exception as e:  # recorded and checked by the caller
            r = e
        out[i] = (r, time.perf_counter() - t)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    return out, sum(th.is_alive() for th in threads)


def _service_trickle(dev, items, ok):
    """(c): TRICKLE_CALLERS callers through one TrickleBatcher (1 ms
    window) on a one-card verifier, verdicts equal to the oracle in fewer
    dispatches than callers; then a window of a second one-card verifier
    under ``fail-device``: every parked caller gets the failure within
    TRICKLE_FAIL_S, none hangs."""
    v = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    tb = TrickleBatcher(v, window_ms=1.0)
    t = time.perf_counter()
    out, alive = _callers(tb, items, TRICKLE_CALLERS)
    wall_s = time.perf_counter() - t
    check(alive == 0, f"service (c): {alive} trickle callers hang")
    got = [r for r, _s in out]
    check(got == [bool(x) for x in ok[:TRICKLE_CALLERS]],
          "service (c): a trickle verdict differs from the oracle")
    check(tb.dispatches < TRICKLE_CALLERS, f"service (c): {tb.dispatches} "
          f"dispatches for {TRICKLE_CALLERS} callers")
    vf = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    tbf = TrickleBatcher(vf, window_ms=TRICKLE_FAIL_WINDOW_MS)
    faults.set_fault(faults.DISPATCH, "fail-device", 0)
    try:
        failed, alive = _callers(tbf, items, TRICKLE_FAIL_CALLERS)
    finally:
        faults.clear()
    check(alive == 0, f"service (c): {alive} callers of the failing "
          "window hang")
    worst = max(s for _r, s in failed)
    check(all(isinstance(r, RuntimeError) and
              isinstance(r.__cause__, faults.FaultInjected)
              for r, _s in failed) and worst <= TRICKLE_FAIL_S,
          f"service (c): the failing window's callers got "
          f"{[type(r).__name__ for r, _s in failed]}, the last after "
          f"{worst:.3f} s")
    res = {"callers": TRICKLE_CALLERS, "dispatches": tb.dispatches,
           "wall_s": wall_s, "fail_callers": TRICKLE_FAIL_CALLERS,
           "fail_dispatches": tbf.dispatches, "fail_worst_s": worst}
    print(f"[service] (c) trickle: {TRICKLE_CALLERS} callers in "
          f"{tb.dispatches} dispatches ({wall_s:.3f} s), verdicts equal to "
          f"the oracle; under fail-device all {TRICKLE_FAIL_CALLERS} callers "
          f"of {tbf.dispatches} failing window(s) raised, the last after "
          f"{worst:.3f} s (limit {TRICKLE_FAIL_S} s)")
    return res


def _service_cache(dev, items, ok):
    """(d): ``keys.batch_verify_into_cache`` on the TxSet with a one-card
    verifier installed, timed; then ``keys.verify_sig`` on each item: all
    cache hits, no K1 or K2 launch, verdicts equal to the oracle; then the
    prefetch timed again after a flush."""
    v = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    keys.flush_verify_cache()
    v.install()
    try:
        t = time.perf_counter()
        keys.batch_verify_into_cache(items)
        torch.cuda.synchronize()
        prefetch_ms = (time.perf_counter() - t) * 1e3
        before = keys.get_verify_cache_stats()
        k1, k2 = vk.verify_kernel.launches, vk.verify_kernel_hot.launches
        t = time.perf_counter()
        got = [keys.verify_sig(*it) for it in items]
        lookups_ms = (time.perf_counter() - t) * 1e3
        after = keys.get_verify_cache_stats()
        backend = keys.get_verifier_backend_name()
        new = (vk.verify_kernel.launches - k1,
               vk.verify_kernel_hot.launches - k2)
        # the same prefetch again from an empty cache, the engine warm
        keys.flush_verify_cache()
        t = time.perf_counter()
        keys.batch_verify_into_cache(items)
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t) * 1e3
    finally:
        keys.set_verifier_backend(None)
        keys.flush_verify_cache()
    check(got == [bool(x) for x in ok], "service (d): a cached verdict "
          "differs from the oracle")
    check(after["hits"] - before["hits"] == len(items) and
          after["misses"] == before["misses"] and new == (0, 0),
          f"service (d): cache {before} -> {after}, new launches {new}")
    res = {"prefetch_ms": prefetch_ms, "prefetch_again_ms": again_ms,
           "lookups_ms": lookups_ms, "backend": backend, "stats": after}
    print(f"[service] (d) node cache: batch_verify_into_cache on "
          f"{len(items)} items {prefetch_ms:.3f} ms on a new verifier "
          f"(backend {backend}), {again_ms:.3f} ms again after a flush; "
          f"verify_sig on each {lookups_ms:.3f} ms, {len(items)} hits, no "
          f"K1 or K2 launch; get_verify_cache_stats() {after}")
    return res


def _service_defaults(items, ok, want, lane_subs):
    """(d), the node's default paths, on the process's
    ``default_verifier()`` (this card): ``keys.batch_verify_into_cache``
    on the TxSet with no backend installed, then ``keys.verify_sig`` on
    each item, all cache hits equal to the oracle; and
    ``verify_service.default_service()`` (``VerifyService()`` with no
    verifier, which builds ``default_verifier()`` at start) on one
    submission a lane of ``lane_subs``, equal to the oracle. Each path's
    K1 and K2 launches are counted; each path must launch one, and the
    default verifier must serve rows on the card in each."""
    dv = default_verifier()
    keys.set_verifier_backend(None)
    keys.flush_verify_cache()

    def launched():
        return (vk.verify_kernel.launches, vk.verify_kernel_hot.launches,
                dv.served["device"])

    try:
        l0 = launched()
        t = time.perf_counter()
        keys.batch_verify_into_cache(items)
        torch.cuda.synchronize()
        prefetch_ms = (time.perf_counter() - t) * 1e3
        l1 = launched()
        before = keys.get_verify_cache_stats()
        got = [keys.verify_sig(*it) for it in items]
        after = keys.get_verify_cache_stats()
        backend = keys.get_verifier_backend_name()
    finally:
        keys.flush_verify_cache()
    check(got == [bool(x) for x in ok], "service (d, default): a cached "
          "verdict differs from the oracle")
    check(after["hits"] - before["hits"] == len(items) and
          after["misses"] == before["misses"],
          f"service (d, default): cache {before} -> {after}")
    svc = verify_service.default_service()
    try:
        for lane, rows in lane_subs:
            check(np.array_equal(
                svc.verify([want["items"][i] for i in rows], lane=lane,
                           timeout=30), want["ok"][rows]),
                f"service (d, default): the {lane} submission differs from "
                "the oracle")
        torch.cuda.synchronize()
        snap = svc.snapshot()
    finally:
        svc.stop(drain=True, timeout=30)
    l2 = launched()
    check(snap["conservation_gap"] == 0 and snap["totals"]["failed"] == 0,
          f"service (d, default): totals {snap['totals']}")
    cache_l = {"verify_cold": l1[0] - l0[0], "verify_hot": l1[1] - l0[1]}
    svc_l = {"verify_cold": l2[0] - l1[0], "verify_hot": l2[1] - l1[1]}
    check(sum(cache_l.values()) > 0 and sum(svc_l.values()) > 0 and
          l1[2] > l0[2] and l2[2] > l1[2],
          f"service (d, default): launches {cache_l} and {svc_l}, the "
          f"default verifier served {l1[2] - l0[2]} and {l2[2] - l1[2]} "
          f"rows")
    check_dispatch_clean([dv], "service (d, default)")
    res = {"prefetch_ms": prefetch_ms, "backend": backend,
           "stats": after, "prefetch_launches": cache_l,
           "service_launches": svc_l}
    print(f"[service] (d) default paths: batch_verify_into_cache with no "
          f"backend ({backend}) on {len(items)} items in "
          f"{prefetch_ms:.3f} ms, launches {cache_l}, then {len(items)} "
          f"verify_sig hits equal to the oracle; default_service() on "
          f"{len(lane_subs)} submissions ("
          f"{', '.join(ln for ln, _r in lane_subs)}) equal to the oracle, "
          f"launches {svc_l}; default_verifier() served rows on the card "
          f"in both")
    return res


def _service_wedged(dev, bulk, scp_sub, want):
    """(e): the service on a one-card verifier at a DEADLINE_PHASE_MS
    deadline, behind a STALL_S spin: the bulk ticket raises within
    RAISE_ONE_S while the spin runs, its items count failed, the
    conservation gap stays 0, and an scp submission after the spin
    verifies equal to the oracle."""
    deadline0 = batch_engine.DEADLINE_MS
    v = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    svc = verify_service.VerifyService(verifier=v).start()
    scp_items = [want["items"][i] for i in scp_sub]
    try:
        batch_engine.configure_dispatch(deadline_ms=DEADLINE_PHASE_MS)
        check(np.array_equal(svc.verify(scp_items, lane="scp", timeout=30),
                             want["ok"][scp_sub]), "service (e): the warm-up "
              "differs from the oracle")
        torch.cuda.synchronize()
        torch.cuda._sleep(int(STALL_S * SLEEP_CYCLES_PER_S))
        spin = torch.cuda.Event()
        spin.record()
        t = time.perf_counter()
        tkt = svc.submit([want["items"][i] for i in bulk], lane="bulk")
        try:
            tkt.result(timeout=5 * STALL_S)
        except RuntimeError as e:
            raised_s = time.perf_counter() - t
            spinning = not spin.query()
            err = e
        else:
            raise PhaseFailed("service (e): the bulk ticket did not raise "
                              "behind the spin")
        check(raised_s <= RAISE_ONE_S and spinning,
              f"service (e): raised after {raised_s:.3f} s (limit "
              f"{RAISE_ONE_S} s), spin running: {spinning}")
        check(isinstance(err.__cause__, resilience.DeadlineExceeded),
              f"service (e): not a missed deadline: {err!r}")
        snap = svc.snapshot()
        check(snap["lanes"]["bulk"]["failed"] == len(bulk) and
              snap["conservation_gap"] == 0,
              f"service (e): bulk {snap['lanes']['bulk']}, gap "
              f"{snap['conservation_gap']}")
        torch.cuda.synchronize()
        spin_end_s = time.perf_counter() - t
        t = time.perf_counter()
        got = svc.verify(scp_items, lane="scp", timeout=30)
        after_ms = (time.perf_counter() - t) * 1e3
        check(np.array_equal(got, want["ok"][scp_sub]), "service (e): the "
              "scp submission after the spin differs from the oracle")
        snap = svc.snapshot()
        check(snap["conservation_gap"] == 0, "service (e): conservation gap")
    finally:
        batch_engine.configure_dispatch(deadline_ms=deadline0)
        svc.stop(drain=True, timeout=30)
    res = {"raised_s": raised_s, "limit_s": RAISE_ONE_S,
           "spin_end_s": spin_end_s, "failed": snap["lanes"]["bulk"]["failed"],
           "scp_after_ms": after_ms}
    print(f"[service] (e) wedged card: the bulk ticket ({len(bulk)} items) "
          f"raised after {raised_s:.3f} s (limit {RAISE_ONE_S} s) with the "
          f"{STALL_S} s spin still running (it ended {spin_end_s:.3f} s in); "
          f"{res['failed']} items failed, conservation gap 0; the scp "
          f"submission after the spin equal to the oracle in "
          f"{after_ms:.3f} ms")
    return res


def service_items(rng, txset_items, txset_want):
    """Phase 18's and 19's arrivals: SCP_SUBS scp submissions of SCP_SIGS
    signatures by VALIDATORS keys, AUTH_SUBS single signatures from fresh
    keys (2% corrupted) and the TxSet in BULK_SUBS bulk submissions, as
    index lists into ``want["items"]``, whose oracle bits are
    ``want["ok"]``."""
    validators = [vectors.keypair(rng) for _ in range(VALIDATORS)]
    scp_items = []
    for k in range(SCP_SUBS * SCP_SIGS):
        seed, pk = validators[k % VALIDATORS]
        msg = rng.bytes(32)
        scp_items.append((pk, msg, ref.sign(seed, msg)))
    auth_items = vectors.valid_items(rng, AUTH_SUBS)
    corrupt(auth_items, rng, CORRUPT_SHARE)
    items = txset_items + scp_items + auth_items
    ok = np.concatenate([txset_want,
                         native_verify.host_verify(scp_items + auth_items)])
    check(ok[len(txset_items):].sum() == len(scp_items) + len(auth_items)
          - max(1, int(AUTH_SUBS * CORRUPT_SHARE)),
          "service: the scp and auth items do not verify as planned")
    n_tx, n_scp = len(txset_items), len(scp_items)
    per = n_tx // BULK_SUBS
    return {"items": items, "ok": ok,
            "scp": [list(range(n_tx + k * SCP_SIGS,
                               n_tx + (k + 1) * SCP_SIGS))
                    for k in range(SCP_SUBS)],
            "auth": [[n_tx + n_scp + k] for k in range(AUTH_SUBS)],
            "bulk": [list(range(k * per, (k + 1) * per))
                     for k in range(BULK_SUBS)]}


def phase_service(dev, rng, txset_items, txset_want, info):
    """Phase 18: the resident verify service on the card, sub-phases (a)
    to (e), the signer-table cache on. K1's and K2's launch counts are set
    to 0 before the phase; (a) must launch both. Returns the records, the
    launches of (a) and of the whole phase, and the arrivals
    (:func:`service_items`)."""
    t0 = time.perf_counter()
    signer_table_cache._reset_for_testing()
    signer_table_cache.configure(enabled=True)
    want = service_items(rng, txset_items, txset_want)
    scp_subs, auth_subs, bulk_subs = want["scp"], want["auth"], want["bulk"]
    n_tx = len(txset_items)
    steady_subs = [[(k * STEADY_BULK_ROWS + j) % n_tx
                    for j in range(STEADY_BULK_ROWS)]
                   for k in range(STEADY_BULK_SUBS)]
    gen_s = time.perf_counter() - t0
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    res = {"card": info["smi"], "generate_s": gen_s}
    try:
        res["mixed"] = _service_mixed(dev, scp_subs, auth_subs, bulk_subs,
                                      steady_subs, want)
        launches_a = dict(res["mixed"]["launches"])
        res["replicas"] = _service_replicas(dev, scp_subs,
                                            list(range(n_tx)), want)
        res["trickle"] = _service_trickle(dev, txset_items, txset_want)
        res["node_cache"] = _service_cache(dev, txset_items, txset_want)
        res["defaults"] = _service_defaults(
            txset_items, txset_want, want,
            (("scp", scp_subs[0]), ("auth", auth_subs[0]),
             ("bulk", bulk_subs[0])))
        res["wedged"] = _service_wedged(
            dev, [i for sub in scp_subs for i in sub][:WEDGED_BULK_ROWS],
            scp_subs[0], want)
    finally:
        signer_table_cache._reset_for_testing()
    launches = {"verify_cold": vk.verify_kernel.launches,
                "verify_hot": vk.verify_kernel_hot.launches}
    res["seconds"] = time.perf_counter() - t0
    print(f"[service] phase done in {res['seconds']:.1f} s (items made in "
          f"{gen_s:.1f} s); K1 {launches['verify_cold']} and K2 "
          f"{launches['verify_hot']} launches over the phase, "
          f"(a) {launches_a}; card {info['smi']}")
    return res, launches_a, launches, want


def _fleet_waits(recs):
    """Each submission's wait in one fleet run, by lane (ms): from the
    first ``service.enqueue`` event of its trace block (the arrival, not a
    handoff's re-admission) to the ``service.verdict`` event that holds
    it."""
    first = {}
    for r in recs:
        if r["name"] == "service.enqueue":
            lo = r["attrs"]["traces"][0][0]
            first.setdefault(lo, (r["start_ms"], r["attrs"]["lane"]))
    los = sorted(first)
    waits = {ln: [] for ln in verify_service.LANES}
    for r in recs:
        if r["name"] != "service.verdict":
            continue
        for lo, hi in r["attrs"]["traces"]:
            i = bisect.bisect_left(los, lo)
            while i < len(los) and los[i] < hi:
                t, ln = first[los[i]]
                waits[ln].append(r["start_ms"] - t)
                i += 1
    return waits


def _block_ends(tickets):
    """The first and last trace ID of each ticket's block. Every record
    the stitch reads (``ingress.frame``, ``fleet.route``,
    ``service.enqueue``, ``service.handoff``, ``service.verdict``) holds a
    submission's block whole, so its two ends stitch as every ID between
    them does; ``trace_timeline`` scans the whole ring for each ID."""
    return sorted({i for t in tickets
                   for i in (t.trace_lo, t.trace_lo + t.n_items - 1)})


def _route_grid():
    return [(ln, f"t{k}") for ln in verify_service.LANES
            for k in range(FLEET_TENANTS)] + \
        [(ln, None) for ln in verify_service.LANES]


def _fleet_run(v, want):
    """(a): a started fleet of FLEET_REPLICAS replicas over ``v``, three
    threads submitting phase 18's scp, auth and bulk arrivals at once
    (bulk over FLEET_TENANTS tenants), then the bulk backlog, and one
    replica holding queued bulk work killed while it is queued. Every
    ticket, the handed-off ones too, equals the oracle; the fleet's gap
    is 0 at every poll and after; the dead replica shows in
    ``dispatch_health()["fleet"]``; no replica is convicted; a router
    built apart routes the grid alike. Returns the fleet (still running)
    and the run's numbers."""
    fl = fleet.FleetRouter(verifier=v, replicas=FLEET_REPLICAS).start()
    n_tx = len(want["bulk"]) * len(want["bulk"][0])
    backlog = [[(k * FLEET_BACKLOG_ROWS + j) % n_tx
                for j in range(FLEET_BACKLOG_ROWS)]
               for k in range(FLEET_BACKLOG_SUBS)]
    lanes = (("scp", want["scp"]), ("auth", want["auth"]),
             ("bulk", want["bulk"]))
    tickets = {ln: [] for ln in verify_service.LANES}
    gaps, stop_poll = [], threading.Event()

    def submit(lane, subs):
        for k, rows in enumerate(subs):
            tenant = f"t{k % FLEET_TENANTS}" if lane == "bulk" else None
            tickets[lane].append((fl.submit(
                [want["items"][i] for i in rows], lane=lane, tenant=tenant),
                rows))

    def poll():
        while not stop_poll.is_set():
            gaps.append(fl.snapshot()["conservation_gap"])
            time.sleep(GAP_POLL_S)

    grid = _route_grid()
    routes_before = [fl.route_of(*k) for k in grid]
    mark = "smoke.fleet.a"
    tracing.flight_recorder.note(mark)
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t = time.perf_counter()
    with ThreadPoolExecutor(len(lanes)) as pool:
        for f in [pool.submit(submit, ln, subs) for ln, subs in lanes]:
            f.result()
    submit("bulk", backlog)
    queued = [svc.snapshot()["lanes"]["bulk"]["queued_items"]
              for svc in fl.services()]
    victim = int(np.argmax(queued))
    check(queued[victim] > 0, f"fleet: no replica holds queued bulk work "
          f"when the backlog is in ({queued})")
    moved = fl.kill_replica(victim, stop_timeout=60)
    outcomes = {ln: _outcomes(tickets[ln], want["ok"])
                for ln in verify_service.LANES}
    wall_s = time.perf_counter() - t
    torch.cuda.synchronize()
    stop_poll.set()
    poller.join(5)
    snap = fl.snapshot()
    health = batch_engine.dispatch_health()["fleet"]
    convicted = fl.divergence_check()
    other = fleet.FleetRouter(services=[
        verify_service.VerifyService() for _ in range(FLEET_REPLICAS)])
    routes_apart = [other.route_of(*k) for k in grid]
    other.kill_replica(victim)
    check(routes_apart == routes_before and
          [other.route_of(*k) for k in grid] ==
          [fl.route_of(*k) for k in grid],
          "fleet: a router built apart routes the grid differently")
    check(len(set(routes_before)) == FLEET_REPLICAS,
          f"fleet: the grid reaches only replicas {set(routes_before)}")
    check(all(o == "verified" for os_ in outcomes.values() for o in os_),
          "fleet: a ticket was not verified")
    check(moved > 0 and snap["handoffs"] == moved,
          f"fleet: {moved} items handed off, snapshot {snap['handoffs']}")
    check(all(g == 0 for g in gaps) and snap["conservation_gap"] == 0,
          f"fleet: conservation gap {snap['conservation_gap']} after the "
          f"run, nonzero at {sum(g != 0 for g in gaps)} of {len(gaps)} "
          f"polls")
    check(health["states"][victim] == "dead" and
          health["states"].count("active") == FLEET_REPLICAS - 1,
          f"fleet: dispatch_health()['fleet'] states {health['states']}")
    check(convicted == [] and snap["divergence_convictions"] == 0,
          f"fleet: an honest replica was convicted: {convicted}, "
          f"{snap['conviction_log']}")
    recs = _flight_since(mark)
    waits = _fleet_waits(recs)
    sigs = sum(len(r) for _ln, subs in lanes for r in subs) + \
        FLEET_BACKLOG_SUBS * FLEET_BACKLOG_ROWS
    check(all(len(waits[ln]) == len(tickets[ln])
              for ln in verify_service.LANES),
          f"fleet: the flight recorder holds "
          f"{ {ln: len(w) for ln, w in waits.items()} } waits for "
          f"{ {ln: len(tk) for ln, tk in tickets.items()} } submissions")
    handoff_los = {lo for r in recs if r["name"] == "service.handoff"
                   for lo, _hi in r["attrs"]["traces"]}
    handed = [t for ln in verify_service.LANES for t, _rows in tickets[ln]
              if t.trace_lo in handoff_los]
    handed_ids = _block_ends(handed)
    frac = journal.stitch_fraction(
        handed_ids, tracing.flight_recorder,
        require=("route", "enqueue", "terminal"))
    check(handed and frac == 1.0, f"fleet: {len(handed)} handed-off "
          f"submissions found, their stitch fraction {frac}")
    res = {"wall_s": wall_s, "sigs": sigs, "sigs_per_s": sigs / wall_s,
           "handed_off_items": moved, "handed_off_submissions": len(handed),
           "handed_off_stitch_fraction": frac, "victim": victim,
           "queued_bulk_at_kill": queued, "gap_polls": len(gaps),
           "routes": snap["routes"],
           "routed_items": [r["routed_items"] for r in snap["per_replica"]],
           "dispatches": [s.snapshot()["batches"] for s in fl.services()],
           "trace_wait_ms": _wait_quantiles(waits),
           "lock_waits": _lock_waits(recs),
           "recorder_records": len(recs)}
    print(f"[fleet] (a) {FLEET_REPLICAS} replicas over one card: {sigs} sigs "
          f"({len(want['scp'])} scp x {SCP_SIGS}, {len(want['auth'])} auth "
          f"x 1, {len(want['bulk'])} bulk x {len(want['bulk'][0])} over "
          f"{FLEET_TENANTS} tenants from 3 threads, then {FLEET_BACKLOG_SUBS} "
          f"bulk x {FLEET_BACKLOG_ROWS}) in {wall_s:.3f} s, "
          f"{res['sigs_per_s']:.0f} sigs/s; replica {victim} killed with "
          f"{queued[victim]} bulk items queued: {moved} items handed off; "
          f"every verdict equal to the oracle; conservation gap 0 at "
          f"{len(gaps)} polls and after; routed items a replica "
          f"{res['routed_items']}, dispatches {res['dispatches']}; no "
          f"conviction; a router built apart routes alike; handed-off "
          f"traces stitch {frac}")
    for ln in verify_service.LANES:
        q = res["trace_wait_ms"].get(ln, {})
        print(f"[fleet] (a) {ln} lane wait p50 {q.get('p50')} ms, p99 "
              f"{q.get('p99')} ms over {len(waits[ln])} submissions "
              f"(flight recorder, {len(recs)} records)")
    for by, rows in res["lock_waits"].items():
        for k, d in sorted(rows.items()):
            print(f"[fleet] (a) the shared engine's lock, {by} {k}: "
                  f"{d['dispatches']} dispatches, {d['dispatch_ms']} ms, of "
                  f"it {d['lock_wait_ms']} ms waiting on the lock (share "
                  f"{d['share']}, largest wait {d['max_wait_ms']} ms)")
    return fl, res


def _lock_waits(recs):
    """The shared engine's lock wait in one fleet run, from the flight
    recorder: a replica's ``service.dispatch`` span runs from before
    ``SharedVerifier.submit`` takes the lock to after the engine's submit,
    whose first child span (the partition's ``verify.prep``) opens as soon
    as the lock is held; the time between is the wait. By dispatcher
    thread and by lane: dispatches, their ms, the wait's ms and its share,
    and the largest wait."""
    first_child = {}
    for r in recs:
        if r.get("parent") is not None and r.get("dur_ms") is not None:
            at = first_child.get(r["parent"])
            if at is None or r["start_ms"] < at:
                first_child[r["parent"]] = r["start_ms"]
    out = {"thread": {}, "lane": {}}
    for r in recs:
        if r["name"] != "span.service.dispatch" or r.get("dur_ms") is None \
                or r["id"] not in first_child:
            continue
        wait = first_child[r["id"]] - r["start_ms"]
        for key, k in (("thread", r["thread"]), ("lane", r["attrs"]["lane"])):
            d = out[key].setdefault(k, {"dispatches": 0, "dispatch_ms": 0.0,
                                        "lock_wait_ms": 0.0,
                                        "max_wait_ms": 0.0})
            d["dispatches"] += 1
            d["dispatch_ms"] += r["dur_ms"]
            d["lock_wait_ms"] += wait
            d["max_wait_ms"] = max(d["max_wait_ms"], wait)
    for by in out.values():
        for d in by.values():
            d["share"] = d["lock_wait_ms"] / max(d["dispatch_ms"], 1e-9)
            for k in ("dispatch_ms", "lock_wait_ms", "max_wait_ms", "share"):
                d[k] = round(d[k], 4)
    return out


def _wire_client(port, subs, want, lane, tenants, fault_point=None):
    """One client thread's work: ``subs`` sent on its own connection, the
    verdicts read back in order and checked against the oracle; returns
    its tickets and each submission's latency as the client sees it, from
    its submit to the return of its ``result()`` (ms; a verdict that came
    early waits for the reads before it)."""
    cli = ingress.WireClient("127.0.0.1", port, timeout=120,
                             fault_point=fault_point)
    sent, lat = [], []
    try:
        for k, rows in enumerate(subs):
            t0 = time.perf_counter()
            tkt = cli.submit([want["items"][i] for i in rows], lane=lane,
                             tenant=tenants[k % len(tenants)])
            sent.append((tkt, rows, t0))
        for tkt, rows, t0 in sent:
            got = tkt.result(timeout=120)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, want["ok"][rows]),
                  f"wire: a {lane} ticket's verdicts differ from the oracle")
    finally:
        cli.close()
    return [(tkt, rows) for tkt, rows, _t0 in sent], lat


def _wire_run(fl, want):
    """(b): an ``IngressServer`` over the fleet of (a); WIRE_CLIENTS
    clients each send a quarter of the TxSet, one of them with
    ``torn-frame`` on its sends, and one client the scp submissions, each
    on its own thread: every verdict equals the oracle and the wire's gap
    is 0. Then a client under ``disconnect-mid-batch`` while a clean one
    is served: its connection is killed with the typed reason and the gap
    stays 0. After ``stop()`` every admitted ticket reached a terminal.
    Returns the server (stopped), the numbers and the tickets."""
    srv = ingress.IngressServer(fl, "127.0.0.1", 0).start()
    n_tx = len(want["bulk"]) * len(want["bulk"][0])
    quarter = n_tx // WIRE_CLIENTS
    per = quarter // WIRE_SUBS
    clients = [([list(range(c * quarter + k * per,
                            c * quarter + (k + 1) * per))
                 for k in range(WIRE_SUBS)], "bulk",
                [f"t{(c * WIRE_SUBS + k) % FLEET_TENANTS}"
                 for k in range(WIRE_SUBS)],
                "wire.client.torn" if c == 0 else None)
               for c in range(WIRE_CLIENTS)]
    clients.append((want["scp"], "scp", [None], None))
    faults.set_fault("wire.client.torn", "torn-frame")
    try:
        t = time.perf_counter()
        with ThreadPoolExecutor(len(clients)) as pool:
            runs = [f.result() for f in [
                pool.submit(_wire_client, srv.port, subs, want, lane,
                            tenants, fp)
                for subs, lane, tenants, fp in clients]]
        wall_s = time.perf_counter() - t
        torn_fired = faults.counters()["wire.client.torn"]["fired"]
    finally:
        faults.clear("wire.client.torn")
    snap = srv.snapshot()
    check(snap["conservation_gap"] == 0 and snap["malformed_frames"] == 0,
          f"wire: gap {snap['conservation_gap']}, malformed "
          f"{snap['malformed_reasons']}")
    check(torn_fired == WIRE_SUBS, f"wire: torn-frame fired {torn_fired} "
          f"times for {WIRE_SUBS} sends")
    # a connection cut mid-frame while a clean client is served
    faults.set_fault("wire.client.cut", "disconnect-mid-batch")
    try:
        cut = ingress.WireClient("127.0.0.1", srv.port, timeout=120,
                                 fault_point="wire.client.cut")
        with ThreadPoolExecutor(1) as pool:
            clean = pool.submit(_wire_client, srv.port, clients[1][0], want,
                                "bulk", clients[1][2])
            try:
                cut.submit([want["items"][i] for i in clients[0][0][0]])
                check(False, "wire: the cut client's send did not fail")
            except ConnectionError:
                pass
            runs.append(clean.result())
        cut.close()
    finally:
        faults.clear("wire.client.cut")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            not srv.snapshot()["malformed_reasons"].get("disconnect"):
        time.sleep(0.01)
    snap = srv.snapshot()
    check(snap["malformed_reasons"] == {"disconnect": 1} and
          snap["conservation_gap"] == 0,
          f"wire: after the cut, malformed {snap['malformed_reasons']}, "
          f"gap {snap['conservation_gap']}")
    srv.stop(timeout=60)
    snap = srv.snapshot()
    check(snap["pending"] == 0 and snap["conservation_gap"] == 0 and
          snap["resolved"] == snap["accepted"] and snap["refused"] == 0,
          f"wire: after stop() {snap}")
    tickets = [tk for sent, _lat in runs for tk, _rows in sent]
    lat = [x for _sent, la in runs for x in la]
    sigs = sum(t.n_items for t in tickets)
    res = {"wall_s": wall_s, "sigs": snap["items_decoded"],
           "sigs_per_s": sum(t.n_items for sent, _ in runs[:len(clients)]
                             for t, _r in sent) / wall_s,
           "frames": snap["frames_received"],
           "bytes_in": snap["bytes_in"], "bytes_out": snap["bytes_out"],
           "malformed": snap["malformed_reasons"],
           "client_p50_ms": round(float(np.percentile(lat, 50)), 3),
           "client_p99_ms": round(float(np.percentile(lat, 99)), 3),
           "pool": snap["pool"]}
    print(f"[fleet] (b) wire: {len(clients)} clients on loopback "
          f"({WIRE_CLIENTS} x {WIRE_SUBS} bulk x {per}, client 0 torn, "
          f"1 x {len(want['scp'])} scp x {SCP_SIGS}) in {wall_s:.3f} s, "
          f"{res['sigs_per_s']:.0f} sigs/s; then a cut client beside a "
          f"clean one; {sigs} sigs in {res['frames']} frames, "
          f"{res['bytes_in']} B in, {res['bytes_out']} B out; submission "
          f"p50 {res['client_p50_ms']} ms, p99 {res['client_p99_ms']} ms "
          f"(client side); malformed {res['malformed']}; every verdict "
          f"equal to the oracle, conservation gap 0, nothing pending after "
          f"stop()")
    return srv, res, tickets


def phase_fleet(dev, rng, want, info):
    """Phase 19: the fleet and the wire on the card, the signer-table
    cache on. The first dispatch of one replica with an empty cache is
    timed apart; one untimed call then builds every signer's table, so
    (a) and (b) measure the steady state. K1's and K2's launch counts are
    set to 0 before (a) and before (b) and read after each: both kernels
    must launch in both. (c) the journal of the drained fleet and
    ingress: the completeness law exact, two collects merged without
    divergence, every wire trace stitched whole."""
    t0 = time.perf_counter()
    v = BatchVerifier(device=dev, bucket_sizes=DEFAULT_BUCKET_SIZES)
    signer_table_cache._reset_for_testing()
    signer_table_cache.configure(enabled=True)
    res = {"card": info["smi"]}
    launches = {}
    try:
        first = fleet.FleetRouter(verifier=v, replicas=FLEET_REPLICAS).start()
        rows = want["bulk"][0]
        t = time.perf_counter()
        got = first.submit([want["items"][i] for i in rows], lane="bulk",
                           tenant="t0").result(timeout=120)
        res["first_sight_dispatch_s"] = time.perf_counter() - t
        first.stop(drain=True, timeout=60)
        check(np.array_equal(got, want["ok"][rows]),
              "fleet: the first-sight dispatch differs from the oracle")
        print(f"[fleet] first sight: one replica's first dispatch of "
              f"{len(rows)} bulk rows with the signer-table cache empty "
              f"took {res['first_sight_dispatch_s']:.3f} s (its tables "
              f"built inside the shared engine's lock)")
        t = time.perf_counter()
        v.verify_batch(want["items"])
        res["table_build_s"] = time.perf_counter() - t
        vk.verify_kernel.launches = 0
        vk.verify_kernel_hot.launches = 0
        fl, res["fleet"] = _fleet_run(v, want)
        launches["fleet"] = _launches_since_zero("fleet")
        srv, res["wire"], wire_tickets = _wire_run(fl, want)
        launches["wire"] = _launches_since_zero("wire")
        fl.stop(drain=True, timeout=60)
        res["journal"] = _journal_view(fl, srv, wire_tickets)
    finally:
        signer_table_cache._reset_for_testing()
    check_dispatch_clean([v], "fleet")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"[fleet] phase done in {res['seconds']:.1f} s (tables built in "
          f"{res['table_build_s']:.1f} s); K1 and K2 launches (a) "
          f"{launches['fleet']}, (b) {launches['wire']}; card {info['smi']}")
    return res, launches


def _launches_since_zero(label):
    """K1's and K2's launch counts since they were set to 0, both of
    which must be above 0; the counts are set to 0 again."""
    torch.cuda.synchronize()
    out = {"verify_cold": vk.verify_kernel.launches,
           "verify_hot": vk.verify_kernel_hot.launches}
    check(all(n > 0 for n in out.values()),
          f"fleet ({label}): K1 and K2 launches {out}")
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    return out


def _journal_view(fl, srv, wire_tickets):
    """(c): the journal of the drained fleet and ingress."""
    j1 = journal.collect(fleet=fl, ingress=srv)
    j2 = journal.collect(fleet=fl, ingress=srv)
    merged = journal.merge(j1, j2)   # raises JournalDivergence
    comp = journal.completeness(merged, drained=True)
    check(comp["gap"] == 0 and not comp["wrapped"],
          f"journal: completeness {comp}")
    ids = _block_ends(wire_tickets)
    frac = journal.stitch_fraction(
        ids, tracing.flight_recorder,
        require=("wire", "route", "enqueue", "terminal"))
    check(frac == 1.0, f"journal: the wire traces stitch {frac}")
    out = {"completeness_gap": comp["gap"], "checks": len(comp["checks"]),
           "events": len(merged["events"]), "wire_blocks": len(wire_tickets),
           "wire_traces": sum(t.n_items for t in wire_tickets),
           "stitch_fraction": frac}
    print(f"[fleet] (c) journal: {out['events']} events over "
          f"{len(merged['components'])} components, completeness gap 0 over "
          f"{out['checks']} checks (drained), two collects merged without "
          f"divergence; the {out['wire_traces']} wire traces' "
          f"{len(wire_tickets)} blocks (both ends of each) stitch "
          f"wire -> route -> enqueue -> terminal: {frac}")
    return out


def _counts():
    """K1's, K2's and K3's launch counts, the card synchronised first."""
    torch.cuda.synchronize()
    return {"verify_cold": vk.verify_kernel.launches,
            "verify_hot": vk.verify_kernel_hot.launches,
            "sha256": sk.sha256_kernel.launches}


def _zero_counts():
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    sk.sha256_kernel.launches = 0


def _node_pass(envs, accounts, prefetch=True):
    """One pass of the node's signature path over the envelopes, the
    verify cache flushed first: ``(verdicts, hashes, payloads, items,
    checker cache misses, ms a step)``. ``prefetch=False`` leaves every
    verify to the checker's own ``keys.verify_sig`` (the oracle run)."""
    nid = vectors.NODE_NETWORK_ID
    keys.flush_verify_cache()
    ms = {}
    t = time.perf_counter()
    dec = [from_bytes(xtx.TransactionEnvelope, e) for e in envs]
    t, ms["decode"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    payloads = [xtx.transaction_sig_payload(nid, d.value.tx) for d in dec]
    t, ms["payload"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    hashes = hash_many(payloads)
    t, ms["hash"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    items = vectors.collect_candidates(dec, accounts, hashes)
    t, ms["collect"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    if prefetch:
        keys.batch_verify_into_cache(items)
    t, ms["prefetch"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    misses = keys.get_verify_cache_stats()["misses"]
    verdicts = [vectors.check_transaction(d, accounts, h)
                for d, h in zip(dec, hashes)]
    ms["check"] = (time.perf_counter() - t) * 1e3
    stats = keys.get_verify_cache_stats()
    tracing.frame_mark()
    for k in ("hits", "misses", "size"):
        registry.gauge(f"crypto.verify.cache.{k}").set(stats[k])
    return (verdicts, hashes, payloads, items, stats["misses"] - misses,
            ms)


def _node_passes(envs, accounts, want, label):
    """NODE_PASSES timed passes, each gated: digests, no cache miss in
    the checker, verdicts and used flags equal to the oracle run's."""
    walls, steps = [], collections.defaultdict(list)
    for _ in range(NODE_PASSES):
        t = time.perf_counter()
        verdicts, hashes, _p, _i, misses, ms = _node_pass(envs, accounts)
        walls.append((time.perf_counter() - t) * 1e3)
        check(hashes == want["hashes"],
              f"node ({label}): a digest differs from transaction_hash")
        check(misses == 0, f"node ({label}): the checker missed the verify "
              f"cache {misses} times")
        differ = sum(a != b for a, b in zip(verdicts, want["verdicts"]))
        check(differ == 0, f"node ({label}): {differ} verdicts or used "
              "flags differ from the oracle run's")
        for k, v in ms.items():
            steps[k].append(v)
    return {"p50_ms": float(np.percentile(walls, 50)),
            "p90_ms": float(np.percentile(walls, 90)),
            "steps_p50_ms": {k: float(np.percentile(steps[k], 50))
                             for k in NODE_STEPS},
            "steps_p90_ms": {k: float(np.percentile(steps[k], 90))
                             for k in NODE_STEPS}}


def phase_node(rng, info):
    """Phase 20: the node's transactions on the card. The oracle run
    first (the pure-Python oracle as the verify backend, no prefetch),
    then NODE_PASSES cold passes (signer-table cache off) with K1's and
    K3's counts set to 0 before them and read after, then one untimed
    pass that builds the tables and NODE_PASSES hot passes with K2's and
    K3's counts read the same way. The process ring samples through the
    phase."""
    t0 = time.perf_counter()
    envs, accounts = vectors.node_txset(rng)
    build_s = time.perf_counter() - t0
    check(len(envs) == NODE_TXS, f"node: {len(envs)} envelopes")
    check(keys._backend is None, "node: a verify backend is installed")
    v, h = default_verifier(), default_hasher()
    check(v.device.type == "cuda" and h.device.type == "cuda",
          f"node: the default verifier on {v.device}, hasher on {h.device}")
    ring = metrics.timeseries
    prefixes = ring._prefixes
    ring._prefixes = ("crypto.", "frame.")
    fired0 = registry.counter("metrics.timeseries.anomalies").count
    ring.start(interval_s=NODE_SAMPLE_S)
    thread = ring._thread
    res = {"card": info["smi"], "txs": len(envs), "build_s": build_s}
    launches = {}
    try:
        keys.set_verifier_backend(ref.verify)
        try:
            t = time.perf_counter()
            verdicts, hashes, payloads, items, _m, _ms = _node_pass(
                envs, accounts, prefetch=False)
            res["oracle_s"] = time.perf_counter() - t
        finally:
            keys.set_verifier_backend(None)
        want = {"verdicts": verdicts, "hashes": hashes}
        nid = vectors.NODE_NETWORK_ID
        check(hashes == [xtx.transaction_hash(nid, from_bytes(
            xtx.TransactionEnvelope, e).value.tx) for e in envs],
            "node: hash_many's digests differ from transaction_hash")
        res["candidates"] = len(items)
        res["accepted"] = sum(ok for ok, _u in verdicts)
        res["rejected"] = len(verdicts) - res["accepted"]
        hl = []
        for _ in range(NODE_PASSES):
            t = time.perf_counter()
            [hashlib.sha256(p).digest() for p in payloads]
            hl.append((time.perf_counter() - t) * 1e3)
        res["hashlib_p50_ms"] = float(np.percentile(hl, 50))
        signer_table_cache.configure(enabled=False)
        _zero_counts()
        res["cold"] = _node_passes(envs, accounts, want, "cold")
        launches["cold"] = _counts()
        check(launches["cold"]["verify_cold"] > 0 and
              launches["cold"]["sha256"] > 0,
              f"node (cold): K1 and K3 launches {launches['cold']}")
        signer_table_cache._reset_for_testing()
        signer_table_cache.configure(enabled=True)
        t = time.perf_counter()
        _node_pass(envs, accounts)
        res["table_build_s"] = time.perf_counter() - t
        _zero_counts()
        res["hot"] = _node_passes(envs, accounts, want, "hot")
        launches["hot"] = _counts()
        check(launches["hot"]["verify_hot"] > 0 and
              launches["hot"]["sha256"] > 0,
              f"node (hot): K2 and K3 launches {launches['hot']}")
    finally:
        signer_table_cache._reset_for_testing()
        ring.sample_once()
        ring.stop()
        ring._prefixes = prefixes
    check_dispatch_clean([v, h], "node")
    snap = ring.snapshot()
    series = snap["series"]
    for name in ("frame.ledger_close.count", "crypto.verify.cache.hits",
                 "crypto.verify.cache.misses"):
        check(name in series, f"node: the ring holds no {name} series")
    # a cumulative series' first sample is its baseline (delta 0): the
    # marks before the meter's first tick are not counted
    frames = sum(val for _t, val in
                 series["frame.ledger_close.count"]["samples"])
    check(NODE_PASSES <= frames <= 2 * NODE_PASSES + 2,
          f"node: the ring saw {frames} of {2 * NODE_PASSES + 2} frame "
          "marks")
    check(snap["sampling"]["dropped_series"] == 0,
          f"node: the ring dropped {snap['sampling']['dropped_series']} "
          f"series of {snap['sampling']['tracked_series']}")
    check(not snap["sampling"]["running"] and not thread.is_alive(),
          "node: the ring's sampler thread did not stop")
    res["ring"] = {"ticks": snap["sampling"]["ticks"],
                   "tracked_series": snap["sampling"]["tracked_series"],
                   "anomalies": registry.counter(
                       "metrics.timeseries.anomalies").count - fired0,
                   "anomaly_series": [a["series"] for a in
                                      snap["anomalies"]][-8:]}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    traffic = {"envs": envs, "accounts": accounts, "hashes": hashes,
               "verdicts": [ok for ok, _u in verdicts]}
    print(f"[node] {len(envs)} transactions, {res['candidates']} candidate "
          f"signatures, built in {build_s:.1f} s; oracle run "
          f"{res['oracle_s']:.1f} s; accepted {res['accepted']}, rejected "
          f"{res['rejected']}; card {info['smi']}")
    for mode in ("cold", "hot"):
        r = res[mode]
        parts = ", ".join(f"{k} {r['steps_p50_ms'][k]:.3f} / "
                          f"{r['steps_p90_ms'][k]:.3f}" for k in NODE_STEPS)
        print(f"[node] {mode}: pass p50 {r['p50_ms']:.3f} ms, p90 "
              f"{r['p90_ms']:.3f} ms over {NODE_PASSES} passes; step p50 / "
              f"p90 ms: {parts}; launches {launches[mode]}")
    print(f"[node] hashlib on the same {len(payloads)} payloads p50 "
          f"{res['hashlib_p50_ms']:.3f} ms; tables built in "
          f"{res['table_build_s']:.1f} s; ring: {res['ring']['ticks']} "
          f"ticks, {res['ring']['tracked_series']} series, none dropped, "
          f"{res['ring']['anomalies']} anomalies fired "
          f"{res['ring']['anomaly_series']}; phase {res['seconds']:.1f} s")
    return res, launches, traffic


def _keyed(items) -> int:
    """The (pk, msg, sig) triples the verify cache keys."""
    return sum(keys.cache_keyable(pk, sig) for pk, _m, sig in items)


def _admit(root, frames):
    """Admission, as the transaction queue checks it: the contents
    hashes (K3), one ``prefetch_signature_batch`` over a ``LedgerTxn`` on
    the root (K1 or K2), then every frame's ``check_valid``; rolled back.
    Returns each result's code."""
    tx_set.prefetch_contents_hashes(frames)
    ltx = LedgerTxn(root)
    tx_set.prefetch_signature_batch(ltx, frames)
    codes = [f.check_valid(ltx).code for f in frames]
    ltx.rollback()
    return codes


def _txset_pass(raw, root, flush=True):
    """One pass of a received TxSet, the verify cache flushed first (unless
    ``flush`` is False): ``TxSetXDRFrame.from_bytes`` and
    ``prepare_for_apply``, ``prefetch_contents_hashes`` (K3),
    ``check_valid`` on a ``LedgerTxn`` over the root, rolled back (one
    ``prefetch_signature_batch``: K1 or K2, then every transaction's
    ``check_valid``), ``get_txs_in_apply_order``. Returns the applicable
    set, ``check_valid``'s answer, the apply order's full hashes, the
    verify cache's misses over the pass, the verify engine's blocking
    span inside ``check_valid`` (ms; a ``tracing.span_totals()`` delta)
    and the ms of each step."""
    if flush:
        keys.flush_verify_cache()
    misses0 = keys.get_verify_cache_stats()["misses"]
    ms = {}
    t = time.perf_counter()
    applicable = tx_set.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(
        vectors.NODE_NETWORK_ID)
    t, ms["decode_prepare"] = time.perf_counter(), \
        (time.perf_counter() - t) * 1e3
    check(applicable is not None, "txset: prepare_for_apply refused the set")
    tx_set.prefetch_contents_hashes(applicable.frames)
    t, ms["hash"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    before = tracing.span_totals()
    ltx = LedgerTxn(root)
    ok = applicable.check_valid(ltx, TXSET_LCL)
    ltx.rollback()
    t, ms["check_valid"] = time.perf_counter(), \
        (time.perf_counter() - t) * 1e3
    att = batch_engine.dispatch_attribution(before, tracing.span_totals())
    order = [tx_set.full_tx_hash(f)
             for f in applicable.get_txs_in_apply_order()]
    ms["apply_order"] = (time.perf_counter() - t) * 1e3
    misses = keys.get_verify_cache_stats()["misses"] - misses0
    return (applicable, ok, order, misses, att["blocking_span_per_rep_ms"],
            ms)


def _txset_passes(raw, root, want, label):
    """TXSET_PASSES timed passes, each gated: ``check_valid`` True, every
    contents hash hashlib's, the verify cache missed once for each
    well-formed triple the set collected (so no per-transaction check
    missed), the apply order the oracle pass's."""
    walls, spans, steps = [], [], collections.defaultdict(list)
    for _ in range(TXSET_PASSES):
        t = time.perf_counter()
        applicable, ok, order, misses, span, ms = _txset_pass(raw, root)
        walls.append((time.perf_counter() - t) * 1e3)
        check(ok is True, f"txset ({label}): check_valid refused the set")
        check(all(f._hash == hashlib.sha256(f.contents_preimage()).digest()
                  for f in applicable.frames),
              f"txset ({label}): a contents hash differs from hashlib's")
        keyed = _keyed(applicable.sig_triples)
        check(misses == keyed, f"txset ({label}): {misses} verify cache "
              f"misses over the pass, {keyed} keyed triples collected")
        check(order == want["order"], f"txset ({label}): the apply order "
              "differs from the oracle pass's")
        spans.append(span)
        for k, v in ms.items():
            steps[k].append(v)
    return {"p50_ms": float(np.percentile(walls, 50)),
            "p90_ms": float(np.percentile(walls, 90)),
            "steps_p50_ms": {k: float(np.percentile(steps[k], 50))
                             for k in TXSET_STEPS},
            "steps_p90_ms": {k: float(np.percentile(steps[k], 90))
                             for k in TXSET_STEPS},
            "verify_span_p50_ms": float(np.percentile(spans, 50)),
            "verify_span_p90_ms": float(np.percentile(spans, 90)),
            "triples": len(applicable.sig_triples), "misses": misses}


def phase_node_txset(info, traffic):
    """Phase 21: the node's TxSet on the card, over phase 20's
    transactions. Setup (the ledger, the frames) timed apart; admission
    once, equal to phase 20's checker verdicts; nomination of the
    accepted, nothing excluded, and of the accepted plus one rejected
    transaction; the oracle pass (the pure-Python oracle as the verify
    backend); then TXSET_PASSES cold passes (signer-table cache off) with
    K1's and K3's counts set to 0 before them and read after, and, after
    one untimed pass that builds the tables, TXSET_PASSES hot passes with
    K2's and K3's counts read the same way."""
    t0 = time.perf_counter()
    envs, accounts = traffic["envs"], traffic["accounts"]
    nid = vectors.NODE_NETWORK_ID
    check(keys._backend is None, "txset: a verify backend is installed")
    res = {"card": info["smi"], "txs": len(envs)}
    t = time.perf_counter()
    root = vectors.node_ledger(accounts)
    res["ledger_s"] = time.perf_counter() - t
    t = time.perf_counter()
    frames = [make_transaction_frame(nid, from_bytes(
        xtx.TransactionEnvelope, e)) for e in envs]
    res["frames_s"] = time.perf_counter() - t
    header = root.header()
    signer_table_cache.configure(enabled=False)
    launches = {}
    try:
        keys.flush_verify_cache()
        t = time.perf_counter()
        codes = _admit(root, frames)
        res["admission_s"] = time.perf_counter() - t
        ok = [c == xresults.TransactionResultCode.txSUCCESS for c in codes]
        check(ok == traffic["verdicts"], f"txset: admission differs from "
              f"phase 20's verdicts on "
              f"{sum(a != b for a, b in zip(ok, traffic['verdicts']))} "
              "transactions")
        accepted = [f for f, k in zip(frames, ok) if k]
        rejected = [f for f, k in zip(frames, ok) if not k]
        res["accepted"], res["rejected"] = len(accepted), len(rejected)
        check(accepted and rejected, f"txset: {len(accepted)} accepted, "
              f"{len(rejected)} rejected")
        t = time.perf_counter()
        app, excluded = tx_set.make_tx_set_from_transactions(
            accepted, header, TXSET_LCL)
        res["nominate_s"] = time.perf_counter() - t
        check(not excluded, f"txset: nomination excluded {len(excluded)}")
        raw = to_bytes(xledger.GeneralizedTransactionSet, app.xdr)
        worse, worse_excluded = tx_set.make_tx_set_from_transactions(
            accepted + rejected[:1], header, TXSET_LCL)
        check(not worse_excluded and worse.size_op() <= header.maxTxSetSize,
              "txset: the set with a rejected transaction does not fit "
              f"maxTxSetSize ({worse.size_op()} operations)")
        worse_raw = to_bytes(xledger.GeneralizedTransactionSet, worse.xdr)
        dec = [from_bytes(xtx.TransactionEnvelope, e) for e in envs]
        ltx = LedgerTxn(root)
        triples = tx_set.collect_signature_triples(ltx, accepted)
        ltx.rollback()
        check(triples == vectors.collect_candidates(
            [d for d, k in zip(dec, ok) if k], accounts,
            [h for h, k in zip(traffic["hashes"], ok) if k]),
            "txset: collect_signature_triples differs from "
            "vectors.collect_candidates on the accepted transactions")
        res["set_bytes"], res["set_ops"] = len(raw), app.size_op()
        res["phases"] = [p.arm for p in app.xdr.value.phases]
        # the oracle pass: admission, the received set and the set with a
        # rejected transaction, every verify through the oracle
        keys.set_verifier_backend(ref.verify)
        try:
            keys.flush_verify_cache()
            t = time.perf_counter()
            oracle_frames = [make_transaction_frame(nid, from_bytes(
                xtx.TransactionEnvelope, e)) for e in envs]
            oracle_codes = _admit(root, oracle_frames)
            _a, oracle_ok, oracle_order, _m, _s, _ms = _txset_pass(
                raw, root, flush=False)
            _a, oracle_worse, _o, _m, _s, _ms = _txset_pass(
                worse_raw, root, flush=False)
            res["oracle_s"] = time.perf_counter() - t
        finally:
            keys.set_verifier_backend(None)
        check(oracle_codes == codes and oracle_ok is True and
              oracle_worse is False, "txset: the oracle pass differs "
              f"(check_valid {oracle_ok}, with a rejected transaction "
              f"{oracle_worse})")
        want = {"order": oracle_order}
        _zero_counts()
        res["cold"] = _txset_passes(raw, root, want, "cold")
        launches["cold"] = _counts()
        check(launches["cold"]["verify_cold"] > 0 and
              launches["cold"]["sha256"] > 0,
              f"txset (cold): K1 and K3 launches {launches['cold']}")
        _a, bad_ok, _o, _m, _s, _ms = _txset_pass(worse_raw, root)
        check(bad_ok is False, "txset: check_valid took the set holding a "
              "rejected transaction")
        signer_table_cache._reset_for_testing()
        signer_table_cache.configure(enabled=True)
        t = time.perf_counter()
        _txset_pass(raw, root)
        res["table_build_s"] = time.perf_counter() - t
        _zero_counts()
        res["hot"] = _txset_passes(raw, root, want, "hot")
        launches["hot"] = _counts()
        check(launches["hot"]["verify_hot"] > 0 and
              launches["hot"]["sha256"] > 0,
              f"txset (hot): K2 and K3 launches {launches['hot']}")
    finally:
        signer_table_cache._reset_for_testing()
    check_dispatch_clean([default_verifier(), default_hasher()], "txset")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"[txset] {len(envs)} transactions over vectors.node_ledger "
          f"(protocol {header.ledgerVersion}, maxTxSetSize "
          f"{header.maxTxSetSize}): ledger built in {res['ledger_s']:.3f} s, "
          f"frames in {res['frames_s']:.3f} s; admission "
          f"{res['admission_s']:.3f} s: accepted {res['accepted']}, "
          f"rejected {res['rejected']} (phase 20's verdicts); nomination "
          f"{res['nominate_s']:.3f} s, nothing excluded, {res['set_ops']} "
          f"operations, phases {res['phases']}, {res['set_bytes']} B on the "
          f"wire; oracle pass {res['oracle_s']:.1f} s; card {info['smi']}")
    for mode in ("cold", "hot"):
        r = res[mode]
        parts = ", ".join(f"{k} {r['steps_p50_ms'][k]:.3f} / "
                          f"{r['steps_p90_ms'][k]:.3f}" for k in TXSET_STEPS)
        print(f"[txset] {mode}: pass p50 {r['p50_ms']:.3f} ms, p90 "
              f"{r['p90_ms']:.3f} ms over {TXSET_PASSES} passes; step p50 / "
              f"p90 ms: {parts}; the verify engine's span inside check_valid "
              f"p50 / p90 {r['verify_span_p50_ms']:.3f} / "
              f"{r['verify_span_p90_ms']:.3f} ms; {r['triples']} triples, "
              f"{r['misses']} verify cache misses a pass; launches "
              f"{launches[mode]}")
    print(f"[txset] check_valid True on every pass and False with a "
          f"rejected transaction; tables built in "
          f"{res['table_build_s']:.1f} s; phase {res['seconds']:.1f} s")
    return res, launches


def phase_faults(v, items, want):
    """The reference's device-domain scenarios on the SPLIT-index
    verifier, cache off: fail-device 1, probation healing, corrupt-device
    2; every verdict equals the oracle and every row is served by a
    device index. Then the port's own: a launch fault on every index, and
    on a one-card verifier, raises instead of serving rows on the host.
    The verifiers are the phase's own and are dropped after it."""
    signer_table_cache.configure(enabled=False)
    health = v.health
    health.configure(failure_threshold=2, backoff_min_s=FAULT_BACKOFF_S,
                     backoff_max_s=2 * FAULT_BACKOFF_S)
    retries0 = batch_engine.DISPATCH_RETRIES
    batch_engine.DISPATCH_RETRIES = 0
    out = {}

    def call(label):
        served0 = dict(v.device_served)
        dev0 = v.served["device"]
        got = v.verify_batch(items)
        torch.cuda.synchronize()
        check(np.array_equal(got, want), f"faults, {label}: a verdict "
              "differs from the oracle")
        out[label] = {
            "served": {str(i): v.device_served.get(i, 0) - served0.get(i, 0)
                       for i in range(SPLIT)},
            "device_rows": v.served["device"] - dev0,
            "quarantined": health.quarantined(SPLIT),
            "convicted": sorted(v.convicted)}
        check(out[label]["device_rows"] == len(items),
              f"faults, {label}: {out[label]['device_rows']} of "
              f"{len(items)} rows served by a device")
        return out[label]

    def raises(label, verifier):
        try:
            verifier.verify_batch(items)
        except RuntimeError as e:
            out[label] = {"raised": str(e)[:160]}
            return
        check(False, f"faults, {label}: the call did not raise")

    try:
        faults.set_fault(faults.DISPATCH, "fail-device", 1)
        rec = call("fail_device_1")
        check(rec["served"]["1"] == 0 and rec["quarantined"] == [],
              f"fail-device 1, first call: {rec}")
        rec = call("fail_device_1_again")
        opened = time.monotonic()
        check(rec["quarantined"] == [1], f"fail-device 1 quarantined "
              f"{rec['quarantined']}")
        rec = call("degraded")
        check(rec["served"]["1"] == 0 and
              all(rec["served"][str(i)] > 0 for i in (0, 2, 3)),
              f"degraded: the survivors did not serve alone: {rec}")
        faults.clear()
        time.sleep(max(0.0, opened + 1.2 * FAULT_BACKOFF_S
                       - time.monotonic()))
        call("probation")
        check(health.breaker(1).state == resilience.CLOSED,
              "probation did not heal index 1")
        rec = call("healed")
        check(rec["served"]["1"] > 0 and rec["quarantined"] == [],
              f"healed: index 1 does not serve: {rec}")
        faults.set_fault(faults.RESOLVE, "corrupt-device", 2)
        mism = v.audit_mismatches
        rec = call("corrupt_device_2")
        check(v.audit_mismatches == mism + 1 and rec["quarantined"] == [2]
              and rec["convicted"] == [2] and rec["served"]["2"] == 0,
              f"corrupt-device 2 not convicted: {rec}")
        faults.clear()
        time.sleep(1.2 * FAULT_BACKOFF_S)
        rec = call("convicted")
        check(rec["served"]["2"] == 0 and rec["quarantined"] == [2],
              f"convicted index 2 served again: {rec}")
        faults.set_fault(faults.DISPATCH, "raise")
        raises("every_index_fails", v)
        raises("one_card_fails", BatchVerifier(
            device=v.device, bucket_sizes=DEFAULT_BUCKET_SIZES))
    finally:
        faults.clear()
        batch_engine.DISPATCH_RETRIES = retries0
    print("[faults] " + "; ".join(f"{k}: {r}" for k, r in out.items()))
    print("[faults] fail-device 1 benched index 1 alone (its parts moved "
          "to the survivors), probation healed it, corrupt-device 2 was "
          "convicted by the audit (index 2 quarantined for good, its parts "
          "moved), every verdict equal to the oracle and every row served "
          "by a card; a launch fault with no device left raised")
    return out


def source_line(fn):
    """``path:line`` of ``fn``'s ``def``, the path from the repository
    root."""
    path = os.path.relpath(inspect.getsourcefile(fn),
                           os.path.dirname(os.path.abspath(__file__)))
    return f"{path}:{inspect.getsourcelines(fn)[1]}"


def kernel_entry(name, source, replaces, jax_function, launches,
                 rows_compared, err, per_batch, batch, card, **extra):
    """One entry of the kernels line; ``batch`` keys its headline numbers
    in ``per_batch``."""
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
    builds = phase_build(dev)
    rows_compared, err = phase_kernel_vs_plain(dev, rng)
    vk.verify_kernel.launches = 0
    txset, txset_items, txset_want = phase_txset(rng)
    catchup, catchup_items, catchup_got, catchup_bad = phase_catchup(rng)
    launches = vk.verify_kernel.launches
    check(launches > 0, "the main path launched no K1 kernel")
    audited = check_dispatch_clean([default_verifier()], "cold paths")
    print(f"[main-path] verify_cold launches: {launches}; dispatch clean "
          f"(no device fault, no audit mismatch, breakers closed); "
          f"{audited} parts audited clean at rate {batch_engine.AUDIT_RATE}")
    main_items = dict(zip(KERNEL_BATCHES, (txset_items, catchup_items)))
    per_batch, compared, err6, k1_ops, k1_bits = phase_kernel_times(
        dev, rng, info, main_items)
    vk.verify_kernel.launches = 0
    vk.verify_kernel_hot.launches = 0
    hot_k1_ops = {}
    hot_txset, txset_rows = phase_hot_txset(txset_items, txset_want,
                                            hot_k1_ops)
    hot_catchup, catchup_rows = phase_hot_catchup(
        rng, catchup_items, catchup_got, catchup_bad, hot_k1_ops)
    hot_launches = vk.verify_kernel_hot.launches
    hot_k1_launches = vk.verify_kernel.launches
    check(hot_launches > 0, "the hot main path launched no K2 kernel")
    check(hot_k1_launches > 0, "the hot main path launched no K1 kernel")
    check_dispatch_clean([default_verifier()], "hot paths")
    print(f"[main-path] verify_hot launches: {hot_launches}; verify_cold "
          f"launches on the hot paths: {hot_k1_launches}; dispatch clean")
    k1_hot, k1_hot_compared, k1_hot_err, hot_bits = phase_hot_k1_times(
        info, hot_k1_ops)
    per_batch.update(k1_hot)
    k1_sweep = phase_block_sweep("verify_cold", {
        128: (hot_k1_ops["hot_txset"][0], hot_bits["hot_txset"]),
        **{b: (k1_ops[b], k1_bits[b]) for b in KERNEL_BATCHES}},
        vk.COLD_BLOCK_THREADS)
    del hot_k1_ops, k1_bits, hot_bits
    hot_batch, hot_compared, hot_err, k2_rows = phase_hot_kernel_times(
        dev, rng, info, dict(zip(KERNEL_BATCHES, (txset_rows,
                                                  catchup_rows))))
    del txset_rows, catchup_rows
    k2_sweep = phase_block_sweep("verify_hot", k2_rows, vk.HOT_BLOCK_THREADS)
    del k2_rows
    hashing = phase_hashing(dev, rng, info, builds["sha256"]["executed"])
    check_dispatch_clean([default_hasher()], "hashing")
    r16_batch, r16_compared, r16_err, r16_launches = phase_radix_sweep(
        dev, rng, info, main_items, builds["verify_r16"])
    k4_batch, k4_compared, k4_launches = phase_sharded(dev, k1_ops, per_batch)
    del k1_ops
    split, split_v = phase_split(dev, txset_items, txset_want)
    audit_cost = phase_audit_cost(txset_items, txset_want)
    transfer_cost = phase_transfer_cost(dev, rng, txset_items, txset_want)
    deadline = phase_deadline(dev, txset_items, txset_want)
    probe = phase_probe()
    service, service_a, service_launches, service_want = phase_service(
        dev, rng, txset_items, txset_want, info)
    fleet_res, fleet_launches = phase_fleet(dev, rng, service_want, info)
    del service_want
    node, node_launches, node_traffic = phase_node(rng, info)
    node_txset, txset_launches = phase_node_txset(info, node_traffic)
    del node_traffic
    fault_domains = phase_faults(split_v, txset_items, txset_want)
    k2_txset = hot_batch[str(KERNEL_BATCHES[0])]["ms"]
    print(f"[hot-txset] K2 at B={KERNEL_BATCHES[0]} is {k2_txset:.4f} ms, "
          f"{k2_txset / hot_txset['p50_ms']:.1%} of the hot TxSet p50")
    kernels = [
        kernel_entry("verify_cold", "stellar_tpu_torch/csrc/verify_cold.cu",
                     "stellar_tpu/ops/verify.py:155", "verify_kernel",
                     launches, rows_compared + compared + k1_hot_compared,
                     max(err, err6, k1_hot_err), per_batch,
                     KERNEL_BATCHES[0], info["smi"],
                     launches_hot_paths=hot_k1_launches,
                     launches_deadline_phase=deadline["launches"],
                     launches_service=service_launches["verify_cold"],
                     launches_service_mixed=service_a["verify_cold"],
                     launches_fleet=fleet_launches["fleet"]["verify_cold"],
                     launches_wire=fleet_launches["wire"]["verify_cold"],
                     launches_node=node_launches["cold"]["verify_cold"],
                     launches_node_hot=node_launches["hot"]["verify_cold"],
                     launches_txset=txset_launches["cold"]["verify_cold"],
                     launches_txset_hot=txset_launches["hot"]["verify_cold"],
                     block_sweep=k1_sweep, **builds["verify_cold"]),
        kernel_entry("verify_hot", "stellar_tpu_torch/csrc/verify_hot.cu",
                     "stellar_tpu/ops/verify.py:188", "verify_kernel_hot",
                     hot_launches, hot_compared, hot_err, hot_batch,
                     KERNEL_BATCHES[0], info["smi"], block_sweep=k2_sweep,
                     launches_service=service_launches["verify_hot"],
                     launches_service_mixed=service_a["verify_hot"],
                     launches_fleet=fleet_launches["fleet"]["verify_hot"],
                     launches_wire=fleet_launches["wire"]["verify_hot"],
                     launches_node=node_launches["hot"]["verify_hot"],
                     launches_txset=txset_launches["hot"]["verify_hot"],
                     **builds["verify_hot"]),
        kernel_entry("sha256", "stellar_tpu_torch/csrc/sha256.cu",
                     "stellar_tpu/ops/sha256.py:171", "sha256_kernel",
                     hashing["launches"], hashing["rows_compared"],
                     hashing["max_abs_err"], hashing["by_batch"], HASH_MSGS,
                     info["smi"],
                     launches_node=node_launches["cold"]["sha256"],
                     launches_node_hot=node_launches["hot"]["sha256"],
                     launches_txset=txset_launches["cold"]["sha256"],
                     launches_txset_hot=txset_launches["hot"]["sha256"],
                     **builds["sha256"]),
        kernel_entry("verify_sharded", source_line(vk.verify_kernel_sharded),
                     "stellar_tpu/ops/verify.py:211", "verify_kernel_sharded",
                     k4_launches, k4_compared, 0.0, k4_batch,
                     f"card x {SPLIT}:{KERNEL_BATCHES[0]}", info["smi"],
                     launches_of="verify_cold (csrc/verify_cold.cu), one "
                     "per device entry"),
        kernel_entry("verify_r16", "stellar_tpu_torch/csrc/verify_r16.cu",
                     "stellar_tpu/ops/edwards.py:540",
                     "signed_digits16_dev + _double_scalarmult16",
                     r16_launches, r16_compared, r16_err, r16_batch,
                     KERNEL_BATCHES[0], info["smi"], **builds["verify_r16"])]
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
            "oversize", "engine_phases", "transfer")},
        "txset_engine_phases": txset["engine_phases"],
        "txset_pipeline": txset["pipeline"],
        "txset_transfer": txset["transfer"],
        "txset_transfer_first_call": txset["transfer_first_call"],
        "catchup_transfer": catchup["transfer"],
        "split_txset": split, "audit_cost": audit_cost,
        "transfer_cost": transfer_cost,
        "deadline": deadline, "probe": probe, "service": service,
        "fleet": fleet_res, "node": node, "node_txset": node_txset,
        "fault_domains": fault_domains,
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
