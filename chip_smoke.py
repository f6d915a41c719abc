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
   width: ``vectors.node_txset`` (from a generator of its own,
   ``NODE_SEED``) builds 1,000 signed v1
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
22. the node's ledger close — ``LedgerManager(network_id, root).
   close_ledger(LedgerCloseData(...))``: the bulk prefetch of apply keys,
   the verify cache seeded (K1 or K2), the fee phase, every transaction's
   apply with its meta, ``txSetResultHash``, the upgrades, the eviction
   scan, the bucket list's batch and hash (the C++ bucket runtime,
   ``utils/native.py``) and the hot archive, the skip list and the LCL,
   the close meta when a consumer is attached; after the device probe
   has answered (``device_available(block=True)``), every close on a
   fresh root and ``LedgerManager`` built before it and timed apart. (a)
   ``BASELINE.json`` config 1, ``tests/test_close_ledger.py``'s 100
   payments to one destination (``tx_test_utils``' test network,
   ``maxTxSetSize`` 200): 10 passes of a verify-cache flush and a close
   with no ``check_valid`` before it, the signer-table cache off; each
   applies 100 and fails none, takes the fee pool to 10,000 and the
   destination to its 1,100 XLM, gives ``CONFIG1_CLOSE_HASH`` (the
   reference's close of the same ledger) and launches K1 once. (b)
   config 2 replayed: phase 21's accepted transactions over
   ``vectors.node_close_ledger`` (their accounts plus each payment's
   destination, each offer's issuer and its seller's trustline),
   nominated once (nothing excluded); a pass runs catchup's order for one
   ledger, a flush, ``TxSetXDRFrame.from_bytes`` and
   ``prepare_for_apply``, ``prefetch_contents_hashes`` (K3),
   ``close_ledger`` (its own ``prefetch_signature_batch``): 5 passes cold
   (signer-table cache off), one untimed that builds the tables, 5 hot.
   (c) one close after the set's own ``check_valid`` (rolled back): the
   close re-seeds from its ``sig_triples``, with no K1 or K2 launch and
   no verify-cache miss inside. (d) one close each over the pure-Python
   oracle, with every invariant (``InvariantManager()``), and with a
   ``close_meta_stream`` consumer keeping the ``LedgerCloseMeta`` bytes.
   Gates: every config 2 close applies ``CONFIG2_APPLIED`` and fails
   none and gives ``CONFIG2_CLOSE_HASH``, the meta bytes hash to
   ``CONFIG2_META_HASH`` (both the reference's), no
   ``InvariantDoesNotHold``, every contents hash hashlib's, the verify
   cache's misses over a replayed close equal to the keyed triples the
   set collects (no per-signature check of the fee or apply phase
   missed), K1 and K3 launched cold and K2 and K3 hot, the C++ bucket
   runtime loaded, the dispatch clean. p50 and p90 of (a) and of (b)
   cold and hot, the ms a pass of each step, inside the close (from
   ``tracing.span_totals()`` deltas) the ``ledger.close`` zone, the
   verify engine's span, the ``bucket.addBatch`` zone and the rest (the
   fee and apply phases), the roots' and ``LedgerManager`` s' build
   times, the nomination, (c)'s and (d)'s closes;
23. catchup on the card — ``WorkScheduler(VirtualClock(VIRTUAL_TIME)).
   schedule(CatchupWork(lm, archive, CatchupConfiguration(127, mode,
   count)))``: the history archive state, the checkpoints' downloads and
   decode, the chain verified (one K3 over ledgers 3-127's 125 headers),
   bucket adoption with the hot archive, the coalesced signature
   prefetch of a checkpoint (``COALESCE_FLUSH_SIGS``, 16,384 triples in
   one ``batch_verify_into_cache``: one K1 cold or K2 hot), then 64
   replayed ``close_ledger`` calls each checked against the archive's
   header hash. ``BASELINE.json`` config 3 at full width a ledger, cut
   to one replayed checkpoint: ``vectors.catchup_plan`` from
   ``CATCHUP_SEED``, 256 senders and 256 destinations, ledger 3
   upgrading to state archival (two entries evicted into the hot
   archive) and ``maxTxSetSize`` 1,000, ledgers 4-63 empty, 64-127 each
   one payment from every sender; signed on a process pool (its seconds
   printed apart), built by the port's closes and published by a
   ``HistoryManager`` into a ``FileArchive`` in a temporary directory.
   Passes, each after a verify-cache flush: (a) ``RECENT`` (count 63:
   checkpoint 63 adopted, 64-127 replayed) on a fresh node, 2 times with
   the signer-table cache off: one K1, one K3, no K2, no verify-cache miss
   inside the closes, the oracle agreeing with the cache on a seeded
   sample of the flushed triples; (b) the same hot, 2 times, after the
   256 tables are built by one ``batch_verify_into_cache`` of (a)'s
   flushed triples (what the prefetch of an untimed pass would do): one
   K2, one K3, no K1; (c)
   ``SKIP_KNOWN_RESULTS``: no K1 or K2, one K3 a replayed ledger (the
   contents hashes) besides the chain's; (d) ``MINIMAL``: buckets only,
   one K3, no K1 or K2; (e) a node with ``NodePersistence(Database(...),
   BucketManager(...))`` runs (a)'s catchup with every close saved, and
   copies of its files restore with ``LedgerManager.from_persistence`` at
   the reference's ``INDEX_CUTOFF_BYTES`` and at 0 (every bucket through
   ``DiskBucket``'s index and SipHash); each restored node, and (a)'s in
   memory, closes ledger 128 (256 more payments). Gates: ledger 127 is
   ``CATCHUP_LCL_HASH`` in the build and after every pass, every
   ``RECENT`` pass replays the 64 ledgers 64-127, every replayed header
   hash is the archive's, ``hashlib`` agrees with every verified header,
   each pass's K1/K2/K3 counts, every ledger 128 is
   ``CATCHUP_NEXT_HASH`` (both pins the reference's chain), the dispatch
   clean. Printed: each pass's wall and replayed ledgers a second, p50
   and p90 of the replayed closes, the chain verify beside hashlib, the
   download and decode, bucket downloads, adoption, the verify and hash
   engines' spans (the coalesced prefetch, the chain), the ``ledger.close``
   and ``bucket.addBatch`` zones and the fee and apply phases, the
   engines' share of the wall; the build's signing, closes, nomination
   and archive bytes; (e)'s save a close, restores and ledger 128 closes;
24. the node — ``BASELINE.json`` config 4, "SCP quorum simulation
   (src/simulation): 16 validators x 5 ballot rounds envelope-sig
   storm", through the port's own entry points: ``Simulation.add_node``
   with a ``Config`` a node (``QUORUM_INTERSECTION_CHECKER`` off, as the
   simulation's default), ``add_connection`` (the ``Topologies.core(16)``
   mesh, threshold 11, keys ``SecretKey.from_seed_str("sim-node-i")``),
   ``start_all_nodes`` and ``crank_until_ledger`` under ``VIRTUAL_TIME``;
   the handshakes on the pure-Python X25519 ladder (the machine has no
   ``cryptography``). (a) ``VERIFY_SERVICE_ENABLED``: SCP envelopes ride
   the resident service's ``scp`` lane and peer auth certs its ``auth``
   lane; cranked until every node holds 15 authenticated peers, then 5
   ledgers. (d) on (a)'s network: node 1's last statement re-signed with
   one signature byte flipped is rejected by node 0's
   ``herder.recv_scp_envelope`` through the scp lane, and node 1's auth
   cert with a flipped byte is refused by ``verify_remote_cert`` through
   the auth lane, both verdicts the oracle's. (b) the same network with
   ``WORKER_THREADS`` 2 and no service: ``Application`` installs
   ``default_verifier()`` behind a ``TrickleBatcher`` (1 ms window), so
   every ``verify_sig`` goes to the card. (c) a flood over core4 with
   the service on, ``MAX_TX_SET_SIZE`` 1,000 and
   ``BACKGROUND_BUCKET_MERGES`` off (the worker pool's work inline, so
   the ledgers do not follow the card's timing): 1,000 funded single-key
   sources (``vectors.flood_accounts``), their payments signed in
   process (``vectors.flood_envelopes``); before each of 10 ledgers node
   1 relays 100 of them to node 0 as overlay TRANSACTION messages, and
   node 0's own pre-verify site (``_preverify_into_cache``) puts each on
   the ``bulk`` lane before admitting it; they flood on by advert and
   demand (the other nodes' pre-verify finds them in the verify cache,
   which the nodes of one process share), are nominated, validated
   (``check_valid``, whose prefetch finds them cached) and closed;
   cranked until every payment has applied on every node. Gates: every
   node in consensus; ledger 6's header hash ``NET_LEDGER_HASH`` and the
   statements' digest ``NET_STATEMENT_DIGEST`` in (a) and (b), ledger 12
   ``FLOOD_LEDGER_HASH`` and the destination's ``FLOOD_DEST_BALANCE`` on
   every node in (c) (all the reference's runs of the same shapes); the
   host oracle decides no signature while an arm runs (``keys._ref``
   counted) and every triple the card decided is decided again by the
   oracle after the arm, with the same verdict; in (c) every bulk row
   put there by node 0's pre-verify site, one a payment; no
   ``service_verified`` fallback (in (b), where no service runs, only "absent" ones), nothing
   shed, rejected or failed; K1 + K2 launched in (a), (b) and (c); the
   service, the trickle backend and the worker pool stopped before the
   next arm; the dispatch clean. Printed: each arm's wall, rounds a
   second, statements and distinct triples, each lane's round trips as
   the crank waits on them (p50, p99, seconds blocked: the verify
   path's share of the wall), the kernels' device time (CUDA events
   around each launch) and its share of the wall, the service's
   submissions and dispatches, the trickle's dispatches, the engine's
   spans, the handshakes' wall, the
   flood's messages (FLOOD_ADVERT, FLOOD_DEMAND, TRANSACTION) and its
   closes' p50 and p90;
25. Soroban — ``BASELINE.json`` config 5, "Soroban InvokeHostFunction
   txs w/ ed25519 auth entries + FeeBump outer sigs, 500 tx/ledger",
   through the port's own entry point
   ``simulation.load_generator.soroban_apply_load``, with
   ``default_verifier().install()`` as ``keys.verify_sig``'s backend (the
   signer-table cache on, empty) and the verify cache flushed. (a)
   ``soroban_apply_load(n_ledgers=3, txs_per_ledger=500)`` on the
   harness's SCVal program: two setup closes (upload, create), then 3
   ledgers of 500 ``FeeBumpTransactionFrame`` s, the outer envelope
   signed by one of 50 payers, the inner by one of 50 sources, each
   calling ``auth_incr`` with one auth entry signed by one key: 1,500
   signatures a ledger. The harness's set build runs no ``check_valid``,
   so each load close's own prefetch sends the 1,000 envelope signatures
   to one ``verify_batch`` (K1 at a signer's first sight, K2 after), and
   each auth entry's signature reaches the card alone during apply (one
   one-row ``verify_batch``). The harness's code is the reference's,
   untouched: the phase puts a recording ``LedgerManager`` (each close's
   header hash, ``LedgerCloseMeta`` bytes, verify calls, cache misses and
   spans) and a timed set build in its module's names; the set build
   first prefetches the candidate frames' contents hashes through
   ``hash_many`` (``tx_set.prefetch_contents_hashes``), as a node's
   admission does: each preimage (792 B inner, 920 B fee-bumped) is
   longer than K3's 8 blocks take, so the hasher serves them on the
   host and K3 is not on config 5's path.
   (b) the compiled wasm counter, ``use_wasm=True``, 1 ledger of 500, on
   the native engine built in phase 2. (c) ``vectors.
   soroban_tamper_envelopes``: the compiled counter deployed and invoked
   by ten sources, one auth signature with a byte flipped. Gates: (a)
   and (b) apply every transaction and count to 1,500 and 500; the five
   and three close hashes and the meta bytes' hash equal the reference's
   (``SOROBAN_CLOSE_HASHES``, ``SOROBAN_META_HASH``, ``SOROBAN_WASM_*``);
   inside each load close one batch of 1,000 rows, 500 one-row verifies,
   none of them an envelope's, and 1,500 verify cache misses (the
   prefetch's 1,000 lookups and the 500 auth entries); (b)'s engine
   ``wasm-native``; in (c) 9 apply and the flipped one fails with
   ``txFAILED`` / ``INVOKE_HOST_FUNCTION_TRAPPED`` (the reference's),
   the card's verdict False; the host oracle decides no signature while
   an arm runs and decides every triple again after it, with the same
   verdicts; K1 and K2 launched in (a) and (b), and every contents
   hash of a load set served on the host (K3 0); the backend restored
   after each arm; the dispatch clean. Printed: per ledger the signing
   seconds, the set build, the close, inside it the verify engine's span
   and the rest, the auth verifies' count, p50, p99 and share of the
   close; the harness's ``close_mean_ms``, ``close_max_ms`` and
   ``txs_per_sec``; the kernels' device time (CUDA events around each
   launch), its share of the wall, and each kernel's launches and rows;
26. fault domains — on the 4-index verifier: ``fail-device`` on
   index 1 quarantines only index 1 and its parts move to the survivors;
   after the backoff one probation sub-chunk heals it; ``corrupt-device``
   on index 2 is caught by the audit, which quarantines 2 for good and
   moves its parts; every verdict equals the oracle and every row is
   served by a card; then a launch fault on every index, and on a
   one-card verifier, raises.
27. the operator surface, last — (a) ``BASELINE.json`` config 1,
   "stellar-core standalone mode, 1 ledger close, 100-tx Payment TxSet",
   through a node started as a user starts it, ``python -m
   stellar_tpu_torch --conf <file> run`` in a process of its own, over a
   database given ``vectors.operator_genesis`` (the network root holding
   every coin), standalone with manual close, its HTTP port bound at 0
   and read from its ``node up:`` line, the verify service on and
   nothing else asked of the card (no ``WORKER_THREADS``: ``Application``
   installs the device batch verifier wherever a card answers): the
   root's transaction creating 100 accounts, then 100
   payments from as many first-seen signers, then 100 more from the same
   signers, each over the ``tx`` route (every answer ``PENDING``) and
   closed on ``manualclose``; every admin route read; empty closes to
   checkpoint 63, which the node publishes; SIGINT, exit code 0. Gates:
   the three ledgers applied 1, 100 and 100 (the node's database); the
   101 accounts' balances and sequence numbers the reference's
   (``vectors.OPERATOR_STATE_DIGEST``, through ``testacc``);
   ``dispatch`` names the device batch verifier and reads the card's
   state; by the node's ``dispatch`` and ``metrics`` routes no row on
   the host, 100 first sights (card rows off K2, signer-table misses)
   then 100 table hits on K2; no service fallback, shed, rejection or
   failure, no trickle rejection, no deadline miss, short circuit or
   audit mismatch. (b) in this process, ``main(argv)`` of the port's
   CLI on (a)'s files: ``self-check`` (all three state checks; its
   benchmark the host oracle, no backend installed), ``offline-info``
   (ledger 63 and its hash), ``dump-ledger --filter "type=='ACCOUNT'"``
   (the pinned accounts), ``print-publish-queue`` and ``publish``;
   ``catchup 63/complete`` into a fresh database given the same genesis
   and (a)'s configuration, its printed hash (a)'s ledger 63's, the
   host oracle deciding nothing (``keys._ref`` counted) and K1 launched;
   ``apply-load --scenario close --ledgers 1 --txs 100`` with its default
   ``--verify``, K1 or K2 launched. (c) ``BASELINE.json`` config 4 over
   localhost sockets: ``Simulation(mode=OVER_TCP)``, 16 validators on
   real-time clocks with the verify service, a ``CommandHandler`` on
   node 0; every node authenticates its 15 peers, every node closes
   each of 5 ledgers with the same hash, K1 on exactly the 16
   validators' first sights (card rows off K2) and K2 on the rest;
   node 0's ``peers``, ``quorum``, ``scp`` and ``info`` routes read on
   a thread while the network cranks; node 1's last statement re-signed
   with a flipped byte and sent to node 0 over its ``TCPPeer`` is
   refused by the card (and the oracle), and the network closes one
   more ledger; the same gates as phase 24's arms. Printed: (a)'s
   start, each round's round trips and close, the routes' ms; (b)'s
   seconds; (c)'s wall, the TCP transport's seconds (``TCPDriver.poll``
   less the frames' handling, plus the socket writes) and share, the
   lanes' round trips, the kernels' device time;
28. the analysis on the card's machine — (a) ``python -m
   stellar_tpu_torch.tools.analyze --json`` in a subprocess: the
   hot-path, lock, lock-order and nondeterminism lints and the
   proof-coverage gate clean, the interval prover over every stage of the
   plain versions (``kernel_total`` and ``kernel_hot_total`` included)
   with no violation, and each envelope's ``envelope_sha256`` that of the
   committed golden; (b) ``python -m stellar_tpu_torch.tools.kernel_cost
   --json`` with the card's SM count and clock and the rows phases 6 and
   9-11 measured K1, K2, K3 and K5 on: every multiply-add count,
   executed count and bound equal to the one that phase used; (c) the
   device probe (``python -m stellar_tpu_torch.tools.device_probe``)
   twice: plain, ``ok`` for ``cuda:0`` with its line appended to
   ``build/torch_device_probes.jsonl``; under ``CUDA_VISIBLE_DEVICES=``,
   no card recorded and a nonzero exit; (d) each part's seconds and the
   phase's, which must stay under 180;
29. the tools on the card — (a) ``tools.run_benchmarks.run_all(quick=
   False, verify="device")``: the reference's five BASELINE scenarios
   and the compute A/B at full scale (config 1 130 x 100, config 2 5 x
   1,000, config 3 130 ledgers of 10, config 4 16 x 5, config 5 and the
   compute load each three interleaved runs a side), the signer-table
   cache on from empty, each harness call's wall, K1/K2/K3 launches and
   kernels' CUDA-event time read around it (the harnesses wrapped in
   ``simulation.load_generator``'s own names, its ``LedgerManager``
   recording each close's header hash); every row's ``verify_backend``
   ``device-batch``, the host oracle deciding nothing, the native oracle
   re-deciding every triple the card decided, each harness's full
   applied count, config 4 in consensus, configs 2-4 launching K1 and
   K2, and the last header hash and non-timing fields of configs 1-3 the
   reference's (``BENCH_PINS``); (b) ``tools.trace_kernel_time.capture``
   (``torch.profiler``, CUDA activities only; one untimed call, then 3)
   of phase 4's cold TxSet (cache off), phase 7's hot TxSet (cache on)
   and one config-2 ledger (``multisig_apply_load(1, 1000)``): the device
   busy ms a call, the wall, the idle share and the top device ops, the
   traced K1/K2/K3 counts equal to the launch counters over the traced
   calls, each TxSet kernel's traced time a launch at most 1.1x its phase
   6 or 9 CUDA-event time, and a trace with no device event a failure;
   (c) ``tools.trace_export``'s synthetic resolve on the card and its
   fleet window, each loading as JSON with spans, instants and counter
   samples;
30. the engine's four self-checks on the card, in this process, each
   ``run()`` of ``stellar_tpu_torch.tools.<name>`` printed as one
   ``[selfcheck]`` line and failing the run unless ``ok`` and on the
   card: (a) ``metrics_selfcheck`` (one 64-row resolve from 8 signers,
   as the reference's: the first sights build their tables and ride
   K1, the repeats ride K2; every phase span, their coverage of the
   root, the Prometheus exposition); (b)
   ``transfer_selfcheck`` (K3 over the card named 4 times, the resident
   cache off then on, ``flaky-device:0`` armed: the redundancy detector,
   zero redundant bytes with resident hits, the ledger reconciled with
   the engine, every digest hashlib's); (c) ``pipeline_selfcheck`` (K3
   over the card named 4 times: ``stall-device:1`` and
   ``stall-transfer:1`` as ``queue_wait`` bubbles, a 6-chunk resolve's
   ``overlap_frac`` at least 0.5, the time-series ring hammered
   concurrently); (d) ``hot_signer_selfcheck`` at 1,008 signers (K1 and
   K2 over the card named 4 times: oracle verdicts, replicas equal,
   every launch at 2 rows, zero redundant bytes on re-dispatch with the
   resident cache on, evictions under a 10-table budget); each tool's
   seconds and K1/K2/K3 launches (one K1 and one K2 for (a), K3 for (b)
   and (c), K1 and K2 for (d)), the engines of (a) and (d) clean after;
   (e) the attribution floor, printed and not gated: 40 K1-only 64-row
   calls with the signer-table cache off, their coverage (the open fault
   of ROADMAP queue 3); the phase under 120 s.

Each kernel's launch count is set to 0 just before its path runs and read
just after: K1 over phases 4-5 and again over phases 7-8, K2 over phases
7-8, K3 over phase 10's calls, K5 over phase 11's sweep calls, K4 over
phase 12's calls, K1 and K2 again over phase 13, K1 over phase 16, K1
and K2 over phase 18 (``launches_service``; (a) alone
``launches_service_mixed``), K1 and K2 over phase 19 (a) and (b)
(``launches_fleet``, ``launches_wire``), K1 and K3 over phase 20's cold
passes and K2 and K3 over its hot ones (``launches_node``,
``launches_node_hot``), K1 and K3 over phase 21's cold passes and K2 and
K3 over its hot ones (``launches_txset``, ``launches_txset_hot``), K1
over phase 22 (a)'s passes (``launches_close_config1``), K1 and K3 over
its cold replayed closes and K2 and K3 over its hot ones
(``launches_close``, ``launches_close_hot``), K1, K2 and K3 over each
pass of phase 23 (``launches_catchup`` over (a), ``launches_catchup_hot``
over (b), ``launches_catchup_build``, ``_skip``, ``_minimal``,
``_persist`` and ``_next`` for the build, (c), (d), (e)'s catchup and
(e)'s three ledger-128 tx sets and closes), K1, K2 and K3 over each arm
of phase 24 (``launches_net_service`` (a), ``_trickle`` (b), ``_flood``
(c), ``_tamper`` (d); each kernel's device time in (a), (b) and (c),
CUDA events around its launches, as ``net_device_ms``), K1, K2 and K3
over each arm of phase 25 (``launches_soroban`` (a),
``launches_soroban_wasm`` (b), ``launches_soroban_tamper`` (c); the
device time of (a) and (b) as ``soroban_device_ms``), K1, K2 and K3
over each in-process arm of phase 27 (``launches_operator_offline``,
``_catchup`` and ``_apply_load`` for (b)'s commands, ``_tcp`` and
``_tcp_tamper`` for (c); (c)'s device time as ``operator_device_ms``);
(a) runs in the node's process, so its rows a kernel come from the
node's ``dispatch`` route (``rows_operator_run``); its ``pipeline``
route's delivered parts count the launches of all kernels together, and
are printed in (a)'s line, not under any one kernel. K1, K2 and K3 over
phase 29 (a)'s ``run_all`` (``launches_tools``; each scenario's, over all
its runs, in ``tools_launches_by_scenario``), and over phase 30's four
self-checks (``launches_selfchecks``; each tool's in
``selfchecks_launches_by_tool``). After every
main-path phase the dispatch must be clean: no device fault (no retry, every
breaker closed and never opened), no audit mismatch, no conviction; only
phases 16, 18 (c) and (e), and 26 expect otherwise. The
engine has no host failover, so no row of a card is ever served by the
host. Before the last line, one ``{"kernels": [...]}`` line holds every
kernel's launches, times, bound and build; the last line is ``{"ok":
true, "device": {...}}``. With no card, or outside the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import bisect
import collections
import contextlib
import copy
import hashlib
import inspect
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

try:
    import numpy as np
    import torch

    import stellar_tpu_torch.tx.ops  # noqa: F401 (fills the op registry)
    from stellar_tpu_torch import invariant
    from stellar_tpu_torch.bucket import bucket_index
    from stellar_tpu_torch.bucket.bucket_manager import BucketManager
    from stellar_tpu_torch.bucket.hot_archive import header_bucket_list_hash
    from stellar_tpu_torch.catchup import catchup
    from stellar_tpu_torch.crypto import ed25519_ref as ref
    from stellar_tpu_torch.crypto import (fleet, ingress, keys, native_prep,
                                          native_verify, strkey, tenant,
                                          vectors, verify_service)
    from stellar_tpu_torch.crypto.batch_hasher import (
        MAX_BLOCKS, MIN_DEVICE_HASH_BATCH, default_hasher, hash_many)
    from stellar_tpu_torch.crypto.batch_verifier import (
        BatchVerifier, Ed25519HotWorkload, Ed25519Workload, TrickleBatcher,
        default_verifier)
    from stellar_tpu_torch.database import Database, NodePersistence
    from stellar_tpu_torch.herder import herder as herder_mod
    from stellar_tpu_torch.herder import tx_set
    from stellar_tpu_torch.history import history_manager
    from stellar_tpu_torch.invariant.invariants import InvariantManager
    from stellar_tpu_torch.ledger import ledger_manager
    from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, key_bytes
    from stellar_tpu_torch.main import cli as port_cli
    from stellar_tpu_torch.main.command_handler import CommandHandler
    from stellar_tpu_torch.ops import _build
    from stellar_tpu_torch.ops import sha256 as sk
    from stellar_tpu_torch.ops import verify as vk
    from stellar_tpu_torch.overlay import overlay_manager
    from stellar_tpu_torch.overlay.peer import Peer
    from stellar_tpu_torch.overlay.tcp import TCPDriver, TCPPeer
    from stellar_tpu_torch.parallel import batch_engine, mesh, residency
    from stellar_tpu_torch.parallel.batch_engine import DEFAULT_BUCKET_SIZES
    from stellar_tpu_torch.parallel.signer_tables import (
        TABLE_ENTRIES, build_signer_table, signer_table_cache)
    from stellar_tpu_torch.scp.scp import EnvelopeState
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    from stellar_tpu_torch.simulation import load_generator
    from stellar_tpu_torch.simulation.simulation import Simulation
    from stellar_tpu_torch.soroban import native_wasm
    from stellar_tpu_torch.utils import (faults, journal, metrics, native,
                                         resilience, tracing)
    from stellar_tpu_torch.utils import workers as bg_workers
    from stellar_tpu_torch.utils.device import resolve_device
    from stellar_tpu_torch.utils.metrics import registry
    from stellar_tpu_torch.utils.timeline import pipeline_timeline
    from stellar_tpu_torch.utils.timer import VIRTUAL_TIME, VirtualClock
    from stellar_tpu_torch.utils.transfer_ledger import (
        DEFAULT_FP_MAX_BYTES, transfer_ledger)
    from stellar_tpu_torch.analysis import overflow
    from stellar_tpu_torch.tools import (
        hot_signer_selfcheck, kernel_cost, metrics_selfcheck,
        pipeline_selfcheck, run_benchmarks, trace_export, trace_kernel_time,
        transfer_selfcheck)
    # the kernels' multiply-adds, operations and bounds (the card's
    # figures with them)
    from stellar_tpu_torch.tools.kernel_cost import (
        HOT_ENTRY_BYTES, IMAD_PER_CLOCK_PER_SM, INT_OPS_PER_CLOCK_PER_SM,
        ROW_BYTES, bound, cold_kernel_executed, cold_kernel_multiplies,
        hot_kernel_executed, hot_kernel_multiplies, r16_kernel_executed,
        r16_kernel_multiplies, sha_ops_per_block)
    from stellar_tpu_torch.tx import tx_test_utils
    from stellar_tpu_torch.tx.op_frame import account_key
    from stellar_tpu_torch.tx.transaction_frame import make_transaction_frame
    from stellar_tpu_torch.work.work import WorkScheduler
    from stellar_tpu_torch.xdr import ledger as xledger
    from stellar_tpu_torch.xdr import results as xresults
    from stellar_tpu_torch.xdr import tx as xtx
    from stellar_tpu_torch.xdr import types as xt
    from stellar_tpu_torch.xdr.overlay import MessageType, StellarMessage
    from stellar_tpu_torch.xdr.scp import SCPEnvelope
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
# cycles of torch.cuda._sleep a second: at least the card's SM clock, so
# that a spin lasts at least as long as asked (queued_ms checks it did)
SLEEP_CYCLES_PER_S = 2e9
# the cold TxSet's operands at its 2,048 bucket (A, R, s, h) and the hot
# TxSet's table operand, over the resident cache's 1 MiB cap
TXSET_OPERAND_BYTES = 4 * KERNEL_BATCHES[0] * 32
HOT_TABLE_BYTES = KERNEL_BATCHES[0] * 128 * HOT_ENTRY_BYTES
# The instructions of the built K3 that do that work, counted from its
# SASS beside the bound (hash_kernel_executed): 32-bit integer add, logic
# and shift.
SHA_SASS_OPS = ("SHF", "LOP3", "IADD3", "IMAD.IADD")
_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?"
                        r"([A-Z0-9_.]+)\s*([^;]*);")

# the split phases' device list: the one card named this many times
SPLIT = 4
# phase 26's per-device backoff: far longer than a TxSet call (tens of
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
# phase 20's traffic comes from a generator of its own, so that phases
# 20-22's transactions, and phase 22's pinned hashes, do not depend on
# what the phases before drew
NODE_SEED = 20261018
NODE_PASSES = 10
NODE_SAMPLE_S = 0.05
NODE_STEPS = ("decode", "payload", "hash", "collect", "prefetch", "check")
# phase 21, the node's TxSet: timed passes cold and hot over phase 20's
# transactions, the previous ledger's hash the set names, and the steps of
# a pass (each a public call of herder/tx_set.py)
TXSET_PASSES = 10
TXSET_LCL = hashlib.sha256(b"chip_smoke.py phase 21").digest()
TXSET_STEPS = ("decode_prepare", "hash", "check_valid", "apply_order")
# phase 22: the node's ledger close
CLOSE_TIME = 5000
CONFIG1_TXS = 100
CONFIG1_PASSES = 10
CLOSE_PASSES = 5
CLOSE_STEPS = ("decode_prepare", "hash", "close")
# the reference's closes of the same ledgers (stellar_tpu, on the CPU;
# tests/test_torch_ledger_close.py recomputes them): config 1 in tier 1,
# config 2 in the test marked slow
CONFIG1_CLOSE_HASH = "54892cc957c8aa2452189c61983a6a3cb2ef799d831ce11766a7a740ff85a1b3"
CONFIG2_APPLIED = 963
CONFIG2_CLOSE_HASH = "703649b1b5d89f6667d078687e56e502d4f4a00a2ee947bd14bcc3eb77384c7b"
CONFIG2_META_HASH = "1703825e8d2e7ddfca3bd083736e3efa5a217f1f4bb96bdcae5118e25f7866aa"
# Phase 23: BASELINE.json config 3 at full width a ledger, cut to one
# replayed checkpoint (vectors.catchup_plan). The pins are the
# reference's chain from the same seed: ledger 127's header hash and the
# hash of the close of ledger 128 over it (tests/test_torch_catchup.py::
# test_catchup_pin_is_the_reference_chain recomputes both).
CATCHUP_SEED = 20261019
CATCHUP_SENDERS = 256
CATCHUP_FIRST_FULL = 64
CATCHUP_LAST = 127
CATCHUP_COUNT = 63          # RECENT: adopt checkpoint 63, replay 64-127
CATCHUP_REPLAYED = CATCHUP_LAST - CATCHUP_COUNT
CATCHUP_SIGS = CATCHUP_SENDERS * (CATCHUP_LAST - CATCHUP_FIRST_FULL + 1)
CATCHUP_HEADERS = CATCHUP_LAST - 2   # ledgers 3-127 in the archive
CATCHUP_COLD_PASSES = 2
CATCHUP_HOT_PASSES = 2
CATCHUP_SAMPLE = 64
CATCHUP_SIGN_WORKERS = 8
CATCHUP_PASSPHRASE = "test-net"
CATCHUP_LCL_HASH = "3c06080666c149073e10014aa0b2a79c6731179ea521963bbad9696903394a16"
CATCHUP_NEXT_HASH = "7fd136b076d648234b66c52a8ddae47e94139aebc95a1f797b705282f5b6b887"
# Phase 24: the node. (a) and (b) are BASELINE.json config 4, "SCP quorum
# simulation (src/simulation): 16 validators x 5 ballot rounds
# envelope-sig storm": Topologies.core(16) (threshold 11) from
# SecretKey.from_seed_str("sim-node-i"), 5 ledgers after the mesh
# authenticated. (c) a flood over core4: 100 payments injected at node 0
# before each of 10 ledgers, 1,000 funded sources. The pins are the
# reference's runs of the same shapes on the CPU (tests/test_torch_scp.py
# and tests/test_torch_overlay.py recompute them in tests marked slow):
# ledger 6's header hash and the SHA-256 over the sorted XDR bytes of
# every distinct statement in the nodes' statements_history; the flood's
# last ledger and its header hash.
NET_VALIDATORS = 16
NET_ROUNDS = 5
NET_AUTH_TIMEOUT_S = 60
NET_CRANK_TIMEOUT_S = 600
NET_LEDGER_HASH = "1c98ece7b79c54255362a7069356b18a67b2f22628b25bd71af30e1379aa6dac"
NET_STATEMENT_DIGEST = "464002bb39b237f951a5f388ded8d2aa7087c4b55d2ec3c1dff270b4f5ce2b69"
NET_TRICKLE_WORKERS = 2
FLOOD_VALIDATORS = 4
FLOOD_SOURCES = 1000
FLOOD_PER_LEDGER = 100
FLOOD_MAX_TX_SET_SIZE = 1000
FLOOD_LAST_LEDGER = 12
FLOOD_LEDGER_HASH = "355ee4a1d4d34c9f3c3f147d52807747c2a077031cd5c74f3794c67de274e3ef"
FLOOD_DEST_BALANCE = 20_000_000_000   # 2,000 XLM: 1,000 + 1,000 payments of 1
# phase 25: BASELINE.json config 5 through simulation.load_generator's
# soroban_apply_load; two setup closes (upload, create), then the loads.
# The pins are the reference's closes of the same calls (header hashes
# in close order, SHA-256 over the closes' LedgerCloseMeta bytes joined)
SOROBAN_LEDGERS = 3
SOROBAN_TXS = 500
SOROBAN_WASM_LEDGERS = 1
SOROBAN_CLOSE_HASHES = (
    "dbdc8bdfa4d0784af8b7174533f02cf233ad6b981b6637d77af9a7834e6fcf93",
    "7124ebaaebe8931f83edfcdd710f9ec191ac0cd04ac3dfe58f5596d9cd0a4023",
    "afeeeb50ca8d28d32802a4a5c47096fa31c41aad048d5c788e679052a0102b8a",
    "461b51f69306f1c2944ed9aeb0e531804ec62293bdc4a24d77e424aa13d18b6f",
    "bce8aeabcaea96e19dac1f762499d9ba2f63cd98c9c35fc1e8320880157bbc97")
SOROBAN_META_HASH = "79dc56104b85d3dc52588fe5f6c5db30850177a504a475556e09b69549381033"
SOROBAN_WASM_CLOSE_HASHES = (
    "8bbd12e36b69c5d1f085a744aa72dc8bd5e8e5a22fe3df0a2d6853bfacb1c917",
    "cbc097e05748ab810ffbddb5d191a8b2aebf75c9e1484050682fefc1d7382be2",
    "61078500c94034342ad1e37e3a6d9ce06013fb2acce6b342e20a083c86139381")
SOROBAN_WASM_META_HASH = "64164fb26f14aa73d85d993b9b5b223aafc7f29a8c1100b70781249eac9000ad"
SOROBAN_TAMPER_CLOSE_HASH = "fa9e16832b39437aba18d2997471db7bf1d84005f22f557a8d37c6b64d9a46d2"
SOROBAN_TAMPER_CODE = "INVOKE_HOST_FUNCTION_TRAPPED"
# phase 27, the operator surface. (a) BASELINE.json config 1, "stellar-core
# standalone mode, 1 ledger close, 100-tx Payment TxSet", through a node
# started as a user starts it (``python -m stellar_tpu_torch --conf <file>
# run``) over its database given ``vectors.operator_genesis``: the root's
# transaction creating the 100 accounts, then two rounds of one payment
# from each (``vectors.operator_rounds``), over its ``tx`` route, each
# ledger closed on ``manualclose``; then empty closes to checkpoint 63,
# which the node publishes. Its configuration asks for the verify service
# and nothing else of the card: ``Application`` installs the device batch
# verifier wherever a card answers, so the transactions' one-row
# admission checks go to the card by default. No close timer fires in the arm
# (``EXPECTED_LEDGER_CLOSE_TIME``). (b) the CLI on that node's files, in
# this process; ``catchup 63/complete`` into a fresh database given the
# same genesis. (c) BASELINE.json config 4 over localhost sockets,
# ``Simulation(mode=OVER_TCP)``, each node on its real-time clock.
OPERATOR_PASSPHRASE = "Standalone stellar_tpu Network"   # Config's default
OPERATOR_CLOSE_TIMER_S = 3600
OPERATOR_UP_S = 180
OPERATOR_STOP_S = 60
OPERATOR_ROUTES = ("info", "dispatch", "service", "metrics",
                   "metrics?format=prometheus", "spans", "pipeline",
                   "journal", "quorum")
TCP_VALIDATORS = NET_VALIDATORS
TCP_ROUNDS = NET_ROUNDS
TCP_AUTH_TIMEOUT_S = 120
TCP_CRANK_TIMEOUT_S = 300
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
# phase 29 (a): each scenario's full applied count under
# ``tools.run_benchmarks.run_all`` at the reference's scale, and the
# reference's last header hash and non-timing fields of configs 1-3
# (``tests/test_torch_tools.py``'s ``slow`` test recomputes them with the
# reference's harnesses)
BENCH_APPLIED = {"close": 130 * 100, "multisig": 5 * 1000,
                 "soroban": 3 * 500, "soroban_wasm": 3 * 500,
                 "soroban_compute_scval": 3 * 100,
                 "soroban_compute_wasm": 3 * 100}
BENCH_PINS = {
    "close": ("6b03281336a86719e351e0d5338d4e6b4172c2809db4cb66de9c7086b7d77594",
              {"ledgers": 130, "txs_per_ledger": 100,
               "total_applied": 13000}),
    "multisig": (
        "4d3a2ed85331ac588f1ee6ab59dd3b97a75c8eb892cb4e196eb904fe9e4f06e6",
        {"scenario": "multisig", "ledgers": 5, "txs_per_ledger": 1000,
         "signatures_per_ledger": 2000, "total_applied": 5000}),
    "catchup": (
        "47410ce79289767528ffc41ee3a140e239a1b832dc319f905d0590bc6b1ac15a",
        {"scenario": "catchup-replay", "replayed_ledgers": 125,
         "txs_per_ledger": 10})}
BENCH_SCP_ROUNDS = 5
# phase 29 (b): the traced calls after the untimed one; a kernel's traced
# time a launch within this factor of its CUDA-event time at the same
# bucket (phases 6 and 9; the events include the host's issue gap); one
# config-2 ledger's transactions; where the traces are written
PROFILE_ITERS = 3
PROFILE_SLACK = 1.1
PROFILE_MULTISIG_TXS = 1000
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "torch_traces")


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


# The rows each kernel phase computed a bound on (phases 6 and 9-11),
# for phase 28 to recompute with the kernel_cost tool: kernel, label,
# operand bytes, the rows' s and h (or K3's active blocks), and what the
# phase computed.
COST_RECORDS = []


def note_cost(kernel, label, s_bytes, h_bytes, nbytes, **computed):
    rec = {"kernel": kernel, "label": label, "bytes": nbytes, **computed}
    if s_bytes is not None:
        rec["s"] = s_bytes.cpu().numpy()
        rec["h"] = h_bytes.cpu().numpy()
    COST_RECORDS.append(rec)


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
    """K1, K2, K3 and K5 with nvcc, the prep library, the host oracle and
    the native wasm engine with its CPython extension with g++, all eight
    builds started together. Returns K1's, K2's and
    K5's registers, spills, lanes a row and shuffle loops, and K3's
    registers and SASS block loop, by library name."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_build.LIBRARIES) + 4) as pool:
        jobs = [pool.submit(_build.library, name, dev)
                for name in _build.LIBRARIES]
        jobs.append(pool.submit(native_prep._load))
        jobs.append(pool.submit(native_verify._load))
        jobs.append(pool.submit(native_wasm._load))
        jobs.append(pool.submit(native_wasm._load_ext))
        for job in jobs:
            job.result()
    secs = time.perf_counter() - t0
    check(native_wasm.available(), "the native wasm engine did not build")
    ext = native_wasm._load_ext() is not None
    print(f"[build] K1, K2, K3, K5, the prep library, the host oracle and "
          f"the native wasm engine built in {secs:.1f} s; host oracle "
          f"backend {native_verify.backend()}; the wasm engine's CPython "
          f"extension {'loaded' if ext else 'not built (ctypes calls)'}")
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
    note_cost("verify_cold", label, ops[2], ops[3], b * ROW_BYTES,
              multiply_adds=macs, executed_multiply_adds=executed,
              bound_ms=bound_ms, bound_by=bound_by)
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
        note_cost("verify_hot", str(b), s_cpu, h_cpu, b * row_bytes,
                  multiply_adds=macs, executed_multiply_adds=executed,
                  bound_ms=bound_ms, bound_by=bound_by)
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
    note_cost("sha256", str(n), None, None, n * row_bytes, blocks=blocks,
              operations=blocks * sha_ops_per_block(), bound_ms=bound_ms,
              bound_by=bound_by)
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
        note_cost("verify_r16", str(b), s_cpu, h_cpu, b * ROW_BYTES,
                  multiply_adds=macs, executed_multiply_adds=executed,
                  bound_ms=bound_ms, bound_by=bound_by)
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


def _close_root_lm(build_root, nid):
    """A fresh root from ``build_root()`` and a ``LedgerManager`` over it
    (its genesis batch into the bucket list): ``(lm, root s, lm s)``."""
    t = time.perf_counter()
    root = build_root()
    root_s = time.perf_counter() - t
    t = time.perf_counter()
    lm = ledger_manager.LedgerManager(nid, root)
    return lm, root_s, time.perf_counter() - t


def _zone_ms(before, after, name):
    """A ``tracing.span_totals()`` timer's ms between two readings."""
    a, b = after.get(name), before.get(name)
    return (a["sum_ms"] if a else 0.0) - (b["sum_ms"] if b else 0.0)


def _close_spans(before, after):
    """Inside one close, from ``tracing.span_totals()`` deltas: the
    ``ledger.close`` zone, the verify engine's blocking span, the
    ``bucket.addBatch`` zone and the rest (the fee and apply phases, the
    hot archive, the eviction scan, the header), ms."""
    out = {"close_zone": _zone_ms(before, after, "zone.ledger.close"),
           "verify_span": batch_engine.dispatch_attribution(
               before, after)["blocking_span_per_rep_ms"],
           "add_batch": _zone_ms(before, after, "zone.bucket.addBatch")}
    out["rest"] = out["close_zone"] - out["verify_span"] - out["add_batch"]
    return out


def _config1_close(info):
    """Phase 22 (a): ``BASELINE.json`` config 1, ``tests/
    test_close_ledger.py``'s 100 payments to one destination over a fresh
    root each pass, closed with no ``check_valid`` before it: the close's
    own ``prefetch_signature_batch`` launches K1 once a pass (signer-table
    cache off)."""
    tu = tx_test_utils
    nid = tu.TEST_NETWORK_ID
    t = time.perf_counter()
    senders = [tu.keypair(f"s{i}") for i in range(CONFIG1_TXS)]
    dest = tu.keypair("well-known-dest")
    xlm = 10_000_000
    accounts = [(k, 1000 * xlm) for k in senders] + [(dest, 1000 * xlm)]
    start = 1 << 32   # seed_root_with_accounts' sequence numbers
    envs = [to_bytes(xtx.TransactionEnvelope, tu.make_tx(
        k, start + 1, [tu.payment_op(dest, xlm)]).envelope)
        for k in senders]
    build_s = time.perf_counter() - t
    dest_key = key_bytes(account_key(xt.account_id(dest.public_key.raw)))
    walls, setups, spans = [], [], collections.defaultdict(list)
    signer_table_cache.configure(enabled=False)
    try:
        for _ in range(CONFIG1_PASSES):
            lm, root_s, lm_s = _close_root_lm(
                lambda: tu.seed_root_with_accounts(accounts), nid)
            setups.append(root_s + lm_s)
            header = lm.last_closed_header
            header.maxTxSetSize = 200
            txset, excluded = tx_set.make_tx_set_from_transactions(
                [make_transaction_frame(nid, from_bytes(
                    xtx.TransactionEnvelope, e)) for e in envs],
                header, lm.last_closed_hash)
            check(not excluded, f"close (a): {len(excluded)} excluded")
            keys.flush_verify_cache()
            k1 = _counts()["verify_cold"]
            before = tracing.span_totals()
            t = time.perf_counter()
            res = lm.close_ledger(ledger_manager.LedgerCloseData(
                ledger_seq=lm.ledger_seq + 1, tx_set=txset,
                close_time=CLOSE_TIME))
            walls.append((time.perf_counter() - t) * 1e3)
            for k, v in _close_spans(before, tracing.span_totals()).items():
                spans[k].append(v)
            check(res.applied_count == CONFIG1_TXS and
                  res.failed_count == 0, f"close (a): applied "
                  f"{res.applied_count}, failed {res.failed_count}")
            check(res.header.feePool == 100 * CONFIG1_TXS,
                  f"close (a): feePool {res.header.feePool}")
            balance = lm.root.store.get(dest_key).data.value.balance
            check(balance == 1000 * xlm + CONFIG1_TXS * xlm,
                  f"close (a): the destination holds {balance}")
            check(res.header_hash.hex() == CONFIG1_CLOSE_HASH,
                  f"close (a): header hash {res.header_hash.hex()} is not "
                  "the reference's")
            launched = _counts()["verify_cold"] - k1
            check(launched == 1, f"close (a): {launched} K1 launches in "
                  "a pass")
    finally:
        signer_table_cache._reset_for_testing()
    return {"txs": CONFIG1_TXS, "build_s": build_s,
            "p50_ms": float(np.percentile(walls, 50)),
            "p90_ms": float(np.percentile(walls, 90)),
            "setup_p50_s": float(np.percentile(setups, 50)),
            "spans_p50_ms": {k: float(np.percentile(v, 50))
                             for k, v in spans.items()},
            "card": info["smi"]}


def _replay_close(raw, lm):
    """Catchup's order for one ledger on ``lm``: the verify cache flushed,
    ``TxSetXDRFrame.from_bytes`` and
    ``prepare_for_apply``, ``prefetch_contents_hashes`` (K3), then
    ``close_ledger`` (its ``sig_triples`` None, so its own
    ``prefetch_signature_batch``: K1 or K2). Returns the result, the
    prepared frames, the verify cache's misses over the pass, the ms of
    each step and the spans inside the close."""
    keys.flush_verify_cache()
    misses0 = keys.get_verify_cache_stats()["misses"]
    ms = {}
    t = time.perf_counter()
    applicable = tx_set.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(
        vectors.NODE_NETWORK_ID)
    t, ms["decode_prepare"] = time.perf_counter(), \
        (time.perf_counter() - t) * 1e3
    check(applicable is not None, "close: prepare_for_apply refused the set")
    tx_set.prefetch_contents_hashes(applicable.frames)
    t, ms["hash"] = time.perf_counter(), (time.perf_counter() - t) * 1e3
    before = tracing.span_totals()
    res = lm.close_ledger(ledger_manager.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=applicable,
        close_time=CLOSE_TIME))
    ms["close"] = (time.perf_counter() - t) * 1e3
    spans = _close_spans(before, tracing.span_totals())
    misses = keys.get_verify_cache_stats()["misses"] - misses0
    return res, applicable.frames, misses, ms, spans


def _check_config2(res, label):
    check(res.applied_count == CONFIG2_APPLIED and res.failed_count == 0,
          f"close ({label}): applied {res.applied_count}, failed "
          f"{res.failed_count}")
    check(res.header_hash.hex() == CONFIG2_CLOSE_HASH,
          f"close ({label}): header hash {res.header_hash.hex()} is not "
          "the reference's")


def _replay_passes(raw, build_root, keyed, label):
    """CLOSE_PASSES replayed closes, each on a fresh root and
    ``LedgerManager`` built before it, untimed, each gated."""
    walls, setups = [], []
    steps, spans = collections.defaultdict(list), collections.defaultdict(
        list)
    for _ in range(CLOSE_PASSES):
        lm, root_s, lm_s = _close_root_lm(build_root,
                                          vectors.NODE_NETWORK_ID)
        setups.append((root_s, lm_s))
        t = time.perf_counter()
        res, frames, misses, ms, sp = _replay_close(raw, lm)
        walls.append((time.perf_counter() - t) * 1e3)
        _check_config2(res, label)
        check(all(f._hash == hashlib.sha256(f.contents_preimage()).digest()
                  for f in frames),
              f"close ({label}): a contents hash differs from hashlib's")
        check(misses == keyed, f"close ({label}): {misses} verify cache "
              f"misses over the close, {keyed} keyed triples collected")
        for k, v in ms.items():
            steps[k].append(v)
        for k, v in sp.items():
            spans[k].append(v)
    return {"p50_ms": float(np.percentile(walls, 50)),
            "p90_ms": float(np.percentile(walls, 90)),
            "steps_p50_ms": {k: float(np.percentile(steps[k], 50))
                             for k in CLOSE_STEPS},
            "steps_p90_ms": {k: float(np.percentile(steps[k], 90))
                             for k in CLOSE_STEPS},
            "spans_p50_ms": {k: float(np.percentile(v, 50))
                             for k, v in spans.items()},
            "root_p50_s": float(np.percentile([a for a, _b in setups], 50)),
            "lm_p50_s": float(np.percentile([b for _a, b in setups], 50))}


def _one_close(raw, build_root, label):
    """One replayed close on a fresh root, gated, untimed against the
    passes: its ms."""
    lm, _r, _l = _close_root_lm(build_root, vectors.NODE_NETWORK_ID)
    t = time.perf_counter()
    res, _f, _m, _ms, _s = _replay_close(raw, lm)
    ms = (time.perf_counter() - t) * 1e3
    _check_config2(res, label)
    return ms


def phase_node_close(info, traffic):
    """Phase 22: the node's ledger close on the card. (a) config 1; then
    phase 21's accepted transactions over ``vectors.node_close_ledger``:
    (b) CLOSE_PASSES replayed closes cold (signer-table cache off) with
    K1's and K3's counts set to 0 before them and read after, one untimed
    close that builds the tables, CLOSE_PASSES hot with K2's and K3's;
    (c) one close after the set's own ``check_valid``; (d) one close each
    over the oracle, with every invariant, with a meta consumer."""
    t0 = time.perf_counter()
    check(keys._backend is None, "close: a verify backend is installed")
    check(batch_engine.device_available(block=True),
          "close: the device probe did not answer")
    check(keys.accelerated_verify_available(),
          "close: the close would not prefetch its signatures")
    res = {"card": info["smi"]}
    launches = {}
    _zero_counts()
    res["config1"] = _config1_close(info)
    launches["config1"] = _counts()
    check(launches["config1"]["verify_cold"] == CONFIG1_PASSES,
          f"close (a): K1 launches {launches['config1']}")
    nid = vectors.NODE_NETWORK_ID
    accepted = [e for e, ok in zip(traffic["envs"], traffic["verdicts"])
                if ok]
    check(len(accepted) == CONFIG2_APPLIED, f"close: {len(accepted)} "
          f"accepted transactions, the pins' set holds {CONFIG2_APPLIED}")
    accounts = traffic["accounts"]

    def build_root():
        return vectors.node_close_ledger(accounts, accepted)
    lm, res["root_s"], res["lm_s"] = _close_root_lm(build_root, nid)
    lcl = lm.last_closed_hash
    t = time.perf_counter()
    app, excluded = tx_set.make_tx_set_from_transactions(
        [make_transaction_frame(nid, from_bytes(xtx.TransactionEnvelope, e))
         for e in accepted], lm.last_closed_header, lcl)
    res["nominate_s"] = time.perf_counter() - t
    check(not excluded, f"close: nomination excluded {len(excluded)}")
    raw = to_bytes(xledger.GeneralizedTransactionSet, app.xdr)
    ltx = LedgerTxn(lm.root)
    keyed = _keyed(tx_set.collect_signature_triples(ltx, app.frames))
    ltx.rollback()
    res["set_ops"], res["set_bytes"], res["keyed"] = \
        app.size_op(), len(raw), keyed
    res["ops_by_type"] = dict(collections.Counter(
        xtx.OperationType.name_of(op.body.arm) for f in app.frames
        for op in f.tx.operations))
    res["root_entries"] = len(lm.root.store.entries)
    check(native.available(), "close: the C++ bucket runtime did not load")
    signer_table_cache.configure(enabled=False)
    try:
        _zero_counts()
        res["cold"] = _replay_passes(raw, build_root, keyed, "cold")
        launches["cold"] = _counts()
        check(launches["cold"]["verify_cold"] > 0 and
              launches["cold"]["sha256"] > 0,
              f"close (cold): K1 and K3 launches {launches['cold']}")
        signer_table_cache._reset_for_testing()
        signer_table_cache.configure(enabled=True)
        res["table_build_ms"] = _one_close(raw, build_root, "tables")
        _zero_counts()
        res["hot"] = _replay_passes(raw, build_root, keyed, "hot")
        launches["hot"] = _counts()
        check(launches["hot"]["verify_hot"] > 0 and
              launches["hot"]["sha256"] > 0,
              f"close (hot): K2 and K3 launches {launches['hot']}")
        # (c) the herder's path: the set's own check_valid, then the close
        lm, _r, _l = _close_root_lm(build_root, nid)
        check(lm.last_closed_hash == lcl, "close (c): another LCL")
        keys.flush_verify_cache()
        applicable = tx_set.TxSetXDRFrame.from_bytes(raw) \
            .prepare_for_apply(nid)
        tx_set.prefetch_contents_hashes(applicable.frames)
        ltx = LedgerTxn(lm.root)
        valid = applicable.check_valid(ltx, lcl)
        ltx.rollback()
        check(valid is True and applicable.sig_triples is not None,
              "close (c): check_valid refused the set")
        before, misses0 = _counts(), keys.get_verify_cache_stats()["misses"]
        t = time.perf_counter()
        out = lm.close_ledger(ledger_manager.LedgerCloseData(
            ledger_seq=lm.ledger_seq + 1, tx_set=applicable,
            close_time=CLOSE_TIME))
        res["herder_close_ms"] = (time.perf_counter() - t) * 1e3
        after = _counts()
        _check_config2(out, "herder")
        check(after["verify_cold"] == before["verify_cold"] and
              after["verify_hot"] == before["verify_hot"],
              f"close (c): K1 or K2 launched inside the close ({before} -> "
              f"{after})")
        missed = keys.get_verify_cache_stats()["misses"] - misses0
        check(missed == 0, f"close (c): {missed} verify cache misses in the "
              "fee and apply phases")
    finally:
        signer_table_cache._reset_for_testing()
    # (d) the oracle close, every invariant, the close meta
    keys.set_verifier_backend(ref.verify)
    try:
        res["oracle_close_ms"] = _one_close(raw, build_root, "oracle")
    finally:
        keys.set_verifier_backend(None)
    invariant.set_active_manager(InvariantManager())
    try:
        res["invariants_close_ms"] = _one_close(raw, build_root,
                                                "invariants")
    finally:
        invariant.set_active_manager(None)
    metas = []
    lm, _r, _l = _close_root_lm(build_root, nid)
    lm.close_meta_stream.append(
        lambda m: metas.append(to_bytes(xledger.LedgerCloseMeta, m)))
    t = time.perf_counter()
    out, _f, _m, _ms, _s = _replay_close(raw, lm)
    res["meta_close_ms"] = (time.perf_counter() - t) * 1e3
    _check_config2(out, "meta")
    check(len(metas) == 1 and
          hashlib.sha256(metas[0]).hexdigest() == CONFIG2_META_HASH,
          f"close (meta): {len(metas)} metas, the first hashing to "
          f"{hashlib.sha256(metas[0]).hexdigest() if metas else None}")
    res["meta_bytes"] = len(metas[0])
    check_dispatch_clean([default_verifier(), default_hasher()], "close")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    c1 = res["config1"]
    print(f"[close] (a) config 1, {c1['txs']} payments: close p50 "
          f"{c1['p50_ms']:.3f} ms, p90 {c1['p90_ms']:.3f} ms over "
          f"{CONFIG1_PASSES} passes (ledger.close {c1['spans_p50_ms']['close_zone']:.3f}, "
          f"verify span {c1['spans_p50_ms']['verify_span']:.3f}, "
          f"bucket.addBatch {c1['spans_p50_ms']['add_batch']:.3f}, rest "
          f"{c1['spans_p50_ms']['rest']:.3f} ms p50); root and "
          f"LedgerManager {c1['setup_p50_s']:.3f} s p50; header hash the "
          f"reference's; K1 launches {launches['config1']}; card "
          f"{info['smi']}")
    print(f"[close] config 2: {CONFIG2_APPLIED} transactions over "
          f"vectors.node_close_ledger: root {res['root_s']:.3f} s, "
          f"LedgerManager {res['lm_s']:.3f} s, nomination "
          f"{res['nominate_s']:.3f} s ({res['set_ops']} operations, "
          f"{res['set_bytes']} B; {res['ops_by_type']}), {keyed} keyed "
          f"triples; the root holds {res['root_entries']} entries; the C++ "
          "bucket runtime loaded")
    for mode in ("cold", "hot"):
        r = res[mode]
        parts = ", ".join(f"{k} {r['steps_p50_ms'][k]:.3f} / "
                          f"{r['steps_p90_ms'][k]:.3f}" for k in CLOSE_STEPS)
        sp = r["spans_p50_ms"]
        print(f"[close] (b) {mode}: pass p50 {r['p50_ms']:.3f} ms, p90 "
              f"{r['p90_ms']:.3f} ms over {CLOSE_PASSES} passes; step p50 / "
              f"p90 ms: {parts}; inside the close p50: ledger.close "
              f"{sp['close_zone']:.3f}, verify span {sp['verify_span']:.3f},"
              f" bucket.addBatch {sp['add_batch']:.3f}, rest (fee and apply) "
              f"{sp['rest']:.3f} ms; root {r['root_p50_s']:.3f} s, "
              f"LedgerManager {r['lm_p50_s']:.3f} s p50; applied "
              f"{CONFIG2_APPLIED}, failed 0, {keyed} misses a pass; "
              f"launches {launches[mode]}")
    print(f"[close] table-building close {res['table_build_ms']:.1f} ms; "
          f"(c) after check_valid {res['herder_close_ms']:.3f} ms, no K1 or "
          f"K2 launch and no miss inside; (d) oracle "
          f"{res['oracle_close_ms']:.1f} ms, every invariant "
          f"{res['invariants_close_ms']:.3f} ms, with the meta consumer "
          f"{res['meta_close_ms']:.3f} ms ({res['meta_bytes']} B); every "
          f"header hash and the meta hash the reference's; phase "
          f"{res['seconds']:.1f} s")
    return res, launches


def _catchup_build(tmp):
    """Phase 23's setup: the plan from ``CATCHUP_SEED``, its payments
    signed on a process pool, then the port's closes from genesis to
    ledger 127 (each through the close's own signature prefetch: K1 on a
    first sight, K2 after), every close handed to a ``HistoryManager``
    over a ``FileArchive`` in ``tmp`` that publishes checkpoints 63 and
    127."""
    plan = vectors.catchup_plan(np.random.default_rng(CATCHUP_SEED),
                                senders=CATCHUP_SENDERS,
                                first_full=CATCHUP_FIRST_FULL,
                                last=CATCHUP_LAST)
    nid = tx_test_utils.TEST_NETWORK_ID
    workers = max(1, min(CATCHUP_SIGN_WORKERS, os.cpu_count() or 1))
    t = time.perf_counter()
    envs = vectors.catchup_envelopes(
        plan, range(CATCHUP_FIRST_FULL, CATCHUP_LAST + 2), nid,
        workers=workers)
    res = {"sign_s": time.perf_counter() - t, "sign_workers": workers,
           "signatures": sum(len(v) for v in envs.values()),
           "nominate_s": 0.0, "close_s": 0.0}
    archive = history_manager.FileArchive(os.path.join(tmp, "archive"))
    hm = history_manager.HistoryManager([archive], CATCHUP_PASSPHRASE)
    t = time.perf_counter()
    lm = ledger_manager.LedgerManager(nid, vectors.catchup_root(plan))
    res["genesis_s"] = time.perf_counter() - t
    ups = vectors.catchup_upgrades()
    _zero_counts()
    t_build = time.perf_counter()
    while lm.ledger_seq < CATCHUP_LAST:
        seq = lm.ledger_seq + 1
        frames = [make_transaction_frame(nid, from_bytes(
            xtx.TransactionEnvelope, e)) for e in envs.get(seq, ())]
        t = time.perf_counter()
        txset, excluded = tx_set.make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash)
        res["nominate_s"] += time.perf_counter() - t
        check(not excluded, f"catchup build: ledger {seq} excluded "
              f"{len(excluded)} of {len(frames)}")
        t = time.perf_counter()
        out = lm.close_ledger(ledger_manager.LedgerCloseData(
            ledger_seq=seq, tx_set=txset,
            close_time=vectors.catchup_close_time(seq),
            upgrades=ups if seq == 3 else []))
        res["close_s"] += time.perf_counter() - t
        check(out.failed_count == 0 and out.applied_count == len(frames),
              f"catchup build: ledger {seq} applied {out.applied_count}, "
              f"failed {out.failed_count}")
        hm.ledger_closed(out, txset, lm.bucket_list,
                         hot_archive=lm.hot_archive)
    res["build_s"] = time.perf_counter() - t_build
    launches = _counts()
    header = lm.last_closed_header
    check(hm.published_checkpoints == [63, CATCHUP_LAST],
          f"catchup build: published {hm.published_checkpoints}")
    check(header.maxTxSetSize >= CATCHUP_SENDERS,
          f"catchup build: maxTxSetSize {header.maxTxSetSize}")
    check(not lm.hot_archive.is_empty(),
          "catchup build: the hot archive is empty")
    check(lm.last_closed_hash.hex() == CATCHUP_LCL_HASH,
          f"catchup build: ledger {CATCHUP_LAST} is "
          f"{lm.last_closed_hash.hex()}, not the reference's")
    sizes = [os.path.getsize(os.path.join(base, n))
             for base, _dirs, names in os.walk(archive.root) for n in names]
    res.update(archive_bytes=sum(sizes), archive_files=len(sizes),
               protocol=header.ledgerVersion,
               max_tx_set_size=header.maxTxSetSize,
               accounts=2 * CATCHUP_SENDERS)
    return plan, envs, archive, res, launches


class _Wrapped:
    """Functions wrapped while it is entered: each ``(owner, attribute,
    wrap)`` is replaced by ``wrap(function)`` on entry and put back on
    exit (a class's ``staticmethod`` stays one)."""

    def __init__(self, *targets):
        self.targets = targets
        self._saved = []

    def __enter__(self):
        for owner, attr, wrap in self.targets:
            raw = owner.__dict__[attr]
            if isinstance(raw, staticmethod):
                new = staticmethod(wrap(raw.__func__))
            else:
                new = wrap(raw)
            self._saved.append((owner, attr, raw))
            setattr(owner, attr, new)
        return self

    def __exit__(self, *exc):
        for owner, attr, raw in reversed(self._saved):
            setattr(owner, attr, raw)
        self._saved.clear()


def _timing(add):
    """A ``_Wrapped`` wrap that hands ``add`` each call's seconds."""
    def wrap(fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(time.perf_counter() - t)
        return timed
    return wrap


def _catchup_pass(archive, mode, count=0, lm=None, record=None):
    """One ``CatchupWork`` to ledger 127 on a virtual clock's
    ``WorkScheduler``, of a fresh node (or ``lm``), the verify cache
    flushed and the launch counts set to 0 first: ``(node, measures)``.
    ``record`` receives the triples of each ``batch_verify_into_cache``
    call. Gates: the work succeeds at ``CATCHUP_LCL_HASH``, the live
    bucket list is the header's, every replayed header hash is the
    archive's and ``hashlib`` gives every verified header's."""
    keys.flush_verify_cache()
    lm = lm or ledger_manager.LedgerManager(tx_test_utils.TEST_NETWORK_ID)
    closes, hashes, marks = [], [], {}
    spans = collections.defaultdict(float)

    def timed_close(close):
        def wrapped(node, lcd):
            t = time.perf_counter()
            out = close(node, lcd)
            closes.append((time.perf_counter() - t) * 1e3)
            hashes.append(out.header_hash)
            return out
        return wrapped

    def marked_prefetch(prefetch):
        def wrapped(*args, **kwargs):
            marks["before"] = keys.get_verify_cache_stats()["misses"]
            out = prefetch(*args, **kwargs)
            marks["after"] = keys.get_verify_cache_stats()["misses"]
            return out
        return wrapped

    def recorded(batch_verify):
        def wrapped(items):
            items = list(items)
            record.append(items)
            return batch_verify(items)
        return wrapped

    def span(label):
        return _timing(lambda s: spans.__setitem__(label, spans[label] + s))
    hm = history_manager.HistoryManager
    targets = [(ledger_manager.LedgerManager, "close_ledger", timed_close),
               (catchup, "_prefetch_checkpoint_sigs", marked_prefetch),
               (catchup, "verify_ledger_chain", span("chain_verify")),
               (hm, "get_checkpoint", span("download_decode")),
               (hm, "get_bucket", span("bucket_download")),
               (catchup, "apply_buckets_catchup", span("adopt"))]
    if record is not None:
        targets.append((keys, "batch_verify_into_cache", recorded))
    ws = WorkScheduler(VirtualClock(VIRTUAL_TIME))
    wk = catchup.CatchupWork(lm, archive, catchup.CatchupConfiguration(
        CATCHUP_LAST, mode, count=count))
    _zero_counts()
    misses0 = keys.get_verify_cache_stats()["misses"]
    before = tracing.span_totals()
    t = time.perf_counter()
    with _Wrapped(*targets):
        ws.schedule(wk)
        done = ws.run_until_done(3600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    after = tracing.span_totals()
    launches = _counts()
    label = f"catchup ({mode})"
    check(done and wk.state == "SUCCESS", f"{label}: the work ended "
          f"{wk.state}")
    header = lm.last_closed_header
    check(lm.ledger_seq == CATCHUP_LAST and
          lm.last_closed_hash.hex() == CATCHUP_LCL_HASH,
          f"{label}: ledger {lm.ledger_seq} at "
          f"{lm.last_closed_hash.hex()}, not the reference's")
    check(header_bucket_list_hash(lm.bucket_list.hash(), lm.hot_archive,
                                  header.ledgerVersion) ==
          header.bucketListHash,
          f"{label}: the bucket lists are not the header's")
    by_seq = {h.header.ledgerSeq: h.hash for h in wk.verified_headers}
    first = CATCHUP_LAST - len(hashes) + 1
    check(hashes == [by_seq[s] for s in range(first, CATCHUP_LAST + 1)],
          f"{label}: a replayed header differs from the archive's")
    check(len(wk.verified_headers) == CATCHUP_HEADERS,
          f"{label}: {len(wk.verified_headers)} headers verified")
    if mode == "RECENT":
        check(len(closes) == CATCHUP_REPLAYED,
              f"{label}: {len(closes)} ledgers replayed, not "
              f"{CATCHUP_REPLAYED}")
    blobs = [to_bytes(xledger.LedgerHeader, h.header)
             for h in wk.verified_headers]
    t = time.perf_counter()
    digests = [hashlib.sha256(b).digest() for b in blobs]
    hashlib_ms = (time.perf_counter() - t) * 1e3
    check(digests == [h.hash for h in wk.verified_headers],
          f"{label}: hashlib disagrees with the archive's headers")
    close_zone = _zone_ms(before, after, "zone.ledger.close")
    add_batch = _zone_ms(before, after, "zone.bucket.addBatch")
    verify_span = batch_engine.dispatch_attribution(
        before, after)["blocking_span_per_rep_ms"]
    hash_span = batch_engine.phase_attribution(
        before, after, span_ns="hash")["blocking_span_per_rep_ms"]
    res = {"mode": mode, "count": count, "wall_s": wall,
           "replayed": len(closes), "ledgers_per_s": len(closes) / wall,
           "launches": launches,
           "misses": keys.get_verify_cache_stats()["misses"] - misses0,
           "spans_ms": {
               "chain_verify": spans["chain_verify"] * 1e3,
               "chain_hashlib": hashlib_ms,
               "download_decode": spans["download_decode"] * 1e3,
               "bucket_download": spans["bucket_download"] * 1e3,
               "adopt": spans["adopt"] * 1e3,
               "verify_span": verify_span, "hash_span": hash_span,
               "closes": sum(closes), "close_zone": close_zone,
               "add_batch": add_batch,
               "fee_and_apply": close_zone - add_batch},
           "engines_share": (verify_span + hash_span) / (wall * 1e3)}
    if closes:
        res["close_p50_ms"] = float(np.percentile(closes, 50))
        res["close_p90_ms"] = float(np.percentile(closes, 90))
    if marks:
        res["prefetch_misses"] = marks["after"] - marks["before"]
        res["close_misses"] = res["misses"] - res["prefetch_misses"]
    return lm, res


def _catchup_gate(r, label, want):
    """The launches a pass must make, and (where it replays) no verify
    cache miss inside its closes."""
    got = {k: r["launches"][k] for k in want}
    check(got == want, f"catchup ({label}): launches {r['launches']}, the "
          f"pass must make {want}")
    if "close_misses" in r:
        check(r["close_misses"] == 0, f"catchup ({label}): "
              f"{r['close_misses']} verify cache misses in the closes")


def _oracle_sample(flushed):
    """The oracle against the verify cache on a seeded sample of the
    triples the coalesced prefetch flushed: every verdict True in both.
    Returns the sample's size and the oracle's seconds."""
    rng = np.random.default_rng(CATCHUP_SEED)
    pick = rng.choice(len(flushed), CATCHUP_SAMPLE, replace=False)
    t = time.perf_counter()
    got = [(ref.verify(*flushed[i]), keys.cached_verify_sig(*flushed[i]))
           for i in pick]
    check(all(o is True and c is True for o, c in got),
          f"catchup (a): the oracle and the verify cache disagree on the "
          f"sample: {[g for g in got if g != (True, True)][:4]}")
    return len(got), time.perf_counter() - t


def _build_tables(flushed):
    """(b)'s tables: the verify cache flushed, then one
    ``batch_verify_into_cache`` of the triples (a)'s prefetch flushed,
    with the signer-table cache on, as the prefetch of a catchup pass
    would make it; its seconds and launches."""
    keys.flush_verify_cache()
    _zero_counts()
    t = time.perf_counter()
    keys.batch_verify_into_cache(flushed)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t, "launches": _counts()}


def _persistence_pass(archive, tmp, envs, memory_lm):
    """(e): a node with ``NodePersistence`` runs (a)'s catchup with every
    close saved; its files are copied; each copy is restored with
    ``LedgerManager.from_persistence``, once at the reference's
    ``INDEX_CUTOFF_BYTES`` and once with it 0 (every bucket through
    ``DiskBucket``'s index), and each restored node closes ledger 128,
    as does the in-memory node ``memory_lm``."""
    nid = tx_test_utils.TEST_NETWORK_ID
    base = os.path.join(tmp, "node")
    os.makedirs(base)
    pers = NodePersistence(Database(os.path.join(base, "node.db")),
                           BucketManager(os.path.join(base, "buckets")))
    saves = []
    with _Wrapped((NodePersistence, "save_ledger",
                   _timing(lambda s: saves.append(s * 1e3)))):
        lm, res = _catchup_pass(archive, "RECENT", CATCHUP_COUNT,
                                lm=ledger_manager.LedgerManager(
                                    nid, persistence=pers))
    pers.db.close()
    check(len(saves) == res["replayed"],
          f"catchup (e): {len(saves)} saves over {res['replayed']} closes")
    res["save_p50_ms"] = float(np.percentile(saves, 50))
    res["save_p90_ms"] = float(np.percentile(saves, 90))
    res["saved_bytes"] = sum(
        os.path.getsize(os.path.join(b, n))
        for b, _d, names in os.walk(base) for n in names)
    frames_128 = envs[CATCHUP_LAST + 1]

    def close_next(node):
        _zero_counts()
        frames = [make_transaction_frame(nid, from_bytes(
            xtx.TransactionEnvelope, e)) for e in frames_128]
        txset, excluded = tx_set.make_tx_set_from_transactions(
            frames, node.last_closed_header, node.last_closed_hash)
        check(not excluded, f"catchup (e): {len(excluded)} excluded")
        t = time.perf_counter()
        out = node.close_ledger(ledger_manager.LedgerCloseData(
            ledger_seq=node.ledger_seq + 1, tx_set=txset,
            close_time=vectors.catchup_close_time(node.ledger_seq + 1)))
        ms = (time.perf_counter() - t) * 1e3
        check(out.failed_count == 0 and out.applied_count == len(frames),
              f"catchup (e): ledger 128 applied {out.applied_count}, failed "
              f"{out.failed_count}")
        check(out.header_hash.hex() == CATCHUP_NEXT_HASH,
              f"catchup (e): ledger 128 is {out.header_hash.hex()}, not the "
              "reference's")
        nexts.append(_counts())
        return ms
    nexts = []
    res["restored"] = {}
    cutoff0 = bucket_index.INDEX_CUTOFF_BYTES
    for name, cutoff in (("default", cutoff0), ("0", 0)):
        path = os.path.join(tmp, f"node-cutoff-{name}")
        shutil.copytree(base, path)
        bucket_index.INDEX_CUTOFF_BYTES = cutoff
        try:
            t = time.perf_counter()
            p = NodePersistence(Database(os.path.join(path, "node.db")),
                                BucketManager(os.path.join(path, "buckets")))
            node = ledger_manager.LedgerManager.from_persistence(nid, p)
            restore_s = time.perf_counter() - t
            check(node is not None and
                  node.last_closed_hash == lm.last_closed_hash and
                  node.bucket_list.hash() == memory_lm.bucket_list.hash() and
                  node.hot_archive.hash() == memory_lm.hot_archive.hash() and
                  getattr(node.root.store, "is_bucket_backed", False),
                  f"catchup (e): the restore at cutoff {cutoff} is not "
                  "(a)'s node")
            res["restored"][name] = {"cutoff_bytes": cutoff,
                                     "restore_s": restore_s,
                                     "close_128_ms": close_next(node)}
            p.db.close()
        finally:
            bucket_index.INDEX_CUTOFF_BYTES = cutoff0
    res["memory_close_128_ms"] = close_next(memory_lm)
    res["launches_next"] = _sum_counts([{"launches": c} for c in nexts])
    return res


def _pass_line(tag, runs):
    """One printed line over a mode's timed passes: p50 over passes of
    the wall and each span, and of the replayed closes."""
    def med(key, sub=None):
        vals = [r["spans_ms"][key] if sub else r[key] for r in runs]
        return float(np.median(vals))
    spans = ", ".join(f"{k} {med(k, True):.3f}" for k in (
        "chain_verify", "chain_hashlib", "download_decode",
        "bucket_download", "adopt", "verify_span", "hash_span",
        "close_zone", "add_batch", "fee_and_apply"))
    closes = ""
    if runs[0]["replayed"]:
        closes = (f"; replayed closes p50 {med('close_p50_ms'):.3f} ms, p90 "
                  f"{med('close_p90_ms'):.3f} ms")
    print(f"[catchup] {tag}: {len(runs)} pass(es), wall p50 "
          f"{med('wall_s'):.3f} s ({[round(r['wall_s'], 3) for r in runs]}),"
          f" {med('ledgers_per_s'):.2f} replayed ledgers/s{closes}; spans "
          f"ms (p50): {spans}; engines' share of the wall "
          f"{med('engines_share'):.4f}; launches {runs[-1]['launches']}")


def phase_catchup_chain(info):
    """Phase 23: catchup on the card. A chain built by the port from
    ``CATCHUP_SEED`` and published to a ``FileArchive``; then (a)
    ``RECENT`` cold, (b) ``RECENT`` hot, (c) ``SKIP_KNOWN_RESULTS``, (d)
    ``MINIMAL``, (e) the persistence and the restart at both index
    cutoffs. Each pass's K1, K2 and K3 counts are set to 0 just before
    it and read just after."""
    t0 = time.perf_counter()
    check(keys._backend is None, "catchup: a verify backend is installed")
    check(batch_engine.device_available(block=True),
          "catchup: the device probe did not answer")
    check(keys.accelerated_verify_available(),
          "catchup: the replay would not coalesce its prefetch")
    res = {"card": info["smi"]}
    launches = {}
    one = {"verify_cold": 1, "verify_hot": 0, "sha256": 1}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-catchup-") as tmp:
        plan, envs, archive, res["build"], launches["build"] = \
            _catchup_build(tmp)
        b = res["build"]
        print(f"[catchup] build: {b['signatures']} payments signed in "
              f"{b['sign_s']:.3f} s on {b['sign_workers']} processes; "
              f"genesis ({b['accounts']} accounts) {b['genesis_s']:.3f} s; "
              f"ledgers 3-{CATCHUP_LAST} in {b['build_s']:.3f} s (closes "
              f"{b['close_s']:.3f} s, nomination {b['nominate_s']:.3f} s); "
              f"protocol {b['protocol']}, maxTxSetSize "
              f"{b['max_tx_set_size']}, nothing excluded; archive "
              f"{b['archive_bytes']} B in {b['archive_files']} files; "
              f"ledger {CATCHUP_LAST} the reference's; launches "
              f"{launches['build']}")
        signer_table_cache.configure(enabled=False)
        try:
            cold, flushed = [], []
            for i in range(CATCHUP_COLD_PASSES):
                memory_lm, r = _catchup_pass(
                    archive, "RECENT", CATCHUP_COUNT,
                    record=flushed if i == 0 else None)
                _catchup_gate(r, "a", one)
                check(r["prefetch_misses"] == CATCHUP_SIGS,
                      f"catchup (a): the prefetch missed "
                      f"{r['prefetch_misses']} of {CATCHUP_SIGS}")
                if i == 0:
                    check(len(flushed[0]) == CATCHUP_SIGS,
                          f"catchup (a): the first flush held "
                          f"{len(flushed[0])} triples")
                    res["sample"], res["sample_s"] = _oracle_sample(
                        flushed[0])
                cold.append(r)
            res["cold"] = cold
            launches["cold"] = _sum_counts(cold)
            signer_table_cache._reset_for_testing()
            signer_table_cache.configure(enabled=True)
            res["tables"] = _build_tables(flushed[0])
            del flushed
            hot = []
            for _ in range(CATCHUP_HOT_PASSES):
                _lm, r = _catchup_pass(archive, "RECENT", CATCHUP_COUNT)
                _catchup_gate(r, "b", {"verify_cold": 0, "verify_hot": 1,
                                       "sha256": 1})
                hot.append(r)
            res["hot"] = hot
            launches["hot"] = _sum_counts(hot)
        finally:
            signer_table_cache._reset_for_testing()
        catchup.SKIP_KNOWN_RESULTS = True
        try:
            _lm, r = _catchup_pass(archive, "RECENT", CATCHUP_COUNT)
        finally:
            catchup.SKIP_KNOWN_RESULTS = False
        _catchup_gate(r, "c", {"verify_cold": 0, "verify_hot": 0,
                               "sha256": 1 + CATCHUP_REPLAYED})
        res["skip"], launches["skip"] = r, r["launches"]
        _lm, r = _catchup_pass(archive, "MINIMAL")
        _catchup_gate(r, "d", {"verify_cold": 0, "verify_hot": 0,
                               "sha256": 1})
        check(r["replayed"] == 0, f"catchup (d): {r['replayed']} replayed")
        res["minimal"], launches["minimal"] = r, r["launches"]
        res["persist"] = _persistence_pass(archive, tmp, envs, memory_lm)
        launches["persist"] = res["persist"]["launches"]
        launches["next"] = res["persist"]["launches_next"]
    check_dispatch_clean([default_verifier(), default_hasher()], "catchup")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    _pass_line("(a) RECENT cold", cold)
    print(f"[catchup] (a) the first pass flushed {CATCHUP_SIGS} triples in "
          f"one batch_verify_into_cache call; the oracle agrees with the "
          f"verify cache on a sample of {res['sample']} "
          f"({res['sample_s']:.3f} s); no miss in the closes")
    print(f"[catchup] (b) the 256 signer tables built by one "
          f"batch_verify_into_cache of (a)'s flushed triples (what an "
          f"untimed pass's prefetch does): {res['tables']['seconds']:.3f} "
          f"s, launches {res['tables']['launches']}")
    _pass_line("(b) RECENT hot", hot)
    _pass_line("(c) SKIP_KNOWN_RESULTS", [res["skip"]])
    _pass_line("(d) MINIMAL", [res["minimal"]])
    e = res["persist"]
    print(f"[catchup] (e) persistence: (a)'s catchup with every close saved,"
          f" wall {e['wall_s']:.3f} s, close p50 {e['close_p50_ms']:.3f} ms, "
          f"save p50 {e['save_p50_ms']:.3f} ms, p90 {e['save_p90_ms']:.3f} "
          f"ms, {e['saved_bytes']} B on disk; restores: " + "; ".join(
              f"cutoff {v['cutoff_bytes']} B: restore {v['restore_s']:.3f} "
              f"s, ledger 128 close {v['close_128_ms']:.3f} ms"
              for v in e["restored"].values()) +
          f"; in memory ledger 128 close {e['memory_close_128_ms']:.3f} ms; "
          f"every ledger 128 the reference's; launches: the catchup "
          f"{e['launches']}, the three ledger 128 tx sets and closes "
          f"{e['launches_next']}")
    print(f"[catchup] phase {res['seconds']:.1f} s; card {info['smi']}")
    return res, launches


class _CountingOracle:
    """The host oracle as ``keys`` reaches it (``keys._ref``): every
    other name passes through, and each ``verify`` it decides is
    counted."""

    def __init__(self, module):
        self._module, self.calls = module, 0

    def __getattr__(self, name):
        return getattr(self._module, name)

    def verify(self, *args):
        self.calls += 1
        return self._module.verify(*args)


def _fallbacks():
    """``service_verified``'s fallbacks so far, by lane and reason."""
    prefix = "crypto.verify.service.adopter_fallback."
    return {name[len(prefix):]: m["count"]
            for name, m in registry.find(prefix).items()}


def _process_state():
    """The process-wide state an arm may start: the service, the verify
    backend, the worker pool, the pool's work run inline."""
    return {"service": verify_service.running_service() is not None,
            "backend": keys._backend is not None,
            "worker_pool": bg_workers._pool is not None,
            "workers_inline": not bg_workers.background_enabled()}


def _stop_process_state():
    """Stop the service (and drop it, so the next arm starts a fresh
    one), uninstall the verify backend, shut the worker pool and put its
    work back in the background."""
    svc = verify_service.running_service()
    if svc is not None:
        svc.stop(drain=True, timeout=30)
    verify_service._service = None
    keys.set_verifier_backend(None)
    bg_workers.shutdown()
    bg_workers.set_background(True)
    check(not any(_process_state().values()),
          f"node: process-wide state left running {_process_state()}")


def _network(n, accounts=None, **knobs):
    """``vectors.core_network(n)`` with ``knobs`` in every node's
    ``Config``; each node's closes are timed and their header hashes kept
    in ``app.closes``."""
    sim = vectors.core_network(n, accounts=accounts, **knobs)
    for app in sim.nodes.values():
        _record_closes(app)
    return sim


def _record_closes(app):
    """``app``'s closes timed (``app.close_s``) and their header hashes
    kept by ledger (``app.closes``)."""
    app.closes, app.close_s = {}, []

    def close(lcd, _app=app, _close=app.lm.close_ledger):
        t = time.perf_counter()
        res = _close(lcd)
        _app.close_s.append(time.perf_counter() - t)
        _app.closes[lcd.ledger_seq] = res.header_hash.hex()
        return res
    app.lm.close_ledger = close


class _ArmRecord:
    """What one arm's verify paths did: each round trip to the card
    (``VerifyService.verify`` by lane, ``TrickleBatcher.verify_sig``)
    timed, the rows the flood's pre-verify site
    (``overlay_manager._preverify_into_cache``) put on a lane, every
    triple that reached a verifier kept, the host oracle's decisions
    counted (``keys._ref`` wrapped), and CUDA events around every kernel
    launch (``_build.launch``): the kernels' own device time."""

    def __init__(self):
        self.trips = collections.defaultdict(list)    # lane -> seconds
        self.items = collections.defaultdict(int)     # lane -> rows
        self.site_rows = collections.defaultdict(int)  # lane -> rows
        self.site_calls = 0
        self.triples = {}                              # triple -> verdict
        self.oracle = _CountingOracle(keys._ref)
        self.launched = collections.defaultdict(list)  # kernel -> events
        self._window = {}                              # lane -> first trip
        self._site = threading.local()
        self._lock = threading.Lock()

    def _service(self, fn):
        def verify(svc, items, lane="bulk", **kwargs):
            t = time.perf_counter()
            out = fn(svc, items, lane=lane, **kwargs)
            dt = time.perf_counter() - t
            with self._lock:
                self.trips[lane].append(dt)
                self.items[lane] += len(items)
                if getattr(self._site, "active", False):
                    self.site_rows[lane] += len(items)
                self.triples.update(zip(map(tuple, items), map(bool, out)))
            return out
        return verify

    def _trickle(self, fn):
        def verify_sig(batcher, pk, msg, sig):
            t = time.perf_counter()
            ok = fn(batcher, pk, msg, sig)
            dt = time.perf_counter() - t
            with self._lock:
                self.trips["trickle"].append(dt)
                self.items["trickle"] += 1
                self.triples[(bytes(pk), bytes(msg), bytes(sig))] = bool(ok)
            return ok
        return verify_sig

    def _preverify(self, fn):
        def preverify(items):
            self._site.active = True
            try:
                return fn(items)
            finally:
                self._site.active = False
                with self._lock:
                    self.site_calls += 1
        return preverify

    def _launch(self, fn):
        def launch(name, inputs, out, n, *ints):
            stream = torch.cuda.current_stream(out.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(name, inputs, out, n, *ints)
            end.record(stream)
            with self._lock:
                self.launched[name].append((start, end, n))
        return launch

    def wrapped(self):
        return _Wrapped(
            (verify_service.VerifyService, "verify", self._service),
            (TrickleBatcher, "verify_sig", self._trickle),
            (overlay_manager, "_preverify_into_cache", self._preverify),
            (_build, "launch", self._launch),
            (keys, "_ref", lambda module: self.oracle))

    def figures(self):
        out = {}
        for lane, trips in self.trips.items():
            ms = np.array(trips) * 1e3
            out[lane] = {"round_trips": len(trips),
                         "rows": self.items[lane],
                         "total_s": float(ms.sum() / 1e3),
                         "p50_ms": float(np.percentile(ms, 50)),
                         "p99_ms": float(np.percentile(ms, 99))}
        return out

    def start_window(self):
        """The arm's timed window starts: the kernels' events and the
        round trips that count as the crank's blocked time are those
        from now on."""
        with self._lock:
            self.launched.clear()
            self._window = {ln: len(t) for ln, t in self.trips.items()}

    def blocked_s(self):
        """Seconds of round trips since ``start_window``."""
        with self._lock:
            return float(sum(sum(t[self._window.get(ln, 0):])
                             for ln, t in self.trips.items()))

    def kernel_time(self, wall_s):
        """Each kernel's launches, rows and summed device ms (CUDA events
        around its launches), and all kernels' share of ``wall_s``."""
        torch.cuda.synchronize()
        with self._lock:
            launched = {k: list(v) for k, v in self.launched.items()}
        out = {name: {"launches": len(ev),
                      "rows": sum(n for _s, _e, n in ev),
                      "ms": sum(s.elapsed_time(e) for s, e, _n in ev)}
               for name, ev in sorted(launched.items())}
        total = sum(k["ms"] for k in out.values())
        return {"by_kernel": out, "ms": total,
                "share_of_wall": total / 1e3 / wall_s}

    def oracle_recheck(self):
        """Every triple that reached the card, decided again by the host
        oracle (``ref.verify`` itself, outside the count): the
        disagreements and the seconds it took."""
        t = time.perf_counter()
        bad = [t_ for t_, ok in self.triples.items() if ref.verify(*t_) != ok]
        return bad, time.perf_counter() - t


def _arm_gates(label, rec, fallback0, svc_snap=None):
    """The gates every arm on the card shares: the host oracle decided
    no signature; with the service (its snapshot ``svc_snap``) no
    ``service_verified`` fallback and nothing shed, rejected or failed,
    without it only the "absent" fallbacks; the oracle agrees with every
    verdict the card gave."""
    check(rec.oracle.calls == 0, f"node ({label}): the host oracle decided "
          f"{rec.oracle.calls} signatures")
    moved = {k: v - fallback0.get(k, 0) for k, v in _fallbacks().items()
             if v != fallback0.get(k, 0)}
    if svc_snap is None:
        # no service in this arm: every miss asks the absent service
        # first, then verify_sig (the trickle, on the card)
        check(all(k.endswith(".absent") for k in moved),
              f"node ({label}): service fallbacks {moved}")
    else:
        check(not moved, f"node ({label}): service fallbacks {moved}")
        tot = svc_snap["totals"]
        check(tot["shed"] == tot["rejected"] == tot["failed"] == 0 and
              svc_snap["conservation_gap"] == 0,
              f"node ({label}): service totals {tot}, gap "
              f"{svc_snap['conservation_gap']}")
    bad, recheck_s = rec.oracle_recheck()
    check(not bad and rec.triples, f"node ({label}): the oracle disagrees "
          f"with {len(bad)} of {len(rec.triples)} verdicts")
    return {"fallbacks": moved, "triples": len(rec.triples),
            "oracle_recheck_s": recheck_s}


def _engine_spans(before, after):
    """The verify engine's time in an arm from ``tracing.span_totals()``
    deltas: the service dispatcher's ``service.dispatch`` and
    ``service.resolve`` spans, and the trickle's ``verify.blocking``
    calls (ms)."""
    return {name: _zone_ms(before, after, f"span.{name}")
            for name in ("service.dispatch", "service.resolve",
                         "verify.blocking")}


def _consensus_arm(label, **knobs):
    """(a) or (b): ``NET_VALIDATORS`` validators fully connected, cranked
    until every node holds ``NET_VALIDATORS - 1`` authenticated peers,
    then ``NET_ROUNDS`` ledgers. Returns the figures and the network."""
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    fallback0 = _fallbacks()
    rec = _ArmRecord()
    _zero_counts()
    spans0 = tracing.span_totals()
    with rec.wrapped():
        t = time.perf_counter()
        sim = _network(NET_VALIDATORS, **knobs)
        apps = list(sim.nodes.values())
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        sim.start_all_nodes()
        check(sim.crank_until(lambda: all(
            a.overlay.authenticated_count() >= NET_VALIDATORS - 1
            for a in apps), NET_AUTH_TIMEOUT_S),
            f"node ({label}): the mesh never authenticated")
        auth_s = time.perf_counter() - t
        rec.start_window()
        start = apps[0].lm.ledger_seq
        last = start + NET_ROUNDS
        t = time.perf_counter()
        check(sim.crank_until_ledger(last, NET_CRANK_TIMEOUT_S),
              f"node ({label}): ledger {last} not reached")
        wall_s = time.perf_counter() - t
        blocked_s = rec.blocked_s()
    launches = _counts()
    spans = _engine_spans(spans0, tracing.span_totals())
    kernels = rec.kernel_time(wall_s)
    check(sim.in_consensus(), f"node ({label}): the nodes disagree")
    hashes = {a.closes.get(last) for a in apps}
    check(hashes == {NET_LEDGER_HASH}, f"node ({label}): ledger {last} is "
          f"{sorted(map(str, hashes))}, not the reference's")
    digest = vectors.statement_digest(apps)
    statements = sum(len(slot.statements_history) for a in apps
                     for slot in a.herder.scp.known_slots.values())
    check(digest == NET_STATEMENT_DIGEST, f"node ({label}): the statements' "
          f"digest {digest} is not the reference's")
    check(launches["verify_cold"] + launches["verify_hot"] > 0,
          f"node ({label}): no K1 or K2 launch {launches}")
    cache = keys.get_verify_cache_stats()
    return {"build_s": build_s, "auth_s": auth_s, "wall_s": wall_s,
            "ledgers": f"{start + 1}-{last}",
            "rounds_per_s": NET_ROUNDS / wall_s, "statements": statements,
            "distinct_triples": cache["size"], "cache": cache,
            "trips": rec.figures(), "blocked_s": blocked_s,
            "launches": launches, "kernels": kernels,
            "engine_spans_ms": spans}, sim, rec, fallback0


def _tamper(apps, rec):
    """(d): node 1's last statement re-signed with one signature byte
    flipped, fed to node 0's ``herder.recv_scp_envelope``: rejected on
    the scp lane; node 1's auth cert with a flipped byte, checked by
    node 0's ``verify_remote_cert``: refused on the auth lane. Both
    verdicts from the card, both the oracle's."""
    a0, a1 = apps[0], apps[1]
    mine = [st for slot in a1.herder.scp.known_slots.values()
            for st, _v in slot.statements_history
            if st.nodeID.value == a1.config.NODE_SEED.public_key.raw]
    st = mine[-1]
    payload = herder_mod.scp_envelope_sign_payload(
        a1.config.network_id(), st)
    sig = bytearray(a1.config.NODE_SEED.sign(payload))
    sig[7] ^= 0x20
    env = SCPEnvelope(statement=st, signature=bytes(sig))
    trips0 = {ln: len(v) for ln, v in rec.trips.items()}
    got_env = a0.herder.recv_scp_envelope(env)
    cert = copy.copy(a1.peer_auth.cert)
    cert.sig = bytes([cert.sig[0] ^ 0x01]) + bytes(cert.sig[1:])
    got_cert = a0.peer_auth.verify_remote_cert(
        cert, a1.config.NODE_SEED.public_key.raw, cert.expiration)
    trips = {ln: len(v) - trips0.get(ln, 0) for ln, v in rec.trips.items()}
    cert_payload = a0.peer_auth._cert_payload(cert.expiration,
                                              cert.pubkey.key)
    oracle = (ref.verify(st.nodeID.value, payload, bytes(sig)),
              ref.verify(a1.config.NODE_SEED.public_key.raw, cert_payload,
                         cert.sig))
    check(got_env == EnvelopeState.INVALID and got_cert is False and
          oracle == (False, False) and trips.get("scp") == 1 and
          trips.get("auth") == 1,
          f"node (d): envelope {got_env}, cert {got_cert}, oracle {oracle},"
          f" round trips {trips}")
    return {"envelope": "INVALID", "cert": False, "round_trips": trips}


def _flood_arm(envs):
    """(c): ``FLOOD_VALIDATORS`` validators over ``FLOOD_SOURCES`` funded
    sources with the service on and ``BACKGROUND_BUCKET_MERGES`` off, so
    the nodes' worker-pool work runs inline and the ledgers do not
    depend on the card's timing. Before each ledger node 1 relays
    ``FLOOD_PER_LEDGER`` payments to node 0 as overlay TRANSACTION
    messages; node 0 pre-verifies each on the bulk lane
    (``_preverify_into_cache``) and admits it with its verdict cached;
    they flood on by advert and demand, are nominated, validated and
    closed. Cranked until every payment has applied on every node."""
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    fallback0 = _fallbacks()
    rec = _ArmRecord()
    t = time.perf_counter()
    accounts = vectors.flood_accounts(FLOOD_SOURCES)
    accounts_s = time.perf_counter() - t
    _zero_counts()
    spans0 = tracing.span_totals()
    with rec.wrapped():
        t = time.perf_counter()
        sim = _network(FLOOD_VALIDATORS, accounts=accounts,
                       MAX_TX_SET_SIZE=FLOOD_MAX_TX_SET_SIZE,
                       VERIFY_SERVICE_ENABLED=True,
                       BACKGROUND_BUCKET_MERGES=False)
        apps = list(sim.nodes.values())
        build_s = time.perf_counter() - t
        sim.start_all_nodes()
        check(sim.crank_until(lambda: all(
            a.overlay.authenticated_count() >= FLOOD_VALIDATORS - 1
            for a in apps), NET_AUTH_TIMEOUT_S),
            "node (c): the mesh never authenticated")
        mt = MessageType
        sent = {mt.FLOOD_ADVERT: 0, mt.FLOOD_DEMAND: 0, mt.TRANSACTION: 0}
        for app in apps:
            for peer in app.overlay.peers:
                def counted(msg, msg_bytes=None, _send=peer.send):
                    if msg.arm in sent:
                        sent[msg.arm] += 1
                    return _send(msg, msg_bytes)
                peer.send = counted
        a0, a1 = apps[0], apps[1]
        id0 = a0.config.NODE_SEED.public_key.raw
        relay = next(p for p in a1.overlay.peers if p.remote_node_id == id0)
        start = a0.lm.ledger_seq
        rec.start_window()
        t = time.perf_counter()
        for first in range(0, FLOOD_SOURCES, FLOOD_PER_LEDGER):
            seq = a0.lm.ledger_seq
            for e in envs[first:first + FLOOD_PER_LEDGER]:
                relay.send(StellarMessage.make(mt.TRANSACTION, from_bytes(
                    xtx.TransactionEnvelope, e)))
            check(sim.crank_until_ledger(seq + 1, NET_CRANK_TIMEOUT_S),
                  f"node (c): ledger {seq + 1} not reached")
        check(sim.crank_until(lambda: all(
            _balance(a) == FLOOD_DEST_BALANCE for a in apps),
            NET_CRANK_TIMEOUT_S), "node (c): not every payment applied "
            f"{[_balance(a) for a in apps]}")
        wall_s = time.perf_counter() - t
        blocked_s = rec.blocked_s()
        svc_snap = verify_service.running_service().snapshot()
    launches = _counts()
    spans = _engine_spans(spans0, tracing.span_totals())
    kernels = rec.kernel_time(wall_s)
    last = min(a.lm.ledger_seq for a in apps)
    check(sim.in_consensus(), "node (c): the nodes disagree")
    hashes = {a.closes.get(FLOOD_LAST_LEDGER) for a in apps}
    check(last == FLOOD_LAST_LEDGER and hashes == {FLOOD_LEDGER_HASH},
          f"node (c): the last ledger {last}, ledger {FLOOD_LAST_LEDGER} "
          f"{sorted(map(str, hashes))}, not the reference's")
    check(launches["verify_cold"] + launches["verify_hot"] > 0,
          f"node (c): no K1 or K2 launch {launches}")
    # every payment pre-verified once on the bulk lane, by node 0's own
    # site and by nothing else
    check(rec.site_rows["bulk"] == rec.items["bulk"] == FLOOD_SOURCES and
          svc_snap["lanes"]["bulk"]["submitted"] == FLOOD_SOURCES,
          f"node (c): the pre-verify site put {rec.site_rows['bulk']} rows "
          f"on the bulk lane, the lane took {rec.items['bulk']}, the "
          f"service counted {svc_snap['lanes']['bulk']['submitted']}, not "
          f"{FLOOD_SOURCES}")
    gates = _arm_gates("c", rec, fallback0, svc_snap=svc_snap)
    closes_ms = np.array([s for a in apps for s in a.close_s]) * 1e3
    out = {"accounts_s": accounts_s, "build_s": build_s, "wall_s": wall_s,
           "ledgers": f"{start + 1}-{last}",
           "rounds_per_s": (last - start) / wall_s,
           "payments": FLOOD_SOURCES,
           "preverify": {"calls": rec.site_calls,
                         "bulk_rows": rec.site_rows["bulk"]},
           "messages": {"FLOOD_ADVERT": sent[mt.FLOOD_ADVERT],
                        "FLOOD_DEMAND": sent[mt.FLOOD_DEMAND],
                        "TRANSACTION": sent[mt.TRANSACTION],
                        "TRANSACTION_relayed": FLOOD_SOURCES},
           "lanes": _lane_figures(svc_snap), "trips": rec.figures(),
           "blocked_s": blocked_s, "launches": launches, "kernels": kernels,
           "engine_spans_ms": spans,
           "close_p50_ms": float(np.percentile(closes_ms, 50)),
           "close_p90_ms": float(np.percentile(closes_ms, 90)),
           "closes": len(closes_ms), **gates}
    _stop_process_state()
    return out


def _balance(app):
    """The flood's destination balance in ``app``'s ledger."""
    raw = vectors._named(vectors.FLOOD_DESTINATION).public_key.raw
    entry = app.lm.root.store.get(key_bytes(account_key(
        xt.account_id(raw))))
    return entry.data.value.balance


def _lane_figures(snap):
    """Each lane's submitted and verified counts, and the service's
    dispatches and rows a dispatch, from its snapshot."""
    return {"lanes": {ln: {k: snap["lanes"][ln][k]
                           for k in ("submitted", "verified", "shed",
                                     "rejected", "failed")}
                      for ln in verify_service.LANES},
            "dispatches": snap["batches"],
            "rows_per_dispatch": (snap["totals"]["verified"] /
                                  max(1, snap["batches"]))}


def _arm_line(tag, r):
    trips = "; ".join(
        f"{ln} {t['round_trips']} round trips of {t['rows']} rows, "
        f"p50 {t['p50_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms, "
        f"{t['total_s']:.3f} s in all" for ln, t in sorted(r["trips"].items()))
    blocked = r["blocked_s"]
    k = r["kernels"]
    kernels = ", ".join(
        f"{name} {v['ms']:.3f} ms over {v['launches']} launches of "
        f"{v['rows']} rows ({v['ms'] / max(1, v['launches']):.4f} ms a "
        f"launch)" for name, v in k["by_kernel"].items())
    print(f"[net] {tag}: wall {r['wall_s']:.3f} s ({r.get('ledgers')}), "
          f"{r.get('rounds_per_s', 0):.3f} rounds/s; build "
          f"{r['build_s']:.3f} s, handshakes {r.get('auth_s', 0):.3f} s; "
          f"statements {r.get('statements')}, distinct triples "
          f"{r.get('distinct_triples')}; {trips}; over the wall, the crank "
          f"blocked on the verify path {blocked:.3f} s, "
          f"{blocked / r['wall_s']:.2%} of it, and the kernels (CUDA "
          f"events around each launch) took {k['ms']:.3f} ms of the "
          f"card, {k['share_of_wall']:.3%} of it: {kernels}; "
          f"engine spans {r['engine_spans_ms']}; launches {r['launches']}; "
          f"oracle re-check of {r['triples']} triples "
          f"{r['oracle_recheck_s']:.3f} s, all agree")


def phase_node_network(info):
    """Phase 24: the node. (a) ``BASELINE.json`` config 4 on the verify
    service, (d) tampering on (a)'s network, (b) config 4 on the
    trickle, (c) a flood over core4 on the service. Each arm's K1, K2
    and K3 counts are set to 0 just before it and read just after; the
    process-wide state each arm starts is stopped before the next."""
    t0 = time.perf_counter()
    # earlier phases may leave the worker pool (their bucket merges) or
    # the default service running: the phase starts from none
    before = _process_state()
    _stop_process_state()
    check(batch_engine.device_available(block=True),
          "node: the device probe did not answer")
    res = {"card": info["smi"], "state_before": before}
    launches = {}
    # (a) and (d)
    r, sim, rec, fallback0 = _consensus_arm("a", VERIFY_SERVICE_ENABLED=True)
    svc = verify_service.running_service()
    check(svc is not None, "node (a): the service is not running")
    r["lanes"] = _lane_figures(svc.snapshot())
    r.update(_arm_gates("a", rec, fallback0, svc_snap=svc.snapshot()))
    res["a"], launches["a"] = r, r["launches"]
    _arm_line("(a) config 4 on the service", r)
    print(f"[net] (a) lanes: {r['lanes']}")
    _zero_counts()
    with rec.wrapped():
        res["d"] = _tamper(list(sim.nodes.values()), rec)
    launches["d"] = _counts()
    check(rec.oracle.calls == 0, "node (d): the host oracle decided")
    print(f"[net] (d) tampering on (a)'s network: {res['d']}, launches "
          f"{launches['d']}")
    del sim
    _stop_process_state()
    # (b)
    r, sim, rec, fallback0 = _consensus_arm(
        "b", WORKER_THREADS=NET_TRICKLE_WORKERS)
    batcher = getattr(keys._backend, "__self__", None)
    check(isinstance(batcher, TrickleBatcher), "node (b): the verify "
          f"backend is {keys.get_verifier_backend_name()}")
    r["trickle_dispatches"] = batcher.dispatches
    r.update(_arm_gates("b", rec, fallback0))
    res["b"], launches["b"] = r, r["launches"]
    _arm_line("(b) config 4 on the trickle", r)
    print(f"[net] (b) trickle dispatches {r['trickle_dispatches']}")
    del sim
    _stop_process_state()
    # (c): signed in this process; a pool of 8 spawned processes took
    # 20.1 s on the card's machine, each child importing torch anew
    t = time.perf_counter()
    envs = vectors.flood_envelopes(FLOOD_SOURCES, hashlib.sha256(
        Simulation().network_passphrase.encode()).digest())
    res["flood_sign_s"] = time.perf_counter() - t
    print(f"[net] (c) flood: {FLOOD_SOURCES} payments signed in "
          f"{res['flood_sign_s']:.3f} s")
    res["c"] = c = _flood_arm(envs)
    launches["c"] = c["launches"]
    _arm_line(f"(c) flood of {FLOOD_SOURCES}, {FLOOD_PER_LEDGER} a ledger",
              c)
    print(f"[net] (c) accounts {c['accounts_s']:.3f} s; node 0's "
          f"pre-verify site: {c['preverify']}; lanes "
          f"{c['lanes']}; messages {c['messages']}; {c['closes']} closes "
          f"p50 {c['close_p50_ms']:.3f} ms, p90 {c['close_p90_ms']:.3f} ms; "
          f"every node's ledger {FLOOD_LAST_LEDGER} the reference's, "
          f"destination {FLOOD_DEST_BALANCE}")
    check_dispatch_clean([default_verifier(), default_hasher()], "node")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"[net] phase {res['seconds']:.1f} s; card {info['smi']}")
    return res, launches


class _SorobanRecord(_ArmRecord):
    """What one arm of phase 25 did: ``_ArmRecord``'s kernel events and
    counted host oracle, every ``BatchVerifier.verify_batch`` call timed
    with its rows and verdicts kept, each ``SecretKey.sign`` timed, and,
    through ``simulation.load_generator``'s own names (its code is the
    reference's, untouched), the harness's ``LedgerManager`` recording
    each close (header hash, meta bytes, ms, the verify cache's misses,
    the verify calls and spans inside it) and its set build timed, the
    candidate set's contents hashes prefetched first
    (``tx_set.prefetch_contents_hashes`` through ``hash_many``), as a
    node's admission does before it nominates."""

    def __init__(self):
        super().__init__()
        self.calls = []       # (rows, seconds, open close, a lone message)
        self.closes = []
        self.metas = []
        self.set_builds = []  # (hash ms, build ms, signing s before it)
        # a device-sized set's contents hashes: (frames, rows the hasher
        # served on the host, the longest preimage, all hashlib's)
        self.hashed = []
        self._sign_s = 0.0
        self._close = None

    def _verify_batch(self, fn):
        def verify_batch(v, items, trace_ids=None):
            t = time.perf_counter()
            out = fn(v, items, trace_ids=trace_ids)
            dt = time.perf_counter() - t
            with self._lock:
                self.calls.append((len(items), dt, self._close,
                                   bytes(items[0][1]) if len(items) == 1
                                   else None))
                self.triples.update(zip(
                    (tuple(bytes(x) for x in it) for it in items),
                    map(bool, out)))
            return out
        return verify_batch

    def _sign(self, fn):
        def sign(sk, msg):
            t = time.perf_counter()
            try:
                return fn(sk, msg)
            finally:
                self._sign_s += time.perf_counter() - t
        return sign

    def _make_set(self, fn):
        def make(frames, *args, **kwargs):
            hasher = default_hasher()
            host0 = hasher.served["host"]
            t = time.perf_counter()
            tx_set.prefetch_contents_hashes(frames)
            hashed = time.perf_counter()
            out = fn(frames, *args, **kwargs)
            self.set_builds.append(((hashed - t) * 1e3,
                                    (time.perf_counter() - hashed) * 1e3,
                                    self._sign_s))
            self._sign_s = 0.0
            if len(frames) >= MIN_DEVICE_HASH_BATCH:
                self.hashed.append((
                    len(frames), hasher.served["host"] - host0,
                    max(len(f.contents_preimage()) for f in frames),
                    all(f._hash == hashlib.sha256(
                        f.contents_preimage()).digest() for f in frames)))
            return out
        return make

    def _manager(self, cls):
        rec = self

        class RecordingManager(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.close_meta_stream.append(lambda m: rec.metas.append(
                    to_bytes(xledger.LedgerCloseMeta, m)))

            def close_ledger(self, lcd):
                frames = lcd.tx_set.frames
                msgs = {f.contents_hash() for f in frames} | {
                    f.inner.contents_hash() for f in frames
                    if hasattr(f, "inner")}
                misses0 = keys.get_verify_cache_stats()["misses"]
                spans0 = tracing.span_totals()
                rec._close = len(rec.closes)
                t = time.perf_counter()
                try:
                    res = super().close_ledger(lcd)
                finally:
                    rec._close = None
                rec.closes.append({
                    "ledger": lcd.ledger_seq, "txs": len(frames),
                    "hash": res.header_hash.hex(),
                    "ms": (time.perf_counter() - t) * 1e3,
                    "applied": res.applied_count,
                    "failed": res.failed_count,
                    "misses": keys.get_verify_cache_stats()["misses"] -
                    misses0,
                    "spans": _close_spans(spans0, tracing.span_totals()),
                    "envelope_msgs": msgs, "result": res})
                return res
        return RecordingManager

    def wrapped(self):
        return _Wrapped(
            (BatchVerifier, "verify_batch", self._verify_batch),
            (keys.SecretKey, "sign", self._sign),
            (load_generator, "LedgerManager", self._manager),
            (load_generator, "make_tx_set_from_transactions",
             self._make_set),
            (_build, "launch", self._launch),
            (keys, "_ref", lambda module: self.oracle))

    def in_close(self, index):
        """The verify calls inside close ``index``: the one-row calls'
        seconds and messages, and the batches' rows."""
        ones = [(dt, msg) for rows, dt, c, msg in self.calls
                if c == index and rows == 1]
        batches = [rows for rows, _dt, c, _m in self.calls
                   if c == index and rows > 1]
        return ones, batches


def _soroban_load_gates(label, rec, first_load, txs):
    """Each load close of a ``soroban_apply_load`` arm: every transaction
    applied; one batch inside it, the close's own prefetch of the set's
    envelope signatures (the payer's and the source's of each
    transaction: the harness's set build runs no ``check_valid``); one
    one-row verify a transaction, each an auth entry's (its message no
    envelope's contents hash); the verify cache's misses exactly those
    two. Returns the auth verifies' figures a close."""
    out = []
    for i, c in enumerate(rec.closes[first_load:], first_load):
        ones, batches = rec.in_close(i)
        stray = sum(msg in c["envelope_msgs"] for _dt, msg in ones)
        check(c["applied"] == txs and c["failed"] == 0,
              f"soroban ({label}): ledger {c['ledger']} applied "
              f"{c['applied']}, failed {c['failed']}")
        check(batches == [2 * txs] and len(ones) == txs and stray == 0,
              f"soroban ({label}): ledger {c['ledger']}: batches {batches},"
              f" {len(ones)} one-row verifies, {stray} of them an "
              "envelope's")
        check(c["misses"] == 2 * txs + txs, f"soroban ({label}): ledger "
              f"{c['ledger']}: {c['misses']} verify cache misses, not "
              f"{2 * txs} prefetched and {txs} auth entries")
        ms = np.array([dt for dt, _m in ones]) * 1e3
        out.append({"ledger": c["ledger"], "close_ms": c["ms"],
                    "auth_verifies": len(ones),
                    "auth_p50_ms": float(np.percentile(ms, 50)),
                    "auth_p99_ms": float(np.percentile(ms, 99)),
                    "auth_s": float(ms.sum() / 1e3),
                    "auth_share_of_close": float(ms.sum() / c["ms"]),
                    "spans_ms": c["spans"], "misses": c["misses"]})
    return out


def _soroban_arm(label, ledgers, txs, use_wasm, pins, meta_pin):
    """(a) or (b): ``soroban_apply_load(n_ledgers=ledgers,
    txs_per_ledger=txs, use_wasm=use_wasm)`` with ``default_verifier()``
    installed as ``keys.verify_sig``'s backend (the signer-table cache on,
    empty) and the verify cache flushed; K1's, K2's and K3's counts set
    to 0 before it and read after. Gated as ``_soroban_load_gates`` says,
    and on the reference's close hashes ``pins`` and meta hash
    ``meta_pin``, the host oracle deciding nothing, and its verdicts
    equal to the card's after the arm."""
    check(keys._backend is None, f"soroban ({label}): a verify backend is "
          "installed")
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    rec = _SorobanRecord()
    spans0 = tracing.span_totals()
    _zero_counts()
    default_verifier().install()
    try:
        with rec.wrapped():
            t = time.perf_counter()
            out = load_generator.soroban_apply_load(
                n_ledgers=ledgers, txs_per_ledger=txs, use_wasm=use_wasm)
            wall_s = time.perf_counter() - t
        launches = _counts()
    finally:
        keys.set_verifier_backend(None)
    check(keys._backend is None, f"soroban ({label}): the backend was not "
          "restored")
    kernels = rec.kernel_time(wall_s)
    want = ledgers * txs
    check(out["total_applied"] == want and out["counter_value"] == want,
          f"soroban ({label}): applied {out['total_applied']}, counter "
          f"{out['counter_value']}, not {want}")
    hashes = tuple(c["hash"] for c in rec.closes)
    meta = hashlib.sha256(b"".join(rec.metas)).hexdigest()
    check(hashes == pins and meta == meta_pin, f"soroban ({label}): close "
          f"hashes {hashes}, meta hash {meta}, not the reference's")
    check(rec.oracle.calls == 0, f"soroban ({label}): the host oracle "
          f"decided {rec.oracle.calls} signatures")
    closes = _soroban_load_gates(label, rec, 2, txs)
    check(launches["verify_cold"] > 0 and launches["verify_hot"] > 0,
          f"soroban ({label}): K1 and K2 launches {launches}")
    # a Soroban transaction's contents preimage (792 B inner, 920 B
    # fee-bumped) is longer than K3's MAX_BLOCKS blocks take, so the
    # hasher serves every row of these sets on the host: K3 is not on
    # config 5's path
    check(len(rec.hashed) == ledgers and all(
        host == n and longest > 64 * MAX_BLOCKS - 9 and ok
        for n, host, longest, ok in rec.hashed) and
        launches["sha256"] == 0, f"soroban ({label}): the sets' contents "
        f"hashes {rec.hashed}, K3 launches {launches['sha256']}")
    bad, recheck_s = rec.oracle_recheck()
    check(not bad and len(rec.triples) >= 3 * want,
          f"soroban ({label}): the oracle disagrees with {len(bad)} of "
          f"{len(rec.triples)} verdicts")
    spans = _engine_spans(spans0, tracing.span_totals())
    for c, (hash_ms, build_ms, sign_s) in zip(closes, rec.set_builds[2:]):
        c.update(set_hash_ms=hash_ms, set_build_ms=build_ms, sign_s=sign_s)
    return {"harness": out, "wall_s": wall_s, "closes": closes,
            "setup_close_ms": [c["ms"] for c in rec.closes[:2]],
            "launches": launches, "kernels": kernels,
            "engine_spans_ms": spans, "triples": len(rec.triples),
            "oracle_recheck_s": recheck_s,
            "contents_hashes": [{"frames": n, "host_rows": host,
                                 "longest_preimage": longest}
                                for n, host, longest, _ok in rec.hashed],
            "one_row_calls": sum(r == 1 for r, *_ in rec.calls),
            "batch_calls": sum(r > 1 for r, *_ in rec.calls)}


def _soroban_tamper():
    """(c): ``vectors.soroban_tamper_envelopes``, the harness's own
    helpers' upload, creation and ten invocations of the compiled
    counter, one auth signature with a byte flipped, closed over
    ``seed_root_with_accounts(vectors.soroban_tamper_accounts())`` with
    ``default_verifier()`` installed: 9 apply, the flipped one fails with
    the reference's code, the card's verdict on its auth triple False,
    the oracle's too."""
    nid = tx_test_utils.TEST_NETWORK_ID
    ledgers, bad = vectors.soroban_tamper_envelopes(nid)
    lm = ledger_manager.LedgerManager(
        nid, tx_test_utils.seed_root_with_accounts(
            vectors.soroban_tamper_accounts()))
    lm.last_closed_header.ledgerVersion = CURRENT_LEDGER_PROTOCOL_VERSION
    lm.soroban_config = vectors.soroban_tamper_config(lm.soroban_config)
    lm.root.soroban_config = lm.soroban_config
    keys.flush_verify_cache()
    rec = _SorobanRecord()
    _zero_counts()
    default_verifier().install()
    try:
        with rec.wrapped():
            for envs in ledgers:
                frames = [make_transaction_frame(nid, from_bytes(
                    xtx.TransactionEnvelope, e)) for e in envs]
                txset, excluded = tx_set.make_tx_set_from_transactions(
                    frames, lm.last_closed_header, lm.last_closed_hash,
                    soroban_config=lm.soroban_config)
                check(not excluded, f"soroban (c): {len(excluded)} excluded")
                res = lm.close_ledger(ledger_manager.LedgerCloseData(
                    lm.ledger_seq + 1, txset,
                    lm.last_closed_header.scpValue.closeTime + 5))
        launches = _counts()
    finally:
        keys.set_verifier_backend(None)
    flipped = frames[vectors.SOROBAN_TAMPER_FLIPPED].contents_hash()
    codes = {}
    for pair in res.result_pairs:
        r = pair.result.result
        op = r.value[0].value.value.arm if isinstance(r.value, list) else None
        codes[pair.transactionHash] = (
            xresults.TransactionResultCode.name_of(r.arm),
            None if op is None else
            xresults.InvokeHostFunctionResultCode.name_of(op))
    card = rec.triples.get(bad)
    check(res.applied_count == vectors.SOROBAN_TAMPER_TXS - 1 and
          res.failed_count == 1 and
          codes[flipped] == ("txFAILED", SOROBAN_TAMPER_CODE) and
          res.header_hash.hex() == SOROBAN_TAMPER_CLOSE_HASH,
          f"soroban (c): applied {res.applied_count}, failed "
          f"{res.failed_count}, the flipped one {codes.get(flipped)}, "
          f"header hash {res.header_hash.hex()}")
    check(card is False and ref.verify(*bad) is False and
          rec.oracle.calls == 0, f"soroban (c): the card's verdict {card}, "
          f"the oracle decided {rec.oracle.calls} while the arm ran")
    check(launches["verify_cold"] + launches["verify_hot"] > 0,
          f"soroban (c): no K1 or K2 launch {launches}")
    bad_verdicts, _s = rec.oracle_recheck()
    check(not bad_verdicts, f"soroban (c): the oracle disagrees with "
          f"{len(bad_verdicts)} verdicts")
    return {"applied": res.applied_count, "failed": res.failed_count,
            "flipped": codes[flipped], "card_verdict": card,
            "launches": launches, "triples": len(rec.triples)}


def _soroban_line(tag, r, card):
    h = r["harness"]
    k = r["kernels"]
    kernels = ", ".join(
        f"{name} {v['ms']:.3f} ms over {v['launches']} launches of "
        f"{v['rows']} rows" for name, v in k["by_kernel"].items())
    print(f"[soroban] {tag}: engine {h['engine']}, applied "
          f"{h['total_applied']}, counter {h['counter_value']}; the "
          f"harness's close_mean_ms {h['close_mean_ms']}, close_max_ms "
          f"{h['close_max_ms']}, txs_per_sec {h['txs_per_sec']}; wall "
          f"{r['wall_s']:.3f} s (setup closes {r['setup_close_ms']} ms); "
          f"the kernels (CUDA events around each launch) took "
          f"{k['ms']:.3f} ms of the card, {k['share_of_wall']:.3%} of the "
          f"wall: {kernels}; the load sets' contents hashes "
          f"{r['contents_hashes']} (every row over K3's {MAX_BLOCKS} "
          f"blocks, so hashed on the host); verify calls: "
          f"{r['one_row_calls']} of one "
          f"row, {r['batch_calls']} batches; engine spans "
          f"{r['engine_spans_ms']}; launches {r['launches']}; oracle "
          f"re-check of {r['triples']} triples {r['oracle_recheck_s']:.3f} "
          f"s, all agree; card {card}")
    for c in r["closes"]:
        sp = c["spans_ms"]
        print(f"[soroban] {tag} ledger {c['ledger']}: signing "
              f"{c['sign_s']:.3f} s, set build {c['set_build_ms']:.3f} ms "
              f"(contents hashes first {c['set_hash_ms']:.3f} ms), close "
              f"{c['close_ms']:.3f} ms (ledger.close {sp['close_zone']:.3f}"
              f", verify span {sp['verify_span']:.3f}, bucket.addBatch "
              f"{sp['add_batch']:.3f}, rest {sp['rest']:.3f}); "
              f"{c['auth_verifies']} auth verifies, p50 "
              f"{c['auth_p50_ms']:.3f} ms, p99 {c['auth_p99_ms']:.3f} ms, "
              f"{c['auth_s']:.3f} s in all, {c['auth_share_of_close']:.2%} "
              f"of the close; {c['misses']} verify cache misses; card "
              f"{card}")


def phase_soroban(info):
    """Phase 25: ``BASELINE.json`` config 5 through the port's
    ``simulation.load_generator.soroban_apply_load``: (a) 3 ledgers of 500
    fee-bumped invocations on the SCVal program, (b) the compiled wasm
    counter on the native engine, (c) a tampered auth entry. Each arm's
    K1, K2 and K3 counts are set to 0 just before it and read just
    after."""
    t0 = time.perf_counter()
    before = _process_state()
    _stop_process_state()
    check(batch_engine.device_available(block=True),
          "soroban: the device probe did not answer")
    res = {"card": info["smi"], "state_before": before}
    launches = {}
    res["a"] = _soroban_arm("a", SOROBAN_LEDGERS, SOROBAN_TXS, False,
                            SOROBAN_CLOSE_HASHES, SOROBAN_META_HASH)
    check(res["a"]["harness"]["engine"] == "scval",
          f"soroban (a): engine {res['a']['harness']['engine']}")
    launches["a"] = res["a"]["launches"]
    _soroban_line(f"(a) config 5, {SOROBAN_LEDGERS} x {SOROBAN_TXS}",
                  res["a"], info["smi"])
    res["b"] = _soroban_arm("b", SOROBAN_WASM_LEDGERS, SOROBAN_TXS, True,
                            SOROBAN_WASM_CLOSE_HASHES,
                            SOROBAN_WASM_META_HASH)
    check(res["b"]["harness"]["engine"] == "wasm-native",
          f"soroban (b): engine {res['b']['harness']['engine']}")
    launches["b"] = res["b"]["launches"]
    _soroban_line(f"(b) the compiled counter, {SOROBAN_WASM_LEDGERS} x "
                  f"{SOROBAN_TXS}", res["b"], info["smi"])
    res["c"] = _soroban_tamper()
    launches["c"] = res["c"]["launches"]
    print(f"[soroban] (c) a tampered auth entry: {res['c']}")
    check_dispatch_clean([default_verifier(), default_hasher()], "soroban")
    _stop_process_state()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"[soroban] phase {res['seconds']:.1f} s; card {info['smi']}")
    return res, launches


def _sum_counts(runs):
    return {k: sum(r["launches"][k] for r in runs)
            for k in runs[0]["launches"]}


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


def _operator_conf(path, database, bucket_dir, archive, **extra):
    """A node's TOML: the passphrase, its files, its archive and
    ``extra``; returns its path."""
    lines = [f'NETWORK_PASSPHRASE = "{OPERATOR_PASSPHRASE}"',
             f'DATABASE = "{database}"', f'BUCKET_DIR_PATH = "{bucket_dir}"',
             f'HISTORY_ARCHIVES = ["{archive}"]']
    lines += [f"{k} = {json.dumps(v)}" for k, v in extra.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class _Node:
    """``python -m stellar_tpu_torch --conf <conf> run`` from the
    repository root: its standard error read on a thread (its lines
    kept), its HTTP port from its ``node up:`` line."""

    def __init__(self, conf):
        self.lines = []
        self._up = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "stellar_tpu_torch", "--conf", conf,
             "run"], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            if "node up:" in line:
                self._up.set()
        self._up.set()

    def wait_up(self, timeout):
        """The node's HTTP port once its ``node up:`` line is out, or None
        when it exited or the time ran out."""
        self._up.wait(timeout)
        if self.proc.poll() is not None:
            return None
        line = next((ln for ln in self.lines if "node up:" in ln), None)
        if line is None:
            return None
        self.port = int(line.rsplit("http port ", 1)[1].split(",")[0])
        return self.port

    def get(self, route):
        """One admin route: its JSON, or its text."""
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/{route}",
                                    timeout=120) as r:
            body = r.read().decode()
        try:
            return json.loads(body)
        except json.JSONDecodeError:
            return body

    def stop(self, timeout):
        """SIGINT, as an operator stops a node; its exit code (None if it
        did not exit in time, and then it is killed)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            rc = None
        self._reader.join(10)
        return rc

    def tail(self, n=3000):
        return "".join(self.lines)[-n:]


def _engine_rows(dispatch, kind="verify"):
    """The ``kind`` engines' served rows from a ``dispatch`` body: on the
    card (``device``), of those by K2 (``hot``), on the host (the
    verify engines', or ``kind="hash"``: K3's)."""
    out = collections.Counter()
    for name, eng in dispatch["engines"].items():
        if name.split(":", 1)[0] == kind:
            for k in ("device", "hot", "host"):
                out[k] += eng["served"].get(k, 0)
    return out


def _signer_counts(metrics):
    """The signer-table counters from a ``metrics`` body."""
    prefix = "crypto.verify.signer_table."
    return {k[len(prefix):]: v["count"] for k, v in metrics.items()
            if k.startswith(prefix)}


def _operator_round(node, blobs, label):
    """Each transaction over the node's ``tx`` route (every answer must be
    ``PENDING``), then ``manualclose``: the round trips (s) and the
    close's."""
    trips = []
    for raw in blobs:
        t = time.perf_counter()
        got = node.get("tx?blob=" + urllib.parse.quote(
            base64.b64encode(raw).decode()))
        trips.append(time.perf_counter() - t)
        check(got == {"status": "PENDING"},
              f"operator (a) {label}: a submission answered {got}")
    seq = node.get("info")["ledger"]["num"]
    t = time.perf_counter()
    got = node.get("manualclose")
    close_s = time.perf_counter() - t
    check(got == {"ledger": seq + 1}, f"operator (a) {label}: manualclose "
          f"answered {got} over ledger {seq}")
    return trips, close_s


def _trip_figures(trips):
    ms = np.array(trips) * 1e3
    return {"n": len(trips), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "total_s": float(ms.sum() / 1e3)}


def _operator_run(tmp):
    """(a): config 1 through a running node. Returns the figures, the
    node's files and ledger 63's hash."""
    database = os.path.join(tmp, "node.db")
    buckets = os.path.join(tmp, "buckets")
    archive = os.path.join(tmp, "archive")
    t = time.perf_counter()
    genesis = vectors.operator_genesis(database, buckets,
                                       OPERATOR_PASSPHRASE)
    rounds = [[to_bytes(xtx.TransactionEnvelope, f.envelope) for f in fr]
              for fr in vectors.operator_rounds(OPERATOR_PASSPHRASE)]
    setup_s = time.perf_counter() - t
    conf = _operator_conf(
        os.path.join(tmp, "node.toml"), database, buckets, archive,
        RUN_STANDALONE=True, MANUAL_CLOSE=True, NODE_SEED="operator-node",
        HTTP_PORT=0, MODE_AUTO_STARTS_OVERLAY=False,
        EXPECTED_LEDGER_CLOSE_TIME=OPERATOR_CLOSE_TIMER_S,
        VERIFY_SERVICE_ENABLED=True)
    t = time.perf_counter()
    node = _Node(conf)
    out = {"setup_s": setup_s, "genesis": genesis}
    try:
        port = node.wait_up(OPERATOR_UP_S)
        check(port is not None, "operator (a): the node never came up: "
              + node.tail())
        out["up_s"] = time.perf_counter() - t
        info = node.get("info")
        check(info["ledger"]["num"] == vectors.OPERATOR_GENESIS_SEQ and
              info["ledger"]["hash"] == genesis[1],
              f"operator (a): the node resumed at {info['ledger']}, not the "
              f"genesis {genesis}")
        d0 = node.get("dispatch")
        check(d0["backend"] == "device-batch" and
              d0["device_state"] == "cuda",
              f"operator (a): backend {d0['backend']}, device "
              f"{d0['device_state']}")
        marks = [(_engine_rows(d0), _signer_counts(node.get("metrics")))]
        rounds_out = []
        t = time.perf_counter()
        for label, blobs in zip(("create", "first sights", "repeats"),
                                rounds):
            trips, close_s = _operator_round(node, blobs, label)
            marks.append((_engine_rows(node.get("dispatch")),
                          _signer_counts(node.get("metrics"))))
            rounds_out.append({"label": label, "trips": _trip_figures(trips),
                               "close_ms": close_s * 1e3})
        out["traffic_s"] = time.perf_counter() - t
        out["rounds"] = rounds_out
        deltas = []
        for (s0, c0), (s1, c1) in zip(marks, marks[1:]):
            deltas.append({
                "device": s1["device"] - s0["device"],
                "hot": s1["hot"] - s0["hot"], "host": s1["host"] - s0["host"],
                "signer_misses": c1.get("misses", 0) - c0.get("misses", 0),
                "signer_hits": c1.get("hits", 0) - c0.get("hits", 0),
                "signer_installs":
                    c1.get("installs", 0) - c0.get("installs", 0)})
        out["served"] = dict(zip(("create", "first", "repeat"), deltas))
        n = vectors.OPERATOR_ACCOUNTS
        first, repeat = deltas[1], deltas[2]
        # the card decides every signature the node checks: no row on
        # the host; the payments' signers are first sights (K1) in the
        # first round and table hits (K2) in the second
        check(all(d["host"] == 0 for d in deltas), "operator (a): rows "
              f"served on the host {deltas}")
        check(first["device"] - first["hot"] >= n and
              first["signer_misses"] >= n and
              repeat["hot"] >= n and repeat["signer_hits"] >= n,
              f"operator (a): the card's rows and the signer table's "
              f"counters do not show {n} first sights then {n} repeats: "
              f"{deltas}")
        accounts = []
        for name in [OPERATOR_PASSPHRASE] + vectors.operator_names():
            acc = node.get("testacc?name=" + urllib.parse.quote(name))
            accounts.append((acc["id"], acc["balance"], acc["seqnum"]))
        digest = vectors.operator_state_digest(accounts)
        check(digest == vectors.OPERATOR_STATE_DIGEST,
              f"operator (a): the accounts' digest {digest} is not the "
              "reference's")
        routes = {}
        for route in OPERATOR_ROUTES:
            t = time.perf_counter()
            body = node.get(route)
            routes[route] = {"ms": (time.perf_counter() - t) * 1e3,
                             "bytes": len(json.dumps(body))}
        prom = node.get("metrics?format=prometheus")
        check(isinstance(prom, str) and "# TYPE" in prom,
              "operator (a): the Prometheus text is missing")
        svc = node.get("service")
        tot = svc.get("totals", {})
        check(svc.get("running") is not False and
              tot.get("shed", 0) == tot.get("rejected", 0) ==
              tot.get("failed", 0) == 0 and
              svc.get("conservation_gap", 0) == 0,
              f"operator (a): the service {svc.get('running')}, totals "
              f"{tot}, gap {svc.get('conservation_gap')}")
        d1 = node.get("dispatch")
        served = _engine_rows(d1)
        out["rows"] = {
            "verify_cold": served["device"] - served["hot"] -
            (marks[0][0]["device"] - marks[0][0]["hot"]),
            "verify_hot": served["hot"] - marks[0][0]["hot"],
            "sha256": _engine_rows(d1, "hash")["device"] -
            _engine_rows(d0, "hash")["device"]}
        check(d1["backend"] == "device-batch" and
              d1["deadline_misses"] == d1["short_circuits"] == 0 and
              d1["audit"]["mismatches"] == 0,
              f"operator (a): dispatch after the traffic {d1['backend']}, "
              f"deadline misses {d1['deadline_misses']}, short circuits "
              f"{d1['short_circuits']}, audit {d1['audit']}")
        metrics = node.get("metrics")
        fallbacks = {k: v["count"] for k, v in metrics.items()
                     if k.startswith("crypto.verify.service.adopter_fallback")
                     and v.get("count")}
        rejected = metrics.get("crypto.verify.trickle.rejected",
                               {}).get("count", 0)
        check(not fallbacks and rejected == 0, f"operator (a): service "
              f"fallbacks {fallbacks}, trickle rejections {rejected}")
        out.update(routes=routes, service_totals=tot,
                   transfer=d1.get("transfer"),
                   pipeline=node.get("pipeline?limit=0"),
                   audit=d1["audit"])
        # empty closes to the checkpoint, which the node publishes
        t = time.perf_counter()
        while node.get("info")["ledger"]["num"] < vectors.OPERATOR_CHECKPOINT:
            node.get("manualclose")
        out["to_checkpoint_s"] = time.perf_counter() - t
        info = node.get("info")["ledger"]
        check(info["num"] == vectors.OPERATOR_CHECKPOINT,
              f"operator (a): the node is at ledger {info['num']}")
        last_hash = info["hash"]
    finally:
        rc = node.stop(OPERATOR_STOP_S)
    check(rc == 0, f"operator (a): the node exited with {rc} on SIGINT: "
          + node.tail())
    db = Database(database)
    try:
        applied = []
        for seq in range(vectors.OPERATOR_GENESIS_SEQ + 1,
                         vectors.OPERATOR_GENESIS_SEQ + 4):
            codes = [from_bytes(xresults.TransactionResult, res).result.arm
                     for _id, _body, res in db.load_tx_history(seq)]
            applied.append(sum(c == 0 for c in codes))
    finally:
        db.close()
    check(applied == [1, vectors.OPERATOR_ACCOUNTS, vectors.OPERATOR_ACCOUNTS],
          f"operator (a): the three ledgers applied {applied}")
    out.update(applied=applied, ledger63=last_hash, exit_code=rc)
    return out, (conf, database, buckets, archive)


def _cli(argv):
    """``stellar_tpu_torch.main.cli.main(argv)`` in this process: its exit
    code, its standard output and its seconds."""
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port_cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _operator_cli(tmp, files, ledger63):
    """(b): the CLI on (a)'s files; ``catchup 63/complete`` into a fresh
    database. Returns the figures and each command's K1/K2/K3 counts."""
    conf, _database, _buckets, archive = files
    out, launches = {}, {}
    _zero_counts()
    rc, text, sec = _cli(["--conf", conf, "self-check"])
    check(rc == 0, f"operator (b): self-check exited {rc}: {text}")
    sc = _last_json(text)
    st = sc["state"]
    check(st["bucket_list_hash_ok"] and st["bucket_files_ok"] and
          st["store_scan_ok"] and st["lcl"] == vectors.OPERATOR_CHECKPOINT,
          f"operator (b): self-check {sc}")
    # its benchmark is one-row verify_sig calls with no backend: the host
    # oracle, as in the reference
    check(keys._backend is None, "operator (b): a verify backend is "
          "installed before self-check")
    out["self_check"] = dict(sc, seconds=sec)
    rc, text, sec = _cli(["--conf", conf, "offline-info"])
    info = json.loads(text)
    check(rc == 0 and info["ledger"]["seq"] == vectors.OPERATOR_CHECKPOINT
          and info["ledger"]["hash"] == ledger63,
          f"operator (b): offline-info {rc} {info.get('ledger')}")
    out["offline_info_s"] = sec
    rc, text, sec = _cli(["--conf", conf, "dump-ledger", "--filter",
                          "type=='ACCOUNT'"])
    accounts = []
    for line in text.splitlines():
        e = from_bytes(xt.LedgerEntry,
                       bytes.fromhex(json.loads(line)["entry"]))
        accounts.append((strkey.encode_account(e.data.value.accountID.value),
                         e.data.value.balance, e.data.value.seqNum))
    digest = vectors.operator_state_digest(accounts)
    check(rc == 0 and len(accounts) == vectors.OPERATOR_ACCOUNTS + 1 and
          digest == vectors.OPERATOR_STATE_DIGEST,
          f"operator (b): dump-ledger {rc}, {len(accounts)} accounts, "
          f"digest {digest}")
    out["dump_ledger_s"] = sec
    rc, text, _ = _cli(["--conf", conf, "print-publish-queue"])
    queue = json.loads(text)["queue"]
    check(rc == 0, f"operator (b): print-publish-queue exited {rc}")
    rc, text, sec = _cli(["--conf", conf, "publish"])
    published = json.loads(text)
    check(rc == 0, f"operator (b): publish exited {rc}")
    check(published["published_checkpoints"] == queue,
          f"operator (b): queue {queue}, published {published}")
    out["publish"] = {"queue": queue, **published, "seconds": sec}
    launches["offline"] = _counts()
    # the catchup: a fresh database given the same genesis, the node's
    # configuration, so that Application installs the device batch
    # verifier as it does wherever a card answers; every decision
    # counted at the host oracle
    fresh = os.path.join(tmp, "fresh")
    os.makedirs(fresh)
    genesis = vectors.operator_genesis(
        os.path.join(fresh, "node.db"), os.path.join(fresh, "buckets"),
        OPERATOR_PASSPHRASE)
    conf2 = _operator_conf(
        os.path.join(fresh, "node.toml"), os.path.join(fresh, "node.db"),
        os.path.join(fresh, "buckets"), archive,
        VERIFY_SERVICE_ENABLED=True)
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    oracle = _CountingOracle(keys._ref)
    _zero_counts()
    with _Wrapped((keys, "_ref", lambda module: oracle)):
        rc, text, sec = _cli(["--conf", conf2, "catchup",
                              f"{vectors.OPERATOR_CHECKPOINT}/complete"])
    launches["catchup"] = _counts()
    backend = keys.get_verifier_backend_name()
    res = _last_json(text)
    check(rc == 0 and res["state"] == "SUCCESS" and
          res["ledger"] == vectors.OPERATOR_CHECKPOINT and
          res["hash"] == ledger63,
          f"operator (b): catchup exited {rc}: {res}, not ledger 63 "
          f"{ledger63}")
    check(oracle.calls == 0 and backend == "device-batch",
          f"operator (b): the host oracle decided {oracle.calls} "
          f"signatures of the replay; backend {backend}")
    check(launches["catchup"]["verify_cold"] > 0,
          f"operator (b): the replay launched no K1 {launches['catchup']}")
    out["catchup"] = {"seconds": sec, "genesis": genesis, **res,
                      "oracle_calls": oracle.calls, "backend": backend}
    _stop_process_state()
    _zero_counts()
    rc, text, sec = _cli(["apply-load", "--scenario", "close", "--ledgers",
                          "1", "--txs", "100"])
    launches["apply_load"] = _counts()
    stats = _last_json(text)
    # its default --verify picks the card wherever one answers
    backend = keys.get_verifier_backend_name()
    check(rc == 0 and backend == "device-batch" and
          launches["apply_load"]["verify_cold"] +
          launches["apply_load"]["verify_hot"] > 0,
          f"operator (b): apply-load {rc} {stats}, backend {backend}, "
          f"launches {launches['apply_load']}")
    out["apply_load"] = dict(stats, seconds=sec, backend=backend)
    _stop_process_state()
    return out, launches


class _TransportClock:
    """Seconds in the TCP transport: ``TCPDriver.poll`` (the selector,
    the socket reads and the framing) less ``Peer.receive_bytes`` (the
    handling of each received frame), plus ``TCPPeer.send_bytes`` (the
    socket writes, wherever called)."""

    def __init__(self):
        self.s = collections.Counter()

    def _timed(self, key):
        def wrap(fn):
            def timed(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.s[key] += time.perf_counter() - t
            return timed
        return wrap

    def wrapped(self):
        return _Wrapped((TCPDriver, "poll", self._timed("poll")),
                        (Peer, "receive_bytes", self._timed("receive")),
                        (TCPPeer, "send_bytes", self._timed("send")))

    def transport_s(self):
        return self.s["poll"] - self.s["receive"] + self.s["send"]


def _routes_off_crank(sim, handler, routes):
    """The handler's routes read on a thread while this one cranks the
    network (a route runs on its node's crank)."""
    got, done = {}, threading.Event()

    def read():
        try:
            for route in routes:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{handler.port}/{route}",
                        timeout=60) as r:
                    got[route] = json.loads(r.read())
        except Exception as e:  # reported by the gate below
            got["error"] = repr(e)
        done.set()
    threading.Thread(target=read, daemon=True).start()
    sim.crank_until(done.is_set, 120)
    check(done.is_set() and "error" not in got,
          f"operator (c): the routes {got.get('error', 'timed out')}")
    return got


def _tcp_tamper(sim, apps, rec):
    """Node 1's last statement re-signed with one signature byte flipped,
    sent to node 0 as an SCP message over node 1's ``TCPPeer`` (the
    frame's MAC computed over the tampered envelope): node 0's scp lane
    takes it to the card, which refuses it."""
    a0, a1 = apps[0], apps[1]
    id0 = a0.config.NODE_SEED.public_key.raw
    slot = max(a1.herder.scp.known_slots)
    mine = [st for st, _v in a1.herder.scp.known_slots[slot]
            .statements_history
            if st.nodeID.value == a1.config.NODE_SEED.public_key.raw]
    st = mine[-1]
    payload = herder_mod.scp_envelope_sign_payload(
        a1.config.network_id(), st)
    sig = bytearray(a1.config.NODE_SEED.sign(payload))
    sig[7] ^= 0x20
    triple = (a1.config.NODE_SEED.public_key.raw, payload, bytes(sig))
    peer = next(p for p in a1.overlay.peers if p.remote_node_id == id0)
    check(isinstance(peer, TCPPeer), f"operator (c): node 1's peer is "
          f"{type(peer).__name__}")
    scp0 = len(rec.trips["scp"])
    peer.send(StellarMessage.make(MessageType.SCP_MESSAGE, SCPEnvelope(
        statement=st, signature=bytes(sig))))
    check(sim.crank_until(lambda: triple in rec.triples, 60),
          "operator (c): the tampered envelope never reached a verifier")
    verdict = rec.triples[triple]
    check(verdict is False and ref.verify(*triple) is False,
          f"operator (c): the card's verdict on the tampered envelope "
          f"{verdict}")
    return {"slot": slot, "verdict": verdict,
            "scp_round_trips": len(rec.trips["scp"]) - scp0}


def _operator_tcp():
    """(c): config 4 over TCP on the verify service, a ``CommandHandler``
    on node 0, then the tampered envelope and one more ledger."""
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    fallback0 = _fallbacks()
    rec = _ArmRecord()
    clock = _TransportClock()
    served0 = _engine_rows({"engines": batch_engine.dispatch_health()[
        "engines"]})
    _zero_counts()
    spans0 = tracing.span_totals()
    out = {}
    with rec.wrapped(), clock.wrapped():
        t = time.perf_counter()
        sim = vectors.core_network(TCP_VALIDATORS, mode=Simulation.OVER_TCP,
                                   VERIFY_SERVICE_ENABLED=True)
        apps = list(sim.nodes.values())
        for app in apps:
            _record_closes(app)
        handler = CommandHandler(apps[0], port=0)
        try:
            out["build_s"] = time.perf_counter() - t
            t = time.perf_counter()
            check(sim.crank_until(lambda: all(
                a.overlay.authenticated_count() >= TCP_VALIDATORS - 1
                for a in apps), TCP_AUTH_TIMEOUT_S),
                "operator (c): the mesh never authenticated "
                f"{[a.overlay.authenticated_count() for a in apps]}")
            out["auth_s"] = time.perf_counter() - t
            sim.start_all_nodes()
            rec.start_window()
            clock.s.clear()
            start = max(a.lm.ledger_seq for a in apps)
            last = start + TCP_ROUNDS
            t = time.perf_counter()
            check(sim.crank_until_ledger(last, TCP_CRANK_TIMEOUT_S),
                  f"operator (c): ledger {last} not reached "
                  f"{[a.lm.ledger_seq for a in apps]}")
            wall_s = time.perf_counter() - t
            blocked_s = rec.blocked_s()
            transport_s = clock.transport_s()
            transport = dict(clock.s)
            statements = sum(len(slot.statements_history) for a in apps
                             for slot in a.herder.scp.known_slots.values())
            distinct = keys.get_verify_cache_stats()["size"]
            launches = _counts()
            spans = _engine_spans(spans0, tracing.span_totals())
            kernels = rec.kernel_time(wall_s)
            served = _engine_rows({"engines": batch_engine.dispatch_health()[
                "engines"]})
            routes = _routes_off_crank(sim, handler,
                                       ("peers", "quorum", "scp", "info"))
            _zero_counts()
            tamper = _tcp_tamper(sim, apps, rec)
            seq = max(a.lm.ledger_seq for a in apps)
            check(sim.crank_until_ledger(seq + 1, TCP_CRANK_TIMEOUT_S),
                  f"operator (c): ledger {seq + 1} not reached after the "
                  "tampered envelope")
            tamper["launches"] = _counts()
            svc_snap = verify_service.running_service().snapshot()
        finally:
            handler.stop()
            sim.close()
    # every node closed every ledger of the arm with the same hash
    ledgers = range(start + 1, last + 1)
    split = {seq: sorted({a.closes.get(seq) for a in apps},
                         key=str) for seq in ledgers}
    check(all(len(h) == 1 and h[0] is not None for h in split.values()),
          f"operator (c): the nodes disagree or missed a ledger {split}")
    peers = routes["peers"]["authenticated_peers"]
    check(len(peers) == TCP_VALIDATORS - 1 and
          all(p["authenticated"] for p in peers),
          f"operator (c): node 0's peers route {peers}")
    q = routes["quorum"]
    check(q["threshold"] == TCP_VALIDATORS - (TCP_VALIDATORS - 1) // 3 and
          len(q["validators"]) == TCP_VALIDATORS,
          f"operator (c): node 0's quorum route {q}")
    check(str(last) in routes["scp"] and
          routes["info"]["peers"]["authenticated_count"] ==
          TCP_VALIDATORS - 1,
          f"operator (c): node 0's scp route {sorted(routes['scp'])}, info "
          f"{routes['info']['peers']}")
    cold_rows = (served["device"] - served["hot"]) - \
        (served0["device"] - served0["hot"])
    check(0 < launches["verify_cold"] <= TCP_VALIDATORS and
          cold_rows == TCP_VALIDATORS and launches["verify_hot"] > 0,
          f"operator (c): launches {launches}, K1 rows {cold_rows}: not one "
          f"first sight a validator, then K2")
    gates = _arm_gates("operator (c)", rec, fallback0, svc_snap=svc_snap)
    out.update({"wall_s": wall_s, "ledgers": f"{start + 1}-{last}",
                "rounds_per_s": TCP_ROUNDS / wall_s,
                "transport_s": transport_s,
                "transport_share": transport_s / wall_s,
                "poll_s": transport["poll"],
                "receive_s": transport["receive"],
                "send_s": transport["send"], "blocked_s": blocked_s,
                "statements": statements,
                "distinct_triples": distinct,
                "trips": rec.figures(), "launches": launches,
                "kernels": kernels, "engine_spans_ms": spans,
                "cold_rows": cold_rows,
                "lanes": _lane_figures(svc_snap), "tamper": tamper,
                "routes": {"scp_slots": sorted(routes["scp"], key=int),
                           "quorum_threshold": q["threshold"],
                           "peers": len(peers)}, **gates})
    _stop_process_state()
    return out


def phase_operator(info):
    """Phase 27: the operator surface. (a) config 1 through a node
    started as ``python -m stellar_tpu_torch --conf <file> run``, (b) the
    CLI on its files in this process, (c) config 4 over TCP. Each arm's
    K1, K2 and K3 counts are set to 0 just before it and read just after
    ((a)'s come from the node's routes: it runs in a process of its own);
    the process-wide state each arm starts is stopped before the next."""
    t0 = time.perf_counter()
    before = _process_state()
    _stop_process_state()
    check(batch_engine.device_available(block=True),
          "operator: the device probe did not answer")
    res = {"card": info["smi"], "state_before": before}
    launches = {}
    tmp = tempfile.mkdtemp(prefix="operator-")
    try:
        a, files = _operator_run(tmp)
        res["a"] = a
        r = a["rounds"]
        print(f"[operator] (a) config 1 through `python -m stellar_tpu_torch "
              f"run`: up {a['up_s']:.3f} s (genesis and signing "
              f"{a['setup_s']:.3f} s); " + "; ".join(
                  f"{x['label']}: {x['trips']['n']} submissions p50 "
                  f"{x['trips']['p50_ms']:.3f} ms, p99 "
                  f"{x['trips']['p99_ms']:.3f} ms, close "
                  f"{x['close_ms']:.3f} ms" for x in r)
              + f"; applied {a['applied']}; to checkpoint 63 "
              f"{a['to_checkpoint_s']:.3f} s; served by the card "
              f"{a['served']}; routes {a['routes']}; pipeline parts of "
              f"all kernels together {a['pipeline'].get('parts')}; accounts the reference's; "
              f"exit {a['exit_code']} on SIGINT")
        b, launches_b = _operator_cli(tmp, files, a["ledger63"])
        res["b"] = b
        launches.update({f"cli_{k}": v for k, v in launches_b.items()})
        print(f"[operator] (b) the CLI on (a)'s files: self-check "
              f"{b['self_check']}; publish {b['publish']}; catchup "
              f"63/complete {b['catchup']['seconds']:.3f} s, hash "
              f"{b['catchup']['hash']} (ledger 63's), oracle 0, launches "
              f"{launches_b['catchup']}; apply-load {b['apply_load']}, "
              f"launches {launches_b['apply_load']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c = _operator_tcp()
    res["c"] = c
    launches["tcp"] = c["launches"]
    launches["tcp_tamper"] = c["tamper"]["launches"]
    _arm_line("operator (c) config 4 over TCP", c)
    print(f"[operator] (c) transport {c['transport_s']:.3f} s, "
          f"{c['transport_share']:.2%} of the wall (poll {c['poll_s']:.3f} "
          f"s, frames handled {c['receive_s']:.3f} s, sends "
          f"{c['send_s']:.3f} s); K1 rows {c['cold_rows']}; lanes "
          f"{c['lanes']}; routes {c['routes']}; tampered envelope "
          f"{c['tamper']}")
    check_dispatch_clean([default_verifier(), default_hasher()], "operator")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"[operator] phase {res['seconds']:.1f} s; card {info['smi']}")
    return res, launches


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


# the kernels line's name of each arm's launch counts: phase 23's (a)
# cold passes, (b) hot ones, the build apart, (c), (d), (e)'s catchup and
# (e)'s three ledger-128 tx sets and closes; phase 24's (a) config 4 on
# the service, (b) on the trickle, (c) the flood, (d) the tampered
# envelope and cert; phase 25's (a) config 5, (b) the compiled counter,
# (c) the tampered auth entry
CHAIN_COUNTS = {"cold": "launches_catchup", "hot": "launches_catchup_hot",
                "build": "launches_catchup_build",
                "skip": "launches_catchup_skip",
                "minimal": "launches_catchup_minimal",
                "persist": "launches_catchup_persist",
                "next": "launches_catchup_next"}
NET_COUNTS = {"a": "launches_net_service", "b": "launches_net_trickle",
              "c": "launches_net_flood", "d": "launches_net_tamper"}
SOROBAN_COUNTS = {"a": "launches_soroban", "b": "launches_soroban_wasm",
                  "c": "launches_soroban_tamper"}
# phase 27's in-process arms: (b)'s offline commands, catchup and
# apply-load, (c) config 4 over TCP and its tampered envelope; (a) runs in
# the node's own process, so its rows come from the node's ``dispatch``
# route (``rows_operator_run``); its ``pipeline`` parts, the launches of
# every kernel together, are printed in (a)'s line
OPERATOR_COUNTS = {"cli_offline": "launches_operator_offline",
                   "cli_catchup": "launches_operator_catchup",
                   "cli_apply_load": "launches_operator_apply_load",
                   "tcp": "launches_operator_tcp",
                   "tcp_tamper": "launches_operator_tcp_tamper"}


def _arm_counts(launches, kernel, names):
    """One kernel's counts in each arm of a phase (``launches`` by arm),
    under the arm's name in ``names``, for the kernels line."""
    return {names[k]: v[kernel] for k, v in launches.items()}


def _arm_device_ms(res, kernel, arms, key):
    """One kernel's device time in each of ``arms`` of a phase's result
    ``res`` (each arm's timed window): launches, rows and ms summed from
    CUDA events around each launch, under ``key``."""
    return {key: {
        arm: res[arm]["kernels"]["by_kernel"].get(
            kernel, {"launches": 0, "rows": 0, "ms": 0.0})
        for arm in arms}}


REPO = os.path.dirname(os.path.abspath(__file__))
ANALYSIS_LIMIT_S = 180
COST_ROWS_FILE = os.path.join(REPO, "build", "chip_smoke_cost_rows.npz")


def _tool(args, label, timeout, env_prefix=()):
    """``python -m stellar_tpu_torch.tools.<...>`` from the repository
    root: (exit code, stdout, stderr, seconds)."""
    t = time.perf_counter()
    proc = subprocess.run(list(env_prefix) + [sys.executable, "-m"] + args,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    secs = time.perf_counter() - t
    print(f"[analysis] {label}: exit {proc.returncode} in {secs:.1f} s")
    return proc.returncode, proc.stdout, proc.stderr, secs


def phase_analysis(info):
    """Phase 28: the analysis gate, the cost tool and the device probe on
    the card's machine."""
    t0 = time.perf_counter()
    out = {}
    # (a) the whole gate, every stage of the interval prover included
    rc, so, se, secs = _tool(["stellar_tpu_torch.tools.analyze", "--json"],
                             "analyze --json", 600)
    check(rc == 0, f"analyze exited {rc}: {so[-2000:]} {se[-2000:]}")
    rep = _last_json(so)
    check(rep["ok"], "analyze reports a failure")
    for name, lint in rep["lints"].items():
        check(lint["ok"] and not lint["findings"] and
              not lint["stale_allowlist"], f"lint {name} is not clean")
    cov = rep["proof_coverage"]
    check(cov["ok"] and cov["proven"] == 3, f"proof coverage: {cov}")
    hashes = {}
    for key, load in (("overflow", overflow.load_golden),
                      ("overflow_sha256", overflow.load_sha_golden)):
        rec = rep[key]
        want = overflow.envelope_sha256(load(REPO))
        check(rec["ok"] and not rec["violations"] and
              not rec["unsupported"] and rec["golden"] == "match",
              f"{key}: {rec}")
        check(rec["envelope_sha256"] == want, f"{key}: envelope "
              f"{rec['envelope_sha256']} is not the golden's {want}")
        hashes[key] = want
    golden = overflow.load_golden(REPO)
    check(set(golden["stages"]) == set(overflow.STAGES),
          f"the golden's stages are {sorted(golden['stages'])}")
    print(f"[analysis] (a) every lint and the coverage gate clean, "
          f"{len(overflow.STAGES)} stages and K3 proven, envelopes equal "
          f"to the goldens ({hashes['overflow'][:16]}, "
          f"{hashes['overflow_sha256'][:16]}) in {secs:.1f} s")
    out["analyze_s"] = secs
    out["envelope_sha256"] = hashes
    # (b) the cost tool on the card's figures and the phases' rows
    kinds = collections.Counter(r["kernel"] for r in COST_RECORDS)
    check(set(kinds) == {"verify_cold", "verify_hot", "verify_r16",
                         "sha256"}, f"the kernel phases noted {kinds}")
    kernel_cost.save_rows(COST_ROWS_FILE, COST_RECORDS)
    rc, so, se, secs = _tool(
        ["stellar_tpu_torch.tools.kernel_cost", "--json",
         f"--sms={info['sms']}", f"--clock-hz={info['clock_hz']!r}",
         f"--rows={COST_ROWS_FILE}"], "kernel_cost --json", 600)
    check(rc == 0, f"kernel_cost exited {rc}: {se[-2000:]}")
    cost = _last_json(so)
    check(len(cost["rows"]) == len(COST_RECORDS), "kernel_cost returned "
          f"{len(cost['rows'])} rows for {len(COST_RECORDS)}")
    for got, want in zip(cost["rows"], COST_RECORDS):
        keys = [k for k in ("multiply_adds", "executed_multiply_adds",
                            "operations", "bound_ms", "bound_by")
                if k in want]
        check({k: got[k] for k in keys} == {k: want[k] for k in keys},
              f"kernel_cost on {want['kernel']} {want['label']}: "
              f"{ {k: got.get(k) for k in keys} } against the phase's "
              f"{ {k: want[k] for k in keys} }")
    plain = cost["plain"]
    print(f"[analysis] (b) {len(COST_RECORDS)} rows of K1, K2, K3 and K5 "
          f"({dict(kinds)}): multiply-adds, executed counts and bounds "
          f"equal to the kernel phases'; the plain versions at batch "
          f"{plain['batch']}: dsm {plain['dsm']['executed_macs_per_call']} "
          f"multiply elements, hot {plain['dsm']['hot']['executed_macs_per_call']}"
          f" ({plain['signer_table']['hot_savings_frac']:.2%} less), "
          f"batch_inv {plain['affine_table']['batch_inv_weighted_mul_elems']}"
          f"; {secs:.1f} s")
    out["kernel_cost_s"] = secs
    out["rows_checked"] = len(COST_RECORDS)
    # (c) the probe, with the card and with none visible
    log = os.path.join(REPO, "build", "torch_device_probes.jsonl")
    before = 0
    if os.path.exists(log):
        with open(log) as f:
            before = len(f.readlines())
    rc, so, se, secs = _tool(["stellar_tpu_torch.tools.device_probe",
                              "120"], "device_probe", 300)
    rec = _last_json(so)
    check(rc == 0 and rec["ok"], f"the probe failed with the card: {rec}")
    check(rec["platform"] == "cuda" and rec["devices"] and
          rec["devices"][0]["device"] == "cuda:0" and
          rec["devices"][0]["ok"], f"the probe's cuda:0: {rec}")
    with open(log) as f:
        lines = f.readlines()
    check(len(lines) == before + 1 and json.loads(lines[-1]) == rec,
          "the probe did not append its line")
    rc2, so2, _se2, secs2 = _tool(
        ["stellar_tpu_torch.tools.device_probe", "120"],
        "device_probe with no card visible", 300,
        env_prefix=("env", "CUDA_VISIBLE_DEVICES="))
    rec2 = _last_json(so2)
    check(rc2 != 0 and not rec2["ok"] and rec2["devices"] == [] and
          rec2["platform"] is None, f"with no card visible the probe "
          f"exited {rc2}: {rec2}")
    print(f"[analysis] (c) probe: cuda:0 ok in "
          f"{rec['devices'][0]['probe_s']} s ({rec['card']}), the line "
          f"appended; with CUDA_VISIBLE_DEVICES= no card recorded, exit "
          f"{rc2}")
    out["probe"] = {"card": rec, "no_card": rec2, "exit_no_card": rc2,
                    "s": [secs, secs2]}
    total = time.perf_counter() - t0
    print(f"[analysis] (d) phase 28 in {total:.1f} s (limit "
          f"{ANALYSIS_LIMIT_S} s); {info['smi']}")
    check(total < ANALYSIS_LIMIT_S, f"phase 28 took {total:.1f} s")
    out["phase_s"] = total
    return out


class _BenchRecord(_ArmRecord):
    """What phase 29 (a) saw: ``_ArmRecord``'s kernel events and counted
    host oracle, every ``BatchVerifier.verify_batch`` call's triples with
    their verdicts, and, through ``simulation.load_generator``'s own names
    (``run_all`` imports them from there when it runs), every harness
    call's keyword arguments, record, wall, K1/K2/K3 launches and kernel
    time, with its closes' header hashes from the harness's
    ``LedgerManager``."""

    HARNESSES = ("apply_load", "multisig_apply_load", "catchup_replay_bench",
                 "scp_storm_bench", "soroban_apply_load",
                 "soroban_compute_load")

    def __init__(self):
        super().__init__()
        self.runs = []
        self._hashes = None

    def _harness(self, name):
        def wrap(fn):
            def run(**kwargs):
                self._hashes = []
                c0 = _counts()
                self.start_window()
                t = time.perf_counter()
                out = fn(**kwargs)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                c1 = _counts()
                self.runs.append({
                    "harness": name, "kwargs": kwargs, "record": dict(out),
                    "wall_s": wall_s,
                    "launches": {k: c1[k] - c0[k] for k in c1},
                    "kernels": self.kernel_time(wall_s),
                    "hashes": self._hashes})
                self._hashes = None
                return out
            return run
        return wrap

    def _verify_batch(self, fn):
        def verify_batch(v, items, trace_ids=None):
            out = fn(v, items, trace_ids=trace_ids)
            with self._lock:
                self.triples.update(zip(
                    (tuple(bytes(x) for x in it) for it in items),
                    map(bool, out)))
            return out
        return verify_batch

    def _manager(self, cls):
        rec = self

        class RecordingManager(cls):
            def close_ledger(self, lcd):
                res = super().close_ledger(lcd)
                if rec._hashes is not None:
                    rec._hashes.append(res.header_hash.hex())
                return res
        return RecordingManager

    def wrapped(self):
        return _Wrapped(
            *((load_generator, name, self._harness(name))
              for name in self.HARNESSES),
            (load_generator, "LedgerManager", self._manager),
            (BatchVerifier, "verify_batch", self._verify_batch),
            (verify_service.VerifyService, "verify", self._service),
            (TrickleBatcher, "verify_sig", self._trickle),
            (overlay_manager, "_preverify_into_cache", self._preverify),
            (_build, "launch", self._launch),
            (keys, "_ref", lambda module: self.oracle))


BENCH_TIMING = ("_ms", "_per_sec", "over_p50", "wall_s")
# run_all's scenario names, by the harness that fills them
BENCH_SCENARIOS = {"close": "apply_load", "multisig": "multisig_apply_load",
                   "catchup": "catchup_replay_bench",
                   "scp_storm": "scp_storm_bench",
                   "soroban": "soroban_apply_load",
                   "soroban_wasm": "soroban_apply_load",
                   "soroban_compute_scval": "soroban_compute_load",
                   "soroban_compute_wasm": "soroban_compute_load"}


def _tools_bench(info):
    """(a): ``run_benchmarks.run_all(quick=False, verify="device")``, the
    reference's five scenarios and the compute A/B at full scale with the
    signer-table cache on (empty) and the verify cache flushed."""
    check(not any(_process_state().values()),
          f"tools (a): process-wide state running {_process_state()}")
    keys.flush_verify_cache()
    signer_table_cache._reset_for_testing()
    rec = _BenchRecord()
    _zero_counts()
    t = time.perf_counter()
    try:
        with rec.wrapped():
            results = run_benchmarks.run_all(quick=False, verify="device")
        launches = _counts()
        backend = keys.get_verifier_backend_name()
    finally:
        _stop_process_state()
    wall_s = time.perf_counter() - t
    check(launches == _sum_counts(rec.runs), f"tools (a): launches "
          f"{launches} over run_all, the harness calls' sum "
          f"{_sum_counts(rec.runs)}")
    check(backend == "device-batch" and all(
        r["verify_backend"] == "device-batch" for r in results.values()),
        f"tools (a): verify backends "
        f"{ {k: r['verify_backend'] for k, r in results.items()} }")
    check(rec.oracle.calls == 0, f"tools (a): the host oracle decided "
          f"{rec.oracle.calls} signatures")
    check_dispatch_clean([default_verifier(), default_hasher()], "tools (a)")
    check(set(results) == set(BENCH_SCENARIOS), f"tools (a): scenarios "
          f"{sorted(results)}")
    for name, want in BENCH_APPLIED.items():
        check(results[name]["total_applied"] == want, f"tools (a): {name} "
              f"applied {results[name]['total_applied']}, not {want}")
    s = results["scp_storm"]
    check(s["rounds"] == BENCH_SCP_ROUNDS and s["total_statements"] > 0,
          f"tools (a): scp storm {s}")
    # each scenario's own run: the one call of configs 1-4, the best run
    # of each A/B side (run_all keeps that run's record)
    runs = {}
    for name, harness in BENCH_SCENARIOS.items():
        mine = [r for r in rec.runs if r["harness"] == harness and
                r["record"].get("engine") == results[name].get("engine")]
        best = [r for r in mine if r["record"] == {
            k: v for k, v in results[name].items()
            if k not in ("ab_runs", "ab_method", "verify_backend")}]
        check(len(best) >= 1, f"tools (a): no run of {harness} gave "
              f"{name}'s record")
        runs[name] = dict(best[0], runs=len(mine),
                          launches_all_runs=_sum_counts(mine))
    for name, (last_hash, fields) in BENCH_PINS.items():
        r = runs[name]
        got = {k: v for k, v in r["record"].items()
               if not any(t_ in k for t_ in BENCH_TIMING)}
        check(r["hashes"] and r["hashes"][-1] == last_hash and
              got == fields, f"tools (a): {name}: last header hash "
              f"{r['hashes'][-1:]} and fields {got}, not the reference's")
    for name in ("multisig", "catchup", "scp_storm"):
        ln = runs[name]["launches"]
        check(ln["verify_cold"] > 0 and ln["verify_hot"] > 0,
              f"tools (a): {name} launched K1 and K2 {ln}")
    # every verdict decided again by the native host oracle (the audit's;
    # ``ref.verify`` in Python takes about 3 ms a triple on that host)
    t = time.perf_counter()
    triples = list(rec.triples)
    host = native_verify.host_verify(triples)
    bad = [x for x, h in zip(triples, host) if bool(h) != rec.triples[x]]
    recheck_s = time.perf_counter() - t
    check(triples and not bad, f"tools (a): the host oracle disagrees "
          f"with {len(bad)} of {len(triples)} verdicts")
    for name, r in runs.items():
        k = r["kernels"]
        print(f"[tools] (a) {name}: {json.dumps(results[name], sort_keys=True)}"
              f"; wall {r['wall_s']:.3f} s (best of {r['runs']} runs); "
              f"launches {r['launches']} ({r['launches_all_runs']} over "
              f"its {r['runs']} runs); the kernels (CUDA events around "
              f"each launch) {k['ms']:.3f} ms, {k['share_of_wall']:.4%} of "
              f"the wall, by kernel "
              f"{ {n: round(v['ms'], 3) for n, v in k['by_kernel'].items()} }"
              f"; card {info['smi']}")
    calls = [(r["harness"], r["kwargs"].get("use_wasm"),
              round(r["wall_s"], 3), r["launches"]) for r in rec.runs]
    print(f"[tools] (a) every harness call in order (harness, use_wasm, "
          f"wall s, launches): {calls}")
    print(f"[tools] (a) run_all in {wall_s:.1f} s, {len(rec.runs)} harness "
          f"calls; every row's verify_backend device-batch; the host oracle "
          f"decided nothing; the native oracle ({native_verify.backend()}) "
          f"re-decided {len(triples)} triples in {recheck_s:.1f} s, all "
          f"agree; pins of configs 1-3 the reference's; launches in all "
          f"{launches}")
    return {"results": results, "wall_s": wall_s,
            "runs": {n: {k: r[k] for k in ("wall_s", "launches", "kernels",
                                           "runs", "launches_all_runs")}
                     for n, r in runs.items()},
            "calls": calls, "triples": len(triples),
            "oracle_recheck_s": recheck_s}, launches


def _kernel_of(op):
    """The port's kernel a traced device op is, by its name, or None."""
    for name in ("verify_cold", "verify_hot", "sha256"):
        if f"{name}_kernel" in op:
            return name
    return None


def _profiled(label, fn, bucket_ms, info):
    """``trace_kernel_time.capture`` of ``fn``: the traced K1/K2/K3 counts
    equal to the launch counters' over the traced calls, each kernel's
    mean traced time a launch at most ``PROFILE_SLACK`` x its CUDA-event
    time ``bucket_ms`` (kernel -> ms) where given, device busy ms a call
    and the idle share over the capture's own wall."""
    calls = []

    def counted():
        c0 = _counts()
        fn()
        c1 = _counts()
        calls.append({k: c1[k] - c0[k] for k in c1})
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{label}.json")
    try:
        rec = trace_kernel_time.capture(counted, PROFILE_ITERS, path)
    except trace_kernel_time.NoDeviceEvents as e:
        raise PhaseFailed(f"tools (b) {label}: {e}")
    events = trace_kernel_time.load_events(path)
    dev = [ev for ev in events if trace_kernel_time.is_device_event(ev)]
    traced = collections.Counter()
    traced_us = collections.defaultdict(float)
    for ev in dev:
        k = _kernel_of(ev["name"])
        if k is not None:
            traced[k] += 1
            traced_us[k] += float(ev["dur"])
    launched = {k: sum(c[k] for c in calls[-PROFILE_ITERS:])
                for k in calls[0]}
    check(all(traced[k] == n for k, n in launched.items()),
          f"tools (b) {label}: traced kernels {dict(traced)}, launched "
          f"{launched}")
    per_launch = {k: traced_us[k] / 1e3 / traced[k] for k in traced}
    for k, want in bucket_ms.items():
        check(k in per_launch and per_launch[k] <= want * PROFILE_SLACK,
              f"tools (b) {label}: {k} {per_launch.get(k)} ms a launch "
              f"traced against {want} ms by CUDA events")
    busy, wall = rec["device_busy_ms_per_iter"], rec["wall_ms_per_iter"]
    out = {"device_busy_ms_per_call": busy, "wall_ms_per_call": wall,
           "idle_share": 1 - busy / wall, "launched": launched,
           "kernel_ms_per_launch": per_launch,
           "against_events_ms": bucket_ms,
           "top_device_ops": rec["top_device_ops"],
           "processes": rec["processes"], "trace": os.path.relpath(path, REPO)}
    print(f"[tools] (b) {label}: device busy {busy} ms a call, wall "
          f"{wall:.3f} ms, idle share {out['idle_share']:.4%}; traced "
          f"{dict(traced)} = launched {launched}; kernel ms a launch "
          f"traced { {k: round(v, 4) for k, v in per_launch.items()} } "
          f"against CUDA events {bucket_ms}; top device ops "
          f"{rec['top_device_ops']}; card {info['smi']}")
    return out, dev, events


def _trace_fields(dev, events):
    """What the trace holds, for the record: the process names, a device
    event's keys and categories."""
    procs = sorted({e.get("args", {}).get("name", "") for e in events
                    if e.get("ph") == "M" and e.get("name") == "process_name"})
    return {"processes": procs, "device_event_keys": sorted(dev[0]),
            "device_cats": sorted({e["cat"] for e in dev}),
            "device_args": sorted(dev[0].get("args", {})),
            "host_cats": sorted({e.get("cat", "") for e in events
                                 if e.get("ph") == "X" and not
                                 trace_kernel_time.is_device_event(e)})}


def _tools_profile(info, txset_items, txset_want, bucket_ms):
    """(b): the cold TxSet of phase 4 (cache off), the hot TxSet of phase 7
    (cache on, its tables built by the untimed call) and one config-2
    ledger (``multisig_apply_load(1, 1000)``, the verify cache flushed a
    call, the card behind ``verify_sig``), each traced by
    ``torch.profiler``."""
    v = default_verifier()
    out = {}

    def txset():
        check(np.array_equal(v.verify_batch(txset_items), txset_want),
              "tools (b): a TxSet call differs from the oracle")
    signer_table_cache.configure(enabled=False)
    out["cold_txset"], dev, events = _profiled(
        "cold_txset", txset, {"verify_cold": bucket_ms["cold"]}, info)
    out["fields"] = _trace_fields(dev, events)
    print(f"[tools] (b) the trace's fields: {out['fields']}")
    signer_table_cache._reset_for_testing()
    signer_table_cache.configure(enabled=True)
    out["hot_txset"], _d, _e = _profiled(
        "hot_txset", txset, {"verify_hot": bucket_ms["hot"],
                             "verify_cold": bucket_ms["hot_cold"]}, info)

    def ledger():
        keys.flush_verify_cache()
        r = load_generator.multisig_apply_load(
            n_ledgers=1, txs_per_ledger=PROFILE_MULTISIG_TXS)
        check(r["total_applied"] == PROFILE_MULTISIG_TXS,
              f"tools (b): the config-2 ledger applied {r['total_applied']}")
    signer_table_cache._reset_for_testing()
    default_verifier().install()
    try:
        out["config2_ledger"], _d, _e = _profiled("config2_ledger", ledger,
                                                  {}, info)
    finally:
        keys.set_verifier_backend(None)
    check_dispatch_clean([default_verifier(), default_hasher()], "tools (b)")
    return out


def _tools_export(info):
    """(c): the exporter's synthetic resolve on the card and its fleet
    window, each from an empty recorder and pipeline ring; each trace loads
    as JSON with spans, instants and counter samples."""
    out = {}
    for name, make in (("synthetic", trace_export.synthetic_trace),
                       ("fleet", trace_export.synthetic_fleet_trace)):
        # each export as the tool's own process gives it: the recorder
        # and the pipeline's ring hold its records alone
        tracing.flight_recorder.clear()
        pipeline_timeline._reset_for_testing()
        t = time.perf_counter()
        trace = json.loads(json.dumps(make()))
        counts = trace_export.event_counts(trace)
        check(counts["spans"] > 0 and counts["instants"] > 0 and
              counts["counters"] > 0, f"tools (c) {name}: {counts}")
        out[name] = dict(counts, s=time.perf_counter() - t)
        print(f"[tools] (c) trace_export {name}: {counts['events']} events "
              f"({counts['spans']} spans, {counts['instants']} instants, "
              f"{counts['counters']} counter samples) in {out[name]['s']:.3f}"
              f" s; card {info['smi']}")
    check_dispatch_clean([default_verifier()], "tools (c)")
    return out


def phase_tools(info, txset_items, txset_want, bucket_ms):
    """Phase 29: the tools on the card. (a) ``run_benchmarks.run_all`` at
    full scale, (b) ``trace_kernel_time`` over ``torch.profiler`` traces
    of the cold and hot TxSets and one config-2 ledger, (c)
    ``trace_export``'s two local modes. K1's, K2's and K3's counts over
    each harness call of (a) are read around it."""
    t0 = time.perf_counter()
    res = {"card": info["smi"]}
    res["a"], launches = _tools_bench(info)
    res["b"] = _tools_profile(info, txset_items, txset_want, bucket_ms)
    res["c"] = _tools_export(info)
    res["seconds"] = time.perf_counter() - t0
    print(f"[tools] phase 29 in {res['seconds']:.1f} s; card {info['smi']}")
    return res, launches


# phase 30: the self-checks in order, and the limit on the phase's seconds
SELFCHECKS = (("metrics", metrics_selfcheck), ("transfer", transfer_selfcheck),
              ("pipeline", pipeline_selfcheck),
              ("hot_signer", hot_signer_selfcheck)) \
    if _IMPORT_ERROR is None else ()
SELFCHECK_LIMIT_S = 120.0
# phase 30 (e): K1-only 64-row calls read for the attribution floor
FLOOR_CALLS = 40


def attribution_floor():
    """Phase 30 (e): ``FLOOR_CALLS`` K1-only calls of the metrics check's
    64 rows from its 8 signers, the signer-table cache off for them, each
    on a fresh verifier: their coverage of the blocking root (min,
    median, the count under the check's 0.95) and the root's ms. Printed,
    not gated: such a call leaves more than 5% of its root outside every
    phase span (ROADMAP queue 3), where the metrics check's own call,
    with its 8 first sights' table builds in ``prep``, passes."""
    pool = metrics_selfcheck.signer_pool()
    items = [pool[i % len(pool)] for i in range(metrics_selfcheck.N_SIGS)]
    enabled = signer_table_cache.enabled
    signer_table_cache.configure(enabled=False)
    covs, roots = [], []
    try:
        for _ in range(FLOOR_CALLS):
            v = BatchVerifier(bucket_sizes=(metrics_selfcheck.N_SIGS,))
            before = tracing.span_totals()
            check(bool(v.verify_batch(items).all()),
                  "attribution floor: a verdict broke")
            att = batch_engine.dispatch_attribution(
                before, tracing.span_totals())
            covs.append(att["coverage"])
            roots.append(att["blocking_span_per_rep_ms"])
    finally:
        signer_table_cache.configure(enabled=enabled)
    return {"calls": FLOOR_CALLS, "coverage_min": min(covs),
            "coverage_median": float(np.median(covs)),
            "under_gate": sum(c < metrics_selfcheck.MIN_COVERAGE
                              for c in covs),
            "root_ms_median": float(np.median(roots))}


def phase_selfchecks(info):
    """Phase 30: the four self-checks of the engine on the card, each
    tool's ``run()`` in this process with its defaults (the card; the
    hot signer at ``N_SIGNERS``). Each record is printed on a line of its
    own and must be ``ok`` and on the card; K1's, K2's and K3's counts are
    set to 0 before the phase and read after each tool, and each tool
    must have launched its kernels: the metrics resolve one K1 launch
    for its 8 first sights and one K2 for their 56 repeats, the transfer
    and pipeline checks K3, the hot signer K1 and K2. The engines of the
    metrics and hot-signer checks, which arm no fault, must end clean."""
    t0 = time.perf_counter()
    _zero_counts()
    res = {"card": info["smi"], "tools": {}}
    records = {}
    clean_engines = []
    prev = _counts()
    for name, tool in SELFCHECKS:
        t = time.perf_counter()
        if name in ("metrics", "hot_signer"):
            rec = tool.run(engines=clean_engines)
        else:
            rec = tool.run()
        records[name] = rec
        counts = _counts()
        seconds = time.perf_counter() - t
        res["tools"][name] = {"seconds": seconds, "launches": {
            k: counts[k] - prev[k] for k in counts}}
        prev = counts
        print(f"[selfcheck] {name} ({seconds:.1f} s, launches "
              f"{res['tools'][name]['launches']}): "
              + json.dumps(rec, default=str))
        check(rec["ok"], f"selfcheck {name}: {rec['problems']}")
        check(rec["device"] == "cuda:0",
              f"selfcheck {name} ran on {rec['device']}")
    want = {"metrics": lambda n: n["verify_cold"] == 1 and
            n["verify_hot"] == 1,
            "transfer": lambda n: n["sha256"] > 0,
            "pipeline": lambda n: n["sha256"] > 0,
            "hot_signer": lambda n: n["verify_cold"] > 0 and
            n["verify_hot"] > 0}
    for name, ok in want.items():
        check(ok(res["tools"][name]["launches"]),
              f"selfcheck {name} launched "
              f"{res['tools'][name]['launches']}")
    check_dispatch_clean(clean_engines, "selfchecks (metrics, hot signer)")
    hot = records["hot_signer"]
    check(hot["distinct_signers"] == hot_signer_selfcheck.N_SIGNERS,
          f"selfcheck hot_signer at {hot['distinct_signers']} signers")
    launches = _counts()
    floor = res["floor"] = attribution_floor()
    print(f"[selfcheck] (e) attribution floor, not gated: {FLOOR_CALLS} "
          f"K1-only 64-row calls covered {floor['coverage_min']:.4f} at "
          f"least, {floor['coverage_median']:.4f} the median, "
          f"{floor['under_gate']} under {metrics_selfcheck.MIN_COVERAGE}; "
          f"root {floor['root_ms_median']:.3f} ms the median")
    res["seconds"] = time.perf_counter() - t0
    check(res["seconds"] < SELFCHECK_LIMIT_S,
          f"phase 30 took {res['seconds']:.1f} s (limit "
          f"{SELFCHECK_LIMIT_S:.0f})")
    print(f"[selfcheck] phase 30 in {res['seconds']:.1f} s, launches "
          f"{launches}; card {info['smi']}")
    return res, launches


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
    node, node_launches, node_traffic = phase_node(
        np.random.default_rng(NODE_SEED), info)
    node_txset, txset_launches = phase_node_txset(info, node_traffic)
    node_close, close_launches = phase_node_close(info, node_traffic)
    del node_traffic
    chain, chain_launches = phase_catchup_chain(info)
    net, net_launches = phase_node_network(info)
    soroban, soroban_launches = phase_soroban(info)
    fault_domains = phase_faults(split_v, txset_items, txset_want)
    operator, operator_launches = phase_operator(info)
    operator_rows = operator["a"]["rows"]
    analysis = phase_analysis(info)
    tools, tools_launches = phase_tools(
        info, txset_items, txset_want, {
            "cold": per_batch[str(KERNEL_BATCHES[0])]["ms"],
            "hot": hot_batch[str(KERNEL_BATCHES[0])]["ms"],
            "hot_cold": next(v["ms"] for k, v in per_batch.items()
                             if k.startswith("hot_txset:"))})
    selfchecks, sc_launches = phase_selfchecks(info)
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
                     launches_close_config1=close_launches["config1"][
                         "verify_cold"],
                     launches_close=close_launches["cold"]["verify_cold"],
                     launches_close_hot=close_launches["hot"]["verify_cold"],
                     **_arm_counts(chain_launches, "verify_cold",
                                   CHAIN_COUNTS),
                     **_arm_counts(net_launches, "verify_cold", NET_COUNTS),
                     **_arm_device_ms(net, "verify_cold", ("a", "b", "c"),
                                      "net_device_ms"),
                     **_arm_counts(soroban_launches, "verify_cold",
                                   SOROBAN_COUNTS),
                     **_arm_device_ms(soroban, "verify_cold", ("a", "b"),
                                      "soroban_device_ms"),
                     **_arm_counts(operator_launches, "verify_cold",
                                   OPERATOR_COUNTS),
                     **_arm_device_ms(operator, "verify_cold", ("c",),
                                      "operator_device_ms"),
                     rows_operator_run=operator_rows["verify_cold"],
                     launches_tools=tools_launches["verify_cold"],
                     tools_launches_by_scenario={
                         n: r["launches_all_runs"]["verify_cold"]
                         for n, r in tools["a"]["runs"].items()},
                     launches_selfchecks=sc_launches["verify_cold"],
                     selfchecks_launches_by_tool={
                         n: r["launches"]["verify_cold"]
                         for n, r in selfchecks["tools"].items()},
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
                     launches_close=close_launches["hot"]["verify_hot"],
                     **_arm_counts(chain_launches, "verify_hot",
                                   CHAIN_COUNTS),
                     **_arm_counts(net_launches, "verify_hot", NET_COUNTS),
                     **_arm_device_ms(net, "verify_hot", ("a", "b", "c"),
                                      "net_device_ms"),
                     **_arm_counts(soroban_launches, "verify_hot",
                                   SOROBAN_COUNTS),
                     **_arm_device_ms(soroban, "verify_hot", ("a", "b"),
                                      "soroban_device_ms"),
                     **_arm_counts(operator_launches, "verify_hot",
                                   OPERATOR_COUNTS),
                     **_arm_device_ms(operator, "verify_hot", ("c",),
                                      "operator_device_ms"),
                     rows_operator_run=operator_rows["verify_hot"],
                     launches_tools=tools_launches["verify_hot"],
                     tools_launches_by_scenario={
                         n: r["launches_all_runs"]["verify_hot"]
                         for n, r in tools["a"]["runs"].items()},
                     launches_selfchecks=sc_launches["verify_hot"],
                     selfchecks_launches_by_tool={
                         n: r["launches"]["verify_hot"]
                         for n, r in selfchecks["tools"].items()},
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
                     launches_close=close_launches["cold"]["sha256"],
                     launches_close_hot=close_launches["hot"]["sha256"],
                     **_arm_counts(chain_launches, "sha256",
                                   CHAIN_COUNTS),
                     **_arm_counts(net_launches, "sha256", NET_COUNTS),
                     **_arm_device_ms(net, "sha256", ("a", "b", "c"),
                                      "net_device_ms"),
                     **_arm_counts(soroban_launches, "sha256",
                                   SOROBAN_COUNTS),
                     **_arm_device_ms(soroban, "sha256", ("a", "b"),
                                      "soroban_device_ms"),
                     **_arm_counts(operator_launches, "sha256",
                                   OPERATOR_COUNTS),
                     **_arm_device_ms(operator, "sha256", ("c",),
                                      "operator_device_ms"),
                     rows_operator_run=operator_rows["sha256"],
                     launches_tools=tools_launches["sha256"],
                     tools_launches_by_scenario={
                         n: r["launches_all_runs"]["sha256"]
                         for n, r in tools["a"]["runs"].items()},
                     launches_selfchecks=sc_launches["sha256"],
                     selfchecks_launches_by_tool={
                         n: r["launches"]["sha256"]
                         for n, r in selfchecks["tools"].items()},
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
        "node_close": node_close, "catchup_chain": chain,
        "node_network": net, "soroban": soroban,
        "fault_domains": fault_domains, "operator": operator,
        "analysis": analysis, "tools": tools, "selfchecks": selfchecks,
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
