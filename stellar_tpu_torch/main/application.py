"""Application: the hub owning every subsystem of one node (reference
``src/main/Application.h:133`` / ``ApplicationImpl.cpp`` — here the
single-threaded crank loop IS the architecture: all consensus work runs
as clock actions, with the card's batch-crypto service as the device-side
coprocessor behind the verify cache)."""

from __future__ import annotations

from typing import List, Optional

from stellar_tpu_torch.herder.herder import Herder
from stellar_tpu_torch.history.history_manager import FileArchive, HistoryManager
from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxnRoot
from stellar_tpu_torch.main.config import Config
from stellar_tpu_torch.overlay.overlay_manager import OverlayManager
from stellar_tpu_torch.overlay.peer import PeerAuth
from stellar_tpu_torch.utils.timer import REAL_TIME, VIRTUAL_TIME, VirtualClock
from stellar_tpu_torch.work.work import WorkScheduler

__all__ = ["Application"]


class Application:
    def __init__(self, config: Config,
                 clock: Optional[VirtualClock] = None,
                 root: Optional[LedgerTxnRoot] = None):
        if config.NODE_SEED is None:
            from stellar_tpu_torch.crypto.keys import SecretKey
            config.NODE_SEED = SecretKey.random()
        self.config = config
        self.clock = clock if clock is not None else \
            VirtualClock(REAL_TIME)
        network_id = config.network_id()
        self._apply_global_config(config)
        self.database = None
        self.persistence = None
        self.lm = None
        if config.DATABASE:
            import os
            from stellar_tpu_torch.bucket.bucket_manager import BucketManager
            from stellar_tpu_torch.database import Database, NodePersistence
            self.database = Database(config.DATABASE)
            bucket_dir = config.BUCKET_DIR_PATH
            if bucket_dir is None and config.DATABASE != ":memory:":
                bucket_dir = os.path.join(
                    os.path.dirname(os.path.abspath(config.DATABASE)),
                    "buckets")
            self.persistence = NodePersistence(self.database,
                                               BucketManager(bucket_dir))
            # resume from the durable LCL when one exists
            self.lm = LedgerManager.from_persistence(network_id,
                                                     self.persistence)
        if self.persistence is not None and \
                config.MODE_USES_IN_MEMORY_LEDGER:
            # reference MODE_USES_IN_MEMORY_LEDGER: the DB stays for
            # misc storage but closes are not made durable
            self.persistence = None
            self.lm = None
        fresh = self.lm is None
        if fresh:
            self.lm = LedgerManager(
                network_id, root, persistence=self.persistence,
                # reference MODE_ENABLES_BUCKETLIST: off = flat state
                # hash, no bucket list maintenance
                bucket_list=(None if config.MODE_ENABLES_BUCKETLIST
                             else False))
            hdr = self.lm.last_closed_header
            hdr.maxTxSetSize = config.MAX_TX_SET_SIZE
            hdr.ledgerVersion = config.LEDGER_PROTOCOL_VERSION

        if config.QUORUM_SET is None and config.VALIDATORS:
            config.resolve_quorum()
        qset = config.QUORUM_SET
        if qset is None:
            from stellar_tpu_torch.scp.quorum import singleton_qset
            qset = singleton_qset(config.NODE_SEED.public_key.raw)
        self.herder = Herder(
            config.NODE_SEED, network_id, self.lm, self.clock, qset,
            is_validator=config.NODE_IS_VALIDATOR,
            target_close_seconds=config.EXPECTED_LEDGER_CLOSE_TIME,
            max_slots_to_remember=config.MAX_SLOTS_TO_REMEMBER,
            node_config=config)
        self._stage_testing_upgrades(config, fresh)
        self.peer_auth = PeerAuth(config.NODE_SEED, network_id,
                                  self.clock.system_now())
        self.overlay = OverlayManager(self)
        self.work_scheduler = WorkScheduler(self.clock)
        self.history: Optional[HistoryManager] = None
        if config.HISTORY_ARCHIVES:
            from stellar_tpu_torch.history.history_manager import (
                archive_from_config,
            )
            self.history = HistoryManager(
                [archive_from_config(p) for p in config.HISTORY_ARCHIVES],
                config.NETWORK_PASSPHRASE,
                store_headers=config.MODE_STORES_HISTORY_LEDGERHEADERS,
                store_misc=config.MODE_STORES_HISTORY_MISC,
                publish_delay_s=config.PUBLISH_TO_ARCHIVE_DELAY,
                clock=self.clock)
        # debug close-meta retention (reference METADATA_DEBUG_LEDGERS)
        self.debug_meta = None
        if config.METADATA_DEBUG_LEDGERS > 0:
            import collections
            self.debug_meta = collections.deque(
                maxlen=config.METADATA_DEBUG_LEDGERS)
            self.lm.close_meta_stream.append(self.debug_meta.append)
        # node-id strkey -> display name (reference VALIDATOR_NAMES,
        # merged with names declared on VALIDATORS entries)
        self.validator_names = dict(config.VALIDATOR_NAMES)
        for v in config.VALIDATORS:
            if v.get("PUBLIC_KEY") and v.get("NAME"):
                self.validator_names.setdefault(v["PUBLIC_KEY"],
                                                v["NAME"])
        from stellar_tpu_torch.process import ProcessManager
        self.process_manager = ProcessManager(
            max_concurrent=config.MAX_CONCURRENT_SUBPROCESSES)
        # ledger-side test/tuning knobs
        if config.TESTING_EVICTION_SCAN_SIZE > 0:
            self.lm.eviction_scanner.max_entries = \
                config.TESTING_EVICTION_SCAN_SIZE
        if config.OVERRIDE_EVICTION_PARAMS_FOR_TESTING:
            if not (0 <= config.TESTING_STARTING_EVICTION_SCAN_LEVEL
                    <= 10):
                raise ValueError(
                    "TESTING_STARTING_EVICTION_SCAN_LEVEL out of range")
            self.lm.eviction_scanner.max_archive_entries = \
                config.TESTING_MAX_ENTRIES_TO_ARCHIVE
            self.lm.eviction_scanner.start_level = \
                config.TESTING_STARTING_EVICTION_SCAN_LEVEL
        if config.TESTING_MINIMUM_PERSISTENT_ENTRY_LIFETIME > 0:
            import dataclasses as _dc
            self.lm.soroban_config = _dc.replace(
                self.lm.soroban_config,
                min_persistent_ttl=(
                    config.TESTING_MINIMUM_PERSISTENT_ENTRY_LIFETIME))
            self.lm.root.soroban_config = self.lm.soroban_config
        self.lm.close_delay_ms = \
            config.ARTIFICIALLY_DELAY_LEDGER_CLOSE_FOR_TESTING
        # reverse-delta snapshot retention powers point-in-time reads
        # on the query server and the admin getledgerentryraw route
        # (reference QUERY_SNAPSHOT_LEDGERS); only paid when some HTTP
        # surface can actually serve the reads
        if config.QUERY_SNAPSHOT_LEDGERS > 0 and \
                (config.HTTP_PORT or config.HTTP_QUERY_PORT):
            self.lm.snapshot_window = config.QUERY_SNAPSHOT_LEDGERS
        # process-wide knobs: push only non-default values (see
        # _apply_global_config's rationale)
        _d = Config()
        if config.OUTBOUND_TX_QUEUE_BYTE_LIMIT != \
                _d.OUTBOUND_TX_QUEUE_BYTE_LIMIT:
            from stellar_tpu_torch.overlay.tx_adverts import TxAdverts
            TxAdverts.queue_byte_limit = \
                config.OUTBOUND_TX_QUEUE_BYTE_LIMIT
        from stellar_tpu_torch.catchup import catchup as catchup_mod
        if config.ARTIFICIALLY_DELAY_BUCKET_APPLICATION_FOR_TESTING:
            catchup_mod.BUCKET_APPLY_DELAY_MS = \
                config.ARTIFICIALLY_DELAY_BUCKET_APPLICATION_FOR_TESTING
        if config.CATCHUP_WAIT_MERGES_TX_APPLY_FOR_TESTING:
            catchup_mod.WAIT_MERGES_ON_APPLY = True
        from stellar_tpu_torch.utils.status import StatusManager
        self.status_manager = StatusManager()
        self._meta_stream_file = None
        if config.METADATA_OUTPUT_STREAM:
            self._open_meta_stream(config.METADATA_OUTPUT_STREAM)
        self.herder.on_externalized = self._on_externalized
        self.herder.on_catchup_needed = self._start_catchup
        self._catchup_work = None
        self._last_catchup_at = None
        if self.database is not None:
            if not fresh:
                self._restore_scp_state()
            # upgrade votes restore even before the first close
            self._restore_scheduled_upgrades()
        if config.INVARIANT_CHECKS:
            from stellar_tpu_torch.invariant import (
                InvariantManager, set_active_manager,
            )
            set_active_manager(
                InvariantManager(config.INVARIANT_CHECKS))
        self._started = False

    def _apply_global_config(self, config: Config):
        """Push Config knobs into the process-wide services they tune
        (reference ApplicationImpl reading Config at construction).

        Only knobs that DIFFER from their defaults are pushed: these
        services are process-wide, and multi-node-in-one-process
        simulations must not have a later default-config node silently
        reset a tuned one. (Two nodes tuning the same global knob
        differently still last-writes — matching the reference, where
        one process is one node.)"""
        defaults = Config()

        def changed(name: str) -> bool:
            return getattr(config, name) != getattr(defaults, name)

        from stellar_tpu_torch.utils import workers
        if config.WORKER_THREADS > 0:
            import concurrent.futures
            with workers._lock:
                if workers._pool is None:
                    workers._pool = \
                        concurrent.futures.ThreadPoolExecutor(
                            max_workers=config.WORKER_THREADS,
                            thread_name_prefix="bg-work")
        if changed("BACKGROUND_BUCKET_MERGES") or \
                changed("ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING"):
            workers.set_background(
                config.BACKGROUND_BUCKET_MERGES and
                not config.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING)
        # dispatch resilience knobs: push before any verify path can
        # engage the device, so the first dispatch already runs under
        # the configured deadline/breaker policy. The reference hands
        # all of them to one ``configure_dispatch``; the port's takes
        # the six process-wide ones, and each other group goes to the
        # port's own owner of that state
        if changed("VERIFY_DONATE_BUFFERS"):
            # the port donates no operand buffer (ROADMAP.md,
            # divergences): a setting that asks for it is refused, never
            # dropped
            raise ValueError(
                "VERIFY_DONATE_BUFFERS has no counterpart in the port: "
                "it donates no operand buffer (divergence 'no "
                "donation')")
        if changed("VERIFY_DEVICE_DEADLINE_MS") or \
                changed("VERIFY_BREAKER_FAILURE_THRESHOLD") or \
                changed("VERIFY_BREAKER_BACKOFF_MIN_S") or \
                changed("VERIFY_BREAKER_BACKOFF_MAX_S") or \
                changed("VERIFY_DISPATCH_RETRIES") or \
                changed("VERIFY_AUDIT_RATE"):
            from stellar_tpu_torch.crypto import batch_verifier
            batch_verifier.configure_dispatch(
                deadline_ms=config.VERIFY_DEVICE_DEADLINE_MS,
                dispatch_retries=config.VERIFY_DISPATCH_RETRIES,
                failure_threshold=config.VERIFY_BREAKER_FAILURE_THRESHOLD,
                backoff_min_s=config.VERIFY_BREAKER_BACKOFF_MIN_S,
                backoff_max_s=config.VERIFY_BREAKER_BACKOFF_MAX_S,
                audit_rate=config.VERIFY_AUDIT_RATE)
        if changed("VERIFY_DEVICE_FAILURE_THRESHOLD") or \
                changed("VERIFY_DEVICE_BACKOFF_MIN_S") or \
                changed("VERIFY_DEVICE_BACKOFF_MAX_S"):
            # the per-device breakers are each engine's: the defaults
            # shape engines built later, ``configure`` those built already
            from stellar_tpu_torch.parallel import batch_engine, device_health
            device_health.DEFAULT_FAILURE_THRESHOLD = \
                config.VERIFY_DEVICE_FAILURE_THRESHOLD
            device_health.DEFAULT_BACKOFF_MIN_S = \
                config.VERIFY_DEVICE_BACKOFF_MIN_S
            device_health.DEFAULT_BACKOFF_MAX_S = \
                config.VERIFY_DEVICE_BACKOFF_MAX_S
            for _name, eng in batch_engine._default_engine_items():
                eng.health.configure(
                    failure_threshold=config.VERIFY_DEVICE_FAILURE_THRESHOLD,
                    backoff_min_s=config.VERIFY_DEVICE_BACKOFF_MIN_S,
                    backoff_max_s=config.VERIFY_DEVICE_BACKOFF_MAX_S)
        if changed("VERIFY_RESIDENT_CACHE_BYTES") or \
                changed("VERIFY_RESIDENT_MAX_ITEM_BYTES") or \
                changed("VERIFY_RESIDENT_CONSTANTS"):
            from stellar_tpu_torch.parallel import residency
            residency.resident_cache.configure(
                max_bytes=config.VERIFY_RESIDENT_CACHE_BYTES,
                max_item_bytes=config.VERIFY_RESIDENT_MAX_ITEM_BYTES,
                enabled=config.VERIFY_RESIDENT_CONSTANTS)
        if changed("VERIFY_SIGNER_TABLE_BYTES") or \
                changed("VERIFY_SIGNER_TABLE_ENABLED"):
            from stellar_tpu_torch.parallel import signer_tables
            signer_tables.signer_table_cache.configure(
                max_bytes=config.VERIFY_SIGNER_TABLE_BYTES,
                enabled=config.VERIFY_SIGNER_TABLE_ENABLED)
        # resident verify service knobs (docs/robustness.md "Overload
        # and load-shed") — pushed BEFORE the service could start, so
        # the first admitted submission already runs under the
        # configured budgets
        if changed("VERIFY_SERVICE_LANE_DEPTH") or \
                changed("VERIFY_SERVICE_LANE_BYTES") or \
                changed("VERIFY_SERVICE_MAX_BATCH") or \
                changed("VERIFY_SERVICE_PIPELINE_DEPTH") or \
                changed("VERIFY_SERVICE_AGING_EVERY"):
            from stellar_tpu_torch.crypto import verify_service
            verify_service.configure_service(
                lane_depth=config.VERIFY_SERVICE_LANE_DEPTH,
                lane_bytes=config.VERIFY_SERVICE_LANE_BYTES,
                max_batch=config.VERIFY_SERVICE_MAX_BATCH,
                pipeline_depth=config.VERIFY_SERVICE_PIPELINE_DEPTH,
                aging_every=config.VERIFY_SERVICE_AGING_EVERY)
        if changed("VERIFY_TENANT_DEPTH") or \
                changed("VERIFY_TENANT_BYTES") or \
                changed("VERIFY_TENANT_TOPK") or \
                changed("VERIFY_TENANT_TRACK_CAP") or \
                changed("VERIFY_TENANT_P99_MS") or \
                changed("VERIFY_TENANT_SHED_BUDGET") or \
                changed("VERIFY_TENANT_SLO_WINDOW") or \
                changed("VERIFY_TENANT_FROM_PEER"):
            from stellar_tpu_torch.crypto import tenant
            tenant.configure_tenants(
                depth=config.VERIFY_TENANT_DEPTH,
                nbytes=config.VERIFY_TENANT_BYTES,
                topk=config.VERIFY_TENANT_TOPK,
                track_cap=config.VERIFY_TENANT_TRACK_CAP,
                p99_ms=config.VERIFY_TENANT_P99_MS,
                shed_budget=config.VERIFY_TENANT_SHED_BUDGET,
                window=config.VERIFY_TENANT_SLO_WINDOW,
                from_peer=config.VERIFY_TENANT_FROM_PEER)
        # closed-loop control knobs (docs/robustness.md "Closed-loop
        # control") — pushed BEFORE the service could start, so an
        # auto-attached controller is born with the configured clamps
        if changed("VERIFY_CONTROL_ENABLED") or \
                changed("VERIFY_CONTROL_EVERY") or \
                changed("VERIFY_CONTROL_MIN_BATCH") or \
                changed("VERIFY_CONTROL_MAX_BATCH") or \
                changed("VERIFY_CONTROL_MAX_PIPELINE_DEPTH") or \
                changed("VERIFY_CONTROL_HYSTERESIS") or \
                changed("VERIFY_CONTROL_COOLDOWN") or \
                changed("VERIFY_CONTROL_LOG"):
            from stellar_tpu_torch.crypto import controller
            controller.configure_control(
                enabled=config.VERIFY_CONTROL_ENABLED,
                every=config.VERIFY_CONTROL_EVERY,
                min_batch=config.VERIFY_CONTROL_MIN_BATCH,
                max_batch=config.VERIFY_CONTROL_MAX_BATCH,
                max_pipeline_depth=(
                    config.VERIFY_CONTROL_MAX_PIPELINE_DEPTH),
                hysteresis=config.VERIFY_CONTROL_HYSTERESIS,
                cooldown=config.VERIFY_CONTROL_COOLDOWN,
                log_cap=config.VERIFY_CONTROL_LOG)
        # fleet knobs (docs/robustness.md "Replicated fleet") —
        # pushed BEFORE the fleet could start, so the router is born
        # with the configured cadence/probation/ledger bounds
        if changed("VERIFY_FLEET_ENABLED") or \
                changed("VERIFY_FLEET_REPLICAS") or \
                changed("VERIFY_FLEET_DIVERGENCE_EVERY") or \
                changed("VERIFY_FLEET_PROBATION") or \
                changed("VERIFY_FLEET_LEDGER") or \
                changed("VERIFY_FLEET_METRIC_REPLICAS"):
            from stellar_tpu_torch.crypto import fleet
            fleet.configure_fleet(
                enabled=config.VERIFY_FLEET_ENABLED,
                replicas=config.VERIFY_FLEET_REPLICAS,
                divergence_every=(
                    config.VERIFY_FLEET_DIVERGENCE_EVERY),
                probation=config.VERIFY_FLEET_PROBATION,
                ledger=config.VERIFY_FLEET_LEDGER,
                metric_replicas=(
                    config.VERIFY_FLEET_METRIC_REPLICAS))
        if config.VERIFY_FLEET_ENABLED:
            # the fleet replaces the single resident service: its
            # replicas ARE the services (router-fronted)
            from stellar_tpu_torch.crypto import fleet
            fleet.default_fleet()
        elif config.VERIFY_SERVICE_ENABLED:
            from stellar_tpu_torch.crypto import verify_service
            verify_service.default_service()
        # the card is the default wherever one answers the probe: the
        # device batch verifier decides single signatures too, whatever
        # the worker pool. A worker pool makes verify callers concurrent
        # (overlay pre-verify, threaded replay), so it puts the verifier
        # behind a trickle window; a single-threaded node calls it
        # directly. Never clobbers an explicitly-installed backend,
        # installs once per process.
        if config.DEVICE_BATCH_VERIFY:
            from stellar_tpu_torch.crypto import batch_verifier, keys
            if keys._backend is None and \
                    batch_verifier.device_available():
                window = config.TRICKLE_VERIFY_WINDOW_MS
                batch_verifier.default_verifier().install(
                    trickle_window_ms=window if window > 0 and
                    config.WORKER_THREADS > 0 else None)
        # logging sinks (reference LOG_FILE_PATH / LOG_COLOR)
        if config.LOG_FILE_PATH:
            import logging
            import os
            root_logger = logging.getLogger("stellar_tpu")
            want = os.path.abspath(config.LOG_FILE_PATH)
            if not any(isinstance(h, logging.FileHandler) and
                       getattr(h, "baseFilename", None) == want
                       for h in root_logger.handlers):
                handler = logging.FileHandler(config.LOG_FILE_PATH)
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s %(name)s %(levelname)s %(message)s"))
                root_logger.addHandler(handler)
        if config.LOG_COLOR:
            from stellar_tpu_torch.utils.logging import set_log_color
            set_log_color(True)
        # soroban host diagnostics (reference
        # ENABLE_SOROBAN_DIAGNOSTIC_EVENTS)
        if changed("ENABLE_SOROBAN_DIAGNOSTIC_EVENTS"):
            from stellar_tpu_torch.soroban import host as soroban_host
            soroban_host.DIAGNOSTIC_EVENTS_ENABLED = \
                config.ENABLE_SOROBAN_DIAGNOSTIC_EVENTS
        # internal tx errors: trap-and-fail (default) vs halt for
        # debugging (reference HALT_ON_INTERNAL_TRANSACTION_ERROR)
        from stellar_tpu_torch.tx import transaction_frame as txf
        if changed("HALT_ON_INTERNAL_TRANSACTION_ERROR"):
            txf.HALT_ON_INTERNAL_ERROR = \
                config.HALT_ON_INTERNAL_TRANSACTION_ERROR
        # weighted per-op apply sleep (reference OP_APPLY_SLEEP_TIME_*)
        if config.OP_APPLY_SLEEP_TIME_DURATION_FOR_TESTING:
            if len(config.OP_APPLY_SLEEP_TIME_DURATION_FOR_TESTING) != \
                    len(config.OP_APPLY_SLEEP_TIME_WEIGHT_FOR_TESTING):
                raise ValueError(
                    "OP_APPLY_SLEEP duration/weight lengths differ")
            txf.OP_APPLY_SLEEP = (
                list(config.OP_APPLY_SLEEP_TIME_DURATION_FOR_TESTING),
                list(config.OP_APPLY_SLEEP_TIME_WEIGHT_FOR_TESTING))
        # bucket-file durability / GC / index knobs
        from stellar_tpu_torch.bucket import bucket_index as bi_mod
        from stellar_tpu_torch.bucket import bucket_manager as bm_mod
        if changed("DISABLE_XDR_FSYNC"):
            bm_mod.XDR_FSYNC = not config.DISABLE_XDR_FSYNC
        if changed("DISABLE_BUCKET_GC"):
            bm_mod.BUCKET_GC = not config.DISABLE_BUCKET_GC
        if changed("BUCKETLIST_DB_INDEX_CUTOFF"):
            bi_mod.INDEX_CUTOFF_BYTES = config.BUCKETLIST_DB_INDEX_CUTOFF
        if changed("BUCKETLIST_DB_PERSIST_INDEX"):
            bi_mod.PERSIST_INDEX = config.BUCKETLIST_DB_PERSIST_INDEX
        if changed("ENTRY_CACHE_SIZE") or changed("PREFETCH_BATCH_SIZE"):
            from stellar_tpu_torch.bucket import bucket_list_db as bldb
            bldb.set_prefetch_limits(config.ENTRY_CACHE_SIZE,
                                     config.PREFETCH_BATCH_SIZE)
        if changed("HISTOGRAM_WINDOW_SIZE"):
            from stellar_tpu_torch.utils import metrics as metrics_mod
            metrics_mod.WINDOW_SECONDS = \
                float(config.HISTOGRAM_WINDOW_SIZE)
        if changed("METRICS_RESERVOIR_SIZE"):
            from stellar_tpu_torch.utils import metrics as metrics_mod
            # read at update time, so pushing before traffic starts
            # sizes every timer's percentile reservoir
            metrics_mod.RESERVOIR_SIZE = \
                int(config.METRICS_RESERVOIR_SIZE)
        if changed("FLIGHT_RECORDER_SPANS"):
            from stellar_tpu_torch.utils import tracing
            tracing.flight_recorder.configure(
                capacity=config.FLIGHT_RECORDER_SPANS)
        if changed("TRANSFER_LEDGER_RESOLVES") or \
                changed("TRANSFER_LEDGER_FINGERPRINTS") or \
                changed("TRANSFER_LEDGER_FP_MAX_BYTES"):
            from stellar_tpu_torch.utils.transfer_ledger import (
                transfer_ledger,
            )
            transfer_ledger.configure(
                resolves=config.TRANSFER_LEDGER_RESOLVES,
                fingerprints=config.TRANSFER_LEDGER_FINGERPRINTS,
                fp_max_bytes=config.TRANSFER_LEDGER_FP_MAX_BYTES)
        # pipeline-bubble profiler + time-series ring + SLO knobs
        # (docs/observability.md §9)
        if changed("PIPELINE_TIMELINE_RESOLVES"):
            from stellar_tpu_torch.utils.timeline import pipeline_timeline
            pipeline_timeline.configure(
                resolves=config.PIPELINE_TIMELINE_RESOLVES)
        if changed("METRICS_TIMESERIES_SAMPLES") or \
                changed("METRICS_TIMESERIES_INTERVAL_S") or \
                changed("METRICS_ANOMALY_Z") or \
                changed("METRICS_ANOMALY_SUSTAIN") or \
                changed("METRICS_ANOMALY_MIN_SAMPLES"):
            from stellar_tpu_torch.utils.metrics import timeseries
            timeseries.configure(
                samples=config.METRICS_TIMESERIES_SAMPLES,
                interval_s=config.METRICS_TIMESERIES_INTERVAL_S,
                z=config.METRICS_ANOMALY_Z,
                sustain=config.METRICS_ANOMALY_SUSTAIN,
                min_samples=config.METRICS_ANOMALY_MIN_SAMPLES)
        if config.METRICS_TIMESERIES_ENABLED:
            # start-only, like VERIFY_SERVICE_ENABLED above: these are
            # process-wide services and a later default-config node in
            # a multi-node simulation must not stop one another node
            # started (operators stop the sampler explicitly via
            # timeseries.stop())
            from stellar_tpu_torch.utils.metrics import timeseries
            timeseries.start()
        if changed("VERIFY_SLO_SCP_P99_MS") or \
                changed("VERIFY_SLO_AUTH_P99_MS") or \
                changed("VERIFY_SLO_BULK_P99_MS") or \
                changed("VERIFY_SLO_LATENCY_TARGET") or \
                changed("VERIFY_SLO_BULK_SHED_BUDGET") or \
                changed("VERIFY_SLO_WINDOW"):
            from stellar_tpu_torch.crypto import verify_service
            verify_service.configure_slo(
                scp_p99_ms=config.VERIFY_SLO_SCP_P99_MS,
                auth_p99_ms=config.VERIFY_SLO_AUTH_P99_MS,
                bulk_p99_ms=config.VERIFY_SLO_BULK_P99_MS,
                latency_target=config.VERIFY_SLO_LATENCY_TARGET,
                bulk_shed_budget=config.VERIFY_SLO_BULK_SHED_BUDGET,
                window=config.VERIFY_SLO_WINDOW)
        if changed("ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING"):
            from stellar_tpu_torch.bucket import bucket_list as bl_mod
            bl_mod.REDUCE_MERGE_COUNTS = \
                config.ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING
        if changed("BEST_OFFER_DEBUGGING_ENABLED"):
            from stellar_tpu_torch.tx import offer_exchange as oe_mod
            oe_mod.BEST_OFFER_DEBUGGING = \
                config.BEST_OFFER_DEBUGGING_ENABLED
        if changed("CATCHUP_SKIP_KNOWN_RESULTS_FOR_TESTING"):
            from stellar_tpu_torch.catchup import catchup as catchup_mod
            catchup_mod.SKIP_KNOWN_RESULTS = \
                config.CATCHUP_SKIP_KNOWN_RESULTS_FOR_TESTING
        if changed("EMIT_LEDGER_CLOSE_META_EXT_V1") or \
                changed("EMIT_SOROBAN_TRANSACTION_META_EXT_V1"):
            from stellar_tpu_torch.ledger import ledger_manager as lm_mod
            lm_mod.EMIT_LEDGER_CLOSE_META_EXT_V1 = \
                config.EMIT_LEDGER_CLOSE_META_EXT_V1
            lm_mod.EMIT_SOROBAN_TX_META_EXT_V1 = \
                config.EMIT_SOROBAN_TRANSACTION_META_EXT_V1

    def _stage_testing_upgrades(self, config: Config,
                                fresh: bool = True):
        """TESTING_UPGRADE_* fields stage upgrade votes at startup for
        standalone test networks (reference Config.h TESTING_UPGRADE
        family + USE_CONFIG_FOR_GENESIS)."""
        p = self.herder.upgrades.params
        staged = False
        if config.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION > 0:
            p.protocol_version = \
                config.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION
            staged = True
        if config.TESTING_UPGRADE_DESIRED_FEE > 0:
            p.base_fee = config.TESTING_UPGRADE_DESIRED_FEE
            staged = True
        if config.TESTING_UPGRADE_MAX_TX_SET_SIZE > 0:
            p.max_tx_set_size = config.TESTING_UPGRADE_MAX_TX_SET_SIZE
            staged = True
        if config.TESTING_UPGRADE_RESERVE > 0:
            p.base_reserve = config.TESTING_UPGRADE_RESERVE
            staged = True
        if staged:
            p.upgrade_time = 0  # vote immediately
        if config.USE_CONFIG_FOR_GENESIS and fresh and staged:
            # standalone genesis adopts the staged values directly;
            # the LCL hash must be recomputed or ledger 2's
            # previousLedgerHash would commit to the pre-mutation
            # header and chain verification would fail
            hdr = self.lm.last_closed_header
            if config.TESTING_UPGRADE_DESIRED_FEE > 0:
                hdr.baseFee = config.TESTING_UPGRADE_DESIRED_FEE
            if config.TESTING_UPGRADE_MAX_TX_SET_SIZE > 0:
                hdr.maxTxSetSize = config.TESTING_UPGRADE_MAX_TX_SET_SIZE
            if config.TESTING_UPGRADE_RESERVE > 0:
                hdr.baseReserve = config.TESTING_UPGRADE_RESERVE
            if config.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION > 0:
                hdr.ledgerVersion = \
                    config.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION
            from stellar_tpu_torch.xdr.ledger import ledger_header_hash
            self.lm._lcl_hash = ledger_header_hash(hdr)

    def _open_meta_stream(self, spec: str):
        """Stream framed LedgerCloseMeta XDR per close (reference
        METADATA_OUTPUT_STREAM, docs/integration.md:24-38)."""
        import os
        import struct
        if spec.startswith("fd:"):
            self._meta_stream_file = os.fdopen(int(spec[3:]), "ab")
        else:
            self._meta_stream_file = open(spec, "ab")

        def write_meta(meta):
            from stellar_tpu_torch.xdr.ledger import LedgerCloseMeta
            from stellar_tpu_torch.xdr.runtime import to_bytes
            raw = to_bytes(LedgerCloseMeta, meta)
            self._meta_stream_file.write(
                struct.pack(">I", 0x80000000 | len(raw)) + raw)
            self._meta_stream_file.flush()
        self.lm.close_meta_stream.append(write_meta)

    # ---------------- lifecycle ----------------

    @property
    def node_id(self) -> bytes:
        return self.config.NODE_SEED.public_key.raw

    def start(self):
        """Begin consensus participation (reference
        ``ApplicationImpl::start``)."""
        self._started = True
        if not self.config.MANUAL_CLOSE or self.config.FORCE_SCP:
            # FORCE_SCP starts consensus from the LCL immediately even
            # in manual-close setups (reference FORCE_SCP)
            self.herder.start()
        if self.config.AUTOMATIC_MAINTENANCE_PERIOD > 0 and \
                self.database is not None:
            self._schedule_maintenance()
        self._schedule_overlay_tick()
        self._schedule_advert_flush()
        if self.config.AUTOMATIC_SELF_CHECK_PERIOD > 0:
            self._schedule_self_check()
        # self-issued admin commands (reference COMMANDS)
        for cmd in self.config.COMMANDS:
            self._run_self_command(cmd)

    def _run_self_command(self, cmd: str):
        """Dispatch one admin route as if it arrived over HTTP
        (reference Config COMMANDS executed at startup) — same
        dispatch shape as the HTTP handler: route(handler, params)
        with parse_qs list-valued params."""
        from urllib.parse import parse_qs, urlsplit
        handler = getattr(self, "command_handler", None)
        if handler is None:
            raise ValueError(
                "COMMANDS configured but no command handler is "
                "attached; start the node through `run` (or attach "
                "app.command_handler) before Application.start()")
        parts = urlsplit("/" + cmd.lstrip("/"))
        name = parts.path.lstrip("/")
        route = handler.routes.get(name)
        if route is None:
            raise ValueError(f"unknown COMMANDS entry {cmd!r}")
        route(handler, parse_qs(parts.query))

    def _schedule_advert_flush(self):
        """Recurring tx-advert flush + pre-verified tx admission
        (reference FLOOD_ADVERT_PERIOD_MS timer)."""
        period = self.overlay.advert_period_s
        if period <= 0:
            return
        from stellar_tpu_torch.utils.timer import VirtualTimer

        def run():
            self.overlay.flush_adverts_tick()
            self._schedule_advert_flush()
        t = VirtualTimer(self.clock)
        t.expires_from_now(period)
        t.async_wait(run, lambda: None)
        self._advert_flush_timer = t

    def _schedule_self_check(self):
        """Periodic integrity self-check (reference
        AUTOMATIC_SELF_CHECK_PERIOD + ApplicationUtils selfCheck):
        bucket-list hash must match the LCL header's commitment."""
        from stellar_tpu_torch.utils.timer import VirtualTimer

        def run():
            self.self_check()
            self._schedule_self_check()
        t = VirtualTimer(self.clock)
        t.expires_from_now(self.config.AUTOMATIC_SELF_CHECK_PERIOD)
        t.async_wait(run, lambda: None)
        self._self_check_timer = t

    def self_check(self) -> bool:
        """Bucket-list integrity vs the header commitment (from the
        state-archival protocol the header commits to the COMBINED
        live+hot hash — recompute exactly what closeLedger wrote)."""
        import logging
        lm = self.lm
        if lm.bucket_list is None:
            return True
        from stellar_tpu_torch.bucket.hot_archive import (
            header_bucket_list_hash,
        )
        header = lm.last_closed_header
        want = header_bucket_list_hash(lm.bucket_list.hash(),
                                       lm.hot_archive,
                                       header.ledgerVersion)
        ok = want == header.bucketListHash
        if not ok:
            logging.getLogger("stellar_tpu.main").error(
                "SELF-CHECK FAILED: bucket list hash does not match "
                "the LCL header")
        return ok

    def _schedule_overlay_tick(self):
        """Recurring peer-liveness sweep (reference OverlayManager
        tick timer)."""
        from stellar_tpu_torch.utils.timer import VirtualTimer

        def run():
            self.overlay.tick()
            self._schedule_overlay_tick()
        t = VirtualTimer(self.clock)
        t.expires_from_now(5)
        t.async_wait(run, lambda: None)
        self._overlay_tick_timer = t

    def _schedule_maintenance(self):
        """Periodic history GC (reference Maintainer::scheduleMaintenance)."""
        from stellar_tpu_torch.utils.timer import VirtualTimer

        def run():
            from stellar_tpu_torch.main.maintainer import Maintainer
            Maintainer(self).perform_maintenance(
                self.config.AUTOMATIC_MAINTENANCE_COUNT)
            self._schedule_maintenance()
        t = VirtualTimer(self.clock)
        t.expires_from_now(self.config.AUTOMATIC_MAINTENANCE_PERIOD)
        t.async_wait(run, lambda: None)
        self._maintenance_timer = t

    def crank(self, block: bool = False) -> int:
        if self.config.ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING > 0:
            # injected main-thread contention (reference
            # ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING, microseconds)
            import time as _time
            _time.sleep(
                self.config.ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING
                / 1_000_000.0)
        n = self.clock.crank(block)
        # reap finished archive subprocesses (reference: exit handlers
        # posted back to the main thread)
        if self.process_manager.running or self.process_manager.pending:
            n += self.process_manager.poll()
        return n

    def _restore_scp_state(self):
        """Re-feed the LCL slot's persisted SCP messages (reference
        ``Herder::restoreSCPState``): a restarted validator can prove
        the last externalization to peers (GET_SCP_STATE)."""
        from stellar_tpu_torch.xdr.runtime import from_bytes
        from stellar_tpu_torch.xdr.scp import SCPEnvelope
        for raw in self.database.load_scp_history(self.lm.ledger_seq):
            try:
                env = from_bytes(SCPEnvelope, raw)
                # restore entry point: records state without re-running
                # validation (the reference's setStateFromEnvelope —
                # tx sets for closed slots are gone, so the normal
                # receive path could not validate them)
                self.herder.scp.set_state_from_envelope(
                    env.statement.slotIndex, env)
            except Exception:
                continue  # stale/foreign rows never block startup

    def _restore_scheduled_upgrades(self):
        from stellar_tpu_torch.database import PersistentState
        raw_up = self.persistence.state.get(
            PersistentState.LEDGER_UPGRADES)
        if raw_up:
            try:
                self.herder.upgrades.params = _upgrade_params_from_json(
                    raw_up)
            except Exception:
                pass
        self._saved_upgrades = raw_up

    def save_scheduled_upgrades(self):
        """Persist the operator's scheduled upgrade votes (reference
        stores Upgrades parameters in PersistentState), including
        clears: remove_upgrades_once_done must not resurrect applied
        votes on restart."""
        if self.persistence is None:
            return
        from stellar_tpu_torch.database import PersistentState
        raw = _upgrade_params_to_json(self.herder.upgrades.params)
        if raw != getattr(self, "_saved_upgrades", None):
            self.persistence.state.set(
                PersistentState.LEDGER_UPGRADES, raw)
            self._saved_upgrades = raw

    def _start_catchup(self, target_seq: int):
        """The node fell behind the network (reference
        LM_CATCHING_UP_STATE): run a CatchupWork from the configured
        archives, then drain the herder's buffered externalizes."""
        if not self.config.MODE_DOES_CATCHUP:
            return  # reference MODE_DOES_CATCHUP=false: observe only
        if self._catchup_work is not None and \
                not self._catchup_work.is_done():
            return  # already catching up
        # cooldown: a finished catchup that could not reach the
        # buffered ledgers (archive's newest checkpoint too old) must
        # not re-download the archive on every externalize — retry at
        # roughly checkpoint-publish cadence
        now = self.clock.now()
        if self._last_catchup_at is not None and \
                now - self._last_catchup_at < 60:
            return
        self._last_catchup_at = now
        if not self.config.HISTORY_ARCHIVES:
            import logging
            logging.getLogger("stellar_tpu.herder").warning(
                "behind the network at slot %d but no HISTORY_ARCHIVES "
                "configured; waiting for buffered ledgers", target_seq)
            return
        from stellar_tpu_torch.catchup.catchup import (
            CatchupConfiguration, CatchupWork,
        )
        from stellar_tpu_torch.history.history_manager import (
            archive_from_config,
        )
        from stellar_tpu_torch.work.work import FunctionWork, WorkSequence
        if self.config.CATCHUP_COMPLETE:
            conf = CatchupConfiguration(0, CatchupConfiguration.COMPLETE)
        elif self.config.CATCHUP_RECENT > 0:
            conf = CatchupConfiguration(0, CatchupConfiguration.RECENT,
                                        count=self.config.CATCHUP_RECENT)
        else:
            conf = CatchupConfiguration(0, CatchupConfiguration.MINIMAL)
        self._catchup_work = CatchupWork(
            self.lm, archive_from_config(self.config.HISTORY_ARCHIVES[0]),
            conf, status_manager=self.status_manager)
        seq = WorkSequence(f"catchup-and-resume-{target_seq}")
        seq.add_child(self._catchup_work)
        seq.add_child(FunctionWork("drain-buffered",
                                   self.herder.drain_buffered))
        self.work_scheduler.schedule(seq)

    # ---------------- hooks ----------------

    def _on_externalized(self, slot_index: int, close_result):
        if self.history is not None:
            txset = None
            sv = close_result.header.scpValue
            txset = self.herder.tx_sets.get(sv.txSetHash)
            if txset is not None:
                self.history.ledger_closed(close_result, txset,
                                           self.lm.bucket_list,
                                           hot_archive=self.lm
                                           .hot_archive)
            self.history.poll_deferred_publishes()
        if self.config.REPORT_METRICS:
            import logging
            from stellar_tpu_torch.utils.metrics import registry
            log = logging.getLogger("stellar_tpu.metrics")
            snapshot = registry.to_dict()
            for name in self.config.REPORT_METRICS:
                if name in snapshot:
                    log.info("metric %s: %s", name, snapshot[name])
        if self.database is not None:
            # HerderPersistence: the slot's SCP messages into scphistory
            # (reference HerderPersistenceImpl::saveSCPHistory)
            from stellar_tpu_torch.xdr.runtime import to_bytes
            from stellar_tpu_torch.xdr.scp import SCPEnvelope
            rows = [(env.statement.nodeID.value,
                     to_bytes(SCPEnvelope, env))
                    for env in self.herder.scp.get_current_state(
                        slot_index)]
            if rows:
                self.database.store_scp_history(slot_index, rows)
            # applied upgrade votes were cleared by the herder; keep
            # the persisted row in sync so restarts don't resurrect
            self.save_scheduled_upgrades()
        self.overlay.ledger_closed(slot_index)

    # ---------------- operator surface ----------------

    def _verify_health(self) -> dict:
        """Verify-dispatch resilience snapshot for the info payload;
        keeps the per-category status line (reference StatusManager) in
        sync so a degraded verify backend is visible wherever operators
        already look. The port's dispatch state is per engine (its
        ``dispatch_health()["engines"]``): no process-wide breaker and no
        host-only mode, so the lines read each engine's breakers and
        convictions."""
        from stellar_tpu_torch.crypto import batch_verifier, keys
        from stellar_tpu_torch.utils.status import StatusCategory
        health = batch_verifier.dispatch_health()
        health["backend"] = keys.get_verifier_backend_name()
        not_closed, shut = [], []
        for name, eng in sorted(health["engines"].items()):
            dh = eng["device_health"]
            not_closed += [(name, idx, br)
                           for idx, br in sorted(dh["devices"].items())
                           if br["state"] != "closed"]
            shut += [f"{name}:{idx}" for idx in
                     sorted(set(dh["quarantined"]) | set(eng["convicted"]))]
        if not_closed:
            name, idx, br = not_closed[0]
            self.status_manager.set_status(
                StatusCategory.VERIFY_DEVICE,
                f"verify device degraded: {name} device {idx} breaker "
                f"{br['state']} ({br['consecutive_failures']} consecutive "
                f"failures, retry in {br['retry_in_s']}s); "
                f"{len(not_closed)} breaker(s) not closed; parts move to "
                "the devices left, and a call with none left raises")
        elif shut:
            self.status_manager.set_status(
                StatusCategory.VERIFY_DEVICE,
                f"verify mesh degraded: device(s) {shut} quarantined; "
                "batch re-sharded over the survivors")
        else:
            self.status_manager.remove_status(StatusCategory.VERIFY_DEVICE)
        return health

    def info(self) -> dict:
        """The HTTP 'info' payload (reference CommandHandler)."""
        from stellar_tpu_torch.herder.herder import HERDER_STATE
        verify_health = self._verify_health()  # refreshes status lines
        lcl = self.lm.last_closed_header
        return {
            "verify": verify_health,
            "ledger": {
                "num": lcl.ledgerSeq,
                "hash": self.lm.last_closed_hash.hex(),
                "closeTime": lcl.scpValue.closeTime,
                "baseFee": lcl.baseFee,
                "baseReserve": lcl.baseReserve,
                "maxTxSetSize": lcl.maxTxSetSize,
                "version": lcl.ledgerVersion,
            },
            "state": {HERDER_STATE.BOOTING: "booting",
                      HERDER_STATE.TRACKING: "synced",
                      HERDER_STATE.OUT_OF_SYNC: "out-of-sync"}[
                self.herder.state],
            "peers": {"authenticated_count":
                      self.overlay.authenticated_count(),
                      "pending_count": len(self.overlay.pending_peers)},
            "quorum": {"node": self.config.NODE_SEED.public_key
                       .to_strkey(),
                       "home_domain": self.config.NODE_HOME_DOMAIN,
                       "intersection":
                           self.herder.latest_quorum_intersection},
            "network": self.config.NETWORK_PASSPHRASE,
            "protocol_version": lcl.ledgerVersion,
            "version": self.config.VERSION_STR or "stellar_tpu",
            "validator_names": self.validator_names,
            "history": {
                "published_checkpoints":
                    list(self.history.published_checkpoints)
                    if self.history else [],
            },
            "database": bool(self.database),
            # per-category operator status lines (reference
            # StatusManager, surfaced the same way in info)
            "status": self.status_manager.status_lines(),
        }

    def manual_close(self) -> dict:
        """Close one ledger on demand (reference ``manualclose``
        command; standalone mode)."""
        seq = self.lm.ledger_seq + 1
        self.herder.trigger_next_ledger(seq)
        # single-node qset externalizes immediately via self-messages
        return {"ledger": self.lm.ledger_seq}


def _upgrade_params_to_json(params) -> str:
    import base64
    import json as _json
    from stellar_tpu_torch.xdr.ledger import ConfigUpgradeSetKey
    from stellar_tpu_torch.xdr.runtime import to_bytes
    d = {
        "upgrade_time": params.upgrade_time,
        "protocol_version": params.protocol_version,
        "base_fee": params.base_fee,
        "max_tx_set_size": params.max_tx_set_size,
        "base_reserve": params.base_reserve,
        "flags": params.flags,
        "max_soroban_tx_set_size": params.max_soroban_tx_set_size,
        "config_upgrade_set_key": base64.b64encode(to_bytes(
            ConfigUpgradeSetKey, params.config_upgrade_set_key)).decode()
        if params.config_upgrade_set_key is not None else None,
    }
    return _json.dumps(d)


def _upgrade_params_from_json(raw: str):
    import base64
    import json as _json
    from stellar_tpu_torch.herder.upgrades import UpgradeParameters
    from stellar_tpu_torch.xdr.ledger import ConfigUpgradeSetKey
    from stellar_tpu_torch.xdr.runtime import from_bytes
    d = _json.loads(raw)
    key = d.get("config_upgrade_set_key")
    return UpgradeParameters(
        upgrade_time=d.get("upgrade_time", 0),
        protocol_version=d.get("protocol_version"),
        base_fee=d.get("base_fee"),
        max_tx_set_size=d.get("max_tx_set_size"),
        base_reserve=d.get("base_reserve"),
        flags=d.get("flags"),
        max_soroban_tx_set_size=d.get("max_soroban_tx_set_size"),
        config_upgrade_set_key=from_bytes(
            ConfigUpgradeSetKey, base64.b64decode(key))
        if key else None)
