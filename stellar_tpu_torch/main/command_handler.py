"""HTTP admin API (reference ``src/main/CommandHandler.cpp:90-134``):
info, metrics, peers, tx submit, manualclose, ll, scp/quorum
introspection — served off the node's crank loop."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["CommandHandler"]


class _TextResponse(str):
    """Marker type: a route result served verbatim as ``text/plain``
    (the Prometheus exposition) instead of being JSON-encoded."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"


def _submit_status(res) -> dict:
    """Uniform tx-submission status JSON (tx + testtx routes):
    AddResult code by NAME, plus the inner result code on rejection."""
    from stellar_tpu_torch.herder.transaction_queue import AddResult
    names = {AddResult.ADD_STATUS_PENDING: "PENDING",
             AddResult.ADD_STATUS_DUPLICATE: "DUPLICATE",
             AddResult.ADD_STATUS_ERROR: "ERROR",
             AddResult.ADD_STATUS_TRY_AGAIN_LATER: "TRY_AGAIN_LATER",
             AddResult.ADD_STATUS_BANNED: "BANNED"}
    out = {"status": names.get(res.code, "?")}
    if res.tx_result is not None:
        out["error_result_code"] = res.tx_result.code
    return out


class CommandHandler:
    """Routes are handled on the HTTP thread but all node state access
    is marshalled onto the main thread via post_to_main + an event —
    the reference's single-writer discipline."""

    def __init__(self, app, port: int = 0, routes=None):
        self.app = app
        self.routes = dict(self.ROUTES if routes is None else routes)
        handler = self._make_handler()
        cfg = getattr(app, "config", None)
        # loopback unless the operator opted into a public admin port
        # (reference PUBLIC_HTTP_PORT); backlog per HTTP_MAX_CLIENT
        host = "0.0.0.0" if getattr(cfg, "PUBLIC_HTTP_PORT", False) \
            else "127.0.0.1"
        backlog = getattr(cfg, "HTTP_MAX_CLIENT", 128)

        class _Server(ThreadingHTTPServer):
            # per-instance backlog, not a process-global class mutation
            request_queue_size = backlog
        self.server = _Server((host, port), handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()

    def _on_main(self, fn):
        """Run fn on the cranking thread; block for the result."""
        done = threading.Event()
        box = {}

        def run():
            try:
                box["out"] = fn()
            except Exception as e:  # surfaced as a 500
                box["err"] = str(e)
            done.set()
        self.app.clock.post_to_main(run, name="http-command")
        if not done.wait(timeout=10.0):
            raise TimeoutError("main thread did not respond")
        if "err" in box:
            raise RuntimeError(box["err"])
        return box.get("out")

    # ---------------- commands ----------------

    def cmd_info(self, params):
        return self._on_main(self.app.info)

    def cmd_metrics(self, params):
        """Registry export: JSON by default; ``metrics?format=
        prometheus`` serves the text exposition (reference
        ``docs/metrics.md`` — medida behind the HTTP endpoint). The
        Prometheus form is served directly: scrapers poll it on a
        cadence, the registry is lock-protected module state, and a
        wedged main thread must not take the node's last observability
        surface down with it (same policy as ``dispatch``)."""
        from stellar_tpu_torch.utils.metrics import registry
        if params.get("format", ["json"])[0] == "prometheus":
            return _TextResponse(registry.to_prometheus())
        return self._on_main(registry.to_dict)

    def cmd_spans(self, params):
        """Flight-recorder surface (docs/observability.md): open
        spans, recent completed spans, and failure dumps (breaker
        trips / audit mismatches / watchdog timeouts). Served directly
        — the recorder exists to explain a wedged main thread, so it
        must stay readable when one is wedged. ``spans?dumps=true``
        returns the full dump payloads; ``limit=N`` bounds the recent
        window; ``spans?format=chrome`` renders the recorder as Chrome
        ``trace_event`` JSON (load in chrome://tracing / Perfetto —
        also exported by ``tools/trace_export.py``);
        ``spans?format=chrome&fleet=true`` splits the
        export into per-replica process tracks merged on the one
        recorder clock — the whole-fleet window."""
        from stellar_tpu_torch.utils import tracing
        if params.get("format", ["json"])[0] == "chrome":
            by_replica = params.get("fleet", ["false"])[0] == "true"
            return tracing.flight_recorder.to_chrome_trace(
                by_replica=by_replica)
        try:
            limit = int(params.get("limit", ["128"])[0])
        except ValueError:
            return {"error": "bad limit param"}
        out = tracing.flight_recorder.snapshot(limit=limit)
        if params.get("dumps", ["false"])[0] == "true":
            out["dumps"] = tracing.flight_recorder.dumps()
        return out

    def cmd_trace(self, params):
        """One item's end-to-end timeline: ``trace?id=N``
        reconstructs the submission's path — wire frame, fleet route,
        service enqueue, lane wait, batch coalesce, dispatch, engine
        sub-chunk fetch/audit/host-fallback, verdict (or shed/
        reject), with cross-replica handoff hops stitched in (the
        ``stitch`` section) — from the flight recorder's
        exemplar-tagged records. Served directly: tracing exists to
        explain a node that is misbehaving, so it must not depend on
        the main thread (same policy as ``spans``).

        Misses return a typed ``{"error", "reason"}`` body:
        ``never-admitted`` — the ID is beyond the allocator, no
        such trace was ever issued; ``expired`` — the ID was issued
        but every record has aged out of the bounded ring;
        ``bad-request`` — the param is missing or malformed."""
        from stellar_tpu_torch.utils import tracing
        tid = params.get("id", [None])[0]
        if tid is None:
            return {"error": "missing id param (trace?id=N)",
                    "reason": "bad-request"}
        try:
            tid = int(tid)
        except ValueError:
            return {"error": "bad id param", "reason": "bad-request"}
        tl = tracing.flight_recorder.trace_timeline(tid)
        if not tl["found"]:
            from stellar_tpu_torch.crypto import verify_service
            if tid < 0 or tid >= verify_service.allocated_traces():
                return {"error": f"trace {tid} was never admitted "
                                 "(beyond the allocator)",
                        "reason": "never-admitted", "trace": tid}
            return {"error": f"trace {tid} has expired from the "
                             "bounded recorder ring",
                    "reason": "expired", "trace": tid}
        return tl

    def cmd_journal(self, params):
        """The unified system journal (docs/observability.md
        §12): the running fleet's (or bare
        service's) deterministic feeds — route/refusal rows, replica
        admission/terminal rows, scheduling decisions, control moves,
        convictions — merged into one ``(component, seq)``-keyed
        stream, plus the completeness-law verdict
        (``completeness.gap`` must read 0). ``journal?events=false``
        drops the merged stream (totals + law only);
        ``limit=N`` bounds each component's retained tail. Served
        directly — the journal exists to explain a misbehaving
        system, so it must not depend on the main thread (same
        policy as ``trace``/``spans``)."""
        from stellar_tpu_torch.crypto import fleet as fleet_mod
        from stellar_tpu_torch.crypto import ingress as ingress_mod
        from stellar_tpu_torch.crypto import verify_service
        from stellar_tpu_torch.utils import journal
        fl = fleet_mod.running_fleet()
        services = None
        if fl is None:
            svc = verify_service.running_service()
            if svc is None:
                return {"error": "no running fleet or verify "
                                 "service to journal",
                        "reason": "no-source"}
            services = [svc]
        srv = ingress_mod.running_server()
        col = journal.collect(fleet=fl, services=services,
                              ingress=srv)
        merged = journal.merge(col)
        out = {"totals": merged["totals"],
               "nondet": merged["nondet"],
               "completeness": journal.completeness(merged)}
        if params.get("events", ["true"])[0] != "false":
            events = merged["events"]
            try:
                limit = int(params.get("limit", ["0"])[0])
            except ValueError:
                return {"error": "bad limit param",
                        "reason": "bad-request"}
            out["events"] = events[-limit:] if limit > 0 else events
        return out

    def cmd_dispatch(self, params):
        """Verify-dispatch resilience surface: breaker state, backend
        attribution, fallback/deadline/retry counters, active knobs
        (docs/robustness.md). Served directly — the dispatch layer's
        state is lock-protected module data, not node state, and must
        stay readable even when the main thread is wedged (that is the
        failure this subsystem exists to detect)."""
        from stellar_tpu_torch.crypto import batch_verifier, keys
        health = batch_verifier.dispatch_health()
        health["backend"] = keys.get_verifier_backend_name()
        return health

    def cmd_service(self, params):
        """Resident verify-service surface: per-lane queue depths,
        the work-conservation counters (submitted == verified +
        rejected + shed + failed + pending), wait-time percentiles
        and the shed-ladder pressure level (docs/robustness.md
        "Overload and load-shed"). Served directly — overload is
        exactly when the main thread may be busy, and this surface
        exists to explain overload (same policy as ``dispatch``)."""
        from stellar_tpu_torch.crypto import verify_service
        return verify_service.service_health()

    def cmd_pipeline(self, params):
        """Pipeline-bubble profiler surface
        (docs/observability.md §9): per-device busy/idle totals,
        busy/overlap fractions, bubble attribution by class, and the
        most recent per-resolve timelines (``pipeline?limit=N``).
        Served directly — lock-protected module state, same policy
        as ``dispatch``/``spans``."""
        from stellar_tpu_torch.utils.timeline import pipeline_timeline
        try:
            limit = int(params.get("limit", ["8"])[0])
        except ValueError:
            return {"error": "bad limit param"}
        return pipeline_timeline.snapshot(limit=limit)

    def cmd_timeseries(self, params):
        """In-process metric time-series: the bounded
        fixed-interval history ring plus the EWMA anomaly watcher's
        recent firings. ``timeseries?series=<prefix>`` filters,
        ``limit=N`` bounds samples per series (0 = all retained).
        Partial windows are marked, never silently averaged. Served
        directly (same policy as ``metrics``)."""
        from stellar_tpu_torch.utils.metrics import timeseries
        try:
            limit = int(params.get("limit", ["0"])[0])
        except ValueError:
            return {"error": "bad limit param"}
        return timeseries.snapshot(
            series=params.get("series", [None])[0], limit=limit)

    def cmd_slo(self, params):
        """Per-lane SLO burn rates: sliding-window
        latency and completion error-budget accounting for every
        verify-service lane. Served directly — burn rates matter
        exactly when the node is under pressure (same policy as
        ``service``)."""
        from stellar_tpu_torch.crypto import verify_service
        return verify_service.slo_health()

    def cmd_tenant(self, params):
        """Per-tenant QoS surface: top-K tenant SLO burn
        rates + the ``tenant.other`` rollup, and the service's
        per-tenant conservation counters — one misbehaving submitter
        is attributable (and provably isolated) from this route
        alone. Served directly, same policy as ``slo``."""
        from stellar_tpu_torch.crypto import verify_service
        return verify_service.tenant_health()

    def cmd_control(self, params):
        """Closed-loop controller surface: the knob
        trajectory the deterministic feedback controller is driving —
        current/base knob values, clamp bounds, hysteresis state, and
        the tail of the bounded control log. Served directly — the
        controller acts exactly when the node is overloaded (same
        policy as ``slo``/``tenant``)."""
        from stellar_tpu_torch.crypto import verify_service
        return verify_service.control_health()

    def cmd_fleet(self, params):
        """Replicated-fleet surface: per-replica states
        and counters, the fleet-level exact conservation law
        (residual must read 0), divergence-conviction evidence and
        the drain/handoff tallies. Served directly — replica health
        matters exactly when the node is struggling (same policy as
        ``slo``/``tenant``/``control``)."""
        from stellar_tpu_torch.crypto import fleet
        return fleet.fleet_health()

    def cmd_ingress(self, params):
        """Wire-ingress surface: the active
        ``IngressServer``'s snapshot — frame/item/byte counters, the
        malformed-frame tally by typed reason, per-connection defense
        kill counts, the reusable host-buffer pool, and the
        wire-extended conservation residual (must read 0). Served
        directly — wire health matters exactly when clients
        misbehave (same policy as ``fleet``)."""
        from stellar_tpu_torch.crypto import ingress
        return ingress.ingress_health()

    def cmd_peers(self, params):
        def peers():
            out = []
            for p in self.app.overlay.peers:
                out.append({
                    "id": p.remote_node_id.hex()
                    if p.remote_node_id else None,
                    "authenticated": p.is_authenticated(),
                })
            return {"authenticated_peers": out}
        return self._on_main(peers)

    def cmd_tx(self, params):
        blob = params.get("blob", [None])[0]
        if blob is None:
            return {"status": "ERROR", "detail": "missing blob param"}

        def submit():
            import base64
            from stellar_tpu_torch.tx.transaction_frame import (
                make_transaction_frame,
            )
            from stellar_tpu_torch.xdr.runtime import from_bytes
            from stellar_tpu_torch.xdr.tx import TransactionEnvelope
            raw = base64.b64decode(blob)
            env = from_bytes(TransactionEnvelope, raw)
            frame = make_transaction_frame(self.app.herder.network_id, env)
            res = self.app.herder.recv_transaction(frame)
            out = _submit_status(res)
            if res.tx_result is not None:
                if self.app.config \
                        .ENABLE_DIAGNOSTICS_FOR_TX_SUBMISSION:
                    # full result XDR for failed submissions
                    # (reference ENABLE_DIAGNOSTICS_FOR_TX_SUBMISSION)
                    from stellar_tpu_torch.xdr.runtime import to_bytes as _tb
                    xdr_res = res.tx_result.to_xdr() \
                        if hasattr(res.tx_result, "to_xdr") \
                        else res.tx_result
                    try:
                        from stellar_tpu_torch.xdr.results import (
                            TransactionResult,
                        )
                        out["diagnostic_result_xdr"] = base64.b64encode(
                            _tb(TransactionResult, xdr_res)).decode()
                    except Exception:
                        pass
            return out
        return self._on_main(submit)

    def cmd_manualclose(self, params):
        return self._on_main(self.app.manual_close)

    def cmd_quorum(self, params):
        def quorum():
            from stellar_tpu_torch.herder.quorum_tracker import QuorumTracker
            from stellar_tpu_torch.scp.quorum import for_all_nodes
            q = self.app.herder.scp.local_qset
            out = {"threshold": q.threshold,
                   "validators": [v.hex()[:16]
                                  for v in for_all_nodes(q)]}
            # reference form: quorum?transitive=true
            if params.get("transitive", ["false"])[0] == "true":
                out["transitive"] = QuorumTracker(
                    self.app.herder).analyze()
            return out
        return self._on_main(quorum)

    def cmd_scp(self, params):
        def scp():
            out = {}
            for idx, slot in self.app.herder.scp.known_slots.items():
                out[str(idx)] = {
                    "phase": slot.ballot.phase,
                    "nomination_round":
                        slot.nomination.round_number,
                    "statements": len(slot.statements_history),
                }
            return out
        return self._on_main(scp)

    def cmd_ll(self, params):
        level = params.get("level", [None])[0]
        partition = params.get("partition", ["root"])[0]
        from stellar_tpu_torch.utils.logging import set_log_level
        if level:
            set_log_level(None if partition == "root" else partition,
                          level)
        return {"partition": partition, "level": level or "unchanged"}

    def cmd_bans(self, params):
        from stellar_tpu_torch.crypto import strkey
        return self._on_main(lambda: [
            strkey.encode_account(n)
            for n in self.app.overlay.ban_manager.banned_nodes()])

    def cmd_ban(self, params):
        from stellar_tpu_torch.crypto import strkey
        node = strkey.decode_account(params["node"][0])
        self._on_main(lambda: self.app.overlay.ban_peer(node))
        return {"banned": params["node"][0]}

    def cmd_unban(self, params):
        from stellar_tpu_torch.crypto import strkey
        node = strkey.decode_account(params["node"][0])
        self._on_main(lambda: self.app.overlay.ban_manager.unban(node))
        return {"unbanned": params["node"][0]}

    def cmd_droppeer(self, params):
        from stellar_tpu_torch.crypto import strkey
        node = strkey.decode_account(params["node"][0])

        def drop():
            for p in list(self.app.overlay.peers):
                if p.remote_node_id == node:
                    p.drop("dropped by operator")
                    return True
            return False
        return {"dropped": self._on_main(drop)}

    def cmd_upgrades(self, params):
        """Schedule upgrade votes (reference 'upgrades?mode=set&...')."""
        mode = params.get("mode", ["get"])[0]

        def apply_():
            up = self.app.herder.upgrades.params
            if mode == "set":
                from stellar_tpu_torch.herder.upgrades import UpgradeParameters
                up = UpgradeParameters(
                    upgrade_time=int(params.get("upgradetime", ["0"])[0]))
                for attr, key in (
                        ("protocol_version", "protocolversion"),
                        ("base_fee", "basefee"),
                        ("max_tx_set_size", "maxtxsetsize"),
                        ("base_reserve", "basereserve"),
                        ("flags", "flags")):
                    if key in params:
                        setattr(up, attr, int(params[key][0]))
                self.app.herder.upgrades.params = up
                self.app.save_scheduled_upgrades()
            elif mode == "clear":
                from stellar_tpu_torch.herder.upgrades import UpgradeParameters
                self.app.herder.upgrades.params = UpgradeParameters()
                up = self.app.herder.upgrades.params
                self.app.save_scheduled_upgrades()
            return {
                "upgradetime": up.upgrade_time,
                "protocolversion": up.protocol_version,
                "basefee": up.base_fee,
                "maxtxsetsize": up.max_tx_set_size,
                "basereserve": up.base_reserve,
                "flags": up.flags,
            }
        return self._on_main(apply_)

    def cmd_start_survey_collecting(self, params):
        return self._on_main(
            self.app.overlay.survey_manager.start_collecting)

    def cmd_stop_survey_collecting(self, params):
        return self._on_main(
            self.app.overlay.survey_manager.stop_collecting)

    def cmd_survey_topology_timesliced(self, params):
        from stellar_tpu_torch.crypto import strkey
        node = strkey.decode_account(params["node"][0])
        return self._on_main(
            lambda: self.app.overlay.survey_manager.request_node(node))

    def cmd_get_survey_result(self, params):
        return self._on_main(
            lambda: dict(self.app.overlay.survey_manager.results))

    def cmd_generate_load(self, params):
        """Reference ``generateload`` admin route: mode=create|pay|
        pretend|soroban_upload|soroban_invoke|mixed_classic_soroban,
        txs=N (+ mode=soroban_invoke_setup to deploy the contract)."""
        mode = params.get("mode", ["pay"])[0]
        n = int(params.get("txs", ["10"])[0])

        def run():
            if getattr(self.app, "_load_generator", None) is None:
                from stellar_tpu_torch.simulation.load_generator import (
                    LoadGenerator,
                )
                self.app._load_generator = LoadGenerator(self.app)
            gen = self.app._load_generator
            before = gen.submitted
            before_rej = gen.rejected
            if mode == "soroban_invoke_setup":
                gen.setup_soroban()
            else:
                gen.generate_load(n, mode=mode)
            return {"mode": mode, "submitted": gen.submitted - before,
                    "rejected": gen.rejected - before_rej,
                    "total_submitted": gen.submitted}
        return self._on_main(run)

    def cmd_clearmetrics(self, params):
        """Reset the metrics registry (reference ``clearmetrics``)."""
        from stellar_tpu_torch.utils.metrics import registry

        def run():
            registry.clear()
            return {"cleared": True}
        return self._on_main(run)

    def cmd_connect(self, params):
        """Dial a peer (reference ``connect?peer=host&port=N``)."""
        peer = params.get("peer", [None])[0]
        if peer is None:
            return {"status": "ERROR", "detail": "missing peer param"}
        try:
            port = int(params.get("port", ["11625"])[0])
        except ValueError:
            return {"status": "ERROR", "detail": "bad port param"}
        driver = getattr(self.app, "tcp_driver", None)
        if driver is None:
            return {"status": "ERROR",
                    "detail": "node has no TCP transport attached"}

        def run():
            driver.connect(peer, port)
            return {"connecting": f"{peer}:{port}"}
        return self._on_main(run)

    def cmd_sorobaninfo(self, params):
        """Current soroban network settings (reference
        ``sorobaninfo``)."""
        import dataclasses

        def run():
            return dataclasses.asdict(self.app.lm.soroban_config)
        return self._on_main(run)

    def cmd_dumpproposedsettings(self, params):
        """The ConfigUpgradeSet this node's scheduled CONFIG vote
        points at, decoded from ledger state (reference
        ``dumpproposedsettings``)."""
        def run():
            from stellar_tpu_torch.herder.upgrades import (
                load_config_upgrade_set,
            )
            key = self.app.herder.upgrades.params.config_upgrade_set_key
            if key is None:
                return {"status": "no config upgrade scheduled"}
            upgrade_set = load_config_upgrade_set(
                key, self.app.lm.root.store.get)
            if upgrade_set is None:
                return {"status": "scheduled set not published/loadable",
                        "contentHash": key.contentHash.hex()}
            return {"contentHash": key.contentHash.hex(),
                    "updatedEntries": [repr(e) for e in
                                       upgrade_set.updatedEntry]}
        return self._on_main(run)

    def cmd_maintenance(self, params):
        count = int(params.get("count", ["50000"])[0])

        def run():
            from stellar_tpu_torch.main.maintainer import Maintainer
            return Maintainer(self.app).perform_maintenance(count)
        return self._on_main(run)

    # ---- downstream-consumer cursors (reference ExternalQueue:
    # setcursor/dropcursor hold history GC back for external readers)

    def _cursor_state(self):
        db = getattr(self.app, "database", None)
        if db is None:
            return None
        from stellar_tpu_torch.database.database import PersistentState
        return PersistentState(db)

    def cmd_setcursor(self, params):
        if "id" not in params or "cursor" not in params:
            return {"status": "ERROR",
                    "detail": "need id and cursor params"}
        cid = params["id"][0]
        if not cid.isalnum() or len(cid) > 32:
            return {"status": "ERROR",
                    "detail": "cursor id must be alphanumeric, <=32"}
        try:
            cursor = int(params["cursor"][0])
        except ValueError:
            return {"status": "ERROR", "detail": "bad cursor"}
        if cursor <= 0:
            return {"status": "ERROR", "detail": "cursor must be > 0"}

        def run():
            ps = self._cursor_state()
            if ps is None:
                return {"status": "ERROR", "detail": "no database"}
            ps.set(f"cursor.{cid}", str(cursor))
            return {"cursor": cid, "value": cursor}
        return self._on_main(run)

    def cmd_getcursor(self, params):
        def run():
            ps = self._cursor_state()
            if ps is None:
                return {"status": "ERROR", "detail": "no database"}
            want = params.get("id", [None])[0]
            out = ps.list_cursors()
            if want is not None:
                out = {want: out[want]} if want in out else {}
            return {"cursors": out}
        return self._on_main(run)

    def cmd_dropcursor(self, params):
        if "id" not in params:
            return {"status": "ERROR", "detail": "need id param"}
        cid = params["id"][0]
        if not cid.isalnum() or len(cid) > 32:
            # same validation as setcursor: a typo'd id must surface
            # as an error, not as "cursor already gone"
            return {"status": "ERROR",
                    "detail": "cursor id must be alphanumeric, <=32"}

        def run():
            ps = self._cursor_state()
            if ps is None:
                return {"status": "ERROR", "detail": "no database"}
            with ps.db.conn:
                cur = ps.db.conn.execute(
                    "DELETE FROM storestate WHERE statename = ?",
                    (f"cursor.{cid}",))
            return {"dropped": cid, "existed": cur.rowcount > 0}
        return self._on_main(run)

    def cmd_testacc(self, params):
        """Reference ``testacc?name=bob`` (BUILD_TESTS route): balance
        and seqnum of the deterministic test account for ``name``."""
        name = params.get("name", [None])[0]
        if name is None:
            return {"status": "error",
                    "detail": "try something like: testacc?name=bob"}

        def run():
            from stellar_tpu_torch.crypto.keys import SecretKey
            from stellar_tpu_torch.ledger.ledger_txn import key_bytes
            from stellar_tpu_torch.tx.op_frame import account_key
            from stellar_tpu_torch.xdr.types import account_id
            key = SecretKey.from_seed_str(name)
            e = self.app.lm.root.store.get(key_bytes(
                account_key(account_id(key.public_key.raw))))
            if e is None:
                return {"status": "error",
                        "detail": f"no account for {name!r}"}
            ae = e.data.value
            return {"name": name, "id": key.public_key.to_strkey(),
                    "balance": ae.balance, "seqnum": ae.seqNum}
        return self._on_main(run)

    def cmd_testtx(self, params):
        """Reference ``testtx?from=root&to=bob&amount=N[&create=true]``:
        build, sign, and submit a payment (or create-account) between
        deterministic test accounts."""
        missing = [k for k in ("from", "to", "amount")
                   if k not in params]
        if missing:
            return {"status": "error",
                    "detail": f"missing params: {missing}"}
        try:
            amount = int(params["amount"][0])
        except ValueError:
            return {"status": "error", "detail": "bad amount param"}

        def run():
            from stellar_tpu_torch.crypto.keys import SecretKey
            from stellar_tpu_torch.ledger.ledger_txn import key_bytes
            from stellar_tpu_torch.tx.op_frame import account_key
            from stellar_tpu_torch.tx.tx_test_utils import (
                create_account_op, make_tx, payment_op,
            )
            from stellar_tpu_torch.xdr.types import account_id
            src = SecretKey.from_seed_str(params["from"][0])
            dst = SecretKey.from_seed_str(params["to"][0])
            create = params.get("create", ["false"])[0] == "true"
            e = self.app.lm.root.store.get(key_bytes(
                account_key(account_id(src.public_key.raw))))
            if e is None:
                return {"status": "error", "detail": "no from account"}
            op = create_account_op(dst, amount) if create \
                else payment_op(dst, amount)
            tx = make_tx(src, e.data.value.seqNum + 1, [op],
                         network_id=self.app.config.network_id())
            res = self.app.herder.recv_transaction(tx)
            return _submit_status(res)
        return self._on_main(run)

    def cmd_self_check(self, params):
        """Online self-check (reference ``self-check``): the bucket
        lists' hashes vs the LCL header commitment."""
        def run():
            ok = self.app.self_check()
            return {"status": "OK" if ok else "FAILED"}
        return self._on_main(run)

    def cmd_logrotate(self, params):
        """Reopen file log sinks (reference ``logrotate``)."""
        import logging

        def run():
            rotated = 0
            logger = logging.getLogger("stellar_tpu")
            for h in logger.handlers:
                if isinstance(h, logging.FileHandler):
                    h.acquire()
                    try:
                        h.close()
                        # next emit reopens the (possibly moved) path
                        h.stream = None
                    finally:
                        h.release()
                    rotated += 1
            return {"rotated": rotated}
        return self._on_main(run)

    def cmd_getledgerentryraw(self, params):
        """The QueryServer route (reference ``QueryServer.h:21-29``):
        hex-encoded LedgerKey XDR in, hex LedgerEntry XDR out."""
        from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
        from stellar_tpu_torch.xdr.types import LedgerEntry, LedgerKey
        keys = params.get("key", [])
        want_seq = params.get("ledgerSeq", [None])[0]

        def run():
            lm = self.app.lm
            cur = lm.ledger_seq
            out = {"ledgerSeq": cur, "entries": []}
            at_seq = None
            if want_seq is not None:
                # reference QUERY_SNAPSHOT_LEDGERS: point-in-time
                # reads within the retained reverse-delta window
                seq = int(want_seq)
                try:
                    lm.check_snapshot_seq(seq)
                except ValueError as e:
                    return {"error": str(e)}
                out["requestedLedgerSeq"] = seq
                if seq != cur:
                    at_seq = seq
                    out["ledgerSeq"] = seq
            for k in keys:
                kb = bytes.fromhex(k)
                from_bytes(LedgerKey, kb)  # validate
                if at_seq is not None:
                    raw = lm.entry_at(kb, at_seq)
                    out["entries"].append(
                        {"key": k,
                         "e": raw.hex() if raw is not None else None})
                else:
                    e = lm.root.store.get(kb)
                    out["entries"].append(
                        {"key": k,
                         "e": to_bytes(LedgerEntry, e).hex()
                         if e is not None else None})
            return out
        return self._on_main(run)

    ROUTES = {
        "info": cmd_info, "metrics": cmd_metrics, "peers": cmd_peers,
        "dispatch": cmd_dispatch, "spans": cmd_spans,
        "trace": cmd_trace, "journal": cmd_journal,
        "service": cmd_service,
        "pipeline": cmd_pipeline, "timeseries": cmd_timeseries,
        "slo": cmd_slo, "tenant": cmd_tenant,
        "control": cmd_control,
        "fleet": cmd_fleet, "ingress": cmd_ingress,
        "tx": cmd_tx, "manualclose": cmd_manualclose,
        "quorum": cmd_quorum, "scp": cmd_scp, "ll": cmd_ll,
        "bans": cmd_bans, "ban": cmd_ban, "unban": cmd_unban,
        "droppeer": cmd_droppeer, "upgrades": cmd_upgrades,
        "generateload": cmd_generate_load,
        "clearmetrics": cmd_clearmetrics, "connect": cmd_connect,
        "sorobaninfo": cmd_sorobaninfo,
        "dumpproposedsettings": cmd_dumpproposedsettings,
        "maintenance": cmd_maintenance,
        "getledgerentryraw": cmd_getledgerentryraw,
        "startsurveycollecting": cmd_start_survey_collecting,
        "stopsurveycollecting": cmd_stop_survey_collecting,
        "surveytopologytimesliced": cmd_survey_topology_timesliced,
        "getsurveyresult": cmd_get_survey_result,
        "setcursor": cmd_setcursor, "getcursor": cmd_getcursor,
        "dropcursor": cmd_dropcursor, "self-check": cmd_self_check,
        "logrotate": cmd_logrotate,
        "testacc": cmd_testacc, "testtx": cmd_testtx,
    }

    def _make_handler(outer_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                route = parsed.path.strip("/")
                fn = outer_self.routes.get(route)
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b'{"error": "unknown command"}')
                    return
                ctype = "application/json"
                try:
                    out = fn(outer_self, parse_qs(parsed.query))
                    if isinstance(out, _TextResponse):
                        body = out.encode()
                        ctype = out.content_type
                    else:
                        body = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)
        return Handler


class QueryServer(CommandHandler):
    """Separate read-only HTTP server answering ledger-entry queries
    (reference ``src/main/QueryServer.h:21-29`` — its own port so heavy
    query load can't crowd out operator commands). Concurrency is
    bounded by ``QUERY_THREAD_POOL_SIZE`` (reference requires it > 0
    with a query port, ``ApplicationImpl.cpp:713-716``)."""

    def __init__(self, app, port: int = 0):
        pool = getattr(getattr(app, "config", None),
                       "QUERY_THREAD_POOL_SIZE", 4)
        if pool <= 0:
            raise ValueError(
                "HTTP_QUERY_PORT requires QUERY_THREAD_POOL_SIZE > 0")
        self._query_slots = threading.BoundedSemaphore(pool)
        super().__init__(app, port, routes={
            "getledgerentryraw": QueryServer._gated_getledgerentryraw,
        })

    def _gated_getledgerentryraw(self, params):
        with self._query_slots:
            return CommandHandler.cmd_getledgerentryraw(self, params)
