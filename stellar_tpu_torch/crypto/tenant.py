"""Multi-tenant QoS primitives for the resident verify service — the
port's copy of ``stellar_tpu/crypto/tenant.py``.

The service's three priority lanes (``scp`` > ``auth`` > ``bulk``)
isolate workload classes; a node also serves many independent
submitters (validators hammering one verification service), where one
misbehaving submitter must degrade itself, not everyone sharing its
lane. This module supplies the tenant half:

* **tenant identities and policies**: a tenant is a short caller-chosen
  id (``[A-Za-z0-9][A-Za-z0-9._-]{0,63}``); each carries a scheduling
  weight and optional depth and byte quotas nested inside the lane's
  budgets. The implicit :data:`DEFAULT_TENANT` (un-tenanted submissions)
  is quota-exempt unless configured, so untagged callers see the lane
  budgets alone;
* **deterministic weighted-fair scheduling** (:class:`TenantLaneQueue`):
  start-time fair queueing over per-tenant FIFOs with sequence-based
  virtual time, integer arithmetic over admission sequence numbers and
  item counts, and no clock read in any scheduling decision, so two
  replicas fed the same arrival order produce identical dispatch
  orders;
* **per-tenant SLO burn rates** (:class:`TenantSloMonitor`): the lane
  :class:`~stellar_tpu_torch.crypto.verify_service.SloMonitor`'s
  discipline (event-count sliding windows; burn = observed bad fraction
  / budgeted bad fraction) per tenant, with a metric-cardinality guard:
  gauges are published under rank-keyed names
  (``crypto.verify.tenant.topk.<rank>.*`` and a ``.id`` label gauge
  naming the tenant) plus a ``tenant.other`` rollup, so any number of
  tenants mints a bounded set of series.

The tenant-keyed shed draw lives in
:func:`stellar_tpu_torch.crypto.audit.keep_under_shed` (``tenant=``);
this module resolves each tenant's effective keep fraction
(:func:`shed_keep_fraction`): a tenant over its own quota high-water
sheds proportionally harder, so a flooding tenant's rows go first while
in-quota tenants keep the lane's ladder fraction.

Thread safety: policy and monitor state change under this module's
locks; :class:`TenantLaneQueue` owns no lock: it is service-internal
state, touched only with the service's condition variable held (the
``_locked`` calling convention of ``verify_service``).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from stellar_tpu_torch.utils.metrics import (
    fresh_burn_window, push_burn_window, registry, trim_burn_window,
)

__all__ = [
    "DEFAULT_TENANT", "OTHER_TENANT", "WFQ_SCALE",
    "TenantLaneQueue", "TenantSloMonitor", "tenant_slo",
    "validate_tenant", "shed_key", "shed_keep_fraction",
    "tenant_policy", "set_tenant_policy", "configure_tenants",
    "clear_tenant_policies", "peer_tenant",
]

# the implicit tenant of un-tenanted submissions; quota-exempt unless
# explicitly configured, so pre-tenant callers keep their exact
# admission behavior (the lane budgets still bound them)
DEFAULT_TENANT = "default"

# reserved rollup id for tenants past the tracking cap ("~" is outside
# the tenant-id alphabet, so no real tenant can collide with it)
OTHER_TENANT = "~other"

# virtual-time scale: costs are integers (items x WFQ_SCALE / weight)
# so the scheduler's arithmetic is exact — no float drift between
# replicas, no rounding order-dependence
WFQ_SCALE = 1 << 20

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}\Z")

# ---------------- policy knobs ----------------
# Module constants, read from no environment option: a node pushes
# its Config knobs through configure_tenants() (same pattern as
# verify_service.configure_service). 0 = unlimited:
# tenancy is opt-in — quotas bind only once an operator sizes them.

TENANT_DEPTH = 0
TENANT_BYTES = 0
# rank-keyed burn-rate gauges published per snapshot (the
# metric-cardinality guard's K)
TENANT_TOPK = 8
# hard cap on individually-tracked tenants (counters + SLO windows);
# tenants past the cap fold into OTHER_TENANT — counted, never silent
TENANT_TRACK_CAP = 4096
# per-tenant SLO defaults (the bulk-lane shape: tenants are submitter
# populations, not consensus lanes)
TENANT_P99_MS = 30000.0
TENANT_LATENCY_TARGET = 0.99
TENANT_SHED_BUDGET = 0.5
TENANT_SLO_WINDOW = 256
# fraction of a tenant's depth quota at which its backlog counts as
# over high-water for the shed pass (mirrors SHED_HIGHWATER_FRAC)
TENANT_HIGHWATER_FRAC = 0.75
# tenant identity adoption: when on,
# the herder SCP-envelope and overlay peer-auth adopters tag their
# service round trips tenant="peer-<id prefix>" via peer_tenant(), so
# REAL peers ride per-tenant quotas/fair-share/burn rates. Off by
# default — identity-to-tenant mapping is an operator policy choice
# (pre-adoption behavior stays byte-identical).
TENANT_FROM_PEER = False
# hex bytes of the peer id used as the tenant tag: 4 bytes = 8 hex
# chars, collision-safe for committee-scale fleets while keeping ids
# short enough for metric/event attributes
PEER_TENANT_PREFIX_BYTES = 4

_policy_lock = threading.Lock()
# tenant -> {"weight": int, "depth": Optional[int],
#            "bytes": Optional[int]} (None = inherit the global knob)
_policies: Dict[str, dict] = {}


def configure_tenants(depth: Optional[int] = None,
                      nbytes: Optional[int] = None,
                      topk: Optional[int] = None,
                      track_cap: Optional[int] = None,
                      p99_ms: Optional[float] = None,
                      latency_target: Optional[float] = None,
                      shed_budget: Optional[float] = None,
                      window: Optional[int] = None,
                      from_peer: Optional[bool] = None) -> None:
    """Push the global tenant knobs (Config / tools); None keeps the
    current value. Quota knobs take effect on the next admission
    check; SLO knobs on the next window push."""
    global TENANT_DEPTH, TENANT_BYTES, TENANT_TOPK, TENANT_TRACK_CAP
    global TENANT_P99_MS, TENANT_LATENCY_TARGET, TENANT_SHED_BUDGET
    global TENANT_FROM_PEER
    with _policy_lock:
        if from_peer is not None:
            TENANT_FROM_PEER = bool(from_peer)
        if depth is not None:
            TENANT_DEPTH = max(0, int(depth))
        if nbytes is not None:
            TENANT_BYTES = max(0, int(nbytes))
        if topk is not None:
            TENANT_TOPK = max(1, int(topk))
        if track_cap is not None:
            TENANT_TRACK_CAP = max(8, int(track_cap))
        if p99_ms is not None:
            TENANT_P99_MS = max(1.0, float(p99_ms))
        if latency_target is not None:
            TENANT_LATENCY_TARGET = min(0.999999,
                                        max(0.0, float(latency_target)))
        if shed_budget is not None:
            TENANT_SHED_BUDGET = min(1.0, max(1e-6, float(shed_budget)))
    tenant_slo.configure(window=window)


def set_tenant_policy(tenant: str, weight: Optional[int] = None,
                      depth: Optional[int] = None,
                      nbytes: Optional[int] = None) -> None:
    """Per-tenant override: scheduling weight (fair-share multiplier,
    >= 1) and/or quota overrides. Setting a policy on
    :data:`DEFAULT_TENANT` opts the un-tenanted stream into quotas."""
    t = validate_tenant(tenant)
    with _policy_lock:
        pol = _policies.setdefault(t, {"weight": 1, "depth": None,
                                       "bytes": None})
        if weight is not None:
            pol["weight"] = max(1, int(weight))
        if depth is not None:
            pol["depth"] = max(0, int(depth))
        if nbytes is not None:
            pol["bytes"] = max(0, int(nbytes))


def clear_tenant_policies() -> None:
    """Drop every per-tenant override (tests / reconfiguration)."""
    with _policy_lock:
        _policies.clear()


def tenant_policy(tenant: str) -> Tuple[int, int, int]:
    """Resolved ``(weight, depth_quota, byte_quota)`` for ``tenant``
    (0 = unlimited). The default tenant inherits NO quota unless a
    policy was set explicitly — lane budgets alone bound the
    un-tenanted stream, exactly the pre-tenant behavior."""
    with _policy_lock:
        pol = _policies.get(tenant)
        if pol is not None:
            depth = TENANT_DEPTH if pol["depth"] is None else pol["depth"]
            nbytes = TENANT_BYTES if pol["bytes"] is None else pol["bytes"]
            return pol["weight"], depth, nbytes
        if tenant == DEFAULT_TENANT:
            return 1, 0, 0
        return 1, TENANT_DEPTH, TENANT_BYTES


def validate_tenant(tenant: Optional[str]) -> str:
    """Normalize + validate a caller-supplied tenant id (None -> the
    default tenant). Ids are bounded and alphanumeric-ish so they are
    safe as metric/event attribute values."""
    if tenant is None:
        return DEFAULT_TENANT
    if not isinstance(tenant, str) or not _ID_RE.match(tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r} (want "
            "[A-Za-z0-9][A-Za-z0-9._-]{0,63})")
    return tenant


def peer_tenant(peer_id: Optional[bytes]) -> Optional[str]:
    """The tenant tag for one real peer identity:
    ``"peer-<first 4 bytes hex>"`` of an ed25519 node id when
    :data:`TENANT_FROM_PEER` is on, else ``None`` (the quota-exempt
    un-tenanted stream — byte-identical pre-adoption admission). The
    tag is derived from the PUBLIC identity alone, so every replica
    maps one peer to one tenant without coordination."""
    if not TENANT_FROM_PEER or not peer_id:
        return None
    if not isinstance(peer_id, (bytes, bytearray)) or \
            len(peer_id) < PEER_TENANT_PREFIX_BYTES:
        return None
    return "peer-" + bytes(peer_id[:PEER_TENANT_PREFIX_BYTES]).hex()


def shed_key(tenant: str) -> bytes:
    """The tenant key mixed into the content-seeded shed draw
    (:func:`stellar_tpu_torch.crypto.audit.keep_under_shed`). Empty for the
    default tenant, so pre-tenant replicas' draws are byte-identical
    to the historical rule."""
    return b"" if tenant == DEFAULT_TENANT else tenant.encode("ascii")


def shed_keep_fraction(base_keep: float, queued_subs: int,
                       depth_quota: int, level: int = 1) -> float:
    """A tenant's effective keep fraction for one shed pass.

    Three regimes, all pure arithmetic of queue state (deterministic
    in arrival order, no clocks, no RNG):

    * **quota-less tenants** (``depth_quota`` 0 — including the
      default/un-tenanted stream): the lane-ladder fraction
      ``base_keep``, exactly the pre-tenant rule;
    * **in-quota tenants** (backlog <= their quota high-water): at
      shed level 1 (backlog) they are PROTECTED (keep 1.0) — their
      possible backlog is bounded by their quota, so the flood valve
      targets the offenders instead of taxing everyone; at level >= 2
      (dispatch-degraded — capacity itself collapsed) nobody is
      protected and they keep ``base_keep``;
    * **over-quota tenants**: ``base_keep`` divided by how far over
      high-water they sit — a flooder at 8x keeps ``base_keep / 8``:
      its own rows shed first.
    """
    if depth_quota <= 0 or queued_subs <= 0:
        return base_keep
    highwater = max(1, int(depth_quota * TENANT_HIGHWATER_FRAC))
    over = queued_subs / highwater
    if over <= 1.0:
        return base_keep if level >= 2 else 1.0
    return base_keep / over


class TenantLaneQueue:
    """Deterministic weighted-fair queue of admitted submissions for
    ONE lane: per-tenant FIFOs under start-time fair queueing.

    Virtual-time accounting (all Python ints, exact):

    * a submission of ``n`` items from tenant ``t`` (weight ``w``)
      gets ``vstart = max(lane_vtime, t's last vfinish)`` and
      ``vfinish = vstart + max(1, n) * WFQ_SCALE // w``;
    * :meth:`pop` serves the tenant head with the smallest
      ``(vfinish, seq)`` — seq (the admission sequence number) breaks
      ties, so the minimum is unique and the dispatch order is a pure
      function of arrival order;
    * lane virtual time advances to the served head's ``vstart``
      (start-time fair queueing), so a tenant idling through a busy
      period re-enters at the CURRENT virtual time — it cannot bank
      idle credit and then monopolize the lane.

    No clocks, no RNG, no per-process hash state anywhere in the
    decision path (nondet-lint scoped, no allowlist). NOT thread-safe
    by itself: every method is called with the owning service's
    condition variable held."""

    __slots__ = ("_q", "_vfin_last", "_vtime", "_bytes", "_len")

    def __init__(self):
        self._q: Dict[str, deque] = {}
        self._vfin_last: Dict[str, int] = {}
        self._vtime = 0
        self._bytes: Dict[str, int] = {}
        # maintained submission count: __len__ runs on EVERY admission
        # check and gauge publish under the service's hot lock, so it
        # must not walk the per-tenant FIFOs
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def depth(self, tenant: str) -> int:
        """Queued submissions for ``tenant`` (the depth-quota check)."""
        q = self._q.get(tenant)
        return len(q) if q else 0

    def queued_bytes(self, tenant: str) -> int:
        """Queued bytes for ``tenant`` (the byte-quota check)."""
        return self._bytes.get(tenant, 0)

    def tenant_depths(self) -> Dict[str, int]:
        """{tenant: queued submissions} over nonempty tenants (the
        shed pass reads this once per pass)."""
        return {t: len(q) for t, q in self._q.items() if q}

    def push(self, tkt, weight: int) -> None:
        """Admit one ticket (its ``tenant``/``n_items``/``_nbytes``
        already set); stamps ``_vstart``/``_vfinish`` on the ticket."""
        t = tkt.tenant
        vstart = max(self._vtime, self._vfin_last.get(t, 0))
        cost = max(1, tkt.n_items) * WFQ_SCALE // max(1, weight)
        tkt._vstart = vstart
        tkt._vfinish = vstart + cost
        self._vfin_last[t] = tkt._vfinish
        self._q.setdefault(t, deque()).append(tkt)
        self._bytes[t] = self._bytes.get(t, 0) + tkt._nbytes
        self._len += 1

    def _best(self):
        """The head ticket with the smallest (vfinish, seq) — the
        WFQ decision. Dict iteration is insertion-ordered, itself a
        function of arrival order, and seq is globally unique, so the
        minimum (and thus the whole dispatch order) is replica-exact."""
        best = None
        for q in self._q.values():
            if not q:
                continue
            head = q[0]
            if best is None or \
                    (head._vfinish, head._seq) < (best._vfinish,
                                                  best._seq):
                best = head
        return best

    def peek(self):
        """The ticket :meth:`pop` would serve next (or None)."""
        return self._best()

    def pop(self, head=None):
        """Serve the WFQ winner: returns ``(ticket, decision)`` or
        ``None``. ``decision`` is the replay-testable record of this
        scheduling choice — the chosen tenant/seq, its virtual times,
        the lane virtual time it advanced, and the candidate window
        the choice was made over. Pass the ticket a preceding
        :meth:`peek` returned (with no intervening mutation) to skip
        re-running the winner scan — the collect loop peeks to check
        batch fit, and the scan is O(active tenants)."""
        if head is None:
            head = self._best()
        if head is None:
            return None
        t = head.tenant
        candidates = sum(1 for q in self._q.values() if q)
        self._q[t].popleft()
        self._len -= 1
        self._bytes[t] = max(0, self._bytes.get(t, 0) - head._nbytes)
        self._vtime = max(self._vtime, head._vstart)
        self._prune(t)
        decision = {"tenant": t, "seq": head._seq,
                    "vstart": head._vstart, "vfinish": head._vfinish,
                    "vtime": self._vtime, "candidates": candidates}
        return head, decision

    def _prune(self, tenant: str) -> None:
        """Drop idle per-tenant state once it can no longer influence
        a decision: an empty FIFO whose last vfinish is <= the lane
        virtual time would resolve to the same vstart either way, so
        forgetting it keeps memory proportional to ACTIVE tenants, not
        every tenant ever seen."""
        q = self._q.get(tenant)
        if q is not None and not q:
            del self._q[tenant]
            self._bytes.pop(tenant, None)
            if self._vfin_last.get(tenant, 0) <= self._vtime:
                self._vfin_last.pop(tenant, None)

    def oldest_seq(self) -> Optional[int]:
        """Smallest admission seq among tenant heads — what the
        service's sequence-based aging rule compares across lanes."""
        heads = [q[0]._seq for q in self._q.values() if q]
        return min(heads) if heads else None

    def drain_if(self, keep_fn) -> list:
        """Filter the whole lane in one deterministic sweep (the shed
        pass / abort path): ``keep_fn(ticket)`` decides per ticket;
        removed tickets are returned in iteration order (tenant
        insertion order, FIFO within tenant) with accounting updated.
        ``keep_fn=None`` removes everything."""
        removed = []
        for t in list(self._q):
            q = self._q[t]
            kept: deque = deque()
            while q:
                tkt = q.popleft()
                if keep_fn is not None and keep_fn(tkt):
                    kept.append(tkt)
                else:
                    removed.append(tkt)
                    self._len -= 1
                    self._bytes[t] = max(
                        0, self._bytes.get(t, 0) - tkt._nbytes)
            if kept:
                self._q[t] = kept
            else:
                self._prune(t)
        return removed


# ---------------- per-tenant SLO burn rates ----------------


class TenantSloMonitor:
    """Per-tenant error-budget accounting — the lane ``SloMonitor``
    discipline (event-count sliding windows, no wall-clock buckets)
    keyed by tenant, with the metric-cardinality guard built in.

    Two objectives per tenant, same semantics as the lane monitor:

    * **latency** — fraction of completed items whose lane wait
      exceeded :data:`TENANT_P99_MS`, budgeted at
      ``1 - TENANT_LATENCY_TARGET``;
    * **completion** — fraction of terminal items that were
      shed/rejected/failed, budgeted at :data:`TENANT_SHED_BUDGET`.

    Cardinality: at most :data:`TENANT_TRACK_CAP` tenants carry
    individual windows (later arrivals fold into
    :data:`OTHER_TENANT`, counted in ``overflow_folded``), and the
    ONLY gauges ever minted are the rank-keyed
    ``crypto.verify.tenant.topk.<rank>.{burn_rate,shed_burn_rate,
    latency_burn_rate,id}`` set (K of them), the ``tenant.other.*``
    rollup, and two accounting gauges — a fixed series budget however
    many tenants exist or churn through the top-K."""

    def __init__(self, window: Optional[int] = None):
        self._lock = threading.Lock()
        self._window = TENANT_SLO_WINDOW if window is None \
            else max(8, int(window))
        # tenant -> {"lat": state, "comp": state}; state is the
        # SloMonitor shape: deque of 0/1 + running counters
        self._tenants: Dict[str, dict] = {}
        self._overflow_folded = 0
        self._events = 0
        # highest rank ever published: a shrunken top-K (fewer
        # tenants, or a lowered TENANT_TOPK push) must ZERO the ranks
        # it no longer writes — the registry has no delete, and a
        # frozen stale burn rate on a dashboard is worse than none
        self._published_ranks = 0

    # window-state machinery is the shared metrics helpers (ONE
    # implementation for the lane and tenant monitors)
    _fresh = staticmethod(fresh_burn_window)

    def configure(self, window: Optional[int] = None) -> None:
        if window is None:
            return
        with self._lock:
            self._window = max(8, int(window))
            for st in self._tenants.values():
                for obj in st.values():
                    self._trim_locked(obj)

    def _trim_locked(self, st: dict) -> None:
        trim_burn_window(st, self._window)

    def _state_locked(self, tenant: str) -> dict:
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= TENANT_TRACK_CAP and \
                    tenant != OTHER_TENANT:
                self._overflow_folded += 1
                return self._state_locked(OTHER_TENANT)
            st = self._tenants[tenant] = {"lat": self._fresh(),
                                          "comp": self._fresh()}
        return st

    def _push_locked(self, st: dict, bad: bool, n: int) -> None:
        push_burn_window(st, bad, n, self._window)

    def note_latency(self, tenant: str, wait_ms: float,
                     n: int = 1) -> None:
        """``n`` of ``tenant``'s items completed with this lane wait
        (the same allowlisted stamp the lane histograms consume — the
        monitor itself never reads a clock)."""
        bad = wait_ms > TENANT_P99_MS
        with self._lock:
            self._push_locked(self._state_locked(tenant)["lat"],
                              bad, n)
            publish = self._tick_locked(n)
        if publish:
            self.publish_topk()

    def note_completion(self, tenant: str, ok: bool,
                        n: int = 1) -> None:
        """``n`` of ``tenant``'s items reached a terminal state
        (``ok=False`` for shed / quota-rejected / failed)."""
        with self._lock:
            self._push_locked(self._state_locked(tenant)["comp"],
                              not ok, n)
            publish = self._tick_locked(n)
        if publish:
            self.publish_topk()

    def _tick_locked(self, n: int) -> bool:
        """Deterministic publish cadence: refresh the rank-keyed
        gauges every 512 recorded events (event-count, not clock)."""
        before = self._events
        self._events += n
        return (before // 512) != (self._events // 512)

    @staticmethod
    def _burns(st: dict) -> Tuple[float, float]:
        """(latency_burn, shed_burn) over the current windows."""
        out = []
        for key, budget in (("lat", max(1e-9,
                                        1.0 - TENANT_LATENCY_TARGET)),
                            ("comp", max(1e-9, TENANT_SHED_BUDGET))):
            obj = st[key]
            n = len(obj["events"])
            frac = (obj["bad"] / n) if n else 0.0
            out.append(round(frac / budget, 4))
        return out[0], out[1]

    def _ranked_locked(self) -> List[tuple]:
        """[(combined_burn, latency_burn, shed_burn, tenant)] sorted
        worst-first; ties break by tenant id so the ranking (and the
        published gauge set) is deterministic."""
        rows = []
        for t, st in self._tenants.items():
            lat, comp = self._burns(st)
            rows.append((max(lat, comp), lat, comp, t))
        rows.sort(key=lambda r: (-r[0], r[3]))
        return rows

    def publish_topk(self) -> List[dict]:
        """Refresh the rank-keyed burn gauges: top-K tenants by burn
        rate individually, everyone else aggregated into the
        ``tenant.other`` rollup. Returns the published top rows (the
        admin/telemetry payload)."""
        with self._lock:
            k = TENANT_TOPK
            ranked = self._ranked_locked()
            top = ranked[:k]
            rest = ranked[k:]
            # the rollup aggregates the REST's window counts, so its
            # burn is the population's, not an average of averages
            o_lat_bad = o_lat_n = o_comp_bad = o_comp_n = 0
            for _b, _l, _c, t in rest:
                st = self._tenants[t]
                o_lat_bad += st["lat"]["bad"]
                o_lat_n += len(st["lat"]["events"])
                o_comp_bad += st["comp"]["bad"]
                o_comp_n += len(st["comp"]["events"])
            tracked = len(self._tenants)
            overflow = self._overflow_folded
            stale_ranks = range(len(top), self._published_ranks)
            self._published_ranks = len(top)
        out = []
        for i in stale_ranks:
            base = f"crypto.verify.tenant.topk.{i}"
            registry.gauge(f"{base}.burn_rate").set(0.0)
            registry.gauge(f"{base}.latency_burn_rate").set(0.0)
            registry.gauge(f"{base}.shed_burn_rate").set(0.0)
            registry.gauge(f"{base}.id").set("")
        for i, (burn, lat, comp, t) in enumerate(top):
            base = f"crypto.verify.tenant.topk.{i}"
            registry.gauge(f"{base}.burn_rate").set(burn)
            registry.gauge(f"{base}.latency_burn_rate").set(lat)
            registry.gauge(f"{base}.shed_burn_rate").set(comp)
            registry.gauge(f"{base}.id").set(t)
            out.append({"rank": i, "tenant": t, "burn_rate": burn,
                        "latency_burn_rate": lat,
                        "shed_burn_rate": comp})
        lat_budget = max(1e-9, 1.0 - TENANT_LATENCY_TARGET)
        comp_budget = max(1e-9, TENANT_SHED_BUDGET)
        registry.gauge("crypto.verify.tenant.other.latency_burn_rate"
                       ).set(round((o_lat_bad / o_lat_n) / lat_budget,
                                   4) if o_lat_n else 0.0)
        registry.gauge("crypto.verify.tenant.other.shed_burn_rate"
                       ).set(round((o_comp_bad / o_comp_n)
                                   / comp_budget, 4)
                             if o_comp_n else 0.0)
        registry.gauge("crypto.verify.tenant.other.tenants").set(
            max(0, tracked - len(top)))
        registry.gauge("crypto.verify.tenant.tracked").set(tracked)
        registry.gauge("crypto.verify.tenant.overflow_folded").set(
            overflow)
        return out

    def burn_rates(self, tenant: str) -> Optional[dict]:
        """One tenant's current burn rates (None if untracked)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return None
            lat, comp = self._burns(st)
            return {"latency_burn_rate": lat, "shed_burn_rate": comp,
                    "latency_n": len(st["lat"]["events"]),
                    "completion_n": len(st["comp"]["events"])}

    def snapshot(self, top: Optional[int] = None) -> dict:
        """The ``tenant`` admin-route SLO payload: top rows (also
        refreshes the rank-keyed gauges), rollup accounting, window
        config."""
        rows = self.publish_topk()
        if top is not None:
            rows = rows[:max(0, int(top))]
        with self._lock:
            return {
                "window": self._window,
                "tracked": len(self._tenants),
                "track_cap": TENANT_TRACK_CAP,
                "overflow_folded": self._overflow_folded,
                "topk": TENANT_TOPK,
                "p99_ms": TENANT_P99_MS,
                "latency_target": TENANT_LATENCY_TARGET,
                "shed_budget": TENANT_SHED_BUDGET,
                "top": rows,
            }

    def _reset_for_testing(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._overflow_folded = 0
            self._events = 0


# process-wide monitor (every service instance feeds it, like the
# lane SloMonitor — one node per process in production)
tenant_slo = TenantSloMonitor()
