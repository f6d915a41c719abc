"""Closed-loop control: the telemetry drives the verify service's
knobs — the port's copy of ``stellar_tpu/crypto/controller.py``.

Without it an operator reads the per-lane SLO burn rates and the
pipeline's bubble attribution and turns ``MAX_BATCH`` by
hand, and a load shift can burn the scp lane's 0.001 completion budget
before anyone reacts. This module is the deterministic feedback
controller that closes the loop:

* **inputs** are event-count telemetry windows the service assembles
  every ``CONTROL_EVERY`` collected batches: per-lane SLO burn rates
  from :data:`stellar_tpu_torch.crypto.verify_service.slo_monitor`,
  queue-wait bubble dominance from the pipeline timeline, per-lane
  backlog, the scp lane's head-of-line sequence age and the shed
  pressure level; each window is a plain dict of numbers;
* **decisions** adapt three knobs within clamped bounds: ``max_batch``
  (x2 or //2 inside ``[min_batch, batch_ceiling]``), ``pipeline_depth``
  (+-1 inside ``[1, max_pipeline_depth]``) and the shed-ladder entry
  threshold ``shed_highwater_frac`` (+-1/8 inside ``[HIGHWATER_MIN,
  HIGHWATER_MAX]``, exact binary steps). Bulk burn high with queue-wait
  bubbles dominant (or backlog over the pressure band) and scp healthy:
  grow batches. The scp objective threatened: shrink batches, raise the
  pipeline depth and lower the shed high-water. Everything inside the
  relax band: step each knob back toward its configured baseline;
* **hysteresis and cool-down** guard every move: a condition must hold
  for ``hysteresis`` consecutive windows before it acts, and a knob that
  moved is frozen for ``cooldown`` further windows; the deadband
  between :data:`ACT_BURN` and :data:`RELAX_BURN` keeps grow and relax
  from ping-ponging;
* **no clock read in any decision**: :meth:`VerifyController.step` is a
  pure function of the window it is handed and the controller's own
  bounded state, so two replicas fed the same window sequence produce
  identical knob trajectories.

Every step appends one tuple to the bounded
:meth:`VerifyController.control_log` (the bit-identity surface, beside
the service's scheduling ``decision_log``) and retains its input window
(:meth:`VerifyController.windows`); the service emits each knob move as
a ``service.control`` flight-recorder event carrying the window it acted
on. :meth:`VerifyController.replay` over the retained windows reproduces
the live log bit for bit.

Thread safety: controller state changes under ``self._lock``; the
service applies the resulting knob values under its own condition
variable (``VerifyService._apply_control_locked``), so scheduling always
reads a consistent knob set.
"""

from __future__ import annotations

import copy
import threading
from collections import deque
from typing import Dict, List, Optional


__all__ = ["VerifyController", "configure_control", "CONTROL_ENABLED",
           "CONTROL_EVERY", "ACT_BURN", "RELAX_BURN",
           "QUEUE_WAIT_DOMINANT", "HIGHWATER_MIN", "HIGHWATER_MAX",
           "HIGHWATER_STEP", "BACKLOG_PRESSURE_OF_HIGHWATER"]


# ---------------- control policy knobs ----------------
# Module constants, read from no environment option: a node pushes
# its Config knobs through configure_control() (same pattern as
# verify_service.configure_service). Disabled by default — closed-loop
# control is opt-in: attach one with VerifyService(controller=...).

CONTROL_ENABLED = False
# controller cadence: one window every N collected batches
# (event-count, never a timer)
CONTROL_EVERY = 8
# clamp bounds for the adapted knobs
CONTROL_MIN_BATCH = 32
CONTROL_MAX_BATCH = 8192
CONTROL_MAX_PIPELINE_DEPTH = 8
# hysteresis: consecutive windows a condition must hold before acting
CONTROL_HYSTERESIS = 2
# cool-down: windows a knob stays frozen after it moved
CONTROL_COOLDOWN = 4
# bounded control log / retained-window depth (the replay surface)
CONTROL_LOG = 4096

# ---------------- decision bands (constants, not knobs) ----------------
# burn rate past which an objective counts as threatened (1.0 = the
# error budget is burning exactly as fast as the objective allows)
ACT_BURN = 1.0
# every signal under this counts as healthy — the deadband between
# ACT_BURN and RELAX_BURN is what keeps grow/relax from ping-ponging
RELAX_BURN = 0.5
# queue_wait share of attributed bubble time past which queue-wait
# counts as the dominant bubble class
QUEUE_WAIT_DOMINANT = 0.5
# shed-highwater clamp + step: exact eighths, so repeated +-steps are
# binary-exact and replicas never drift by a rounding order
HIGHWATER_MIN = 0.25
HIGHWATER_MAX = 0.875
HIGHWATER_STEP = 0.125
# bulk backlog over this fraction OF the shed highwater counts as
# queue pressure — the deterministic stand-in for queue-wait bubble
# dominance when no device timeline exists (a stub verifier), and the
# early-warning band in live ones (sampling only at the highwater
# itself would race the shed pass that drains back under it)
BACKLOG_PRESSURE_OF_HIGHWATER = 0.5

_defaults_lock = threading.Lock()


def configure_control(enabled: Optional[bool] = None,
                      every: Optional[int] = None,
                      min_batch: Optional[int] = None,
                      max_batch: Optional[int] = None,
                      max_pipeline_depth: Optional[int] = None,
                      hysteresis: Optional[int] = None,
                      cooldown: Optional[int] = None,
                      log_cap: Optional[int] = None) -> None:
    """Push the control knobs (Config / tests); None keeps the current
    value. Instances read these at construction — push before the
    service is created (the Application does)."""
    global CONTROL_ENABLED, CONTROL_EVERY, CONTROL_MIN_BATCH
    global CONTROL_MAX_BATCH, CONTROL_MAX_PIPELINE_DEPTH
    global CONTROL_HYSTERESIS, CONTROL_COOLDOWN, CONTROL_LOG
    with _defaults_lock:
        if enabled is not None:
            CONTROL_ENABLED = bool(enabled)
        if every is not None:
            CONTROL_EVERY = max(1, int(every))
        if min_batch is not None:
            CONTROL_MIN_BATCH = max(1, int(min_batch))
        if max_batch is not None:
            CONTROL_MAX_BATCH = max(1, int(max_batch))
        if max_pipeline_depth is not None:
            CONTROL_MAX_PIPELINE_DEPTH = max(1, int(max_pipeline_depth))
        if hysteresis is not None:
            CONTROL_HYSTERESIS = max(1, int(hysteresis))
        if cooldown is not None:
            CONTROL_COOLDOWN = max(0, int(cooldown))
        if log_cap is not None:
            CONTROL_LOG = max(16, int(log_cap))


class VerifyController:
    """The deterministic feedback controller (module docstring). One
    instance belongs to one :class:`~stellar_tpu_torch.crypto.
    verify_service.VerifyService`; construction captures the service's
    CONFIGURED knob values as the relax baseline. ``step(window)`` is
    the whole control surface: pure arithmetic of the window plus the
    controller's bounded state — no clocks, no RNG, no I/O."""

    def __init__(self, max_batch: int, pipeline_depth: int,
                 shed_highwater_frac: float, *,
                 min_batch: Optional[int] = None,
                 batch_ceiling: Optional[int] = None,
                 max_pipeline_depth: Optional[int] = None,
                 hysteresis: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 log_cap: Optional[int] = None):
        self._lock = threading.Lock()
        self._min_batch = CONTROL_MIN_BATCH if min_batch is None \
            else max(1, int(min_batch))
        self._batch_ceiling = CONTROL_MAX_BATCH if batch_ceiling \
            is None else max(1, int(batch_ceiling))
        self._max_pd = CONTROL_MAX_PIPELINE_DEPTH \
            if max_pipeline_depth is None else max(1,
                                                   int(max_pipeline_depth))
        self._hysteresis = CONTROL_HYSTERESIS if hysteresis is None \
            else max(1, int(hysteresis))
        self._cooldown = CONTROL_COOLDOWN if cooldown is None \
            else max(0, int(cooldown))
        cap = CONTROL_LOG if log_cap is None else max(16, int(log_cap))
        # the baseline the relax band steps back toward — the
        # CONFIGURED values (sanitized, never re-shaped): an operator
        # knob outside the default clamp range WIDENS the clamp to
        # include it rather than being silently overridden — a
        # controller may never move a knob the operator set without a
        # logged decision
        base_mb = max(1, int(max_batch))
        base_pd = max(1, int(pipeline_depth))
        base_hw = min(1.0, max(0.01, float(shed_highwater_frac)))
        self._min_batch = min(self._min_batch, base_mb)
        self._batch_ceiling = max(self._batch_ceiling, base_mb)
        self._max_pd = max(self._max_pd, base_pd)
        self._hw_min = min(HIGHWATER_MIN, base_hw)
        self._hw_max = max(HIGHWATER_MAX, base_hw)
        self._base = {
            "max_batch": base_mb,
            "pipeline_depth": base_pd,
            "shed_highwater_frac": base_hw,
        }
        self._knobs = dict(self._base)
        self._seq = 0
        self._moves = 0
        self._streak = {"scp": 0, "bulk": 0, "healthy": 0}
        # knob -> first window seq at which it may move again
        self._frozen: Dict[str, int] = {}
        # compact per-step tuples: the bit-identity surface (mirror of
        # the service decision_log — deterministic fields ONLY)
        self._log: deque = deque(maxlen=cap)
        # full input windows, same depth: the replay surface
        self._windows: deque = deque(maxlen=cap)

    # clamp helpers read only the bound fields set above, so __init__
    # can use them while building _base (tests probe them directly)
    def _clamp_batch(self, v: int) -> int:
        return max(self._min_batch, min(self._batch_ceiling, int(v)))

    def _clamp_pd(self, v: int) -> int:
        return max(1, min(self._max_pd, int(v)))

    def _clamp_hw(self, v: float) -> float:
        return max(self._hw_min, min(self._hw_max, float(v)))

    # ---------------- public API ----------------

    def knobs(self) -> dict:
        """The controller's current knob values (the service applies
        these under its own lock after every step)."""
        with self._lock:
            return dict(self._knobs)

    def step(self, window: dict) -> List[dict]:
        """Evaluate ONE telemetry window; returns the list of applied
        knob moves (empty = hold). Appends one compact entry to the
        control log either way and retains the window for replay."""
        with self._lock:
            return self._step_locked(window)

    def control_log(self, limit: int = 0) -> list:
        """The bounded in-order control log: one
        ``(action, seq, max_batch, pipeline_depth, highwater_milli,
        reason)`` tuple per evaluated window (``action`` one of
        ``grow``/``shrink``/``relax``/``hold``). Two controllers fed
        the identical window sequence produce identical logs.
        ``limit`` bounds the tail returned (0 = all retained)."""
        with self._lock:
            log = list(self._log)
        return log[-limit:] if limit else log

    def journal_log(self, limit: int = 0) -> list:
        """The control log rendered as unified-journal rows: one dict
        per evaluated window, keyed by the window seq —
        already monotone and deterministic, so the journal merge can
        key control events by ``(component, seq)`` without a second
        counter. Same bit-identity contract as :meth:`control_log`."""
        return [
            {"seq": seq, "kind": "control", "action": action,
             "max_batch": mb, "pipeline_depth": pd,
             "highwater_milli": hw, "reason": reason}
            for action, seq, mb, pd, hw, reason
            in self.control_log(limit)]

    def windows(self, limit: int = 0) -> list:
        """The retained input windows, in step order (the replay
        input; bounded by the same cap as the log)."""
        with self._lock:
            out = [copy.deepcopy(w) for w in self._windows]
        return out[-limit:] if limit else out

    @property
    def moves(self) -> int:
        """Cumulative applied knob moves (the
        ``crypto.verify.control.decisions`` gauge)."""
        with self._lock:
            return self._moves

    def snapshot(self) -> dict:
        """The ``control`` admin-route payload: current/base knobs,
        clamp bounds, hysteresis state, accounting."""
        with self._lock:
            return {
                "windows": self._seq,
                "moves": self._moves,
                "knobs": dict(self._knobs),
                "base": dict(self._base),
                "clamps": {"min_batch": self._min_batch,
                           "batch_ceiling": self._batch_ceiling,
                           "max_pipeline_depth": self._max_pd,
                           "highwater_min": self._hw_min,
                           "highwater_max": self._hw_max},
                "hysteresis": self._hysteresis,
                "cooldown": self._cooldown,
                "streaks": dict(self._streak),
                "log_len": len(self._log),
            }

    def replay(self, windows) -> list:
        """Re-derive the knob trajectory from a window sequence: a
        FRESH controller with this one's configuration steps through
        ``windows`` and returns its control log. Replaying a live
        controller's own :meth:`windows` reproduces its
        :meth:`control_log` bit-for-bit WHILE the retained history is
        complete (first log entry still seq 1 — the log and window
        deques share one cap and evict in lockstep; past the cap,
        replay a captured prefix instead)."""
        with self._lock:
            twin = VerifyController(
                self._base["max_batch"], self._base["pipeline_depth"],
                self._base["shed_highwater_frac"],
                min_batch=self._min_batch,
                batch_ceiling=self._batch_ceiling,
                max_pipeline_depth=self._max_pd,
                hysteresis=self._hysteresis, cooldown=self._cooldown,
                log_cap=self._log.maxlen)
        for w in windows:
            twin.step(w)
        return twin.control_log()

    # ---------------- decision internals ----------------

    def _step_locked(self, window: dict) -> List[dict]:
        self._seq += 1
        seq = self._seq
        # DEEP copy on retention: the caller's window (with its nested
        # lane dicts) also rides the service.control recorder event —
        # a consumer mutating that event in place must never be able
        # to corrupt the retained replay surface
        self._windows.append(copy.deepcopy(window))
        lanes = window.get("lanes") or {}
        scp = lanes.get("scp") or {}
        bulk = lanes.get("bulk") or {}
        scp_burn = max(float(scp.get("latency_burn", 0.0)),
                       float(scp.get("shed_burn", 0.0)))
        bulk_burn = float(bulk.get("shed_burn", 0.0))
        lane_depth = max(1, int(window.get("lane_depth", 1)))
        backlog_frac = float(bulk.get("queued_submissions", 0)) \
            / lane_depth
        qw_frac = float(window.get("queue_wait_frac", 0.0))
        scp_queued = int(scp.get("queued_submissions", 0))
        hol_age = int(window.get("scp_hol_age", 0))
        pressure = int(window.get("pressure", 0))
        hw = self._knobs["shed_highwater_frac"]
        # backlog bands measure against the CONFIGURED baseline
        # highwater, never the adapted knob: measuring against the
        # adapted value is a self-reinforcing ratchet — a lowered
        # highwater lowers the pressure band, which keeps reporting
        # pressure, which keeps the healthy/relax branch unreachable
        # and pins the highwater at its floor forever
        band_hw = self._base["shed_highwater_frac"]
        # the three mutually-exclusive conditions; scp protection
        # wins. Beyond the (advisory, clock-derived) burn rate, two
        # DETERMINISTIC early signals threaten scp: the head-of-line
        # sequence age (a queued scp submission has watched a whole
        # lane-depth of newer admissions arrive while it waits — the
        # clock-free latency proxy) and dispatch-degraded pressure
        # with consensus work queued (capacity collapsed to the host
        # oracle: shrink the head-of-line block in front of scp NOW,
        # before the burn rate can show it)
        scp_threat = scp_burn > ACT_BURN or \
            (scp_queued > 0 and hol_age >= lane_depth) or \
            (scp_queued > 0 and pressure >= 2)
        backlog_pressure = backlog_frac >= \
            band_hw * BACKLOG_PRESSURE_OF_HIGHWATER
        bulk_pressure = (not scp_threat) and \
            (bulk_burn > ACT_BURN or backlog_pressure) and \
            (qw_frac >= QUEUE_WAIT_DOMINANT or backlog_pressure)
        healthy = (not scp_threat) and (not bulk_pressure) and \
            scp_burn < RELAX_BURN and bulk_burn < RELAX_BURN and \
            not backlog_pressure
        for cond, held in (("scp", scp_threat), ("bulk", bulk_pressure),
                           ("healthy", healthy)):
            self._streak[cond] = self._streak[cond] + 1 if held else 0
        # wants: (knob, target, action, reason) — applied only past
        # hysteresis and outside each knob's cool-down window
        wants: list = []
        if self._streak["scp"] >= self._hysteresis:
            action, reason = "shrink", "scp-threat"
            wants = [
                ("max_batch",
                 self._clamp_batch(self._knobs["max_batch"] // 2)),
                ("pipeline_depth",
                 self._clamp_pd(self._knobs["pipeline_depth"] + 1)),
                ("shed_highwater_frac",
                 self._clamp_hw(hw - HIGHWATER_STEP)),
            ]
        elif self._streak["bulk"] >= self._hysteresis:
            action = "grow"
            # the logged reason names EXACTLY the signals that fired
            # — an operator reading the control log must never see a
            # burn violation that did not happen
            sig = []
            if bulk_burn > ACT_BURN:
                sig.append("bulk-burn")
            if qw_frac >= QUEUE_WAIT_DOMINANT:
                sig.append("queue-wait")
            if backlog_pressure:
                sig.append("backlog")
            reason = "+".join(sig)
            wants = [
                ("max_batch",
                 self._clamp_batch(self._knobs["max_batch"] * 2)),
            ]
        elif self._streak["healthy"] >= self._hysteresis:
            action, reason = "relax", "healthy-relax"
            wants = [(k, self._toward_base_locked(k))
                     for k in self._knobs]
        else:
            action, reason = "hold", "no-condition"
        applied: List[dict] = []
        for knob, target in wants:
            if target == self._knobs[knob]:
                continue
            if seq < self._frozen.get(knob, 0):
                continue
            applied.append({"seq": seq, "action": action,
                            "knob": knob, "old": self._knobs[knob],
                            "new": target, "reason": reason})
            self._knobs[knob] = target
            self._frozen[knob] = seq + 1 + self._cooldown
            self._moves += 1
        if wants and not applied:
            # the condition held but every target was already at its
            # bound or frozen by a cool-down: the log says WHICH —
            # "at-base" (healthy, knobs steady at the configured
            # baseline) is a different operational state from
            # "at-bound" (a knob riding its clamp under sustained
            # pressure), and an operator must be able to tell them
            # apart from the log alone (replay reproduces either)
            frozen = any(t != self._knobs[k] and
                         seq < self._frozen.get(k, 0)
                         for k, t in wants)
            reason = "cooldown" if frozen else \
                ("at-base" if action == "relax" else "at-bound")
            action = "hold"
        self._log.append((
            action, seq, self._knobs["max_batch"],
            self._knobs["pipeline_depth"],
            int(round(self._knobs["shed_highwater_frac"] * 1000)),
            reason))
        return applied

    def _toward_base_locked(self, knob: str):
        """One relax step from the current value toward the
        configured baseline (never past it)."""
        cur, base = self._knobs[knob], self._base[knob]
        if cur == base:
            return cur
        if knob == "max_batch":
            return min(base, cur * 2) if cur < base \
                else max(base, cur // 2)
        if knob == "pipeline_depth":
            return cur + 1 if cur < base else cur - 1
        step = HIGHWATER_STEP
        return min(base, cur + step) if cur < base \
            else max(base, cur - step)
