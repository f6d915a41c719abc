"""Hierarchical async work system (reference ``src/work/BasicWork.h:102``
state machine, ``Work``, ``WorkScheduler``, ``BatchWork``,
``WorkSequence``, ``ConditionalWork``).

A BasicWork is a crank-driven state machine:
PENDING → RUNNING → {SUCCESS, FAILURE, RETRYING → PENDING…, ABORTED}.
``on_run`` does one bounded step and returns a State; WAITING means an
external event (timer, child, process exit) will wake it. Everything is
cranked on the main thread via the WorkScheduler — exactly the
reference's single-threaded discipline for catchup/publish pipelines.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from stellar_tpu_torch.utils.timer import VirtualClock, VirtualTimer

__all__ = ["State", "BasicWork", "Work", "WorkScheduler", "BatchWork",
           "WorkSequence", "FunctionWork", "ConditionalWork"]


class State:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    WAITING = "WAITING"
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"
    RETRYING = "RETRYING"
    ABORTED = "ABORTED"


RETRY_NEVER = 0
RETRY_ONCE = 1
RETRY_A_FEW = 5
RETRY_A_LOT = 32
RETRY_FOREVER = 0xFFFFFFFF


class BasicWork:
    """One unit of crank-driven work (reference ``BasicWork``)."""

    def __init__(self, name: str, max_retries: int = RETRY_A_FEW):
        self.name = name
        self.max_retries = max_retries
        self.state = State.PENDING
        self.retries = 0
        self._scheduler: Optional["WorkScheduler"] = None
        self._parent_work: Optional["Work"] = None
        self._retry_timer: Optional[VirtualTimer] = None

    # -- subclass hooks --

    def on_reset(self):
        pass

    def on_run(self) -> str:
        """Perform one step; return RUNNING (more to do), WAITING,
        SUCCESS, or FAILURE."""
        raise NotImplementedError

    def on_success(self):
        pass

    def on_failure_raise(self):
        pass

    def on_aborted(self):
        pass

    # -- driver interface --

    def is_done(self) -> bool:
        return self.state in (State.SUCCESS, State.FAILURE, State.ABORTED)

    def reset(self):
        self.state = State.PENDING
        self.retries = 0
        self.on_reset()

    def crank(self, clock: VirtualClock) -> None:
        if self.is_done() or self.state == State.WAITING:
            return
        if self.state == State.RETRYING:
            return  # timer will flip us back to PENDING
        self.state = State.RUNNING
        try:
            nxt = self.on_run()
        except Exception:
            nxt = State.FAILURE
        if nxt == State.FAILURE:
            if self.retries < self.max_retries:
                self.retries += 1
                self.state = State.RETRYING
                self._arm_retry(clock)
                return
            self.state = State.FAILURE
            self.on_failure_raise()
        elif nxt == State.SUCCESS:
            self.state = State.SUCCESS
            self.on_success()
        else:
            self.state = nxt

    def _retry_delay(self) -> float:
        # truncated exponential backoff (reference getRetryETA)
        return min(2.0 ** min(self.retries, 6), 64.0)

    def _arm_retry(self, clock: VirtualClock):
        if self._retry_timer is None:
            self._retry_timer = VirtualTimer(clock)
        self._retry_timer.expires_from_now(self._retry_delay())

        def fire():
            if self.state == State.RETRYING:
                self.state = State.PENDING
                self.on_reset()
                self._wake_ancestors()
        self._retry_timer.async_wait(fire)

    def _wake_ancestors(self):
        """Un-park WAITING ancestors and pump the owning scheduler —
        a nested work's timer must be able to resume the whole tree."""
        node = self
        root = self
        while node is not None:
            if node.state == State.WAITING:
                node.state = State.PENDING
            root = node
            node = getattr(node, "_parent_work", None)
        if root._scheduler is not None:
            root._scheduler._pump()

    def wake(self):
        """External event: WAITING -> RUNNING-eligible. Propagates up
        so a nested parked tree (parents WAITING on this child)
        resumes too."""
        if self.state == State.WAITING:
            self.state = State.PENDING
            self._wake_ancestors()

    def abort(self):
        if not self.is_done():
            self.state = State.ABORTED
            self.on_aborted()


class Work(BasicWork):
    """Work with children: runs children to completion, then its own
    ``do_work`` (reference ``Work::doWork`` + child management)."""

    def __init__(self, name: str, max_retries: int = RETRY_A_FEW):
        super().__init__(name, max_retries)
        self.children: List[BasicWork] = []
        self._clock: Optional[VirtualClock] = None

    def add_child(self, child: BasicWork) -> BasicWork:
        self.children.append(child)
        child._parent_work = self
        return child

    def insert_child(self, index: int, child: BasicWork) -> BasicWork:
        self.children.insert(index, child)
        child._parent_work = self
        return child

    def any_child_failed(self) -> bool:
        return any(c.state in (State.FAILURE, State.ABORTED)
                   for c in self.children)

    def all_children_successful(self) -> bool:
        return all(c.state == State.SUCCESS for c in self.children)

    def on_run(self) -> str:
        pending = [c for c in self.children if not c.is_done()]
        if pending:
            for c in pending:
                c.crank(self._clock)
            if self.any_child_failed():
                return State.FAILURE
            still = [c for c in pending if not c.is_done()]
            if still and all(
                    c.state in (State.RETRYING, State.WAITING)
                    for c in still):
                # nothing runnable until a child's timer/event fires;
                # park so the scheduler's action queue can drain and
                # (virtual) time can advance to fire that timer — the
                # child's wake propagates back up through _parent_work
                return State.WAITING
            return State.RUNNING
        if self.any_child_failed():
            return State.FAILURE
        return self.do_work()

    def do_work(self) -> str:
        return State.SUCCESS

    def crank(self, clock: VirtualClock) -> None:
        self._clock = clock
        super().crank(clock)

    def on_reset(self):
        for c in self.children:
            c.reset()


class WorkSequence(Work):
    """Children run strictly one after another (reference
    ``WorkSequence``)."""

    def on_run(self) -> str:
        for c in self.children:
            if c.is_done():
                if c.state != State.SUCCESS:
                    return State.FAILURE
                continue
            c.crank(self._clock)
            if c.state in (State.FAILURE, State.ABORTED):
                return State.FAILURE
            if c.state in (State.RETRYING, State.WAITING):
                return State.WAITING  # parked until the child wakes
            return State.RUNNING
        return self.do_work()


class BatchWork(Work):
    """Bounded-parallelism fan-out: yields children lazily, keeps at
    most ``max_parallel`` in flight (reference ``BatchWork``)."""

    def __init__(self, name: str, max_parallel: int = 8,
                 max_retries: int = RETRY_A_FEW):
        super().__init__(name, max_retries)
        self.max_parallel = max_parallel
        self._started = False

    def has_next(self) -> bool:
        raise NotImplementedError

    def yield_more_work(self) -> BasicWork:
        raise NotImplementedError

    def on_reset(self):
        self.children = []
        self._started = False
        super().on_reset()

    def on_run(self) -> str:
        in_flight = [c for c in self.children if not c.is_done()]
        while len(in_flight) < self.max_parallel and self.has_next():
            c = self.add_child(self.yield_more_work())
            in_flight.append(c)
        for c in in_flight:
            c.crank(self._clock)
        if self.any_child_failed():
            return State.FAILURE
        still = [c for c in in_flight if not c.is_done()]
        if still or self.has_next():
            if still and all(
                    c.state in (State.RETRYING, State.WAITING)
                    for c in still):
                # every in-flight child is parked on a timer/event —
                # even with more items queued, the parallelism cap is
                # full of parked children, so park too; the first
                # retry wake resumes and refills the window
                return State.WAITING
            return State.RUNNING
        return State.SUCCESS


class FunctionWork(BasicWork):
    """Wrap a callable; it may return a State or None (=SUCCESS)."""

    def __init__(self, name: str, fn: Callable[[], Optional[str]],
                 max_retries: int = RETRY_NEVER):
        super().__init__(name, max_retries)
        self.fn = fn

    def on_run(self) -> str:
        out = self.fn()
        return State.SUCCESS if out is None else out


class ConditionalWork(BasicWork):
    """Waits for a predicate, then runs the wrapped work (reference
    ``ConditionalWork``)."""

    def __init__(self, name: str, condition: Callable[[], bool],
                 inner: BasicWork):
        super().__init__(name, RETRY_NEVER)
        self.condition = condition
        self.inner = inner
        inner._parent_work = self
        self._clock = None

    def crank(self, clock):
        self._clock = clock
        super().crank(clock)

    def on_run(self) -> str:
        if not self.condition():
            return State.RUNNING
        self.inner.crank(self._clock)
        if self.inner.is_done():
            return self.inner.state
        return State.RUNNING


class WorkScheduler:
    """App-level root work cranked off the clock's action queue
    (reference ``WorkScheduler``)."""

    def __init__(self, clock: VirtualClock):
        self.clock = clock
        self.works: List[BasicWork] = []
        self._scheduled = False

    def schedule(self, work: BasicWork) -> BasicWork:
        work._scheduler = self
        self.works.append(work)
        self._pump()
        return work

    def _pump(self):
        if self._scheduled:
            return
        self._scheduled = True

        def step():
            self._scheduled = False
            # prune finished works: a long-running app schedules many
            # one-shot trees (catchup retries) and must not accumulate
            # them (or their downloaded payloads) forever
            self.works = [w for w in self.works if not w.is_done()]
            live = list(self.works)
            for w in live:
                w.crank(self.clock)
            # re-post only while something is actually runnable;
            # RETRYING/WAITING works are woken by their timers/events
            # (otherwise the action queue never drains and virtual
            # time cannot advance to fire those very timers)
            if any(w.state in (State.PENDING, State.RUNNING)
                   for w in self.works):
                self._pump()
        self.clock.post_action(step, name="work-scheduler")

    def wake(self):
        for w in self.works:
            w.wake()
        self._pump()

    def all_done(self) -> bool:
        return all(w.is_done() for w in self.works)

    def run_until_done(self, timeout: float = 60.0) -> bool:
        return self.clock.crank_until(self.all_done, timeout)
