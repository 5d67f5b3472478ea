"""Instrumented event-driven execution substrate.

Two execution backends:

* :class:`Sim` — a deterministic discrete-event simulator with ``k`` worker
  slots and a dedicated master lane.  All of the paper's §2 overhead metrics
  are tracked *exactly* (they are object-lifetime counts, machine
  independent), and the makespan gives the wall-time trends of §5.2 without
  noise from the host (this container has a single core).

* :class:`ThreadedAutodec` (in ``threaded.py``) — a real thread-pool runtime
  for the autodec model, proving the atomic get-or-create under true
  concurrency.

Overhead gauges (paper Table 2):
  ``startup``        sequential master ops before the first task can start
  ``spatial``        live synchronization objects (edges / tags / counters)
  ``inflight_tasks`` tasks known to the scheduler but not yet ready/running
  ``inflight_deps``  unresolved dependence objects
  ``garbage``        objects whose last use has passed but not yet destroyed
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


class Gauge:
    """Current value + high-water mark."""

    __slots__ = ("cur", "peak", "total")

    def __init__(self) -> None:
        self.cur = 0
        self.peak = 0
        self.total = 0

    def inc(self, k: int = 1) -> None:
        self.cur += k
        self.total += k
        if self.cur > self.peak:
            self.peak = self.cur

    def dec(self, k: int = 1) -> None:
        self.cur -= k


@dataclass
class Counters:
    """The five Table-2 overheads + makespan, measured not asserted."""
    startup_ops: int = 0
    spatial: Gauge = field(default_factory=Gauge)
    inflight_tasks: Gauge = field(default_factory=Gauge)
    inflight_deps: Gauge = field(default_factory=Gauge)
    garbage: Gauge = field(default_factory=Gauge)
    makespan: float = 0.0
    master_ops: int = 0

    def summary(self) -> dict:
        return {
            "startup_ops": self.startup_ops,
            "spatial_peak": self.spatial.peak,
            "inflight_tasks_peak": self.inflight_tasks.peak,
            "inflight_deps_peak": self.inflight_deps.peak,
            "garbage_peak": self.garbage.peak,
            "sync_objects_total": self.spatial.total,
            "makespan": self.makespan,
            "master_ops": self.master_ops,
        }


class Sim:
    """Discrete-event simulator: ``workers`` task slots + 1 master lane.

    The master runs a generator of setup *ops*; each op costs ``setup_cost``
    time on the master lane.  Tasks cost ``task_dur`` and occupy a worker.
    Models dispatch ready tasks via :meth:`make_ready`; whether tasks may
    start before the master finishes is the model's choice (``gate``).
    """

    def __init__(self, workers: int = 4, task_dur: float = 1.0,
                 setup_cost: float = 0.01,
                 on_task_error: Optional[Callable] = None,
                 on_start: Optional[Callable] = None):
        self.workers = workers
        self.task_dur = task_dur
        self.setup_cost = setup_cost
        # Start hook: called with the task key at dispatch time, after the
        # task is recorded in exec_order and before its completion is
        # scheduled.  The sync models hang their GC-at-start side effects
        # here (syncmodels.py) — it is part of the dispatch loop proper, so
        # model instrumentation can never drift from the real exactly-once
        # guard / worker accounting the way a monkey-patched clone of
        # _dispatch would.  Settable after construction.
        self.on_start = on_start
        # Robustness hook: with on_task_error set, a run_fn exception is
        # caught at completion time — recorded in task_errors and reported
        # to the callback — instead of unwinding through run() and leaving
        # the event heap mid-dispatch (a wedged simulator).  The failed
        # task's worker slot is freed either way.
        self.on_task_error = on_task_error
        self.task_errors: list = []
        self.now = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self.free = workers
        # FIFO of (task_key, run_fn); deque so dispatch is O(1) per task
        # (list.pop(0) made the ready queue O(n^2) at scale).
        self.ready: deque = deque()
        self.gate_open = True
        self.counters = Counters()
        self._started_any = False
        self.exec_order: list = []
        self.running = 0
        # Exactly-once guard: every key ever enqueued.  A task made ready
        # twice would double-start and leak counters (the class of bug a
        # threaded stress test once caught in ThreadedAutodec); the Sim
        # layer rejects it at enqueue time rather than mis-counting later.
        self._enqueued: set = set()

    # ---------------------------------------------------------------- events
    def at(self, dt: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (self.now + dt, next(self._seq), fn))

    def run(self) -> None:
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        self.counters.makespan = self.now

    # ---------------------------------------------------------------- master
    def run_master(self, ops, gate_after_all: bool) -> None:
        """Schedule master setup ops; optionally gate task execution on them.

        ``ops`` is an iterable of callables.  With ``gate_after_all`` the gate
        opens only when every op has run (prescribed / counted models); the
        number of ops before the gate opens is the sequential start-up
        overhead.  Without it the gate is open from the start (tags /
        autodec): setup overlaps execution.
        """
        ops = list(ops)
        self.gate_open = not gate_after_all
        n = len(ops)
        self.counters.master_ops += n
        self.counters.startup_ops += n if gate_after_all else min(1, n)

        def step(i: int) -> None:
            if i < n:
                ops[i]()
                self.at(self.setup_cost, lambda: step(i + 1))
            else:
                if gate_after_all:
                    self.gate_open = True
                    self._dispatch()

        self.at(0.0, lambda: step(0))

    # ---------------------------------------------------------------- tasks
    def _claim(self, key) -> None:
        """Record ``key`` as enqueued; reject a second make-ready of it."""
        if key in self._enqueued:
            raise ValueError(
                f"task {key!r} was already made ready: a duplicate enqueue "
                f"would double-start it and corrupt the overhead counters")
        self._enqueued.add(key)

    def make_ready(self, key, run_fn: Callable[[], None]) -> None:
        self._claim(key)
        self.ready.append((key, run_fn))
        self._dispatch()

    def make_ready_batch(self, items) -> None:
        """Enqueue a whole wavefront level in one call.

        ``items`` is an iterable of ``(key, run_fn)`` pairs; the queue is
        extended en bloc and dispatched once — level-sized batches from the
        wavefront scheduler don't pay a dispatch attempt per task.  Each
        key must be new to this Sim (exactly-once; ``ValueError`` on a
        duplicate, within the batch or against any earlier enqueue).
        """
        claim = self._claim
        ready = self.ready
        for key, run_fn in items:
            claim(key)
            ready.append((key, run_fn))
        self._dispatch()

    def make_ready_ids(self, ids, run_fn: Callable[[], None]) -> None:
        """Enqueue a level of integer task ids sharing one completion fn.

        Fed straight from merged index arrays (sharded materialization /
        :class:`IndexedSchedule` levels): keys are plain ints and every
        task of the level shares ``run_fn``, so driving a million-task
        schedule allocates no per-task closures or label tuples.  Ids are
        validated exactly-once like every other enqueue path
        (``ValueError`` on a duplicate).
        """
        claim = self._claim
        ready = self.ready
        for i in ids:
            key = int(i)
            claim(key)
            ready.append((key, run_fn))
        self._dispatch()

    def _dispatch(self) -> None:
        if not self.gate_open:
            return
        while self.free > 0 and self.ready:
            key, run_fn = self.ready.popleft()
            self.free -= 1
            self.running += 1
            self.exec_order.append(key)
            self._started_any = True
            if self.on_start is not None:
                self.on_start(key)

            def complete(key=key, run_fn=run_fn) -> None:
                try:
                    run_fn()
                except BaseException as e:  # noqa: BLE001 — see __init__
                    if self.on_task_error is None:
                        raise
                    self.task_errors.append((key, e))
                    self.on_task_error(key, e)
                finally:
                    self.free += 1
                    self.running -= 1
                self._dispatch()

            self.at(self.task_dur, complete)

    # ------------------------------------------------------------- progress
    def progress(self) -> tuple[int, int]:
        """Monotone ``(started, finished)`` counters for a stall watchdog
        (:class:`~.recovery.Watchdog`)."""
        started = len(self.exec_order)
        return started, started - self.running
