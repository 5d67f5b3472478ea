"""A real-thread autodec runtime (the paper's §2.2.4, with preschedule).

Correctness evidence that the atomic get-or-create resolves the "who
creates the successor" race (paper Fig 1) under genuine concurrency.  Task
bodies run on host threads.

The counter table is guarded by striped locks; `autodec` performs
get-or-create-then-decrement atomically, so exactly one caller observes the
transition to zero and becomes the task's (unique) creator.

Robustness: a task body that raises does not signal its successors, so
its dependent cone never runs — the quarantine is *structural*.
:func:`run_graph_threaded` surfaces every failure (an aggregated
:class:`~.recovery.TaskGroupError`, not just the first), a
:class:`~.recovery.Watchdog` converts hung bodies and dropped decrements
into :class:`StallReport`s with a counter-state dump, and
:func:`run_graph_threaded_resilient` returns the structured
:class:`FailureReport` (failed tasks, poisoned cone, undrained counters)
instead of raising.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Hashable, Iterable, Optional

from .faults import FaultPlan, InjectedTaskError
from .recovery import (FailureReport, StallError, StallReport, TaskGroupError,
                       Watchdog, cone_from_successors)

Key = Hashable


class ThreadedAutodec:
    """Autodec/preschedule over a task family given by three closures.

    pred_count(key) -> int           number of input dependences
    successors(key) -> iterable      keys to autodec at completion
    body(key) -> None                the task's computation
    """

    N_STRIPES = 64

    def __init__(self, pred_count: Callable[[Key], int],
                 successors: Callable[[Key], Iterable[Key]],
                 body: Callable[[Key], None],
                 workers: int = 4,
                 on_error: Optional[Callable[[Key, BaseException], None]] = None):
        self._pred_count = pred_count
        self._successors = successors
        self._body = body
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._locks = [threading.Lock() for _ in range(self.N_STRIPES)]
        self._counters: dict[Key, int] = {}
        self._scheduled: set[Key] = set()
        self._executed: list[Key] = []
        self._exec_lock = threading.Lock()
        self._outstanding = 0
        self._quiet = threading.Condition()
        self._errors: list[tuple[Key, BaseException]] = []
        self._on_error = on_error
        # monotone progress counters for the stall watchdog
        self.started = 0
        self.finished = 0

    def _stripe(self, key: Key) -> threading.Lock:
        return self._locks[hash(key) % self.N_STRIPES]

    # ------------------------------------------------------------- protocol
    def _get_or_create_then(self, key: Key, decrement: bool) -> None:
        fire = False
        with self._stripe(key):
            if key in self._scheduled:
                # counter already consumed: a preschedule that arrives after
                # autodecs fired the task must not re-create it (that would
                # call pred_count twice and leak a dead counter entry)
                return
            if key not in self._counters:
                self._counters[key] = self._pred_count(key)
            if decrement:
                self._counters[key] -= 1
            if self._counters[key] <= 0:
                self._scheduled.add(key)
                del self._counters[key]  # GC at schedule time
                fire = True
        if fire:
            self._submit(key)

    def autodec(self, key: Key) -> None:
        self._get_or_create_then(key, decrement=True)

    def preschedule(self, key: Key) -> None:
        self._get_or_create_then(key, decrement=False)

    # ------------------------------------------------------------ execution
    def _submit(self, key: Key) -> None:
        with self._quiet:
            self._outstanding += 1
            self.started += 1
        self._pool.submit(self._run, key)

    def _run(self, key: Key) -> None:
        try:
            self._body(key)
            with self._exec_lock:
                self._executed.append(key)
            for s in self._successors(key):
                self.autodec(s)
        except BaseException as e:  # noqa: BLE001 — runtime must not wedge
            self._errors.append((key, e))
            if self._on_error:
                self._on_error(key, e)
        finally:
            with self._quiet:
                self._outstanding -= 1
                self.finished += 1
                if self._outstanding == 0:
                    self._quiet.notify_all()

    # -------------------------------------------------------------- control
    def preschedule_all(self, keys: Iterable[Key]) -> None:
        for k in keys:
            self.preschedule(k)

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._quiet:
            return self._quiet.wait_for(lambda: self._outstanding == 0, timeout)

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)

    @property
    def executed(self) -> list[Key]:
        return list(self._executed)

    @property
    def errors(self) -> list:
        return list(self._errors)

    # ---------------------------------------------------------- diagnostics
    def progress(self) -> tuple[int, int]:
        """Monotone ``(started, finished)`` for the stall watchdog."""
        with self._quiet:
            return self.started, self.finished

    def counter_snapshot(self) -> dict:
        """Undrained counters right now (diagnostic: racy by nature).

        Every key still present never reached zero — after quiescence this
        is exactly the set of tasks whose signals never arrived, with the
        remaining count each is waiting on.
        """
        return dict(self._counters)

    def failure_report(self, total: Optional[int] = None) -> Optional[FailureReport]:
        """Structured account of this run's failures (None when clean).

        The poisoned cone is the forward closure of the failed tasks over
        the ``successors`` closure — exactly the tasks whose counters can
        never drain because a failed body stopped signaling.
        """
        if not self._errors:
            return None
        failed = [k for k, _ in self._errors]
        cone = cone_from_successors(self._successors, failed)
        counters = self.counter_snapshot()
        return FailureReport(
            context="threaded",
            failed=[(k, repr(e)) for k, e in self._errors],
            poisoned=sorted(cone),
            undrained={k: c for k, c in counters.items() if k in cone},
            executed=len(self._executed),
            total=total)


@dataclass
class ThreadedRunResult:
    """Quarantined run outcome: what executed, plus structured diagnostics."""

    executed: list
    failure: Optional[FailureReport] = None
    stall: Optional[object] = None     # StallReport when progress died

    @property
    def ok(self) -> bool:
        return self.failure is None and self.stall is None


def _wrap_faulty_body(body: Callable, faults: FaultPlan) -> Callable:
    """Apply TASK_BODY_ERROR / WORKER_HANG faults around a task body."""
    import time as _time

    def run(key) -> None:
        hang = faults.hang_fault(key)
        if hang is not None:
            faults.record("worker_hang", key, 0)
            _time.sleep(hang.delay)
        fault = faults.body_fault(key)
        if fault is not None:
            faults.record("task_body_error", key, 0)
            raise InjectedTaskError(key)
        body(key)

    return run


def _wrap_faulty_successors(successors: Callable,
                            faults: FaultPlan) -> Callable:
    """Drop exactly one decrement into each DROPPED_DECREMENT target.

    The first signal headed for a dropped task is swallowed (atomically —
    producers race, but exactly one loses its signal); the task's counter
    can then never drain, which is precisely the deadlock the stall
    watchdog must convert into a report.
    """
    dropped = set(faults.dropped_tasks())
    lock = threading.Lock()

    def succ(key):
        for s in successors(key):
            if dropped:
                with lock:
                    if s in dropped:
                        dropped.discard(s)
                        faults.record("dropped_decrement", s, 0)
                        continue
            yield s

    return succ


def _execute_graph(graph, params: dict, workers: int, body, faults,
                   stall_timeout: float):
    """Shared driver: run the graph, watchdog the progress, diagnose.

    Returns ``(rt, total, stall_report)``.  Quiescence alone is not
    success: a dropped decrement leaves the runtime quiet with undrained
    counters, which is reported as a stall (the counter dump names the
    suspects) rather than silently returning a partial execution.
    """
    tasks = list(graph.tasks(params))
    run_body = body or (lambda t: None)
    successors = lambda t: list(graph.successors(t, params))  # noqa: E731
    if faults is not None:
        run_body = _wrap_faulty_body(run_body, faults)
        successors = _wrap_faulty_successors(successors, faults)
    rt = ThreadedAutodec(
        pred_count=lambda t: graph.pred_count(t, params),
        successors=successors,
        body=run_body,
        workers=workers,
    )
    dog = Watchdog(rt.progress, stall_timeout=stall_timeout,
                   context="threaded", dump=rt.counter_snapshot)
    stall = None
    with dog:
        rt.preschedule_all(tasks)
        while not rt.wait(timeout=min(0.05, stall_timeout / 4)):
            if dog.stalled.is_set():
                stall = dog.report
                break
    if stall is not None:
        rt.shutdown(wait=False)    # a hung body may never return
        return rt, len(tasks), stall
    rt.shutdown()
    # quiesced — but did every task run?  Tasks outside the poisoned cone
    # that never fired mean a decrement was dropped: a real deadlock.
    report = rt.failure_report(total=len(tasks))
    covered = len(rt.executed) + len(rt.errors)
    if report is not None:
        covered += len(report.poisoned)
    if covered < len(tasks):
        started, finished = rt.progress()
        stall = StallReport(
            context="threaded", elapsed=0.0,
            started=started, finished=finished, in_flight=0,
            undrained=rt.counter_snapshot(),
            note=(f"quiesced with {len(tasks) - covered} task(s) never "
                  "scheduled — a decrement was dropped"))
    return rt, len(tasks), stall


def run_graph_threaded(graph, params: dict, workers: int = 4,
                       body: Optional[Callable] = None,
                       faults: Optional[FaultPlan] = None,
                       stall_timeout: float = 300.0) -> list:
    """Execute a TiledTaskGraph with the threaded autodec runtime.

    Failures are aggregated: every (task key, exception) pair rides on one
    :class:`TaskGroupError` (with the :class:`FailureReport` attached)
    instead of surfacing only the first error.  A stall — hung body or
    dropped decrement — raises :class:`StallError` with the counter-state
    dump after ``stall_timeout`` seconds without progress.
    """
    rt, total, stall = _execute_graph(graph, params, workers, body, faults,
                                      stall_timeout)
    if stall is not None:
        raise StallError(stall)
    if rt.errors:
        raise TaskGroupError(rt.errors, rt.failure_report(total=total))
    return rt.executed


def run_graph_threaded_resilient(graph, params: dict, workers: int = 4,
                                 body: Optional[Callable] = None,
                                 faults: Optional[FaultPlan] = None,
                                 stall_timeout: float = 300.0) -> ThreadedRunResult:
    """Quarantined execution: never raises on task faults, always reports.

    A task-body exception cancels exactly its dependent cone (the other
    tasks run to completion) and the result carries the structured
    :class:`FailureReport`; a stall yields the :class:`StallReport`
    instead of a hang.  With no faults the executed list matches
    :func:`run_graph_threaded` exactly.
    """
    rt, total, stall = _execute_graph(graph, params, workers, body, faults,
                                      stall_timeout)
    return ThreadedRunResult(executed=rt.executed,
                             failure=rt.failure_report(total=total),
                             stall=stall)
