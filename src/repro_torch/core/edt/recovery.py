"""What the counted-sync engines raise, and how a failed run is answered.

* :class:`StallError` (carrying a :class:`StallReport`) — a run reached
  a fixpoint with counters undrained: the task graph has a cycle, a
  decrement was dropped, a task body hung or a cross-rank message was
  lost.  The report's ``undrained`` dump names exactly the tasks whose
  signals never arrived.
* :class:`ScheduleValidationError` — a replayed schedule failed the
  on-device validation counters; it carries the offending kind, level,
  task ids and counter state.
* :class:`FailureReport` — the account of a failed run: the failed tasks
  or ranks, the poisoned cone, the undrained counters, how far it got.
* :class:`TaskGroupError` — every task-body failure of a threaded run in
  one exception, with its :class:`FailureReport`.
* :class:`RetryPolicy` — bounded exponential backoff over whole
  distributed attempts and over shard jobs: both are pure functions of
  their inputs (a partition, a :class:`~.shard.ShardSpec`), so a
  recovered run is byte-identical to a fault-free one.
* **Shard retry** — :func:`run_round` drives one pool round of shard jobs
  with per-round timeouts, dead-worker detection (a broken pool is
  rebuilt when the caller owns it) and bounded backoff; even a stale
  duplicate from a timed-out worker deposits the same bytes.  Exhausted
  retries raise :class:`ShardRecoveryError` carrying a
  :class:`FailureReport`, never a partial graph.
* **Poisoned-cone quarantine** — a task-body exception must cancel exactly
  the tasks data-dependent on it.  :func:`poisoned_cone` computes the
  forward closure over flat edge arrays (:func:`cone_from_successors` is
  the closure-world twin for :class:`~.threaded.ThreadedAutodec`);
  :func:`simulate_indexed_resilient` executes an indexed schedule on the
  instrumented Sim, quarantining each failure's cone level by level.
* :class:`Watchdog` — a progress heartbeat that turns a silent hang of
  the threaded runtime or the process driver into a :class:`StallReport`.

Payloads match the reference package's types field for field, so a
differential test can compare them directly.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import BrokenExecutor, wait as _fwait
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .executor import Sim
from .faults import FaultPlan, InjectedTaskError


@dataclass
class FailureReport:
    """Structured account of a run with failures.

    ``failed`` holds every ``(key, error repr)`` pair; ``poisoned`` the
    task ids/keys cancelled because they depend on a failure; ``undrained``
    maps each poisoned task to the counter value it was left with (its
    signals that never arrived).  ``context`` names the failure domain
    (``sharded`` / ``threaded`` / ``sim`` / ``distributed``).
    """

    context: str
    failed: list = field(default_factory=list)
    poisoned: list = field(default_factory=list)
    undrained: dict = field(default_factory=dict)
    executed: int = 0
    total: Optional[int] = None
    attempts: dict = field(default_factory=dict)   # key -> attempt count

    def summary(self) -> dict:
        return {
            "context": self.context,
            "n_failed": len(self.failed),
            "n_poisoned": len(self.poisoned),
            "n_undrained": len(self.undrained),
            "executed": self.executed,
            "total": self.total,
        }

    def to_json(self) -> str:
        return json.dumps({
            **self.summary(),
            "failed": [[repr(k), e] for k, e in self.failed],
            "poisoned": [repr(t) for t in self.poisoned],
            "undrained": {repr(t): int(c) for t, c in self.undrained.items()},
            "attempts": {repr(k): int(v) for k, v in self.attempts.items()},
        }, sort_keys=True)


@dataclass
class StallReport:
    """Diagnosis of a run that stopped making progress.

    ``undrained`` is the counter-state dump at stall time — exactly the
    tasks whose signals never arrived, with their remaining counts — which
    turns a dropped-decrement deadlock from an infinite hang into a named
    set of suspects.
    """

    context: str
    elapsed: float
    started: int
    finished: int
    in_flight: int
    undrained: dict = field(default_factory=dict)
    note: str = ""

    def summary(self) -> dict:
        return {
            "context": self.context,
            "elapsed": round(self.elapsed, 3),
            "started": self.started,
            "finished": self.finished,
            "in_flight": self.in_flight,
            "n_undrained": len(self.undrained),
            "note": self.note,
        }

    def to_json(self) -> str:
        return json.dumps({
            **self.summary(),
            "undrained": {repr(t): int(c) for t, c in self.undrained.items()},
        }, sort_keys=True)


class StallError(RuntimeError):
    """Execution stalled; ``.report`` is the :class:`StallReport`."""

    def __init__(self, report: StallReport, msg: Optional[str] = None):
        super().__init__(msg or f"execution stalled: {report.summary()}")
        self.report = report


class ShardRecoveryError(RuntimeError):
    """Shard retries exhausted; ``.report`` is the :class:`FailureReport`."""

    def __init__(self, report: FailureReport, msg: Optional[str] = None):
        super().__init__(msg or ("sharded materialization failed after "
                                 f"retries: {report.summary()}"))
        self.report = report


class TaskGroupError(RuntimeError):
    """Exception-group-style aggregate of every task-body failure.

    Carries ``.failures`` — the full ``(task key, exception)`` list — and
    ``.report``, instead of surfacing only the first error and silently
    dropping the rest.
    """

    def __init__(self, failures: list, report: Optional[FailureReport] = None):
        heads = ", ".join(f"{k!r}: {e!r}" for k, e in failures[:4])
        more = f" (+{len(failures) - 4} more)" if len(failures) > 4 else ""
        super().__init__(
            f"{len(failures)} task(s) failed — {heads}{more}")
        self.failures = list(failures)
        self.report = report


class ScheduleValidationError(RuntimeError):
    """A schedule failed the counted-sync validation, with the evidence.

    ``kind`` is one of ``not-ready`` / ``early-ready`` / ``undrained``;
    ``level`` the offending wavefront (``depth`` for end-of-sweep
    undrained counters); ``task_ids`` the offending global task ids;
    ``counters`` a summary of the counter state at detection.
    """

    def __init__(self, kind: str, level: int, task_ids, counters: dict):
        ids = np.asarray(task_ids, dtype=np.int64)
        shown = ids[:8].tolist()
        more = f" (+{ids.size - 8} more)" if ids.size > 8 else ""
        super().__init__(
            "schedule is not the counted-sync execution of this graph: "
            f"{kind} at level {level}, task(s) {shown}{more}; "
            f"counters: {counters}")
        self.kind = kind
        self.level = level
        self.task_ids = ids
        self.counters = counters


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for failed attempts.

    ``timeout`` bounds how long a rank waits on an empty inbox before it
    reports a stall (``None``: the distributed run's default), and is
    the per-wave wait of a shard round before outstanding jobs are
    declared hung and resubmitted (``None`` waits forever — hang
    detection off).  A fault that fails ``times <= max_retries``
    successive attempts is recoverable under this policy by construction.
    """

    max_retries: int = 3
    base_delay: float = 0.01
    backoff: float = 2.0
    timeout: Optional[float] = None


def run_round(fn: Callable, jobs: list, pool, *,
              policy: Optional[RetryPolicy] = None,
              plan: Optional[FaultPlan] = None,
              round_no: int = 0,
              pool_factory: Optional[Callable] = None):
    """Run one round of shard jobs with retry/backoff/timeout recovery.

    ``fn`` is a picklable worker entry taking ``(job, fault, attempt)``
    payloads.  Without a policy (and without faults) this is exactly
    ``pool.map`` — the fault-free fast path pays nothing.  With one, jobs
    are submitted individually; failures (worker exceptions, broken pools,
    per-wave timeouts) are retried with exponential backoff up to
    ``max_retries`` attempts each.  A broken pool is torn down and rebuilt
    via ``pool_factory`` when the caller owns it; without a factory a
    broken pool is unrecoverable.  Returns ``(results, pool)`` — results
    in job order, and the (possibly rebuilt) pool for the next round.

    Raises :class:`ShardRecoveryError` with a :class:`FailureReport` when
    any job exhausts its budget — never returns partial results.
    """
    if policy is None and plan is None:
        return list(pool.map(fn, [(j, None, 0) for j in jobs])), pool
    if policy is None:
        policy = RetryPolicy()

    n = len(jobs)
    results = [None] * n
    done = [False] * n
    attempts = [0] * n
    errors: dict[int, list] = {}
    pending = list(range(n))
    dead: list[int] = []
    while pending:
        futs = {}
        submit_err = None
        for i in pending:
            fault = plan.shard_fault(round_no, i) if plan is not None else None
            try:
                futs[pool.submit(fn, (jobs[i], fault, attempts[i]))] = i
            except (BrokenExecutor, RuntimeError) as e:
                submit_err = e
                break
        failed_now: list[tuple[int, BaseException]] = []
        requeued: list[int] = []
        if futs:
            done_set, not_done = _fwait(set(futs), timeout=policy.timeout)
            for f in done_set:
                i = futs[f]
                try:
                    results[i] = f.result()
                    done[i] = True
                except BaseException as e:  # noqa: BLE001 — any worker death
                    failed_now.append((i, e))
            for f in not_done:
                i = futs[f]
                if f.cancel():
                    # never started — it was queued behind a stalled
                    # worker.  The job is blameless: resubmit without
                    # charging its retry budget.
                    requeued.append(i)
                    continue
                failed_now.append((i, TimeoutError(
                    f"shard job {i} (round {round_no}) exceeded the "
                    f"{policy.timeout}s round timeout")))
            if not done_set and not failed_now and requeued \
                    and submit_err is None:
                # dead spin: nothing ran, nothing was charged — every
                # worker is wedged by an abandoned task.  Charge the
                # queued jobs so the budget still bounds total waiting.
                for i in requeued:
                    failed_now.append((i, TimeoutError(
                        f"shard job {i} (round {round_no}) starved: all "
                        "workers wedged past the round timeout")))
                requeued = []
        if submit_err is not None:
            for i in pending:
                if not done[i] and i not in requeued \
                        and all(j != i for j, _ in failed_now):
                    failed_now.append((i, submit_err))
        pending = requeued
        broken = submit_err is not None
        for i, e in failed_now:
            broken = broken or isinstance(e, BrokenExecutor)
            errors.setdefault(i, []).append(e)
            if plan is not None:
                plan.record("shard_failure", (round_no, i), attempts[i], e)
            attempts[i] += 1
            if attempts[i] > policy.max_retries:
                dead.append(i)
            else:
                pending.append(i)
        if dead:
            report = FailureReport(
                context="sharded",
                failed=[((round_no, i), repr(errors[i][-1])) for i in dead],
                executed=sum(done),
                total=n,
                attempts={(round_no, i): attempts[i] for i in errors})
            raise ShardRecoveryError(report)
        if broken:
            if pool_factory is None:
                report = FailureReport(
                    context="sharded",
                    failed=[((round_no, i), "pool broken (caller-owned, "
                             "cannot rebuild)") for i in pending],
                    executed=sum(done), total=n,
                    attempts={(round_no, i): attempts[i] for i in errors})
                raise ShardRecoveryError(report)
            pool.shutdown(wait=False)
            pool = pool_factory()
        if pending:
            worst = max(attempts[i] for i in pending)
            time.sleep(policy.base_delay * policy.backoff ** (worst - 1))
    return results, pool


# ------------------------------------------------------------ poisoned cone
def poisoned_cone(n: int, edge_src, edge_tgt, failed) -> "np.ndarray":
    """Forward closure of ``failed`` over flat edge arrays (failed excluded).

    The exact set of tasks that can never run once the failed tasks stop
    signaling: every task reachable from a failure through the dependence
    edges.  Vectorized BFS over a CSR view — O(V + E) total.
    """
    failed = np.asarray(list(failed), dtype=np.int64)
    if not n or not failed.size:
        return np.zeros(0, dtype=np.int64)
    edge_src = np.asarray(edge_src)
    edge_tgt = np.asarray(edge_tgt)
    order = np.argsort(edge_src, kind="stable")
    es, et = edge_src[order], edge_tgt[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(es, minlength=n), out=indptr[1:])
    seen = np.zeros(n, dtype=bool)
    seen[failed] = True
    frontier = failed
    while frontier.size:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        tot = int(counts.sum())
        if not tot:
            break
        csum = np.cumsum(counts)
        eidx = (np.repeat(starts - (csum - counts), counts)
                + np.arange(tot, dtype=np.int64))
        nxt = np.unique(et[eidx])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    cone = np.flatnonzero(seen)
    return cone[~np.isin(cone, failed)]


def cone_from_successors(successors: Callable, failed) -> set:
    """Closure-world twin of :func:`poisoned_cone` for ThreadedAutodec.

    ``successors(key) -> iterable of keys``; returns the forward closure
    of ``failed`` (failed keys themselves excluded).
    """
    failed = set(failed)
    seen = set(failed)
    frontier = list(failed)
    while frontier:
        nxt = []
        for k in frontier:
            for s in successors(k):
                if s not in seen:
                    seen.add(s)
                    nxt.append(s)
        frontier = nxt
    return seen - failed


class Watchdog:
    """Progress heartbeat: convert a silent hang into a :class:`StallReport`.

    ``progress()`` returns a tuple of monotone counters (e.g. ``(started,
    finished)``); ``dump()`` returns the undrained-counter dict for the
    report.  A daemon thread samples progress every ``interval`` seconds;
    when the tuple is unchanged for ``stall_timeout`` seconds the
    ``stalled`` event is set and ``report`` is filled in.  ``stop()`` ends
    the thread; entering/exiting as a context manager starts/stops it.
    The threaded runtime passes ``dump`` (its counter table); the process
    transport of the distributed driver passes neither ``dump`` nor
    ``interval``.
    """

    def __init__(self, progress: Callable[[], tuple],
                 stall_timeout: float = 30.0,
                 interval: Optional[float] = None,
                 context: str = "",
                 dump: Optional[Callable[[], dict]] = None):
        self._progress = progress
        self._dump = dump or (lambda: {})
        self.stall_timeout = stall_timeout
        self.interval = interval if interval is not None else max(
            0.01, stall_timeout / 20.0)
        self.context = context
        self.stalled = threading.Event()
        self.report: Optional[StallReport] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        last = self._progress()
        t0 = time.monotonic()
        since = t0
        while not self._stop.wait(self.interval):
            cur = self._progress()
            now = time.monotonic()
            if cur != last:
                last = cur
                since = now
                continue
            if now - since >= self.stall_timeout:
                started, finished = (cur + (0, 0))[:2]
                in_flight = max(0, started - finished)
                self.report = StallReport(
                    context=self.context,
                    elapsed=now - t0,
                    started=int(started), finished=int(finished),
                    in_flight=int(in_flight),
                    undrained=dict(self._dump()),
                    note=(f"no progress for {self.stall_timeout}s — a "
                          "decrement was dropped or a worker is hung"))
                self.stalled.set()
                return


# --------------------------------------------------- resilient Sim execution
@dataclass
class ResilientRun:
    """Result of a quarantined execution: the Sim plus an optional report."""

    sim: Sim
    report: Optional[FailureReport] = None

    @property
    def ok(self) -> bool:
        return self.report is None


def simulate_indexed_resilient(ig, schedule, body: Optional[Callable] = None,
                               workers: int = 4, task_dur: float = 1.0,
                               faults: Optional[FaultPlan] = None) -> ResilientRun:
    """Execute an :class:`IndexedSchedule` with poisoned-cone quarantine.

    The resilient twin of :func:`~.wavefront.simulate_indexed`:
    ``body(task_id)`` runs per task on the instrumented Sim and may raise.
    A failure cancels exactly its dependent cone — computed from the index
    graph's edge arrays — and execution continues for every task outside
    it.  The quarantine is applied at each level barrier: a level's ids are
    filtered against the poison set accumulated from all earlier levels,
    so the executed set is deterministic regardless of worker count.

    Returns a :class:`ResilientRun`; with no failures the Sim's
    ``exec_order`` is byte-identical to the fault-free
    ``simulate_indexed``.  With failures the report names every failed
    task, the poisoned cone, and each poisoned task's undrained counter
    (its predecessor signals that never arrived).
    """
    n = ig.n
    failed: list[tuple] = []
    errors: list[tuple] = []
    poison = np.zeros(n, dtype=bool)

    sim = Sim(workers, task_dur, setup_cost=0.0)
    run_body = body or (lambda t: None)

    def make_task(tid: int):
        def run() -> None:
            try:
                fault = faults.body_fault(tid) if faults is not None else None
                if fault is not None:
                    faults.record("task_body_error", tid, 0)
                    raise InjectedTaskError(tid)
                run_body(tid)
            except BaseException as e:  # noqa: BLE001 — quarantine, not wedge
                failed.append((tid, e))
            done()
        return run

    lvl_state = {"i": -1, "remaining": 0}

    def done() -> None:
        lvl_state["remaining"] -= 1
        if lvl_state["remaining"] == 0:
            launch(lvl_state["i"] + 1)

    def launch(i: int) -> None:
        while i < schedule.depth:
            if failed and len(failed) > len(errors):
                # new failures since the last cone update: re-poison
                new = [(t, e) for t, e in failed[len(errors):]]
                errors.extend(new)
                ids = np.asarray([t for t, _ in new], dtype=np.int64)
                poison[poisoned_cone(n, ig.edge_src, ig.edge_tgt, ids)] = True
            lvl = schedule.levels[i]
            live = lvl[~poison[lvl]]
            if live.size:
                lvl_state["i"] = i
                lvl_state["remaining"] = int(live.size)
                sim.make_ready_batch(
                    (int(t), make_task(int(t))) for t in live)
                return
            i += 1

    launch(0)
    sim.run()
    if not failed:
        return ResilientRun(sim)
    if failed and len(failed) > len(errors):
        errors.extend(failed[len(errors):])
        ids = np.asarray([t for t, _ in failed], dtype=np.int64)
        poison[poisoned_cone(n, ig.edge_src, ig.edge_tgt, ids)] = True
    failed_ids = np.asarray([t for t, _ in failed], dtype=np.int64)
    dead = poison.copy()
    dead[failed_ids] = True
    # a poisoned task's counter keeps one unit per predecessor that never
    # signaled — i.e. every pred that itself failed or was poisoned
    missing = np.bincount(ig.edge_tgt[dead[ig.edge_src]], minlength=n)
    poisoned_ids = np.flatnonzero(poison)
    report = FailureReport(
        context="sim",
        failed=[(int(t), repr(e)) for t, e in failed],
        poisoned=poisoned_ids.tolist(),
        undrained={int(t): int(missing[t]) for t in poisoned_ids
                   if missing[t] > 0},
        executed=len(sim.exec_order),
        total=n)
    return ResilientRun(sim, report)
