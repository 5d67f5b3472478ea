"""What the counted-sync engines raise, and how a failed run is retried.

* :class:`StallError` (carrying a :class:`StallReport`) — a sweep reached
  a fixpoint with counters undrained: the task graph has a cycle, a
  decrement was dropped or a cross-rank message was lost.  The report's
  ``undrained`` dump names exactly the tasks whose signals never arrived.
* :class:`ScheduleValidationError` — a replayed schedule failed the
  on-device validation counters; it carries the offending kind, level,
  task ids and counter state.
* :class:`FailureReport` — the account of a failed distributed attempt
  (which rank died, how far the run got).
* :class:`RetryPolicy` — bounded exponential backoff over whole
  distributed attempts, which are pure functions of their partition, so
  a recovered run is byte-identical to a fault-free one.
* :class:`Watchdog` — a progress heartbeat that turns a silent hang of
  the process driver into a :class:`StallReport`.

Payloads match the reference package's types field for field, so a
differential test can compare them directly.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class FailureReport:
    """Structured account of a run with failures.

    ``failed`` holds every ``(key, error repr)`` pair; ``poisoned`` the
    task ids/keys cancelled because they depend on a failure; ``undrained``
    maps each poisoned task to the counter value it was left with.
    ``context`` names the failure domain (``distributed`` here).
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
    reports a stall (``None``: the distributed driver's default).  A fault
    that fails ``times <= max_retries`` successive attempts is recoverable
    under this policy by construction.
    """

    max_retries: int = 3
    base_delay: float = 0.01
    backoff: float = 2.0
    timeout: Optional[float] = None


class Watchdog:
    """Progress heartbeat: convert a silent hang into a :class:`StallReport`.

    ``progress()`` returns a tuple of monotone counters (e.g. ``(started,
    finished)``); ``dump()`` returns the undrained-counter dict for the
    report.  A daemon thread samples progress every ``interval`` seconds;
    when the tuple is unchanged for ``stall_timeout`` seconds the
    ``stalled`` event is set and ``report`` is filled in.  ``stop()`` ends
    the thread; entering/exiting as a context manager starts/stops it.
    ``interval`` and ``dump`` are kept as the reference has them for the
    threaded executor's watchdog; the process transport sets neither.
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
