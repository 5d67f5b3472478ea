"""What the counted-sync sweeps raise when a run is not the counted model.

* :class:`StallError` (carrying a :class:`StallReport`) — a discover
  sweep reached a fixpoint with counters undrained: the task graph has a
  cycle or a decrement was dropped.  The report's ``undrained`` dump names
  exactly the tasks whose signals never arrived.
* :class:`ScheduleValidationError` — a replayed schedule failed the
  on-device validation counters; it carries the offending kind, level,
  task ids and counter state.

Payloads match the reference package's types field for field, so a
differential test can compare them directly.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


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
