"""Deterministic fault injection for the counted-sync sweeps.

The counted-sync model lives and dies by its invariants — every counter
drained exactly once — and those invariants only mean something if the
sweeps survive their violation *visibly*: a dropped decrement must surface
as a diagnosable stall instead of an infinite hang.

Only the fault the device sweeps read is carried over from the reference
package's injection layer: ``DROPPED_DECREMENT`` (one predecessor signal
of task ``t`` never arrives, injected as a counter initialized one too
high).  The plan records every fire in ``fired``, so tests can assert a
fault actually triggered rather than silently missing its target.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

DROPPED_DECREMENT = "dropped_decrement"


@dataclass(frozen=True)
class Fault:
    """One injected fault, addressed to a global task id (``task``)."""

    kind: str
    task: object = None


@dataclass
class FaultPlan:
    """A set of faults plus a log of what fired."""

    faults: tuple = ()
    seed: Optional[int] = None
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self.faults = tuple(self.faults)

    def dropped_tasks(self) -> list:
        return [f.task for f in self.faults if f.kind == DROPPED_DECREMENT]

    def record(self, kind: str, where, attempt: int, error=None) -> None:
        self.fired.append((kind, where, attempt, repr(error) if error else None))
