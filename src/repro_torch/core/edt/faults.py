"""Deterministic fault injection for the counted-sync sweeps.

The counted-sync model lives and dies by its invariants — every counter
drained exactly once — and those invariants only mean something if the
sweeps survive their violation *visibly*: a dropped decrement must surface
as a diagnosable stall instead of an infinite hang, and a dead rank or a
lost message must fail the attempt instead of corrupting the result.

The faults the ported engines read are carried over from the reference
package's injection layer:

=====================  =====================================================
kind                   meaning / injection site
=====================  =====================================================
``DROPPED_DECREMENT``  one predecessor signal of task ``t`` never arrives
                       (device counter init one too high)
``RANK_CRASH``         a distributed rank dies mid-run (``index`` = rank;
                       ``hard=True`` kills the rank process)
``MESSAGE_LOSS``       one cross-rank decrement batch is dropped in flight
                       (``round`` = source rank, ``index`` = destination)
=====================  =====================================================

``times`` bounds how many successive *attempts* fail, so ``times <=
RetryPolicy.max_retries`` makes a distributed fault recoverable by
construction.  The plan records every fire in ``fired``, so tests can
assert a fault actually triggered rather than silently missing its
target.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

DROPPED_DECREMENT = "dropped_decrement"
RANK_CRASH = "rank_crash"
MESSAGE_LOSS = "message_loss"

DIST_KINDS = (RANK_CRASH, MESSAGE_LOSS)


class InjectedRankCrash(RuntimeError):
    """A distributed rank died mid-run (soft injection of ``RANK_CRASH``)."""

    def __init__(self, rank: int, attempt: int):
        super().__init__(
            f"injected rank crash (rank {rank}, attempt {attempt})")
        self.rank = rank


@dataclass(frozen=True)
class Fault:
    """One injected fault — picklable, addressed by site.

    ``round``/``index`` address distributed faults (a rank, or a ``src ->
    dst`` channel); ``task`` addresses a global task id.  ``times`` is the
    number of successive attempts that fail: a retrying driver recovers
    iff ``times <= max_retries``.  ``hard`` upgrades a rank crash to
    ``os._exit`` (kills the rank process).  ``delay`` is kept for field
    parity with the reference's ``Fault``.
    """

    kind: str
    round: int = -1
    index: int = 0
    task: object = None
    times: int = 1
    delay: float = 0.5
    hard: bool = False


@dataclass
class FaultPlan:
    """A set of faults plus a driver-side log of what fired."""

    faults: tuple = ()
    seed: Optional[int] = None
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self.faults = tuple(self.faults)

    def dropped_tasks(self) -> list:
        return [f.task for f in self.faults if f.kind == DROPPED_DECREMENT]

    def rank_fault(self, rank: int) -> Optional[Fault]:
        """The ``RANK_CRASH`` fault addressed to ``rank`` (``index``), if any."""
        for f in self.faults:
            if f.kind == RANK_CRASH and f.index == rank:
                return f
        return None

    def message_fault(self, src_rank: int, dst_rank: int) -> Optional[Fault]:
        """The ``MESSAGE_LOSS`` fault on the ``src -> dst`` channel
        (``round`` = source rank, ``index`` = destination rank), if any."""
        for f in self.faults:
            if (f.kind == MESSAGE_LOSS and f.round == src_rank
                    and f.index == dst_rank):
                return f
        return None

    def dist_kinds(self) -> list:
        return [f for f in self.faults if f.kind in DIST_KINDS]

    def record(self, kind: str, where, attempt: int, error=None) -> None:
        self.fired.append((kind, where, attempt, repr(error) if error else None))

    def recoverable(self, max_retries: int) -> bool:
        """Whether a retrying run must end byte-identical.

        Distributed faults (rank crash, message loss) recover iff every
        one exhausts within the retry budget — a whole distributed attempt
        is a pure function of its partition, so a retried run reproduces
        the fault-free bytes.  A dropped decrement is never "recovered" —
        it stalls by design — so a plan is judged on the retryable kinds
        only.
        """
        return all(f.times <= max_retries for f in self.dist_kinds())
