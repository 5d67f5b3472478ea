"""Deterministic fault injection for the EDT pipeline.

The counted-sync model lives and dies by its invariants — every counter
drained exactly once — and those invariants only mean something if the
pipeline survives their violation *visibly*: a dead pool worker must not
corrupt a merged graph, a dropped decrement must surface as a diagnosable
stall instead of an infinite hang, a task-body exception must poison
exactly its dependent cone, and a dead rank or a lost message must fail
the attempt instead of corrupting the result.

The kinds are carried over from the reference package's injection layer:

=====================  =====================================================
kind                   meaning / injection site
=====================  =====================================================
``WORKER_CRASH``       a shard job dies mid-round — raised in the worker
                       (``hard=True`` kills the whole process with
                       ``os._exit``, breaking the pool)
``WORKER_HANG``        a shard job sleeps past the round timeout; in the
                       threaded runtime (addressed by ``task``) a task
                       body sleeps ``delay`` seconds before it runs
``SHM_ATTACH_FAIL``    a worker fails to attach its shared-memory slot
``TASK_BODY_ERROR``    a task body raises at task ``t`` (threaded / Sim)
``DROPPED_DECREMENT``  one predecessor signal of task ``t`` never arrives
                       (threaded successors / device counter init)
``RANK_CRASH``         a distributed rank dies mid-run (``index`` = rank;
                       ``hard=True`` kills the rank process)
``MESSAGE_LOSS``       one cross-rank decrement batch is dropped in flight
                       (``round`` = source rank, ``index`` = destination)
=====================  =====================================================

Shard faults address a pool round of the sharded generation scan (0 =
counts, 1 = tiles, 2 = edges; :mod:`.shard`) and a job index within it;
``times`` bounds how many successive *attempts* fail, so ``times <=
RetryPolicy.max_retries`` makes a retryable fault recoverable by
construction.  The plan records every fire in ``fired`` (parent side), so
tests can assert a fault actually triggered rather than silently missing
its target.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Optional

WORKER_CRASH = "worker_crash"
WORKER_HANG = "worker_hang"
SHM_ATTACH_FAIL = "shm_attach_fail"
TASK_BODY_ERROR = "task_body_error"
DROPPED_DECREMENT = "dropped_decrement"
RANK_CRASH = "rank_crash"
MESSAGE_LOSS = "message_loss"

SHARD_KINDS = (WORKER_CRASH, WORKER_HANG, SHM_ATTACH_FAIL)
DIST_KINDS = (RANK_CRASH, MESSAGE_LOSS)
KINDS = SHARD_KINDS + (TASK_BODY_ERROR, DROPPED_DECREMENT) + DIST_KINDS


class InjectedWorkerCrash(RuntimeError):
    """A shard worker died mid-round (soft injection)."""


class InjectedAttachFailure(OSError):
    """A shard worker could not attach its shared-memory segment."""


class InjectedTaskError(RuntimeError):
    """A task body raised (the injected fault of ``TASK_BODY_ERROR``)."""

    def __init__(self, task):
        super().__init__(f"injected task-body fault at task {task!r}")
        self.task = task


class InjectedRankCrash(RuntimeError):
    """A distributed rank died mid-run (soft injection of ``RANK_CRASH``)."""

    def __init__(self, rank: int, attempt: int):
        super().__init__(
            f"injected rank crash (rank {rank}, attempt {attempt})")
        self.rank = rank


@dataclass(frozen=True)
class Fault:
    """One injected fault — picklable, addressed by site.

    ``round``/``index`` address shard faults (pool round × job index) and
    distributed faults (a rank, or a ``src -> dst`` channel); ``task``
    addresses task-level faults (a TaskId or a global task id).  ``times``
    is the number of successive attempts that fail: a retrying run
    recovers iff ``times <= max_retries``.  ``delay`` is the hang
    duration; ``hard`` upgrades a crash to ``os._exit`` (kills the worker
    or rank process; a dead pool worker breaks every in-flight job of the
    pool).
    """

    kind: str
    round: int = -1
    index: int = 0
    task: object = None
    times: int = 1
    delay: float = 0.5
    hard: bool = False


def maybe_inject(fault: Optional[Fault], attempt: int) -> None:
    """Fire ``fault`` if this attempt is within its ``times`` budget.

    Runs *inside* the shard worker.  A crash raises (or kills the process
    when ``hard``), a hang sleeps past the round timeout, an
    attach failure raises ``OSError`` — the parent treats all three
    identically: the shard failed, retry it.
    """
    if fault is None or attempt >= fault.times:
        return
    if fault.kind == WORKER_CRASH:
        if fault.hard:
            os._exit(1)
        raise InjectedWorkerCrash(
            f"injected worker crash (round {fault.round}, job {fault.index}, "
            f"attempt {attempt})")
    if fault.kind == WORKER_HANG:
        time.sleep(fault.delay)
    elif fault.kind == SHM_ATTACH_FAIL:
        raise InjectedAttachFailure(
            f"injected shm attach failure (round {fault.round}, "
            f"job {fault.index}, attempt {attempt})")


@dataclass
class FaultPlan:
    """A seeded set of faults plus a parent-side log of what fired."""

    faults: tuple = ()
    seed: Optional[int] = None
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self.faults = tuple(self.faults)

    def shard_fault(self, round_no: int, index: int) -> Optional[Fault]:
        for f in self.faults:
            if f.kind in SHARD_KINDS and f.round == round_no and f.index == index:
                return f
        return None

    def body_fault(self, task) -> Optional[Fault]:
        for f in self.faults:
            if f.kind == TASK_BODY_ERROR and f.task == task:
                return f
        return None

    def hang_fault(self, task) -> Optional[Fault]:
        for f in self.faults:
            if f.kind == WORKER_HANG and f.task == task:
                return f
        return None

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

    def shard_kinds(self) -> list:
        return [f for f in self.faults if f.kind in SHARD_KINDS]

    def dist_kinds(self) -> list:
        return [f for f in self.faults if f.kind in DIST_KINDS]

    def record(self, kind: str, where, attempt: int, error=None) -> None:
        self.fired.append((kind, where, attempt, repr(error) if error else None))

    def recoverable(self, max_retries: int) -> bool:
        """Whether a retrying run must end byte-identical.

        Shard faults (the task hang among them) and distributed faults
        (rank crash, message loss) recover iff every one exhausts within
        the retry budget — shard blocks and whole distributed attempts are
        both pure functions of their inputs, so a retried run reproduces
        the fault-free bytes.  Task-level faults are never "recovered" —
        they quarantine or stall by design — so a plan containing them is
        judged on the retryable kinds only.
        """
        return all(f.times <= max_retries
                   for f in self.shard_kinds() + self.dist_kinds())

    @classmethod
    def random(cls, seed: int, n_jobs: int = 4, tasks=(),
               kinds=SHARD_KINDS, max_times: int = 3,
               n_faults: int = 1) -> "FaultPlan":
        """A seeded random plan — the fuzzing entry point.

        ``n_jobs`` bounds the shard job index, ``tasks`` supplies the task
        universe for task-level kinds, ``max_times`` bounds the attempt
        budget (so recoverability is decided by the caller's retry policy,
        not the generator).
        """
        rng = random.Random(seed)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(tuple(kinds))
            if kind in SHARD_KINDS:
                faults.append(Fault(
                    kind=kind,
                    round=rng.randrange(3),
                    index=rng.randrange(max(1, n_jobs)),
                    times=rng.randint(1, max_times),
                    delay=0.3,
                    hard=(kind == WORKER_CRASH and rng.random() < 0.25)))
            else:
                if not len(tasks):
                    continue
                faults.append(Fault(
                    kind=kind, task=tasks[rng.randrange(len(tasks))]))
        return cls(faults=tuple(faults), seed=seed)
