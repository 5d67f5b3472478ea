"""Distributed counted-sync runtime: rank-owned ranges, message decrements.

The :class:`~repro_torch.core.edt.taskgraph.IndexedGraph` is partitioned
by **contiguous global task-id range** (a deterministic divmod split) and
each rank owns exactly the counters of its range.  A dependence edge then
lowers to one of two decrements:

* **local edge** (source and target on one rank) — an in-place counter
  decrement, exactly the single-host sweep;
* **cross-rank edge** — an *active message*: the owning rank of the source
  batches ``(target id, source level + 1)`` pairs per destination rank and
  sends them; the receiving rank's mailbox admits each batch exactly once
  (per-channel sequence numbers) and applies it as a counter decrement.

Counters alone decide readiness — no global schedule, no level barrier
between ranks.  A rank is done when it has started all ``n_local`` of its
tasks *and* received all ``expected_in`` cross-rank decrements (both known
at partition time), so no distributed termination detection is needed.
Levels stay exact without synchrony because decrements carry them (a
task's level is ``max(pred level) + 1``, merged with ``np.maximum.at``),
so the merged per-rank levels are byte-identical to the single-host
:func:`~repro_torch.core.edt.wavefront.schedule_from_graph` and
``DeviceExecutor`` discover.

Two rank engines share the partition:

* ``engine="numpy"`` — the sparse frontier sweep on the host (CSR gather +
  unique decrement).  Fully async; the only engine allowed on the
  ``processes`` transport.
* ``engine="device"`` — each rank keeps its local counters on the card and
  steps them through the hand-written kernel of the single-host discover
  sweep, :func:`~repro_torch.core.edt.device.wavefront_step`, over its
  local transpose-CSR columns (uploaded once).  Cross-rank batches are
  applied on the card too (``index_add_`` of the negated counts), and the
  host reads back only the ids of the next frontier, once a round.
  Level-synchronous by construction (superstep index == wavefront level),
  so it requires the barriered ``inline`` transport; every rank runs on
  the one device.

Transports: ``inline`` round-robins every rank in one process
(deterministic); ``processes`` spawns one OS process per rank with
multiprocessing queues as the message fabric (``start_method="spawn"``
safe; the engines only ever see :class:`MsgBatch` objects).

Failure semantics: ``RANK_CRASH`` and ``MESSAGE_LOSS`` faults inject a
dying rank / a dropped decrement batch; a lost batch leaves ``received <
expected_in`` and surfaces as a
:class:`~repro_torch.core.edt.recovery.StallReport` (worker inbox timeout
or the inline fixpoint check), a dead rank as a :class:`RankFailureError`;
under a :class:`~repro_torch.core.edt.recovery.RetryPolicy` the driver
re-runs the attempt — the sweep is a pure function of the partition, so
the recovered frontiers are byte-identical by construction.  A
:class:`~repro_torch.core.edt.recovery.Watchdog` guards the process
driver against silent hangs.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from queue import Empty
from typing import Optional, Union

import numpy as np
import torch

from ...compat import default_device
from .device import upload, wavefront_step
from .faults import MESSAGE_LOSS, RANK_CRASH, FaultPlan, InjectedRankCrash
from .recovery import (FailureReport, RetryPolicy, StallError, StallReport,
                       Watchdog)
from .taskgraph import IndexedGraph, TiledTaskGraph
from .wavefront import levels_from_array

#: Seconds a rank waits on an empty inbox (and the driver's watchdog base)
#: before declaring the run stalled, when no RetryPolicy timeout is set.
DEFAULT_STALL_TIMEOUT = 20.0


class RankFailureError(RuntimeError):
    """A rank died mid-run; ``.report`` is the :class:`FailureReport`."""

    def __init__(self, report: FailureReport, msg: Optional[str] = None):
        super().__init__(msg or ("distributed rank failed: "
                                 f"{report.summary()}"))
        self.report = report


# --------------------------------------------------------------- partition
def plan_ranks(n: int, ranks: int) -> "np.ndarray":
    """Contiguous task-id range boundaries: ``bounds[k] .. bounds[k+1]``.

    A deterministic divmod split — boundaries depend only on ``(n,
    ranks)``, never on scheduling, so every attempt (and every retry)
    partitions identically.
    """
    if ranks < 1:
        raise ValueError(f"need at least one rank, got {ranks}")
    q, r = divmod(n, ranks)
    sizes = np.full(ranks, q, dtype=np.int64)
    sizes[:r] += 1
    bounds = np.zeros(ranks + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds


@dataclass
class RankSlice:
    """One rank's share of the graph — picklable, spawn-safe.

    ``indeg`` is the full counter init (cross-rank predecessors included —
    a missing remote signal must keep the counter up).  Local out-edges
    are CSR with *local* target indices; cross-rank out-edges are CSR with
    *global* target ids (the message payload).  ``expected_in`` is the
    exact number of cross-rank decrements this rank will receive — the
    local termination condition.
    """

    rank: int
    ranks: int
    lo: int
    hi: int
    bounds: "np.ndarray"      # i64[ranks+1] ownership boundaries
    indeg: "np.ndarray"       # i64[nl] full in-degree counter init
    l_indptr: "np.ndarray"    # i64[nl+1] CSR over local sources
    l_tgt: "np.ndarray"       # i64[El]   local target indices
    r_indptr: "np.ndarray"    # i64[nl+1] CSR over local sources
    r_tgt: "np.ndarray"       # i64[Er]   global target ids (other ranks)
    expected_in: int

    @property
    def n_local(self) -> int:
        return self.hi - self.lo


def partition_graph(ig: IndexedGraph, ranks: int) -> list[RankSlice]:
    """Split an index graph into per-rank slices (host-side, one pass).

    Edges are grouped by source rank (one stable argsort), then split
    local/cross per rank; the per-rank arrays are views/copies of the
    grouped columns, so the partition is deterministic and
    byte-reproducible.
    """
    n = ig.n
    bounds = plan_ranks(n, ranks)
    order = np.argsort(ig.edge_src, kind="stable")
    es = ig.edge_src[order]
    et = ig.edge_tgt[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(es, minlength=n), out=indptr[1:])
    tr = np.searchsorted(bounds, et, side="right") - 1
    sr = np.searchsorted(bounds, es, side="right") - 1
    cross = sr != tr
    exp_in = (np.bincount(tr[cross], minlength=ranks) if cross.any()
              else np.zeros(ranks, dtype=np.int64))
    slices = []
    for k in range(ranks):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        nl = hi - lo
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        tgt = et[e0:e1]
        row = indptr[lo:hi + 1] - e0
        src_of = np.repeat(np.arange(nl, dtype=np.int64), np.diff(row))
        local = (tgt >= lo) & (tgt < hi)
        ls, lt = src_of[local], tgt[local] - lo
        rs, rt = src_of[~local], tgt[~local]
        l_indptr = np.zeros(nl + 1, dtype=np.int64)
        np.cumsum(np.bincount(ls, minlength=nl), out=l_indptr[1:])
        r_indptr = np.zeros(nl + 1, dtype=np.int64)
        np.cumsum(np.bincount(rs, minlength=nl), out=r_indptr[1:])
        slices.append(RankSlice(
            rank=k, ranks=ranks, lo=lo, hi=hi, bounds=bounds,
            indeg=ig.pred_n[lo:hi].astype(np.int64),
            l_indptr=l_indptr, l_tgt=lt, r_indptr=r_indptr, r_tgt=rt,
            expected_in=int(exp_in[k])))
    return slices


# ---------------------------------------------------------------- messages
@dataclass
class MsgBatch:
    """One active-message batch: decrements for one destination rank.

    ``tgt`` holds global target ids, ``lvl`` the candidate wavefront
    levels (source level + 1) riding along so the receiver's
    ``np.maximum.at`` keeps levels exact without any barrier.  ``seq``
    orders the ``src -> dst`` channel for exactly-once admission.
    """

    src: int
    dst: int
    seq: int
    tgt: "np.ndarray"
    lvl: "np.ndarray"


class Mailbox:
    """Exactly-once admission of decrement batches, per source channel.

    Channels are FIFO (queue transports preserve order), so a batch is a
    duplicate iff its sequence number is behind the channel cursor —
    re-sent or replayed batches are dropped and counted, never applied
    twice (a double decrement would corrupt the counter invariant).
    """

    def __init__(self, ranks: int):
        self._next = [0] * ranks
        self.duplicates = 0
        self.admitted_batches = 0
        self.admitted_msgs = 0

    def admit(self, batch: MsgBatch) -> bool:
        if batch.seq < self._next[batch.src]:
            self.duplicates += 1
            return False
        self._next[batch.src] = batch.seq + 1
        self.admitted_batches += 1
        self.admitted_msgs += int(batch.tgt.shape[0])
        return True


@dataclass
class RankStats:
    """Per-rank observables of one distributed run (picklable)."""

    rank: int
    n_local: int
    started: int
    supersteps: int
    msgs_out: int
    msgs_in: int
    batches_out: int
    batches_in: int
    duplicates: int
    seconds: float


# ----------------------------------------------------------- rank engines
def _gather(indptr, tgt, front, level):
    """All out-edges of ``front`` through a CSR: (targets, src level + 1)."""
    starts = indptr[front]
    counts = indptr[front + 1] - starts
    tot = int(counts.sum())
    if not tot:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    csum = np.cumsum(counts)
    eidx = (np.repeat(starts - (csum - counts), counts)
            + np.arange(tot, dtype=np.int64))
    cand = np.repeat(level[front] + 1, counts)
    return tgt[eidx], cand


class _Rank:
    """What both engines share: termination, the outbox, the stats."""

    def __init__(self, sl: RankSlice):
        self.sl = sl
        self.level = np.zeros(sl.n_local, dtype=np.int64)
        self.started = 0
        self.received = 0
        self.mail = Mailbox(sl.ranks)
        self.out_seq = [0] * sl.ranks
        self.supersteps = 0
        self.msgs_out = 0
        self.batches_out = 0
        self._t0 = time.perf_counter()

    @property
    def done(self) -> bool:
        return (self.started == self.sl.n_local
                and self.received == self.sl.expected_in)

    def _host_indeg(self) -> "np.ndarray":
        return self.indeg

    def undrained(self) -> dict:
        indeg = self._host_indeg()
        und = np.flatnonzero(indeg != 0)
        return {int(t + self.sl.lo): int(indeg[t]) for t in und[:1024]}

    def stats(self) -> RankStats:
        return RankStats(
            rank=self.sl.rank, n_local=self.sl.n_local, started=self.started,
            supersteps=self.supersteps, msgs_out=self.msgs_out,
            msgs_in=self.mail.admitted_msgs, batches_out=self.batches_out,
            batches_in=self.mail.admitted_batches,
            duplicates=self.mail.duplicates,
            seconds=time.perf_counter() - self._t0)

    def _outbox(self, rt, rc) -> list[MsgBatch]:
        """Cross-rank decrements as one sequenced batch per destination."""
        out: list[MsgBatch] = []
        if not rt.size:
            return out
        sl = self.sl
        dst = np.searchsorted(sl.bounds, rt, side="right") - 1
        order = np.argsort(dst, kind="stable")
        rt, rc, dst = rt[order], rc[order], dst[order]
        cuts = np.flatnonzero(np.diff(dst)) + 1
        firsts = np.concatenate([[0], cuts])
        for t, c, at in zip(np.split(rt, cuts), np.split(rc, cuts), firsts):
            d = int(dst[at])
            out.append(MsgBatch(src=sl.rank, dst=d, seq=self.out_seq[d],
                                tgt=t, lvl=c))
            self.out_seq[d] += 1
            self.msgs_out += int(t.size)
            self.batches_out += 1
        return out


class RankEngine(_Rank):
    """One rank's counted sweep — sparse NumPy frontier, fully async.

    Ready local tasks are processed in whatever order their counters
    drain (batch FIFO), local out-edges decrement in place, cross-rank
    out-edges batch into the outbox.  Levels max-propagate through the
    carried ``source level + 1`` candidates, so the result is independent
    of message arrival order — the asynchrony never shows in the output.
    """

    def __init__(self, sl: RankSlice):
        super().__init__(sl)
        self.indeg = sl.indeg.copy()
        self.pending: deque = deque()
        roots = np.flatnonzero(self.indeg == 0)
        if roots.size:
            self.pending.append(roots)

    @property
    def pending_size(self) -> int:
        return sum(int(a.size) for a in self.pending)

    def _drain(self, tgt_local, cand) -> None:
        """Apply decrements + level candidates; queue newly-ready tasks."""
        np.maximum.at(self.level, tgt_local, cand)
        touched, dec = np.unique(tgt_local, return_counts=True)
        self.indeg[touched] -= dec
        newly = touched[self.indeg[touched] == 0]
        if newly.size:
            self.pending.append(newly)

    def superstep(self) -> list[MsgBatch]:
        """Process every currently-ready local task; return the outbox."""
        if not self.pending:
            return []
        front = (self.pending.popleft() if len(self.pending) == 1
                 else np.concatenate(list(self.pending)))
        self.pending.clear()
        self.started += int(front.size)
        self.supersteps += 1
        sl = self.sl
        lt, lc = _gather(sl.l_indptr, sl.l_tgt, front, self.level)
        rt, rc = _gather(sl.r_indptr, sl.r_tgt, front, self.level)
        if lt.size:
            self._drain(lt, lc)
        return self._outbox(rt, rc)

    def apply(self, batch: MsgBatch) -> None:
        """Message-triggered decrement: admit exactly once, then drain."""
        if not self.mail.admit(batch):
            return
        self.received += int(batch.tgt.shape[0])
        self._drain(batch.tgt - self.sl.lo, batch.lvl)


class DeviceRankEngine(_Rank):
    """BSP rank engine on the card's decrement step — inline transport only.

    Steps the rank's *local* counters through :func:`~repro_torch.core.edt
    .device.wavefront_step`, the hand-written kernel of the single-host
    discover sweep, over the local transpose-CSR edge columns (uploaded
    once).  The counters and the next frontier's mask stay on ``device``:
    a cross-rank batch is applied there (``index_add_`` of the negated
    per-target counts), and the host reads back only the ids of the next
    frontier, once a round.  Because the inline transport barriers every
    rank each round, the superstep index *is* the global wavefront level
    (lockstep Kahn), so levels need no carried candidates.  ``device``
    defaults to CUDA (the kernel launches or the step raises); on
    ``device="cpu"`` the step is its plain torch version.
    """

    def __init__(self, sl: RankSlice, device=None):
        super().__init__(sl)
        self.device = dev = default_device(device)
        nl = sl.n_local
        src_of = np.repeat(np.arange(nl, dtype=np.int64),
                           np.diff(sl.l_indptr))
        torder = np.argsort(sl.l_tgt, kind="stable")
        dec_ptr = np.zeros(nl + 1, dtype=np.int32)
        np.cumsum(np.bincount(sl.l_tgt, minlength=nl), out=dec_ptr[1:])
        self._dec_src = upload(src_of[torder].astype(np.int32), dev)
        self._dec_ptr = upload(dec_ptr, dev)
        self.indeg = upload(sl.indeg.astype(np.int32), dev)
        self._ready = self.indeg == 0    # the next frontier, as a mask
        self._ids: Optional[np.ndarray] = None   # its ids; None: not read
        self.round = 0

    def _host_indeg(self) -> "np.ndarray":
        return self.indeg.cpu().numpy()

    def _frontier(self) -> "np.ndarray":
        """Ids of the next frontier, read back once after each change."""
        if self._ids is None:
            self._ids = torch.nonzero(self._ready).flatten().cpu().numpy()
        return self._ids

    @property
    def pending_size(self) -> int:
        return int(self._frontier().size)

    def superstep(self) -> list[MsgBatch]:
        """One BSP round: device-step the frontier, emit the outbox.

        Rounds advance even when the frontier is empty (the rank idles a
        wavefront) so the round counter stays the global level index.
        """
        cur = self.round
        self.round = cur + 1
        ids = self._frontier()
        if not ids.size:
            return []
        sl = self.sl
        self.level[ids] = cur
        self.started += int(ids.size)
        self.supersteps += 1
        self.indeg, self._ready = wavefront_step(
            self.indeg, self._ready, self._dec_src, self._dec_ptr)
        self._ids = None
        rt, _ = _gather(sl.r_indptr, sl.r_tgt, ids, self.level)
        return self._outbox(rt, np.full(rt.size, cur + 1, dtype=np.int64))

    def apply(self, batch: MsgBatch) -> None:
        """Admit exactly once, decrement on the card, mark the drained."""
        if not self.mail.admit(batch):
            return
        self.received += int(batch.tgt.shape[0])
        touched, dec = np.unique(batch.tgt - self.sl.lo, return_counts=True)
        cols = torch.from_numpy(np.stack([touched, -dec])).to(
            self.device)        # one upload: ids, negated counts
        t = cols[0]
        self.indeg.index_add_(0, t, cols[1].to(self.indeg.dtype))
        self._ready[t] |= self.indeg[t] == 0
        self._ids = None


def _make_engine(sl: RankSlice, engine: str, device):
    if engine == "numpy":
        return RankEngine(sl)
    if engine == "device":
        return DeviceRankEngine(sl, device=device)
    raise ValueError(f"unknown rank engine {engine!r} "
                     "(expected 'numpy' or 'device')")


# --------------------------------------------------------------- transports
def _lose_or_send(batch: MsgBatch, send, faults: Optional[FaultPlan],
                  attempt: int, dropped: set, record: bool) -> None:
    """Deliver one batch, dropping the first per faulted channel/attempt."""
    if faults is not None:
        f = faults.message_fault(batch.src, batch.dst)
        if (f is not None and attempt < f.times
                and (batch.src, batch.dst) not in dropped):
            dropped.add((batch.src, batch.dst))
            if record:
                faults.record(MESSAGE_LOSS, (batch.src, batch.dst), attempt)
            return
    send(batch)


def _stall_report(engines, context: str, elapsed: float) -> StallReport:
    und: dict = {}
    for e in engines:
        und.update(e.undrained())
    started = sum(e.started for e in engines)
    missing = sum(e.sl.expected_in - e.received for e in engines)
    return StallReport(
        context=context, elapsed=elapsed, started=started, finished=started,
        in_flight=0, undrained=und,
        note=(f"counted sweep reached a fixpoint with {len(und)} counter(s) "
              f"undrained and {missing} expected cross-rank decrement(s) "
              "missing — a message was lost or the graph has a cycle"))


def _run_inline(slices, engine: str, faults: Optional[FaultPlan],
                attempt: int, device=None):
    """All ranks in one process, round-robin BSP rounds — deterministic."""
    engines = [_make_engine(sl, engine, device) for sl in slices]
    queues = [deque() for _ in slices]
    dropped: set = set()
    t0 = time.perf_counter()
    while True:
        for eng, q in zip(engines, queues):
            while q:
                eng.apply(q.popleft())
        if all(e.done for e in engines):
            return engines
        moved = False
        for k, eng in enumerate(engines):
            if faults is not None and not eng.done:
                crash = faults.rank_fault(k)
                if (crash is not None and attempt < crash.times
                        and eng.started > 0):
                    faults.record(RANK_CRASH, k, attempt)
                    raise InjectedRankCrash(k, attempt)
            moved = moved or eng.pending_size > 0
            for b in eng.superstep():
                _lose_or_send(b, queues[b.dst].append, faults, attempt,
                              dropped, record=True)
        if not moved and not any(queues):
            raise StallError(_stall_report(
                engines, "distributed-inline", time.perf_counter() - t0))


def _rank_worker(sl: RankSlice, faults: Optional[FaultPlan], attempt: int,
                 inboxes, result_q, timeout: float) -> None:
    """One rank as an OS process (module-level: spawn-start safe).

    Runs the async NumPy engine to local termination (no device is
    touched); an empty frontier blocks on the inbox with ``timeout`` as
    the stall bound — expiring it reports a :class:`StallReport` (the
    message-loss surface) instead of hanging.  Injected crashes report
    (soft) or kill the process (hard); the driver converts either into a
    failed attempt.
    """
    try:
        eng = RankEngine(sl)
        crash = faults.rank_fault(sl.rank) if faults is not None else None
        dropped: set = set()
        t0 = time.perf_counter()
        while not eng.done:
            for b in eng.superstep():
                _lose_or_send(b, inboxes[b.dst].put, faults, attempt,
                              dropped, record=False)
            if crash is not None and attempt < crash.times and eng.started:
                if crash.hard:
                    os._exit(1)
                raise InjectedRankCrash(sl.rank, attempt)
            if eng.done or eng.pending_size:
                continue
            try:
                eng.apply(inboxes[sl.rank].get(timeout=timeout))
            except Empty:
                result_q.put(("stall", sl.rank, _stall_report(
                    [eng], "distributed-rank", time.perf_counter() - t0)))
                return
            while True:
                try:
                    eng.apply(inboxes[sl.rank].get_nowait())
                except Empty:
                    break
        result_q.put(("ok", sl.rank, eng.level, eng.stats()))
    except InjectedRankCrash as e:
        result_q.put(("crash", sl.rank, repr(e)))
    except BaseException as e:  # noqa: BLE001 — any rank death is a report
        result_q.put(("error", sl.rank, repr(e)))


def _rank_failure(kind: str, rank, err, done: int, total: int,
                  attempt: int) -> RankFailureError:
    report = FailureReport(
        context="distributed", failed=[(("rank", rank), err)],
        executed=done, total=total, attempts={("rank", rank): attempt + 1})
    return RankFailureError(report, msg=(
        f"rank {rank} {kind} (attempt {attempt}): {err}"))


def _run_processes(slices, faults: Optional[FaultPlan], attempt: int,
                   timeout: float, start_method: Optional[str]):
    """One OS process per rank, multiprocessing queues as the fabric."""
    import multiprocessing as mp

    ctx = mp.get_context(start_method) if start_method else mp.get_context()
    inboxes = [ctx.Queue() for _ in slices]
    result_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_worker,
                         args=(sl, faults, attempt, inboxes, result_q,
                               timeout),
                         daemon=True)
             for sl in slices]
    results: dict = {}
    wd = Watchdog(progress=lambda: (len(results), 0),
                  stall_timeout=max(5 * timeout, 60.0),
                  context="distributed-driver")
    try:
        for p in procs:
            p.start()
        with wd:
            while len(results) < len(slices):
                if wd.stalled.is_set():
                    raise StallError(wd.report)
                try:
                    msg = result_q.get(timeout=0.2)
                except Empty:
                    for p, sl in zip(procs, slices):
                        if (sl.rank not in results and not p.is_alive()
                                and p.exitcode not in (0, None)):
                            raise _rank_failure(
                                "died", sl.rank, f"exitcode {p.exitcode}",
                                len(results), len(slices), attempt)
                    continue
                kind, rank = msg[0], msg[1]
                if kind == "ok":
                    results[rank] = (msg[2], msg[3])
                elif kind == "stall":
                    raise StallError(msg[2])
                else:
                    raise _rank_failure(kind, rank, msg[2], len(results),
                                        len(slices), attempt)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
        for q in [*inboxes, result_q]:
            q.cancel_join_thread()
            q.close()
    return results


# ------------------------------------------------------------------ driver
@dataclass
class DistributedRun:
    """Result of one distributed counted-sync run, merged host-side.

    ``levels``/``level_of`` are the union of the per-rank frontiers —
    byte-identical to the single-host discover sweep and to
    ``schedule_from_graph`` for the same graph.  ``attempts`` counts
    retries consumed (0 = clean first attempt); ``rank_stats`` carries
    each rank's task and message volume.
    """

    ranks: int
    engine: str
    transport: str
    levels: list
    level_of: "np.ndarray"
    rank_stats: list = field(default_factory=list)
    attempts: int = 0

    @property
    def n(self) -> int:
        return int(self.level_of.shape[0])

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def exec_order(self) -> "np.ndarray":
        """Global ids in execution order (level-major, ascending within a
        level) — what the host simulator records for the same schedule."""
        if not self.levels:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self.levels)

    def summary(self) -> dict:
        return {
            "ranks": self.ranks, "engine": self.engine,
            "transport": self.transport, "tasks": self.n,
            "depth": self.depth, "attempts": self.attempts,
            "msgs": sum(s.msgs_out for s in self.rank_stats),
            "batches": sum(s.batches_out for s in self.rank_stats),
            "duplicates": sum(s.duplicates for s in self.rank_stats),
        }


def run_distributed(graph: Union[TiledTaskGraph, IndexedGraph],
                    params: Optional[dict] = None, *,
                    ranks: int = 2,
                    engine: str = "numpy",
                    transport: Optional[str] = None,
                    faults: Optional[FaultPlan] = None,
                    recovery: Optional[RetryPolicy] = None,
                    device=None,
                    start_method: Optional[str] = None,
                    timeout: Optional[float] = None) -> DistributedRun:
    """Execute the counted-sync model across ``ranks`` task-range owners.

    Accepts a :class:`TiledTaskGraph` + ``params`` (generated in process)
    or a pre-built :class:`IndexedGraph`.  ``transport`` defaults to
    ``"processes"`` for the NumPy engine and ``"inline"`` for the device
    engine (which is level-synchronous and therefore inline-only).
    ``device`` is where the device engine keeps its counters: CUDA unless
    the caller passes ``device="cpu"`` (the NumPy engine runs on the host
    and ignores it).  ``faults`` arms ``RANK_CRASH``/``MESSAGE_LOSS``
    injection; ``recovery`` (a :class:`RetryPolicy`) retries failed
    attempts with backoff — attempts are pure, so a recovered run is
    byte-identical to a fault-free one.  ``timeout`` (or
    ``recovery.timeout``) bounds how long a rank waits on an empty inbox
    before reporting a stall.
    """
    if isinstance(graph, TiledTaskGraph):
        if params is None:
            raise TypeError("params required with a TiledTaskGraph")
        ig = graph.index_graph(params)
    else:
        ig = graph
    if transport is None:
        transport = "processes" if engine == "numpy" else "inline"
    if transport not in ("inline", "processes"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "processes" and engine != "numpy":
        raise ValueError(
            "the device rank engine is level-synchronous and runs on the "
            "inline transport only (device state does not survive the rank "
            "process boundary); use engine='numpy' across processes")
    if engine == "device":
        device = default_device(device)
    if timeout is None:
        timeout = (recovery.timeout if recovery is not None
                   and recovery.timeout is not None
                   else DEFAULT_STALL_TIMEOUT)
    if ig.n == 0:
        return DistributedRun(ranks=ranks, engine=engine, transport=transport,
                              levels=[], level_of=np.zeros(0, dtype=np.int64))
    slices = partition_graph(ig, ranks)
    attempt = 0
    while True:
        try:
            if transport == "inline":
                engines = _run_inline(slices, engine, faults, attempt, device)
                parts = {e.sl.rank: (e.level, e.stats()) for e in engines}
            else:
                parts = _run_processes(slices, faults, attempt, timeout,
                                       start_method)
            break
        except (StallError, RankFailureError, InjectedRankCrash) as e:
            if transport == "processes" and faults is not None:
                # the worker's plan copy (and its fired log) died with the
                # worker — reconstruct the fires driver-side
                for f in faults.dist_kinds():
                    if attempt < f.times:
                        site = (f.index if f.kind == RANK_CRASH
                                else (f.round, f.index))
                        faults.record(f.kind, site, attempt, e)
            attempt += 1
            if recovery is None or attempt > recovery.max_retries:
                raise
            time.sleep(recovery.base_delay
                       * recovery.backoff ** (attempt - 1))
    level_of = np.empty(ig.n, dtype=np.int64)
    stats = []
    for sl in slices:
        lvl, st = parts[sl.rank]
        level_of[sl.lo:sl.hi] = lvl
        stats.append(st)
    return DistributedRun(
        ranks=ranks, engine=engine, transport=transport,
        levels=levels_from_array(level_of), level_of=level_of,
        rank_stats=stats, attempts=attempt)
