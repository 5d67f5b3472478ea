"""Counted-sync execution of index graphs on the card.

The flat arrays of an :class:`IndexedGraph` are packed **once** into int32
columns and uploaded, and the §2 *counted* synchronization model —
predecessor counters decremented by completions, a task ready exactly when
its counter drains — runs on the device.

Two sweeps share the packed graph:

* **discover** (no schedule input) — the device derives the frontiers
  itself.  Each level decrements every frontier task's successors and
  emits the next ready frontier from the counters alone, in one launch of
  the hand-written CUDA kernel :func:`wavefront_step` (``csrc/
  wavefront_step.cu``), a segmented reduction over the transpose-CSR edge
  columns.  The host reads one scalar a level (the frontier's width), which
  both ends the loop and feeds the counters.  Work is ``O(depth * (V +
  E))`` — the dense-frontier tradeoff every fixed-shape runtime makes.
* **replay** (schedule packed too) — the million-task path.  Edges are
  pre-sorted by source wavefront, so one loop over levels touches each
  edge exactly once (``O(V + E)`` total): a level's out-edges are a
  contiguous slice, scatter-decremented with ``index_add_``.  The level
  boundaries are host integers, so each level is an exact-width slice and
  the loop reads nothing back from the device until it ends.  The counters
  are *checked*, not merely trusted: violation counters accumulate (a) any
  task whose counter is nonzero when its level starts, (b) any task whose
  counter drained before the level preceding its own, and (c) any counter
  left undrained at the end.  All three at zero proves the packed schedule
  is exactly the counted-model execution.

:class:`DeviceExecutor` wraps both behind one ``run()``, mirroring the
reference package's observable counters (tasks started/finished, max
in-flight, per-level widths).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ...compat import default_device
from .config import UNSET, resolve_execution
from .faults import DROPPED_DECREMENT
from .recovery import ScheduleValidationError, StallError, StallReport
from .taskgraph import IndexedGraph, TiledTaskGraph
from .wavefront import IndexedSchedule, levels_from_array

_I32_MAX = np.iinfo(np.int32).max


# ------------------------------------------------------------------ packing
@dataclass
class DeviceGraph:
    """An :class:`IndexedGraph` as int32 columns, ready to upload.

    Successors are CSR by source (the put-loop order: ``succ[indptr[t] :
    indptr[t+1]]`` are task ``t``'s out-edges, lexicographic); the
    transpose columns (``dec_src`` grouped by target via ``dec_ptr``) drive
    the counter decrement as a segment sum.  ``pred_n`` is the §4.3 counter
    init vector.  Everything is int32 — a graph near 2^31 tasks or edges
    does not fit a single device anyway.
    """

    n: int
    n_edges: int
    indptr: "np.ndarray"     # i32[n+1]  CSR row starts, source-major
    succ: "np.ndarray"       # i32[E]    edge targets, source-major lex order
    dec_src: "np.ndarray"    # i32[E]    edge sources, target-major order
    dec_ptr: "np.ndarray"    # i32[n+1]  per-target boundaries into dec_src
    pred_n: "np.ndarray"     # i32[n]    §4.3 predecessor counts


@dataclass
class DeviceSchedule:
    """An :class:`IndexedSchedule` packed for the replay sweep.

    ``order`` concatenates the levels (each level's ids ascend) and is
    padded with the sentinel id ``n`` so every level can be read as one
    fixed-size ``dynamic_slice`` of ``w_pad`` ids; ``task_ptr`` holds the
    level boundaries (two trailing entries pin the one-past-end reads).
    ``lvl_tgt`` holds every edge's *target*, sorted stably by the source's
    level, ``e_pad``-padded likewise — a level's out-edges are the slice
    ``[edge_ptr[l], edge_ptr[l+1])``, so the whole sweep touches each edge
    once.

    ``origin`` (optional, set by the fused executor's packing) carries the
    per-task tile-origin columns — row ``t`` is task ``t``'s iteration-space
    origin (tile coords × tile sizes), with a sentinel row at index ``n``
    whose negative time coordinate masks padded lanes; see
    :func:`~repro_torch.core.edt.fused.pack_origins`.
    """

    depth: int
    w_pad: int               # max level width (slice size for task ids)
    e_pad: int               # max out-edges of any level (slice size)
    order: "np.ndarray"      # i32[n + w_pad], sentinel-padded level concat
    task_ptr: "np.ndarray"   # i32[depth+2]
    lvl_tgt: "np.ndarray"    # i32[E + e_pad], sentinel-padded
    edge_ptr: "np.ndarray"   # i32[depth+1]
    levels: list             # the source IndexedSchedule levels (int64 ids)
    level_of: "np.ndarray"   # int64[n]
    origin: Optional["np.ndarray"] = None   # i32[n+1, ndim] tile origins


def pack_graph(ig: IndexedGraph) -> DeviceGraph:
    """CSR + transpose-CSR + counter-init columns, int32, host-side."""
    n, e = ig.n, ig.n_edges
    if max(n, e) >= _I32_MAX:
        raise ValueError(f"graph too large for int32 device ids: {n=} {e=}")
    order = np.argsort(ig.edge_src, kind="stable")
    succ = ig.edge_tgt[order].astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(ig.edge_src, minlength=n), out=indptr[1:])
    torder = np.argsort(ig.edge_tgt, kind="stable")
    dec_src = ig.edge_src[torder].astype(np.int32)
    dec_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(ig.pred_n, out=dec_ptr[1:])
    return DeviceGraph(n=n, n_edges=e, indptr=indptr, succ=succ,
                       dec_src=dec_src, dec_ptr=dec_ptr,
                       pred_n=ig.pred_n.astype(np.int32))


def pack_schedule(ig: IndexedGraph, schedule: IndexedSchedule,
                  origins: Optional["np.ndarray"] = None) -> DeviceSchedule:
    """Level-major task and edge columns for the O(V+E) replay sweep.

    ``origins`` (from :func:`~repro_torch.core.edt.fused.pack_origins`) attaches
    the fused executor's tile-origin columns so one packed object carries
    everything the fused replay sweep reads.
    """
    n = ig.n
    if max(n, ig.n_edges) >= _I32_MAX:
        raise ValueError(
            f"graph too large for int32 device ids: n={n} e={ig.n_edges}")
    depth = schedule.depth
    widths = np.asarray([lv.size for lv in schedule.levels], dtype=np.int64)
    order = (np.concatenate(schedule.levels).astype(np.int32) if depth
             else np.zeros(0, dtype=np.int32))
    counts = np.bincount(order, minlength=n) if n else np.zeros(0, np.int64)
    if order.shape[0] != n or (n and (counts != 1).any()):
        raise ValueError("schedule is not an exactly-once permutation of "
                         "the graph's task ids")
    w_pad = int(widths.max()) if depth else 1
    task_ptr = np.zeros(depth + 2, dtype=np.int32)
    task_ptr[1:depth + 1] = np.cumsum(widths)
    task_ptr[depth + 1] = n
    lv_src = schedule.level_of[ig.edge_src]
    eorder = np.argsort(lv_src, kind="stable")
    ecounts = np.bincount(lv_src, minlength=max(depth, 1))
    e_pad = max(int(ecounts.max()), 1)
    edge_ptr = np.zeros(depth + 1, dtype=np.int32)
    edge_ptr[1:] = np.cumsum(ecounts[:depth])
    sent = np.int32(n)
    return DeviceSchedule(
        depth=depth, w_pad=w_pad, e_pad=e_pad,
        order=np.concatenate([order, np.full(w_pad, sent, np.int32)]),
        task_ptr=task_ptr,
        lvl_tgt=np.concatenate([ig.edge_tgt[eorder].astype(np.int32),
                                np.full(e_pad, sent, np.int32)]),
        edge_ptr=edge_ptr,
        levels=schedule.levels, level_of=schedule.level_of, origin=origins)


# ----------------------------------------------------------- decrement step
def decrement_reference(indeg, frontier, dec_src, dec_ptr):
    """Pure-NumPy oracle for one counted-sync wavefront step.

    Given the current counters, the frontier mask, and the transpose-CSR
    edge columns: decrement each task's counter by its in-edges from the
    frontier and report which tasks just became ready.  Returns
    ``(new_indeg, newly_ready_mask)``.
    """
    active = frontier[dec_src].astype(np.int32)
    c = np.zeros(active.shape[0] + 1, dtype=np.int32)
    np.cumsum(active, out=c[1:])
    dec = c[dec_ptr[1:]] - c[dec_ptr[:-1]]
    new_indeg = indeg - dec
    return new_indeg, (new_indeg == 0) & (dec > 0)


def wavefront_step_torch(indeg: torch.Tensor, frontier: torch.Tensor,
                         dec_src: torch.Tensor, dec_ptr: torch.Tensor):
    """The plain torch version of :func:`wavefront_step`.

    The reference arithmetic in torch ops — gather the frontier bits of
    every edge source, an int32 cumsum, the row-boundary difference — on
    whatever device the tensors lie.  Returns ``(new_indeg, newly)``.
    """
    active = frontier[dec_src.long()].to(torch.int32)
    c = torch.zeros(active.shape[0] + 1, dtype=torch.int32,
                    device=active.device)
    torch.cumsum(active, 0, dtype=torch.int32, out=c[1:])
    ptr = dec_ptr.long()
    dec = c[ptr[1:]] - c[ptr[:-1]]
    new_indeg = indeg - dec
    return new_indeg, (new_indeg == 0) & (dec > 0)


@functools.cache
def _wavefront_lib() -> ctypes.CDLL:
    from ...kernels.build import load

    lib = load("wavefront_step")
    # every pointer and the stream as c_void_p: untyped, ctypes would pass
    # each Python int as a 32-bit C int and cut the address
    lib.wavefront_step.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.wavefront_step.restype = ctypes.c_int
    return lib


def _check_step_args(indeg, frontier, dec_src, dec_ptr) -> int:
    n = indeg.shape[0] if indeg.dim() == 1 else -1
    want = ((indeg, torch.int32, (n,)), (frontier, torch.bool, (n,)),
            (dec_src, torch.int32, (dec_src.numel(),)),
            (dec_ptr, torch.int32, (n + 1,)))
    for name, (t, dtype, shape) in zip(
            ("indeg", "frontier", "dec_src", "dec_ptr"), want):
        if t.device != indeg.device:
            raise ValueError(f"{name} is on {t.device}, indeg on "
                             f"{indeg.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(n, dec_src.numel()) >= _I32_MAX:
        raise ValueError(f"graph too large for int32 ids: n={n} "
                         f"e={dec_src.numel()}")
    return n


def wavefront_step(indeg: torch.Tensor, frontier: torch.Tensor,
                   dec_src: torch.Tensor, dec_ptr: torch.Tensor):
    """One counted-sync wavefront step: decrement and frontier emit.

    Replaces the Pallas kernel of the reference package
    (``repro/core/edt/device.py::make_pallas_step``).  For each task ``t``,
    ``dec[t]`` counts its in-edges whose source is in ``frontier``; returns
    ``(indeg - dec, (indeg - dec == 0) & (dec > 0))`` as int32 and bool.

    On CUDA tensors this launches the hand-written kernel of
    ``csrc/wavefront_step.cu`` on the current stream (built on first use)
    or raises; on CPU tensors it runs :func:`wavefront_step_torch`.  An
    edgeless graph launches nothing: ``indeg`` comes back unchanged and no
    task becomes ready.  ``wavefront_step.launches`` counts kernel launches.
    """
    if indeg.device.type == "cpu":
        return wavefront_step_torch(indeg, frontier, dec_src, dec_ptr)
    if indeg.device.type != "cuda":
        raise ValueError(f"wavefront_step runs on cuda or cpu tensors, not "
                         f"{indeg.device}")
    n = _check_step_args(indeg, frontier, dec_src, dec_ptr)
    if dec_src.numel() == 0:
        return indeg, torch.zeros(n, dtype=torch.bool, device=indeg.device)
    lib = _wavefront_lib()
    new_indeg = torch.empty_like(indeg)
    newly = torch.empty(n, dtype=torch.bool, device=indeg.device)
    stream = torch.cuda.current_stream(indeg.device).cuda_stream
    rc = lib.wavefront_step(indeg.data_ptr(), frontier.data_ptr(),
                            dec_src.data_ptr(), dec_ptr.data_ptr(),
                            new_indeg.data_ptr(), newly.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"wavefront_step kernel launch failed: CUDA "
                           f"error {rc}")
    wavefront_step.launches += 1
    return new_indeg, newly


wavefront_step.launches = 0


# ---------------------------------------------------------------- diagnosis
def _diagnose_replay(dg: DeviceGraph, ds: DeviceSchedule):
    """Host-side replay of the on-device validation, naming the offenders.

    The device sweep accumulates violation *counts* (cheap scalars on the
    device); when any is nonzero this NumPy twin re-walks the levels
    with the identical check order — (a) level tasks not ready, (b) next
    level ready early, (c) end-of-sweep undrained counters — and returns
    ``(kind, level, offending task ids, counter state)`` for the first
    violation, so the raised error carries evidence, not just totals.
    """
    indeg = dg.pred_n.astype(np.int64).copy()
    indptr = dg.indptr.astype(np.int64)
    succ = dg.succ.astype(np.int64)
    for level, ids in enumerate(ds.levels):
        bad = ids[indeg[ids] != 0]
        if bad.size:
            return "not-ready", level, bad, indeg
        if level + 1 < ds.depth:
            nxt = ds.levels[level + 1]
            early = nxt[indeg[nxt] == 0]
            if early.size:
                return "early-ready", level + 1, early, indeg
        starts = indptr[ids]
        counts = indptr[ids + 1] - starts
        tot = int(counts.sum())
        if tot:
            csum = np.cumsum(counts)
            eidx = (np.repeat(starts - (csum - counts), counts)
                    + np.arange(tot, dtype=np.int64))
            np.subtract.at(indeg, succ[eidx], 1)
    und = np.flatnonzero(indeg != 0)
    return "undrained", ds.depth, und, indeg


def _counter_summary(indeg: "np.ndarray") -> dict:
    und = np.flatnonzero(indeg != 0)
    return {
        "tasks": int(indeg.shape[0]),
        "undrained": int(und.size),
        "undrained_ids": und[:32].tolist(),
        "max_residual": int(indeg[und].max()) if und.size else 0,
    }


# ----------------------------------------------------------------- counters
@dataclass
class DeviceCounters:
    """The counters of the reference's host simulator, measured on device.

    ``tasks_started``/``tasks_finished`` mirror the simulator's dispatch
    counts (on the device every started wavefront task finishes within its
    level); ``max_in_flight`` is the widest wavefront — what the
    simulator's in-flight gauge peaks at once workers outnumber the
    frontier; ``level_widths`` are the per-level batch sizes.
    """

    tasks_started: int
    tasks_finished: int
    max_in_flight: int
    depth: int
    level_widths: "np.ndarray"

    def summary(self) -> dict:
        n = self.tasks_started
        return {"tasks_started": n,
                "tasks_finished": self.tasks_finished,
                "max_in_flight": self.max_in_flight,
                "depth": self.depth,
                "avg_width": n / max(1, self.depth)}


@dataclass
class DeviceRun:
    """Result of one device sweep: frontiers + counters, host-side.

    In discover mode ``levels``/``level_of`` are *computed* by the sweep;
    in replay mode they are the input schedule's own arrays, returned only
    after the on-device violation counters proved the schedule is exactly
    the counted-model execution — so "the frontiers match" is established
    by that validation, not by comparing these arrays back to their
    source.
    """

    mode: str                  # "discover" | "replay"
    levels: list               # int64 id arrays per level — the frontiers
    level_of: "np.ndarray"     # int64[n]
    counters: DeviceCounters

    @property
    def exec_order(self) -> "np.ndarray":
        """Global task ids in execution order (level-major, ids ascending
        within a level) — the host simulator's order for the same schedule."""
        if not self.levels:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self.levels)


# ------------------------------------------------------------------ sweeps
def upload(a: "np.ndarray", device: torch.device) -> torch.Tensor:
    """A host column as a tensor on ``device`` (dtype kept)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def counter_init(pred_n: "np.ndarray", faults) -> "np.ndarray":
    """The counters a discover sweep starts from, with injected faults.

    ``DROPPED_DECREMENT``: the counter is initialized one too high, so the
    matching signal "never arrives" — the exact state a lost decrement
    leaves behind in the counted model.
    """
    if faults is None:
        return pred_n
    dropped = [int(t) for t in faults.dropped_tasks()]
    if not dropped:
        return pred_n
    pred = pred_n.copy()
    for t in dropped:
        pred[t] += 1
        faults.record(DROPPED_DECREMENT, t, 0)
    return pred


def discover_sweep(pred: torch.Tensor, dec_src: torch.Tensor,
                   dec_ptr: torch.Tensor, on_level=None):
    """Self-leveling counted sweep from the counters alone.

    Each level records the frontier's level, runs ``on_level(frontier)``
    (the fused executor's tile bodies) and takes one
    :func:`wavefront_step`.  The host reads the frontier's width once a
    level: an empty frontier ends the loop, so no step runs on one and the
    level count is exactly the depth.  Returns ``(indeg, level_of, depth,
    started, max_width)``.
    """
    indeg, frontier = pred, pred == 0
    level_of = torch.full(pred.shape, -1, dtype=torch.int32,
                          device=pred.device)
    depth = started = maxw = 0
    while True:
        w = int(frontier.sum())
        if not w:
            break
        level_of.masked_fill_(frontier, depth)
        if on_level is not None:
            on_level(frontier)
        indeg, frontier = wavefront_step(indeg, frontier, dec_src, dec_ptr)
        depth += 1
        started += w
        maxw = max(maxw, w)
    return indeg, level_of, depth, started, maxw


def discover_result(n: int, indeg: torch.Tensor, level_of: torch.Tensor,
                    depth: int, started: int, maxw: int, context: str,
                    label: str):
    """Levels and counters of a finished discover sweep, or the stall.

    A sweep that stops with fewer than ``n`` tasks started reached a
    fixpoint with counters undrained — a cycle or a dropped decrement.
    Not an infinite hang, so it is diagnosed: the undrained counters name
    exactly the tasks whose signals never arrived.
    """
    if started != n:
        indeg = indeg.cpu().numpy()
        und = np.flatnonzero(indeg != 0)
        report = StallReport(
            context=context, elapsed=0.0,
            started=started, finished=started,
            in_flight=0,
            undrained={int(t): int(indeg[t]) for t in und[:1024]},
            note=(f"{label}counted-sync sweep reached a fixpoint with "
                  f"{und.size} counter(s) undrained — the task graph "
                  "has a cycle or a decrement was dropped"))
        raise StallError(report, msg=(
            f"{label}counted-sync sweep deadlocked: {started}/{n} tasks "
            "became ready — the task graph has a cycle or a decrement was "
            f"dropped; undrained: {und[:8].tolist()}"
            + (f" (+{und.size - 8} more)" if und.size > 8 else "")))
    level_of = level_of.cpu().numpy().astype(np.int64)
    levels = levels_from_array(level_of)
    widths = np.asarray([lv.size for lv in levels], dtype=np.int64)
    return levels, level_of, DeviceCounters(started, started, maxw, depth,
                                            widths)


def replay_sweep(dg: DeviceGraph, ds: DeviceSchedule, order: torch.Tensor,
                 lvl_tgt: torch.Tensor, pred: torch.Tensor,
                 validate: bool = True, on_level=None) -> tuple:
    """The O(V+E) leveled sweep with the three validation counters.

    Level boundaries are host integers, so each level reads an exact-width
    slice of task ids and of out-edge targets and nothing is read back
    until the end.  Per level: (a) count the level's tasks whose counter
    has not drained, (b) count the next level's tasks already drained —
    checked level by level, this pins every task's drain to exactly the
    level before its own — then run ``on_level(ids)`` and decrement the
    level's out-edges.  (c) counts the counters left undrained.  Returns
    ``(not_ready, early, undrained)`` (zeros when ``validate`` is False).
    """
    indeg = pred.clone()
    tp, ep = ds.task_ptr.tolist(), ds.edge_ptr.tolist()
    neg = torch.full((ds.e_pad,), -1, dtype=torch.int32, device=pred.device)
    not_ready, early, undrained = (
        torch.zeros((), dtype=torch.int64, device=pred.device)
        for _ in range(3))
    for level in range(ds.depth):
        ids = order[tp[level]:tp[level + 1]]
        if validate:
            not_ready += (indeg.index_select(0, ids) != 0).sum()
            nids = order[tp[level + 1]:tp[level + 2]]
            early += (indeg.index_select(0, nids) == 0).sum()
        if on_level is not None:
            on_level(ids)
        lo, hi = ep[level], ep[level + 1]
        indeg.index_add_(0, lvl_tgt[lo:hi], neg[:hi - lo])
    if validate:
        undrained = (indeg != 0).sum()
    return tuple(torch.stack([not_ready, early, undrained]).tolist())


def replay_result(dg: DeviceGraph, ds: DeviceSchedule, tally: tuple):
    """Counters of a validated replay, or the diagnosed violation.

    The device counted the violations; when any is nonzero the offenders
    are re-derived host-side so the error carries evidence, not just
    totals.
    """
    not_ready, early, undrained = tally
    if not_ready or early or undrained:
        kind, level, ids, indeg = _diagnose_replay(dg, ds)
        counters = _counter_summary(indeg)
        counters.update(device_not_ready=not_ready, device_early=early,
                        device_undrained=undrained)
        raise ScheduleValidationError(kind, level, ids, counters)
    widths = np.asarray([lv.size for lv in ds.levels], dtype=np.int64)
    maxw = int(widths.max()) if widths.size else 0
    return DeviceCounters(dg.n, dg.n, maxw, ds.depth, widths)


# ---------------------------------------------------------------- executor
class DeviceExecutor:
    """Counted-sync execution of an index graph on the card.

    Construct from a :class:`TiledTaskGraph` (``params`` required;
    ``config=``/``session=`` drive the generation scans — shard fan-out,
    pool, recovery; a session serves the graph from its cache) or directly
    from an :class:`IndexedGraph`.  The per-call
    ``shards=``/``parallel=``/``pool=``/``faults=`` kwargs are the
    deprecated spelling of the same config; ``config.faults`` (a
    :class:`~.faults.FaultPlan`) arms dropped decrements, and with a
    :class:`TiledTaskGraph` also the shard faults of its generation scans.
    With ``schedule=`` (an :class:`IndexedSchedule`, e.g. from
    ``synthesize_indexed``) the O(V+E) replay sweep runs and *validates*
    the schedule against the counters; without it the discover sweep
    derives the frontiers on the device through :func:`wavefront_step`.
    ``packed=(DeviceGraph, DeviceSchedule | None)`` skips the host-side
    packing — the graph cache hands its stored columns through here, so a
    warm executor build packs nothing.  ``device`` defaults to CUDA and
    raises where there is none; pass ``device="cpu"`` for the plain torch
    versions.

    ``run()`` returns a :class:`DeviceRun` whose ``levels`` are
    byte-identical to ``synthesize_indexed``'s for the same graph.
    """

    def __init__(self, graph: Union[TiledTaskGraph, IndexedGraph],
                 params: Optional[dict] = None, *,
                 schedule: Optional[IndexedSchedule] = None,
                 shards=UNSET, parallel=UNSET, pool=UNSET, faults=UNSET,
                 config=None, session=None, packed=None, device=None):
        cfg, sess = resolve_execution(
            config, session, stacklevel=3,
            legacy=dict(shards=shards, parallel=parallel, pool=pool,
                        faults=faults))
        self.device = default_device(device)
        if isinstance(graph, TiledTaskGraph):
            if params is None:
                raise TypeError("params required with a TiledTaskGraph")
            ig = (sess.index_graph(graph, params) if sess is not None
                  else graph._index_graph_cfg(params, cfg))
        else:
            ig = graph
        if packed is not None and schedule is not None:
            raise TypeError("pass schedule= or packed=, not both")
        self.ig = ig
        self.faults = cfg.faults
        if packed is not None:
            self.dg, self.ds = packed
        else:
            self.dg = pack_graph(ig)
            self.ds = (pack_schedule(ig, schedule)
                       if schedule is not None else None)
        self._cols = None   # device columns, uploaded on the first run()

    def _columns(self) -> dict:
        if self._cols is None:
            dg, ds, dev = self.dg, self.ds, self.device
            self._cols = ({"order": upload(ds.order, dev),
                           "lvl_tgt": upload(ds.lvl_tgt, dev),
                           "pred": upload(dg.pred_n, dev)}
                          if ds is not None else
                          {"dec_src": upload(dg.dec_src, dev),
                           "dec_ptr": upload(dg.dec_ptr, dev)})
        return self._cols

    def run(self) -> DeviceRun:
        if self.dg.n == 0:
            counters = DeviceCounters(0, 0, 0, 0, np.zeros(0, np.int64))
            return DeviceRun("replay" if self.ds is not None else "discover",
                             [], np.zeros(0, np.int64), counters)
        if self.ds is not None:
            return self._run_replay()
        return self._run_discover()

    def _run_discover(self) -> DeviceRun:
        cols = self._columns()
        pred = upload(counter_init(self.dg.pred_n, self.faults), self.device)
        out = discover_sweep(pred, cols["dec_src"], cols["dec_ptr"])
        levels, level_of, counters = discover_result(
            self.dg.n, *out, context="device-discover", label="")
        return DeviceRun("discover", levels, level_of, counters)

    def _run_replay(self) -> DeviceRun:
        cols = self._columns()
        tally = replay_sweep(self.dg, self.ds, cols["order"],
                             cols["lvl_tgt"], cols["pred"])
        counters = replay_result(self.dg, self.ds, tally)
        return DeviceRun("replay", self.ds.levels, self.ds.level_of, counters)
