"""Wavefront leveling of index graphs — the counted model's frontiers.

Every task's earliest start level (longest-path depth in the tile graph)
is its wavefront index: all tasks of a level can run in parallel, and the
device sweeps (:mod:`.device`, :mod:`.fused`) either derive these levels
from the counters themselves (discover) or replay and validate them.

:func:`schedule_from_graph` levels a flat :class:`IndexedGraph` with a CSR
Kahn sweep in which each wavefront's out-edges are gathered, decremented,
and max-propagated as whole arrays — no per-task Python dispatch — on the
host, in NumPy.  It is the oracle the device sweeps are held against.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .taskgraph import IndexedGraph, TiledTaskGraph


@dataclass
class IndexedSchedule:
    """Wavefront levels in pure index space: arrays of global task ids.

    The million-task representation — no TaskId tuples, no dicts; levels
    feed the device sweeps straight from the merged arrays
    (:func:`~.device.pack_schedule`).  Ids within a level ascend, so
    iteration order is deterministic.
    """
    levels: list["np.ndarray"]
    level_of: "np.ndarray"   # level index per global task id

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def max_width(self) -> int:
        return max((int(lv.size) for lv in self.levels), default=0)

    def stats(self) -> dict:
        n = int(self.level_of.shape[0])
        return {"tasks": n, "depth": self.depth, "max_width": self.max_width,
                "avg_width": n / max(1, self.depth)}


def _level_array(ig: IndexedGraph) -> "np.ndarray":
    """Vectorized Kahn + longest-path over flat edge arrays.

    Each iteration retires one wavefront: the frontier's out-edges are
    gathered through a CSR index (ragged arange via repeat/cumsum), target
    levels max-propagate with ``np.maximum.at``, and in-degrees fall by
    per-target counts (``np.unique``).  The next frontier comes from the
    decremented targets only — O(V + E log E) total, never a full-array
    rescan per level.  Returns the longest-path level per global task id.
    """
    n = ig.n
    order = np.argsort(ig.edge_src, kind="stable")
    es = ig.edge_src[order]
    et = ig.edge_tgt[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(es, minlength=n), out=indptr[1:])
    indeg = ig.pred_n.copy()
    level = np.zeros(n, dtype=np.int64)
    frontier = np.flatnonzero(indeg == 0)
    done = 0
    while frontier.size:
        done += frontier.size
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        tot = int(counts.sum())
        if not tot:
            break
        csum = np.cumsum(counts)
        eidx = np.repeat(starts - (csum - counts), counts) + np.arange(tot, dtype=np.int64)
        tg = et[eidx]
        np.maximum.at(level, tg, np.repeat(level[frontier] + 1, counts))
        touched, dec = np.unique(tg, return_counts=True)
        indeg[touched] -= dec
        # a task enters the frontier exactly when its last get is satisfied
        frontier = touched[indeg[touched] == 0]
    assert done == n, "cycle in task graph"
    return level


def levels_from_array(level: "np.ndarray") -> list["np.ndarray"]:
    """Bucket global task ids by level with one stable argsort.

    ``level`` is an int array of per-task level indices (0-based, dense).
    Returns int64 id arrays per level with ids ascending within each —
    the exact :class:`IndexedSchedule.levels` layout.  Shared by
    :func:`synthesize_indexed` and the device executor
    (:mod:`repro_torch.core.edt.device`) so both derive byte-identical frontiers
    from a ``level_of`` array.
    """
    if not level.size:
        return []
    order = np.argsort(level, kind="stable")   # ids ascend within a level
    bounds = np.cumsum(np.bincount(level))[:-1]
    return np.split(order, bounds)


def schedule_from_graph(ig: IndexedGraph) -> IndexedSchedule:
    """Level an already-materialized index graph (pure index space).

    The second half of :func:`synthesize_indexed`, split out so callers
    holding a cached :class:`IndexedGraph` (the graph cache, the schedule
    service) never re-materialize just to level.
    """
    level = _level_array(ig)
    return IndexedSchedule(levels=levels_from_array(level), level_of=level)


def synthesize_indexed(graph: TiledTaskGraph, params: dict,
                       shards: int = 0) -> tuple[IndexedGraph, IndexedSchedule]:
    """Level the graph without ever leaving index space.

    The million-task path: the index graph is leveled by
    :func:`_level_array` and bucketed with one stable argsort — no TaskId
    tuples, no per-task dicts.  Returns the graph too, since executors need
    the id -> label blocks only if they label at all.  ``shards`` as in
    :meth:`TiledTaskGraph.index_graph` (in-process only).
    """
    ig = graph.index_graph(params, shards=shards)
    return ig, schedule_from_graph(ig)
