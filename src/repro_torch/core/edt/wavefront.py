"""Static wavefront schedules — the counted model resolved ahead of time.

Every task's earliest start level (longest-path depth in the tile graph)
is its wavefront index: all tasks of a level can run in parallel, and the
device sweeps (:mod:`.device`, :mod:`.fused`) either derive these levels
from the counters themselves (discover) or replay and validate them.  For
uniform dependences (constant distance vectors — pipelines, stencils) the
wavefront index also has a closed affine form
(:func:`closed_form_level`), so huge tile spaces never need
materializing.

:func:`schedule_from_graph` levels a flat :class:`IndexedGraph` with a CSR
Kahn sweep in which each wavefront's out-edges are gathered, decremented,
and max-propagated as whole arrays — no per-task Python dispatch — on the
host, in NumPy.  It is the oracle the device sweeps are held against.
:func:`synthesize` gives the same levels with :data:`TaskId` labels (from
the index arrays for ``numpy``-backend graphs, by walking the dict graph
otherwise), and :func:`simulate_schedule` / :func:`simulate_indexed`
execute either form on the instrumented :class:`~.executor.Sim`, one
level a batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np

from .config import UNSET, resolve_execution
from .executor import Sim
from .taskgraph import IndexedGraph, TaskId, TiledTaskGraph


@dataclass
class WavefrontSchedule:
    levels: list[list[TaskId]]
    level_of: dict[TaskId, int]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def max_width(self) -> int:
        return max((len(lv) for lv in self.levels), default=0)

    def stats(self) -> dict:
        n = sum(len(lv) for lv in self.levels)
        return {"tasks": n, "depth": self.depth, "max_width": self.max_width,
                "avg_width": n / max(1, self.depth)}


@dataclass
class IndexedSchedule:
    """Wavefront levels in pure index space: arrays of global task ids.

    The million-task representation — no TaskId tuples, no dicts; levels
    feed the device sweeps straight from the merged arrays
    (:func:`~.device.pack_schedule`) and the executor in batches
    (:func:`simulate_indexed` / :meth:`Sim.make_ready_ids`).  Ids within a level ascend, so
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


def synthesize(graph: TiledTaskGraph, params: dict, shards=UNSET,
               parallel=UNSET, pool=UNSET, faults=UNSET, recovery=UNSET, *,
               config=None, session=None) -> WavefrontSchedule:
    """Longest-path leveling of the tile graph.

    ``numpy``-backend graphs level from flat index arrays (whole wavefronts
    per step); the scalar path materializes and walks the dict graph.  Both
    produce identical schedules.  Execution knobs arrive via
    ``config=``/``session=`` (the per-call kwargs are the deprecated
    spelling); sharded configs fan the underlying scans across processes
    (any backend) — the schedule is unchanged, only generation
    parallelizes.
    """
    cfg, sess = resolve_execution(
        config, session, stacklevel=3,
        legacy=dict(shards=shards, parallel=parallel, pool=pool,
                    faults=faults, recovery=recovery))
    if sess is not None:
        return sess.synthesize(graph, params)
    if cfg.resolve_shards() > 1 or graph.backend == "numpy":
        return _synthesize_from_ig(graph._index_graph_cfg(params, cfg))
    g = graph._materialize_cfg(params, cfg)
    indeg = dict(g.pred_n)
    level = {t: 0 for t in g.tasks}
    cur = sorted(t for t in g.tasks if indeg[t] == 0)
    levels: list[list[TaskId]] = []
    placed = 0
    while cur:
        levels.append(cur)
        placed += len(cur)
        nxt = set()
        for t in cur:
            for s in g.succ[t]:
                indeg[s] -= 1
                level[s] = max(level[s], level[t] + 1)
                if indeg[s] == 0:
                    nxt.add(s)
        cur = sorted(nxt)
    assert placed == len(g.tasks), "cycle in task graph"
    # re-bucket by longest-path level (Kahn order may under-level)
    buckets: dict[int, list[TaskId]] = {}
    for t, lv in level.items():
        buckets.setdefault(lv, []).append(t)
    levels = [sorted(buckets[lv]) for lv in sorted(buckets)]
    return WavefrontSchedule(levels, level)


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


def _synthesize_from_ig(ig: IndexedGraph) -> WavefrontSchedule:
    """Array-leveled schedule with TaskId labels (see :func:`_level_array`)."""
    lv = _level_array(ig).tolist()
    level_of = dict(zip(ig.tasks, lv))
    buckets: dict[int, list[TaskId]] = {}
    for t, l_ in zip(ig.tasks, lv):
        buckets.setdefault(l_, []).append(t)
    levels = [sorted(buckets[l_]) for l_ in sorted(buckets)]
    return WavefrontSchedule(levels, level_of)


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


def synthesize_indexed(graph: TiledTaskGraph, params: dict, shards=UNSET,
                       parallel=UNSET, pool=UNSET, faults=UNSET,
                       recovery=UNSET, *, config=None,
                       session=None) -> tuple[IndexedGraph, IndexedSchedule]:
    """Level the graph without ever leaving index space.

    The sharded/million-task path: the (optionally sharded) index graph is
    leveled by :func:`_level_array` and bucketed with one stable argsort —
    no TaskId tuples, no per-task dicts.  Returns the graph too, since
    executors need the id -> label blocks only if they label at all.
    Knobs via ``config=``/``session=`` (session calls are cached — warm
    hits return the stored arrays); the per-call kwargs are deprecated.
    """
    cfg, sess = resolve_execution(
        config, session, stacklevel=3,
        legacy=dict(shards=shards, parallel=parallel, pool=pool,
                    faults=faults, recovery=recovery))
    if sess is not None:
        return sess.schedule(graph, params)
    ig = graph._index_graph_cfg(params, cfg)
    return ig, schedule_from_graph(ig)


def simulate_schedule(schedule: WavefrontSchedule, workers: int = 4,
                      task_dur: float = 1.0) -> Sim:
    """Execute a static wavefront schedule on the Sim, level by level.

    Each level is handed to the executor as ONE batch
    (:meth:`Sim.make_ready_batch`) — the on-device lowering where a whole
    wavefront launches together and the only sync is the level barrier.
    Returns the finished Sim (``exec_order``, ``counters.makespan``).
    """
    sim = Sim(workers, task_dur, setup_cost=0.0)

    def launch(i: int) -> None:
        if i >= len(schedule.levels):
            return
        lvl = schedule.levels[i]
        remaining = len(lvl)

        def done() -> None:
            nonlocal remaining
            remaining -= 1
            if remaining == 0:
                launch(i + 1)

        sim.make_ready_batch((t, done) for t in lvl)

    launch(0)
    sim.run()
    return sim


def simulate_indexed(schedule: IndexedSchedule, workers: int = 4,
                     task_dur: float = 1.0) -> Sim:
    """Execute an :class:`IndexedSchedule` level by level on the Sim.

    The array twin of :func:`simulate_schedule`: each level's id array is
    fed to the executor in one call (:meth:`Sim.make_ready_ids`) with a
    single shared completion callback — no per-task closures or labels, so
    the host-side cost of driving a merged million-task schedule is the
    queue itself.  ``exec_order`` holds global task ids.
    """
    sim = Sim(workers, task_dur, setup_cost=0.0)

    def launch(i: int) -> None:
        if i >= len(schedule.levels):
            return
        lvl = schedule.levels[i]
        state = {"remaining": int(lvl.size)}

        def done() -> None:
            state["remaining"] -= 1
            if state["remaining"] == 0:
                launch(i + 1)

        sim.make_ready_ids(lvl, done)

    launch(0)
    sim.run()
    return sim


def uniform_distance_vectors(graph: TiledTaskGraph) -> Optional[list[tuple]]:
    """If every tiled dependence is a constant shift T_t = T_s + d, return the
    distance vectors; else None.  (Pipelines and stencils are uniform.)"""
    out = []
    for td in graph.tiled_deps:
        ns = graph.tilings[td.dep.src].ndim
        nt = td.delta_t.ndim - ns
        if ns != nt or td.dep.src != td.dep.tgt:
            return None
        d = [None] * ns
        # look for equalities  T_t[i] - T_s[i] = d_i
        for e in td.delta_t.eqs:
            for i in range(ns):
                if (e[ns + i] != 0 and e[i] == -e[ns + i]
                        and all(e[j] == 0 for j in range(td.delta_t.ndim)
                                if j not in (i, ns + i))
                        and all(e[td.delta_t.ndim + p] == 0
                                for p in range(td.delta_t.nparam))):
                    d[i] = Fraction(e[-1], e[ns + i])
        if any(x is None for x in d):
            return None
        out.append(tuple(int(-x) if x == int(x) else None for x in d))
        if any(x is None for x in out[-1]):
            return None
    return out


def closed_form_level(graph: TiledTaskGraph) -> Optional[callable]:
    """For single-statement graphs with uniform nonnegative-lex distance
    vectors, the wavefront index is the classic hyperplane schedule
    t(T) = sum_i w_i T_i with w from the distances.  Returns a callable
    T -> level, or None when not applicable."""
    ds = uniform_distance_vectors(graph)
    if ds is None or not ds:
        return None
    # weights: smallest positive integer combination covering all distances;
    # use w_i = 1 when all distances are >= 0 and each has sum >= 1.
    if all(all(c >= 0 for c in d) and sum(d) >= 1 for d in ds):
        return lambda T: sum(T)
    return None
