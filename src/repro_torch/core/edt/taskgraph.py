"""Polyhedral programs → tiled event-driven task graphs.

A :class:`PolyhedralProgram` is a set of statements (iteration domains) and
dependence polyhedra between them.  :class:`TiledTaskGraph` applies per-
statement tilings, computes the inter-tile dependences with the paper's
compression method (§3, never projection), and exposes the generated-code
primitives of §4:

  * the tile iteration domain per statement (the task creation loop, Fig 3),
  * ``successors`` / ``predecessors`` iterators (the put / get loops, Fig 4),
  * ``pred_count`` — the §4.3 predecessor-count function (autodec init),
  * ``roots`` — the set of tasks without predecessors (master's preschedule
    loop), via destination-projection + subtraction as in §4.3.

Consistency rule (deadlock freedom under over-approximation): the effective
inter-tile dependence is ``Δ_T ∩ (tiledom_src × tiledom_tgt)`` and *all*
generated loops (get / put / count) read the same polyhedron, so a dependence
is counted iff it will be signaled.  Tile-level self-pairs (T,T) of a
statement are excluded everywhere: intra-tile deps are satisfied by sequential
execution inside the task.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from ..poly import (CountingFunction, LoopNest, Polyhedron, Tiling,
                    make_counting_function, project_onto, tile_dependence,
                    tile_domain)
from ..poly.scanning import _row_ints

TaskId = tuple[str, tuple[int, ...]]  # (statement name, tile coords)


def _task_ids(name: str, arr: "np.ndarray") -> list[TaskId]:
    """(name, coords) TaskId tuples for a coord block — C-level zips only."""
    n, d = arr.shape
    if d and n:
        tuples = list(zip(*(arr[:, j].tolist() for j in range(d))))
    else:
        tuples = [()] * n
    return list(zip(itertools.repeat(name), tuples))


def _int_rows(poly: Polyhedron) -> tuple[tuple, tuple]:
    """Constraint rows scaled to plain ints (for fast point containment)."""
    return (tuple(_row_ints(r) for r in poly.ineqs),
            tuple(_row_ints(r) for r in poly.eqs))


def _coord_keys(arr: "np.ndarray"):
    """Mixed-radix keys over the block's bounding box: (keys, mins, strides).

    Lexicographic row order makes the keys strictly increasing, so they
    index the block via searchsorted — or directly, when the block fills
    its bounding box (see :func:`_map_local`).
    """
    n, d = arr.shape
    if n and d:
        mins = arr.min(axis=0)
        extents = arr.max(axis=0) - mins + 1
        strides = np.ones(d, dtype=np.int64)
        for j in range(d - 2, -1, -1):
            strides[j] = strides[j + 1] * extents[j + 1]
        keys = (arr - mins) @ strides
    else:
        mins = np.zeros(d, dtype=np.int64)
        strides = np.zeros(d, dtype=np.int64)
        keys = np.zeros(n, dtype=np.int64)
    return keys, mins, strides


def _map_local(keys: "np.ndarray", mins, strides,
               coords: "np.ndarray") -> "np.ndarray":
    """Coordinate rows -> local task indices within one statement block.

    Dense fast path: strictly-increasing keys starting at 0 and ending at
    n-1 must be exactly ``arange(n)`` (mixed-radix keys are injective), so
    the key *is* the index and the searchsorted disappears — boxes, i.e.
    the million-task scaling cases, never pay the log-factor.
    """
    k = (coords - mins) @ strides
    n = keys.shape[0]
    if n and keys[0] == 0 and int(keys[-1]) == n - 1:
        return k
    return np.searchsorted(keys, k)


def _in_process(shards: int) -> None:
    """Refuse a sharded generation scan: only the in-process scan is ported."""
    if int(shards or 0) > 1:
        raise NotImplementedError(
            f"shards={shards}: the sharded generation scan is not ported; "
            "build the graph in process (shards=0)")


def _contains_int(ineqs: tuple, eqs: tuple, col: tuple) -> bool:
    """``col`` = (dims..., params..., 1) against pre-scaled integer rows."""
    for r in ineqs:
        if sum(a * b for a, b in zip(r, col)) < 0:
            return False
    for r in eqs:
        if sum(a * b for a, b in zip(r, col)) != 0:
            return False
    return True


@dataclass(frozen=True)
class Statement:
    name: str
    domain: Polyhedron  # iteration domain (params allowed)

    @property
    def ndim(self) -> int:
        return self.domain.ndim


@dataclass(frozen=True)
class Dependence:
    """Pre-tiling dependence polyhedron over (src dims, tgt dims)."""
    src: str
    tgt: str
    delta: Polyhedron  # dims = src.ndim + tgt.ndim
    src_ndim: int
    name: str = ""


@dataclass
class PolyhedralProgram:
    statements: dict[str, Statement] = field(default_factory=dict)
    dependences: list[Dependence] = field(default_factory=list)
    param_names: tuple[str, ...] = ()
    # registry name (``repro_torch.core.programs.PROGRAMS`` key) — lets consumers
    # that attach semantics to a program (the fused executor's stencil
    # bodies) find it without threading the name separately
    name: str = ""

    def add_statement(self, name: str, domain: Polyhedron) -> Statement:
        st = Statement(name, domain)
        self.statements[name] = st
        if not self.param_names:
            self.param_names = domain.param_names
        assert domain.param_names == self.param_names, (
            "all statements must share the parameter list")
        return st

    def add_dependence(self, src: str, tgt: str, delta: Polyhedron,
                       name: str = "") -> Dependence:
        s = self.statements[src]
        assert delta.ndim == s.ndim + self.statements[tgt].ndim
        d = Dependence(src, tgt, delta, s.ndim, name or f"{src}->{tgt}")
        self.dependences.append(d)
        return d


@dataclass
class _TiledDep:
    dep: Dependence
    delta_t: Polyhedron          # effective inter-tile dependence
    # successor loop: fix source tile coords (as params) -> iterate targets
    succ_fn: CountingFunction
    # predecessor loop / §4.3 count function: fix target tile -> iterate sources
    pred_fn: CountingFunction
    # delta_t constraint rows as plain ints (fast self-pair containment)
    int_ineqs: tuple = ()
    int_eqs: tuple = ()
    # lazy joint nest over (src dims, tgt dims): one vectorized scan of this
    # polyhedron yields every edge of the dependence (numpy backend)
    joint_nest: Optional[LoopNest] = None
    # position in TiledTaskGraph.tiled_deps (keys IndexedGraph.dep_spans)
    idx: int = -1


class TiledTaskGraph:
    """Tile-level EDT graph with paper-§4 generated-code primitives.

    ``backend`` selects the scanning evaluation path for every generated
    loop (tile nests, get/put loops, counters): ``compiled`` (default,
    integer codegen), ``numpy`` (vectorized batch enumeration) or
    ``fraction`` (the retained reference path) — see
    :mod:`repro_torch.core.poly.scanning`.  Per-``params`` scan state (compiled
    loop bodies, root projections, containment rows) is computed once and
    shared across all tasks, so ``materialize``/``roots``/``pred_count``
    amortize instead of re-deriving per task.

    With ``backend="numpy"`` the batch layer replaces per-task dispatch
    entirely: tile domains are enumerated as ``(N, ndim)`` index arrays,
    every dependence's edges come from **one** vectorized scan of its joint
    ``Δ_T`` polyhedron (src dims × tgt dims — lexicographic order groups
    the put loops by source task for free), predecessor counts evaluate as
    matrix products over tile blocks, and ``roots``/``materialize``/
    ``index_graph`` consume whole statements per call.  Results are
    byte-identical to the scalar backends (asserted by the equivalence
    suite and the taskgen benchmark).
    """

    def __init__(self, program: PolyhedralProgram,
                 tilings: dict[str, Tiling],
                 method: str = "inflate",
                 backend: str = "compiled"):
        self.program = program
        self.tilings = tilings
        self.method = method
        self.backend = backend
        self.param_names = program.param_names

        # Tile iteration domains (task creation loops, Fig 3).
        self.tile_domains: dict[str, Polyhedron] = {}
        self.tile_nests: dict[str, LoopNest] = {}
        for name, st in program.statements.items():
            td = tile_domain(st.domain, tilings[name], method=method)
            self.tile_domains[name] = td
            self.tile_nests[name] = LoopNest(td, backend=backend)

        # Inter-tile dependences by compression (§3), intersected with the
        # product of tile domains for signal/count consistency.
        self.tiled_deps: list[_TiledDep] = []
        self._out: dict[str, list[_TiledDep]] = {n: [] for n in program.statements}
        self._in: dict[str, list[_TiledDep]] = {n: [] for n in program.statements}
        for dep in program.dependences:
            gs = tilings[dep.src]
            gt = tilings[dep.tgt]
            dt = tile_dependence(dep.delta, dep.src_ndim, gs, gt, method=method)
            ns = gs.ndim
            src_td = self.tile_domains[dep.src]
            tgt_td = self.tile_domains[dep.tgt]
            prod = (src_td.add_dims(tgt_td.dim_names)
                    .intersect(tgt_td.add_dims(src_td.dim_names, front=True)
                               .rename(dim_names=src_td.dim_names + tgt_td.dim_names)))
            # align dim names before intersecting
            dt = dt.rename(dim_names=src_td.dim_names + tgt_td.dim_names)
            eff = dt.intersect(prod)
            src_dims = list(range(ns))
            tgt_dims = list(range(ns, eff.ndim))
            ii, ie = _int_rows(eff)
            td = _TiledDep(
                dep=dep,
                delta_t=eff,
                succ_fn=make_counting_function(eff, count_dims=tgt_dims,
                                               fixed_dims=src_dims,
                                               backend=backend),
                pred_fn=make_counting_function(eff, count_dims=src_dims,
                                               fixed_dims=tgt_dims,
                                               backend=backend),
                int_ineqs=ii,
                int_eqs=ie,
                idx=len(self.tiled_deps),
            )
            self.tiled_deps.append(td)
            self._out[dep.src].append(td)
            self._in[dep.tgt].append(td)
        # roots_polyhedra() caches (the projections are pure FM work that
        # depends only on the graph, not on params).
        self._roots_projs: Optional[dict[str, list[Polyhedron]]] = None
        self._roots_rows: dict[str, list[tuple[tuple, tuple]]] = {}

    # ------------------------------------------------------------- tasks
    def tasks(self, params: dict[str, int]) -> Iterator[TaskId]:
        """All tasks: the task-creation loops of Fig 3."""
        pv = self._pv(params)
        for name in self.program.statements:
            for t in self.tile_nests[name].iterate(pv):
                yield (name, t)

    def num_tasks(self, params: dict[str, int]) -> int:
        pv = self._pv(params)
        return sum(self.tile_nests[n].count(pv) for n in self.program.statements)

    # -------------------------------------------------- generated loops (§4)
    def successors(self, task: TaskId, params: dict[str, int]) -> Iterator[TaskId]:
        """The put/autodec loop of task: every (dep, tgt) pair, self excluded."""
        name, t = task
        pv = self._pv(params)
        for td in self._out[name]:
            same = td.dep.src == td.dep.tgt
            for tgt in td.succ_fn.points(t, pv):
                if same and tuple(tgt) == tuple(t):
                    continue
                yield (td.dep.tgt, tuple(tgt))

    def predecessors(self, task: TaskId, params: dict[str, int]) -> Iterator[TaskId]:
        """The get loop of the task (Fig 4)."""
        name, t = task
        pv = self._pv(params)
        for td in self._in[name]:
            same = td.dep.src == td.dep.tgt
            for src in td.pred_fn.points(t, pv):
                if same and tuple(src) == tuple(t):
                    continue
                yield (td.dep.src, tuple(src))

    def pred_count(self, task: TaskId, params: dict[str, int]) -> int:
        """§4.3 predecessor-count function (counts (dep, src-tile) pairs)."""
        name, t = task
        return self._pred_count_pv(name, t, self._pv(params))

    def _pred_count_pv(self, name: str, t: tuple, pv: list[int]) -> int:
        """pred_count with a pre-resolved parameter vector (hot path)."""
        total = 0
        for td in self._in[name]:
            c = td.pred_fn(t, pv)
            if td.dep.src == td.dep.tgt and _contains_int(
                    td.int_ineqs, td.int_eqs, tuple(t) + tuple(t) + tuple(pv) + (1,)):
                c -= 1  # exclude the tile-level self pair
            total += c
        return total

    def pred_count_strategies(self) -> dict[str, str]:
        """Which counting form §4.3's heuristic chose, per dependence."""
        return {td.dep.name: td.pred_fn.strategy for td in self.tiled_deps}

    # ------------------------------------------------------------- roots
    def roots_polyhedra(self) -> dict[str, list[Polyhedron]]:
        """§4.3: project each Δ_T onto destination dims (computed once).

        The set of tasks *with* predecessors per statement; roots = tile
        domain minus their union (set difference is evaluated pointwise since
        the difference is generally non-convex).
        """
        if self._roots_projs is not None:
            return self._roots_projs
        out: dict[str, list[Polyhedron]] = {n: [] for n in self.program.statements}
        for td in self.tiled_deps:
            ns = self.tilings[td.dep.src].ndim
            tgt_dims = list(range(ns, td.delta_t.ndim))
            if td.dep.src == td.dep.tgt:
                # self-dependences: a task with only its self-pair is a root;
                # handled pointwise in roots() via pred_count.
                pass
            proj = project_onto(td.delta_t, tgt_dims)
            out[td.dep.tgt].append(proj)
        self._roots_projs = out
        self._roots_rows = {n: [_int_rows(p) for p in projs]
                            for n, projs in out.items()}
        return out

    def roots(self, params: dict[str, int],
              shards: int = 0) -> Iterator[TaskId]:
        """Tasks with no predecessors (the master's scan, made O(1)-startup by
        preschedule in the autodec model).

        ``shards`` is the generation fan-out; only in-process scans
        (``0``/``1``) are ported, a larger count raises
        ``NotImplementedError``.
        """
        _in_process(shards)
        pv = self._pv(params)
        if self.backend == "numpy":
            return self._roots_numpy(pv)
        return self._roots_scalar(pv)

    def _roots_scalar(self, pv: list[int]) -> Iterator[TaskId]:
        self.roots_polyhedra()
        tail = tuple(pv) + (1,)
        for name in self.program.statements:
            rows = self._roots_rows[name]
            for t in self.tile_nests[name].iterate(pv):
                col = tuple(t) + tail
                if any(_contains_int(ii, ie, col) for ii, ie in rows):
                    # may still be a root if the only "predecessor" was the
                    # self pair; fall back to the exact count.
                    if self._pred_count_pv(name, t, pv) == 0:
                        yield (name, t)
                else:
                    yield (name, t)

    def _roots_numpy(self, pv: list[int]) -> Iterator[TaskId]:
        """Whole-statement root scan: one pred-count block per statement."""
        for name in self.program.statements:
            tiles = self.tile_nests[name].iterate_array(pv)
            counts = self._pred_counts_array(name, tiles, pv)
            rows = tiles.tolist()
            for i in np.flatnonzero(counts == 0).tolist():
                yield (name, tuple(rows[i]))

    # ------------------------------------------------------ batched (numpy)
    def tasks_arrays(self, params: dict[str, int]) -> dict[str, "np.ndarray"]:
        """Per-statement tile coordinates as ``(N, ndim)`` int64 arrays."""
        pv = self._pv(params)
        return {name: self.tile_nests[name].iterate_array(pv)
                for name in self.program.statements}

    def pred_count_block(self, name: str, tiles,
                         params: dict[str, int]) -> "np.ndarray":
        """§4.3 predecessor counts for a whole block of target tiles.

        Equals ``[pred_count((name, t), params) for t in tiles]`` but the
        enumerator-form counters evaluate as array arithmetic over the
        block, and the self-pair exclusion is one containment mask.
        """
        return self._pred_counts_array(
            name, np.asarray(tiles, dtype=np.int64), self._pv(params))

    def _pred_counts_array(self, name: str, tiles: "np.ndarray",
                           pv: list[int]) -> "np.ndarray":
        total = np.zeros(tiles.shape[0], dtype=np.int64)
        for td in self._in[name]:
            total += td.pred_fn.count_block(tiles, pv)
            if td.dep.src == td.dep.tgt:
                total -= self._self_pair_mask(td, tiles, pv)
        return total

    def _self_pair_mask(self, td: _TiledDep, tiles: "np.ndarray",
                        pv: list[int]) -> "np.ndarray":
        """1 where the tile-level self pair (T, T) lies in Δ_T, else 0."""
        n, ns = tiles.shape
        mask = np.ones(n, dtype=bool)
        for rows, eq in ((td.int_ineqs, False), (td.int_eqs, True)):
            for r in rows:
                coeff = np.asarray(
                    [r[j] + r[ns + j] for j in range(ns)], dtype=np.int64)
                c = r[-1] + sum(a * p for a, p in zip(r[2 * ns:-1], pv))
                v = tiles @ coeff + c
                mask &= (v == 0) if eq else (v >= 0)
        return mask.astype(np.int64)

    def _joint_nest(self, td: _TiledDep) -> LoopNest:
        """Lazy loop nest over the joint (src, tgt) dependence polyhedron."""
        if td.joint_nest is None:
            td.joint_nest = LoopNest(td.delta_t)
        return td.joint_nest

    def _stmt_index(self, pv: list[int], with_tasks: bool = True) -> dict:
        """Per statement: coord array, ravel-key index, optional TaskIds.

        Tile coordinates are encoded into mixed-radix keys over the
        statement's bounding box; lexicographic task order makes the keys
        sorted, so edge endpoints map to task indices via searchsorted —
        no per-task hashing anywhere in the batch paths.  TaskId tuples
        (the scalar-world labels) are only built when asked for: the pure
        array paths (``index_graph``) never pay the per-task tuple cost.
        """
        info = {}
        for name in self.program.statements:
            arr = self.tile_nests[name].iterate_array(pv)
            ts = _task_ids(name, arr) if with_tasks else None
            keys, mins, strides = _coord_keys(arr)
            info[name] = (ts, keys, mins, strides, arr)
        return info

    def _dep_edges(self, td: _TiledDep, pv: list[int]) -> "np.ndarray":
        """All (src tile, tgt tile) edge rows of one dependence, self pairs
        excluded — a single vectorized scan of the joint polyhedron."""
        edges = self._joint_nest(td).iterate_array(pv)
        ns = self.tilings[td.dep.src].ndim
        if td.dep.src == td.dep.tgt and edges.shape[0]:
            keep = (edges[:, :ns] != edges[:, ns:]).any(axis=1)
            edges = edges[keep]
        return edges

    def _stmt_bases(self, info) -> dict[str, int]:
        """Global id of each statement's first task (program order)."""
        base: dict[str, int] = {}
        n = 0
        for name in self.program.statements:
            base[name] = n
            n += info[name][4].shape[0]
        return base

    def _edge_indices(self, td: _TiledDep, pv: list[int], info,
                      base: dict[str, int], global_ids: bool = False):
        """One dependence's edges as (src, tgt) task-index columns.

        Self pairs are dropped; raw rows map through :func:`_map_local`.
        """
        sname, tname = td.dep.src, td.dep.tgt
        edges = self._dep_edges(td, pv)
        if not edges.shape[0]:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        ns = self.tilings[sname].ndim
        _, keys_s, mins_s, strides_s, _ = info[sname]
        _, keys_t, mins_t, strides_t, _ = info[tname]
        src_idx = _map_local(keys_s, mins_s, strides_s, edges[:, :ns])
        tgt_idx = _map_local(keys_t, mins_t, strides_t, edges[:, ns:])
        if global_ids:
            return src_idx + base[sname], tgt_idx + base[tname]
        return src_idx, tgt_idx

    def _materialize_numpy(self, pv: list[int]) -> "MaterializedGraph":
        info = self._stmt_index(pv)
        base = self._stmt_bases(info)
        tasks: list[TaskId] = []
        succ: dict[TaskId, list[TaskId]] = {}
        stmt_succ: dict[str, list[list[TaskId]]] = {}
        pred_counts: dict[str, np.ndarray] = {}
        for name in self.program.statements:
            ts = info[name][0]
            tasks.extend(ts)
            lists: list[list[TaskId]] = [[] for _ in ts]
            stmt_succ[name] = lists
            succ.update(zip(ts, lists))
            pred_counts[name] = np.zeros(len(ts), dtype=np.int64)
        for name in self.program.statements:
            for td in self._out[name]:
                tgt_name = td.dep.tgt
                src_idx, tgt_idx = self._edge_indices(td, pv, info, base)
                ne = src_idx.shape[0]
                if not ne:
                    continue
                ts_t = info[tgt_name][0]
                pred_counts[tgt_name] += np.bincount(
                    tgt_idx, minlength=len(ts_t))
                tg = _task_ids(tgt_name, info[tgt_name][4][tgt_idx])
                # edges are lex-sorted by source: group bounds are where the
                # source index changes, then one list-extend per source task
                starts = np.flatnonzero(
                    np.r_[True, src_idx[1:] != src_idx[:-1]])
                bounds = np.append(starts, ne).tolist()
                owners = src_idx[starts].tolist()
                lists = stmt_succ[name]
                for gi, u in enumerate(owners):
                    lists[u].extend(tg[bounds[gi]:bounds[gi + 1]])
        pred_n: dict[TaskId, int] = {}
        for name in self.program.statements:
            pred_n.update(zip(info[name][0], pred_counts[name].tolist()))
        return MaterializedGraph(tasks, succ, pred_n)

    def index_graph(self, params: dict[str, int],
                    shards: int = 0) -> "IndexedGraph":
        """The whole task graph as flat index arrays (no per-task tuples).

        The numpy backend's native graph product: tasks are global integer
        ids (statement blocks concatenated in program order, lex order
        within — same total order as ``materialize().tasks``), edges are
        two parallel int arrays, and ``pred_n`` is their bincount.  Pure
        array output: TaskId labels are derived lazily on access, so
        generation itself never touches per-task Python objects.

        ``shards`` is the generation fan-out; only in-process scans
        (``0``/``1``) are ported, a larger count raises
        ``NotImplementedError``.
        """
        _in_process(shards)
        pv = self._pv(params)
        info = self._stmt_index(pv, with_tasks=False)
        base = self._stmt_bases(info)
        blocks = [(name, info[name][4]) for name in self.program.statements]
        n = sum(arr.shape[0] for _, arr in blocks)
        srcs, tgts = [], []
        spans: dict[int, tuple[int, int]] = {}
        off = 0
        for name in self.program.statements:
            for td in self._out[name]:
                gsrc, gtgt = self._edge_indices(td, pv, info, base,
                                                global_ids=True)
                ne = int(gsrc.shape[0])
                spans[td.idx] = (off, off + ne)
                off += ne
                if ne:
                    srcs.append(gsrc)
                    tgts.append(gtgt)
        z = np.zeros(0, dtype=np.int64)
        edge_src = np.concatenate(srcs) if srcs else z
        edge_tgt = np.concatenate(tgts) if tgts else z
        return IndexedGraph(
            stmt_blocks=blocks, n=n, edge_src=edge_src, edge_tgt=edge_tgt,
            pred_n=np.bincount(edge_tgt, minlength=n), dep_spans=spans)

    # ------------------------------------------------------------ materialize
    def materialize(self, params: dict[str, int],
                    shards: int = 0) -> "MaterializedGraph":
        """Explicit adjacency (for tests / the prescribed model / wavefronts).

        Batched: the parameter vector, compiled scan functions, and
        per-dependence loop state are resolved once per call, then the put
        loops stream over all tasks of a statement — instead of re-entering
        ``successors`` (and re-binding scan state) per task.  The resulting
        task list, per-task successor order, and pred counts are identical
        to the per-task path.  The ``numpy`` backend goes further: each
        dependence's edge list is one vectorized scan of the joint Δ_T
        polyhedron (see ``_materialize_numpy``).  ``shards`` as in
        :meth:`index_graph`.
        """
        _in_process(shards)
        pv = self._pv(params)
        if self.backend == "numpy":
            return self._materialize_numpy(pv)
        tasks: list[TaskId] = []
        by_stmt: dict[str, list[TaskId]] = {}
        for name in self.program.statements:
            ts = [(name, t) for t in self.tile_nests[name].iterate(pv)]
            by_stmt[name] = ts
            tasks.extend(ts)
        succ: dict[TaskId, list[TaskId]] = {t: [] for t in tasks}
        pred_n: dict[TaskId, int] = dict.fromkeys(tasks, 0)
        for name, ts in by_stmt.items():
            for td in self._out[name]:
                tgt_name = td.dep.tgt
                same = td.dep.src == tgt_name
                points = td.succ_fn.points
                for task in ts:
                    t = task[1]
                    out = succ[task]
                    for tgt in points(t, pv):
                        if same and tgt == t:
                            continue
                        s = (tgt_name, tgt)
                        out.append(s)
                        pred_n[s] += 1
        return MaterializedGraph(tasks, succ, pred_n)

    def _pv(self, params: dict[str, int]) -> list[int]:
        return [params[n] for n in self.param_names]


@dataclass
class IndexedGraph:
    """Flat-array task graph: global task ids + parallel edge arrays.

    ``tasks`` (TaskId labels) is derived lazily — consumers that stay in
    index space (wavefront leveling, batch executors) never build it.
    """
    stmt_blocks: list[tuple[str, "np.ndarray"]]  # (statement, (N, d) coords)
    n: int
    # int64 global task indices; sorted by source only WITHIN each
    # dependence's block (blocks are concatenated per statement × dep) —
    # CSR consumers must sort/argsort globally first.
    edge_src: "np.ndarray"
    edge_tgt: "np.ndarray"
    pred_n: "np.ndarray"    # int64 in-degrees, indexed by global task id
    # per-dependence [start, stop) slice of the edge arrays, keyed by
    # tiled_deps index (deps are concatenated in statement × out-dep order).
    # Lets the graph cache reconstruct a dependence's raw joint rows without
    # storing them; absent on hand-built graphs.
    dep_spans: Optional[dict[int, tuple[int, int]]] = None
    _tasks: Optional[list[TaskId]] = None

    @property
    def tasks(self) -> list[TaskId]:
        if self._tasks is None:
            out: list[TaskId] = []
            for name, arr in self.stmt_blocks:
                out.extend(_task_ids(name, arr))
            self._tasks = out
        return self._tasks

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def nbytes(self) -> int:
        """Array payload size (the graph cache's byte-budget unit)."""
        b = self.edge_src.nbytes + self.edge_tgt.nbytes + self.pred_n.nbytes
        for _, arr in self.stmt_blocks:
            b += arr.nbytes
        return int(b)


@dataclass
class MaterializedGraph:
    tasks: list[TaskId]
    succ: dict[TaskId, list[TaskId]]
    pred_n: dict[TaskId, int]

    @property
    def n_edges(self) -> int:
        return sum(len(v) for v in self.succ.values())

    def check_acyclic(self) -> bool:
        indeg = dict(self.pred_n)
        ready = [t for t in self.tasks if indeg[t] == 0]
        seen = 0
        while ready:
            t = ready.pop()
            seen += 1
            for s in self.succ[t]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        return seen == len(self.tasks)

    def wavefronts(self) -> list[list[TaskId]]:
        """Earliest-start levels (longest-path depth) — the static schedule."""
        indeg = dict(self.pred_n)
        level = {t: 0 for t in self.tasks}
        cur = [t for t in self.tasks if indeg[t] == 0]
        out: list[list[TaskId]] = []
        while cur:
            out.append(sorted(cur))
            nxt = []
            for t in cur:
                for s in self.succ[t]:
                    indeg[s] -= 1
                    level[s] = max(level[s], level[t] + 1)
                    if indeg[s] == 0:
                        nxt.append(s)
            cur = nxt
        assert sum(len(w) for w in out) == len(self.tasks), "graph has a cycle"
        return out

    def max_ready(self) -> int:
        """r = max tasks simultaneously ready in the greedy wavefront execution."""
        return max((len(w) for w in self.wavefronts()), default=0)

    def max_out_degree(self) -> int:
        return max((len(v) for v in self.succ.values()), default=0)
