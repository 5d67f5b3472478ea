"""Sharded parallel materialization — scale-out task-graph generation.

:meth:`TiledTaskGraph.materialize` is embarrassingly parallel per
(statement × dependence): every statement's tile domain and every
dependence's joint Δ_T polyhedron is one independent vectorized scan.
This module fans those scans out across processes for million-task graphs.

The unit of work is a :class:`ShardSpec`: one outer-dimension block of one
scan unit (a statement's tile domain or a dependence's joint polyhedron).
Because lexicographic scans emit the outermost dim in ascending order, a
scan restricted to ``lo <= d0 <= hi`` produces *exactly* the contiguous row
range of the full scan whose first coordinate lies in the block — so
per-shard index arrays laid out in block order are **byte-identical** to
the single-process scan.  The restriction itself is expressed with two
extra scan parameters (:func:`~..poly.scanning.shard_polyhedron`),
so all shards of a unit share one canonical polyhedron and the per-process
compiled-scan cache stays warm: each worker compiles each unit once, no
matter how many blocks it receives.

Three design points make the merge *streaming* — per-shard results never
exist as Python objects, only as slices of the final arrays:

1. **Exact pre-counting, in parallel.**  A first pool round evaluates each
   block's row count with the generated vectorized counters (tile-level
   self pairs are subtracted via the diagonal sub-polyhedron), which fixes
   every block's destination offset before any scan runs — and warms each
   worker's nest cache for the scan rounds.
2. **Shared-memory placement.**  Per-unit result segments are allocated at
   final size in ``/dev/shm``; workers write their block's rows straight
   into ``[offset, offset+count)``.  Nothing is pickled back and nothing
   is concatenated — the "merge" is the address layout.  (A pickle
   transport remains as an automatic fallback when shared memory is
   unavailable, or when ``/dev/shm`` has fewer free bytes than the
   counted result segments need: tmpfs grants a segment larger than its
   room, and the worker that writes past the room dies of ``SIGBUS``.)
3. **In-worker index mapping.**  Edge blocks ship with the two statement
   maps (:class:`StmtMap`) built from the merged tile phase; workers drop
   tile-level self pairs and map endpoints to **global task ids** (dense
   boxes: the mixed-radix key *is* the index; other shapes searchsorted
   against the statement's key table, itself published as a read-only
   shared segment).  The parent never touches per-edge data again — it
   only bincounts in-degrees from the final columns.

Entry points:

* :func:`scan_sharded` — run a plan on a process pool, return the merged
  :class:`ShardedScans`.
* ``TiledTaskGraph.materialize(params, shards=n)`` / ``index_graph(...)``
  / ``roots(...)``, and through them ``synthesize``,
  ``synthesize_indexed`` and ``DeviceExecutor`` — the graph-level APIs
  thread through here whenever ``shards``/``parallel`` resolve to >1
  shard.
* :func:`plan_shards` — the deterministic partition (inspectable/testable
  without a pool).
"""
from __future__ import annotations

import os
import shutil
import weakref
from concurrent.futures import Executor, ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..poly.scanning import LoopNest, shard_polyhedron
from .faults import FaultPlan, maybe_inject
from .recovery import RetryPolicy, run_round

TILES = "tiles"
EDGES = "edges"

# Blocks per unit beyond the shard count: outer-dim blocks of equal extent
# carry unequal point counts (triangular domains), so oversubscription keeps
# the pool busy while the deterministic merge order is preserved.
OVERSUBSCRIBE = 4

# With the pickle transport (no shared memory), inline a non-dense
# statement's sorted key table into edge jobs only below this size; above
# it, raw coordinate rows come back and the parent maps them.
KEYS_SHIP_LIMIT = 200_000

SHM_DIR = "/dev/shm"     # where POSIX shared memory lives on Linux


@dataclass(frozen=True)
class ShardSpec:
    """One outer-dim block of one scan unit — picklable, deterministic."""
    kind: str               # TILES (statement) | EDGES (tiled-dep index)
    key: object             # statement name | index into graph.tiled_deps
    poly: object            # __slo/__shi-extended canonical Polyhedron
    pv: tuple               # graph parameter values (block range excluded)
    lo: int                 # outer-dim block [lo, hi], inclusive
    hi: int
    seq: int                # merge position within the (kind, key) unit


@dataclass(frozen=True)
class StmtMap:
    """Coordinate -> global-task-id map for one statement (picklable).

    ``dense`` means the tile block fills its bounding box, so the
    mixed-radix key *is* the local index.  Otherwise the sorted key table
    lives either inline (``keys``) or in a read-only shared segment
    (``keys_shm = (name, n)``) that workers attach on use.  When neither
    is available the map is unusable and edge workers return raw rows.
    """
    mins: "np.ndarray"      # (d,) per-dim minima
    strides: "np.ndarray"   # (d,) mixed-radix strides
    dense: bool
    base: int               # global id of the statement's first task
    n: int                  # task count
    keys: Optional["np.ndarray"] = None
    keys_shm: Optional[tuple] = None

    @property
    def usable(self) -> bool:
        return self.dense or self.keys is not None or self.keys_shm is not None

    def map_global(self, coords: "np.ndarray") -> "np.ndarray":
        k = (coords - self.mins) @ self.strides
        if self.dense:
            return k + self.base
        if self.keys is not None:
            return np.searchsorted(self.keys, k) + self.base
        name, n = self.keys_shm
        seg, shm = _open_segment(name, (n,))
        try:
            out = np.searchsorted(seg, k)
        finally:
            del seg
            if shm is not None:
                shm.close()
        return out + self.base


@dataclass(frozen=True)
class _Slot:
    """Destination of one block: segment name/shape + row offset + count."""
    shm: Optional[str]      # SharedMemory name; None -> pickle the result
    shape: tuple            # full segment shape
    off: int
    count: int              # exact rows this block must produce


@dataclass(frozen=True)
class _CountJob:
    spec: ShardSpec
    diag_poly: Optional[object]   # sharded Δ_T ∩ {T_s = T_t}, or None


@dataclass(frozen=True)
class _TileJob:
    spec: ShardSpec
    slot: _Slot


@dataclass(frozen=True)
class _EdgeJob:
    """An EDGES block plus everything needed to map endpoints in-worker."""
    spec: ShardSpec
    slot: _Slot
    ns: int                 # source tile dims (split column of the scan)
    self_dep: bool          # drop (T, T) rows
    smap: Optional[StmtMap]  # None -> raw coordinate rows (parent maps)
    tmap: Optional[StmtMap]


@dataclass
class ShardPlan:
    """The partitioned work list plus units resolved in the parent."""
    tile_specs: list[ShardSpec] = field(default_factory=list)
    edge_specs: list[ShardSpec] = field(default_factory=list)
    local: dict = field(default_factory=dict)   # (kind, key) -> scanned array

    @property
    def n_shards(self) -> int:
        return len(self.tile_specs) + len(self.edge_specs)


@dataclass
class ShardedScans:
    """Merged scan products, ready for the index/materialize consumers.

    ``transport`` names what carried the blocks back: ``"shm"`` (result
    segments) or ``"pickle"``; ``shm_bytes`` is what the counted plan
    needs in shared memory (result segments plus key tables, 0 when
    nothing was counted).

    ``tiles``: per-statement ``(N, d)`` coordinate blocks — byte-identical
    to ``tile_nests[name].iterate_array``.  Each dependence lands in
    exactly one of ``edges_idx`` (worker-mapped ``(src_ids, tgt_ids)``
    global index columns, self pairs already dropped) or ``edges_raw``
    (joint coordinate rows, self pairs already dropped, mapped by the
    parent like the single-process path).  Arrays may be backed by
    unlinked shared-memory segments; each owns its mapping
    (:class:`_ShmArray`), so they outlive this object safely.
    """
    tiles: dict = field(default_factory=dict)
    edges_idx: dict = field(default_factory=dict)
    edges_raw: dict = field(default_factory=dict)
    transport: str = "pickle"
    shm_bytes: int = 0


# ---------------------------------------------------------------- workers
# Per-process LoopNest cache: every block of a unit reuses the nest (and the
# module-level compiled-scan cache keyed by the canonical polyhedron), so a
# worker pays FM projection + codegen once per unit, not once per block.
_NESTS: dict = {}


def _nest_for(poly) -> LoopNest:
    key = (poly.dim_names, poly.param_names, poly.ineqs, poly.eqs)
    nest = _NESTS.get(key)
    if nest is None:
        _NESTS[key] = nest = LoopNest(poly)
    return nest


def _block_scan(spec: ShardSpec) -> "np.ndarray":
    return _nest_for(spec.poly).iterate_array(
        tuple(spec.pv) + (spec.lo, spec.hi))


def _open_segment(name: str, shape):
    """Attach a parent-owned segment, preferring a direct ``np.memmap`` of
    the POSIX shm file — the worker never constructs a ``SharedMemory``
    object, so no Python version's attach-side resource tracking can
    interfere (falls back to a plain attach where /dev/shm has no file)."""
    path = os.path.join(SHM_DIR, name)
    if os.path.exists(path):
        return np.memmap(path, dtype=np.int64, mode="r+", shape=shape), None
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=name)
    return np.ndarray(shape, dtype=np.int64, buffer=shm.buf), shm


def _deposit(slot: _Slot, rows) -> int:
    """Write a block's rows into its segment slice."""
    if isinstance(rows, tuple):
        n = rows[0].shape[0]
    else:
        n = rows.shape[0]
    assert n == slot.count, (
        f"block produced {n} rows, planner counted {slot.count}")
    seg, shm = _open_segment(slot.shm, slot.shape)
    try:
        if isinstance(rows, tuple):
            seg[0, slot.off:slot.off + n] = rows[0]
            seg[1, slot.off:slot.off + n] = rows[1]
        else:
            seg[slot.off:slot.off + n] = rows
    finally:
        del seg
        if shm is not None:
            shm.close()
    return n


def _count_shard(job: _CountJob) -> int:
    """Worker: exact post-filter row count of one block, no enumeration.

    Warms this process's nest cache for the scan round that follows.
    """
    pv = tuple(job.spec.pv) + (job.spec.lo, job.spec.hi)
    n = _nest_for(job.spec.poly).count_vectorized(pv)
    if job.diag_poly is not None:
        n -= _nest_for(job.diag_poly).count_vectorized(pv)
    return n


def _scan_tile_shard(job: _TileJob):
    """Worker: scan one tile-domain block into its slot."""
    arr = _block_scan(job.spec)
    if job.slot.shm is None:
        return job.spec.key, job.spec.seq, arr
    return job.spec.key, job.spec.seq, _deposit(job.slot, arr)


def _scan_edge_shard(job: _EdgeJob):
    """Worker: scan one dependence block; filter self pairs; map endpoints
    to global ids when the statement maps were shipped."""
    arr = _block_scan(job.spec)
    ns = job.ns
    if job.self_dep and arr.shape[0]:
        arr = arr[(arr[:, :ns] != arr[:, ns:]).any(axis=1)]
    if job.smap is None or job.tmap is None:
        rows = arr
    else:
        rows = (job.smap.map_global(arr[:, :ns]),
                job.tmap.map_global(arr[:, ns:]))
    if job.slot.shm is None:
        return job.spec.key, job.spec.seq, rows
    return job.spec.key, job.spec.seq, _deposit(job.slot, rows)


# Payload entries: every pool round ships ``(job, fault, attempt)`` tuples
# so an injected fault (crash / hang / attach failure) fires *inside* the
# worker before the scan runs — the parent's recovery loop sees exactly
# what a real worker death looks like.  Fault-free runs pass fault=None and
# pay one tuple unpack.
def _job_count(payload) -> int:
    job, fault, attempt = payload
    maybe_inject(fault, attempt)
    return _count_shard(job)


def _job_tile(payload):
    job, fault, attempt = payload
    maybe_inject(fault, attempt)
    return _scan_tile_shard(job)


def _job_edge(payload):
    job, fault, attempt = payload
    maybe_inject(fault, attempt)
    return _scan_edge_shard(job)


# ----------------------------------------------------------------- planning
def _unit_plan(plan: ShardPlan, kind: str, key, nest: LoopNest,
               pv: list, shards: int, oversubscribe: int) -> None:
    """Partition one scan unit into outer-dim blocks (or resolve locally)."""
    bounds = nest.outer_bounds(pv) if nest.ndim else None
    if bounds is None:
        # 0-dim, infeasible, or unbounded outer dim: scan in the parent —
        # these are exactly the cases a block partition cannot help with
        # (and iterate_array raises the same error sharded or not).
        plan.local[(kind, key)] = nest.iterate_array(pv)
        return
    lb, ub = bounds
    extent = ub - lb + 1
    if extent <= 0:
        plan.local[(kind, key)] = np.empty((0, nest.ndim), dtype=np.int64)
        return
    nblocks = min(extent, max(1, shards * oversubscribe))
    spoly = shard_polyhedron(nest.poly)
    q, r = divmod(extent, nblocks)
    specs = plan.tile_specs if kind == TILES else plan.edge_specs
    lo = lb
    for seq in range(nblocks):
        hi = lo + q - 1 + (1 if seq < r else 0)
        specs.append(ShardSpec(kind=kind, key=key, poly=spoly,
                               pv=tuple(pv), lo=lo, hi=hi, seq=seq))
        lo = hi + 1
    assert lo == ub + 1


def plan_shards(graph, params: dict, shards: int,
                oversubscribe: int = OVERSUBSCRIBE) -> ShardPlan:
    """Deterministic (statement × dependence × outer-block) work list.

    Block boundaries depend only on the graph, the params, and the shard
    count — never on pool scheduling — so the merged result is reproducible
    and byte-identical to the single-process scan by construction.
    """
    pv = graph._pv(params)
    plan = ShardPlan()
    for name in graph.program.statements:
        _unit_plan(plan, TILES, name, graph.tile_nests[name], pv,
                   shards, oversubscribe)
    for i, td in enumerate(graph.tiled_deps):
        _unit_plan(plan, EDGES, i, graph._joint_nest(td), pv,
                   shards, oversubscribe)
    return plan


# ------------------------------------------------------------ parent side
def _diag_shard_poly(graph, td_idx: int):
    """Sharded Δ_T ∩ {T_src = T_tgt} — counts a block's self pairs.

    Cached per graph: the polyhedron depends only on the dependence.
    """
    cache = graph._shard_nests
    key = ("diag", td_idx)
    got = cache.get(key)
    if got is None:
        td = graph.tiled_deps[td_idx]
        poly = graph._joint_nest(td).poly
        ns = graph.tilings[td.dep.src].ndim
        for i in range(ns):
            row = [0] * (poly.ndim + poly.nparam + 1)
            row[i], row[ns + i] = 1, -1
            poly = poly.add_eq(row)
        cache[key] = got = shard_polyhedron(poly.canonical())
    return got


class _ShmArray(np.ndarray):
    """An ndarray that owns its shared-memory segment.

    numpy does not pin the exporting memoryview, so a plain ndarray over
    ``shm.buf`` dangles once the ``SharedMemory`` object is collected (its
    ``__del__`` closes the mapping).  The segment rides along on the array
    instead: any view derived from it keeps the base array — and therefore
    the mapping — alive, with no other lifecycle management.
    """
    _shm = None

    def __array_finalize__(self, obj):
        if obj is not None and self._shm is None:
            self._shm = getattr(obj, "_shm", None)


def _release_segments(segs: dict, aux: list) -> None:
    """Unlink every segment still tracked (idempotent, container-driven).

    Module-level so a ``weakref.finalize`` can run it without keeping the
    :class:`_Segments` instance alive: the containers are shared with the
    instance, so whatever ``wrap()`` already handed off is gone from them
    and everything else — including segments stranded by a crashed pool
    round or an exception that skipped the normal cleanup — is unlinked
    here.  ``weakref.finalize`` registers itself atexit, so ``/dev/shm``
    is swept even when the parent is torn down mid-run.
    """
    for shm, _ in segs.values():
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        try:
            shm.close()
        except BufferError:
            pass
    segs.clear()
    for shm in aux:
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        try:
            shm.close()
        except BufferError:
            pass
    aux.clear()


class _Segments:
    """Shared-memory segments: create, hand out slots, wrap, unlink.

    Result segments become :class:`_ShmArray` views that own their mapping;
    auxiliary segments (statement key tables) stay owned by the parent and
    are released when the run finishes.  A ``weakref.finalize`` guarantees
    the release even when the run dies before reaching it (worker crash
    unwinding past the caller, parent exit): segments are tracked in
    shared containers the finalizer sweeps, so ``/dev/shm`` never leaks.
    """

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._segs: dict = {}       # unit key -> (shm, shape)
        self._aux: list = []        # parent-owned segments (key tables)
        self._finalizer = weakref.finalize(
            self, _release_segments, self._segs, self._aux)

    def _new(self, nbytes: int):
        if not self.enabled or nbytes <= 0:
            return None
        try:
            from multiprocessing import shared_memory
            return shared_memory.SharedMemory(create=True, size=nbytes)
        except Exception:
            self.enabled = False    # fall back to pickle for the whole run
            return None

    def allocate(self, key, shape) -> bool:
        shm = self._new(int(np.prod(shape)) * 8)
        if shm is None:
            return False
        self._segs[key] = (shm, shape)
        return True

    def publish(self, arr: "np.ndarray") -> Optional[tuple]:
        """Copy a read-only table into a parent-owned segment."""
        shm = self._new(arr.nbytes)
        if shm is None:
            return None
        np.ndarray(arr.shape, dtype=np.int64, buffer=shm.buf)[:] = arr
        self._aux.append(shm)
        return (shm.name, arr.shape[0])

    def slot(self, key, off: int, count: int) -> _Slot:
        if key in self._segs:
            shm, shape = self._segs[key]
            return _Slot(shm=shm.name, shape=shape, off=off, count=count)
        return _Slot(shm=None, shape=(), off=off, count=count)

    def wrap(self, key) -> Optional["np.ndarray"]:
        got = self._segs.pop(key, None)
        if got is None:
            return None
        shm, shape = got
        arr = np.ndarray(shape, dtype=np.int64, buffer=shm.buf).view(_ShmArray)
        arr._shm = shm
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        return arr

    def release(self) -> None:
        if self._finalizer.alive:
            self._finalizer()   # runs _release_segments exactly once


def shm_room() -> Optional[tuple[int, int]]:
    """``(size, free)`` bytes of ``/dev/shm``, or None where there is none."""
    try:
        usage = shutil.disk_usage(SHM_DIR)
    except OSError:
        return None
    return usage.total, usage.free


def _shm_bytes(plan: ShardPlan, counts: dict) -> int:
    """Shared memory the counted plan takes: each statement's coordinate
    rows and its key table (one int64 a task, published when the block is
    not a dense box), and two int64 columns an edge (worker-mapped ids,
    which every edge unit gets while shared memory carries the keys)."""
    return 8 * (sum(counts[s] * (s.poly.ndim + 1) for s in plan.tile_specs)
                + sum(2 * counts[s] for s in plan.edge_specs))


def _stmt_maps(graph, tiles: dict, segs: _Segments) -> dict:
    """Per-statement :class:`StmtMap` from the merged tile blocks.

    Non-dense key tables are published as read-only shared segments when
    the shm transport is up; with the pickle transport, small tables ship
    inline and large ones leave the map unusable (raw-row fallback).
    """
    from .taskgraph import _coord_keys   # local import: avoid cycle
    maps = {}
    base = 0
    for name in graph.program.statements:
        arr = tiles[name]
        keys, mins, strides = _coord_keys(arr)
        n = arr.shape[0]
        dense = bool(n) and keys[0] == 0 and int(keys[-1]) == n - 1
        inline = None
        keys_shm = None
        if not dense and n:
            keys_shm = segs.publish(keys)
            if keys_shm is None and n <= KEYS_SHIP_LIMIT:
                # pickle fallback: the table rides inline on every edge job
                # of the unit (pool.map pickles jobs independently, so it is
                # duplicated per block) — bounded by KEYS_SHIP_LIMIT and only
                # hit when shared memory is unavailable; larger tables fall
                # back to raw rows mapped in the parent instead
                inline = keys
        maps[name] = StmtMap(mins=mins, strides=strides, dense=dense,
                             base=base, n=n, keys=inline, keys_shm=keys_shm)
        base += n
    return maps


def _gather(results, parts) -> None:
    for key, seq, res in results:
        if not isinstance(res, int):    # pickle transport: res is the rows
            parts[key][seq] = res


def _merge_pickled(parts: dict) -> dict:
    out = {}
    for key, arrs in parts.items():
        if not arrs or arrs[0] is None:     # shm transport: nothing returned
            continue
        if isinstance(arrs[0], tuple):      # mapped edge columns
            out[key] = tuple(
                np.concatenate([a[i] for a in arrs]) if len(arrs) > 1
                else arrs[0][i] for i in (0, 1))
        else:
            out[key] = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
    return out


def scan_sharded(graph, params: dict, shards: int,
                 pool: Optional[Executor] = None,
                 oversubscribe: int = OVERSUBSCRIBE,
                 use_shm: bool = True,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RetryPolicy] = None) -> ShardedScans:
    """Fan all materialization scans of ``graph`` out across processes.

    Round 0 counts every block exactly (and warms worker nest caches);
    round 1 scans the statement tile blocks; round 2 scans every dependence
    block, dropping self pairs and mapping edge endpoints to global task
    ids inside the workers.  Results stream straight into final-size
    shared-memory segments at precomputed offsets — the merged product is
    byte-identical to the single-process scans by construction: blocks
    partition the outermost scan dimension and land in ascending order.
    ``use_shm=False`` (or any shared-memory failure, or a ``/dev/shm``
    with fewer free bytes than the counted plan needs — decided from
    :func:`shm_room` before any segment is made) falls back to returning
    pickled blocks and concatenating; ``ShardedScans.transport`` says
    which ran.

    ``pool`` lets callers amortize one ``ProcessPoolExecutor`` over many
    calls (benchmarks, services); by default a pool of ``min(shards,
    cpu_count)`` workers is spawned and torn down per call.

    ``recovery`` (a :class:`~.recovery.RetryPolicy`) arms
    per-round timeouts, dead-worker detection, and bounded backoff retry:
    a failed block is re-materialized from its :class:`ShardSpec` — scans
    are pure, so the recovered result is byte-identical to the fault-free
    run by construction.  A broken pool is rebuilt when this call owns it.
    ``faults`` injects a seeded :class:`~.faults.FaultPlan`
    (crash / hang / shm-attach failure per round × job) for testing the
    recovery path; exhausted retries raise
    :class:`~.recovery.ShardRecoveryError`, never return a
    partial graph, and never leak a ``/dev/shm`` segment.
    """
    plan = plan_shards(graph, params, shards, oversubscribe)
    scans = ShardedScans()
    segs = _Segments(enabled=use_shm)
    own = pool is None and bool(plan.tile_specs or plan.edge_specs)
    n_workers = max(1, min(shards, os.cpu_count() or 1))
    factory = ((lambda: ProcessPoolExecutor(max_workers=n_workers))
               if own else None)
    if own:
        pool = factory()
    rr = dict(policy=recovery, plan=faults, pool_factory=factory)
    try:
        # ---- round 0: exact block counts (parallel; warms worker nests)
        counts: dict = {}
        if segs.enabled and (plan.tile_specs or plan.edge_specs):
            jobs = [_CountJob(s, None) for s in plan.tile_specs]
            for s in plan.edge_specs:
                td = graph.tiled_deps[s.key]
                diag = (_diag_shard_poly(graph, s.key)
                        if td.dep.src == td.dep.tgt else None)
                jobs.append(_CountJob(s, diag))
            res, pool = run_round(_job_count, jobs, pool, round_no=0, **rr)
            for job, n in zip(jobs, res):
                counts[job.spec] = n
            scans.shm_bytes = _shm_bytes(plan, counts)
            room = shm_room()
            if room is not None and scans.shm_bytes > room[1]:
                segs.enabled = False    # pickle the whole run

        # ---- round 1: tiles
        tile_parts = {}
        tile_jobs = []
        by_unit: dict = {}
        for spec in plan.tile_specs:
            by_unit.setdefault(spec.key, []).append(spec)
        for key, specs in by_unit.items():
            d = specs[0].poly.ndim
            total = sum(counts[s] for s in specs) if counts else None
            use = (total is not None and total
                   and segs.allocate((TILES, key), (total, d)))
            if total == 0:
                scans.tiles[key] = np.empty((0, d), dtype=np.int64)
                continue
            tile_parts[key] = [None] * len(specs)
            if use:
                off = 0
                for s in specs:
                    tile_jobs.append(_TileJob(
                        spec=s, slot=segs.slot((TILES, key), off, counts[s])))
                    off += counts[s]
            else:
                tile_jobs.extend(
                    _TileJob(spec=s, slot=_Slot(None, (), 0, -1))
                    for s in specs)
        if tile_jobs:
            res, pool = run_round(_job_tile, tile_jobs, pool, round_no=1, **rr)
            _gather(res, tile_parts)
        for key, arr in _merge_pickled(tile_parts).items():
            scans.tiles[key] = arr
        for key in list(tile_parts):
            arr = segs.wrap((TILES, key))
            if arr is not None:
                scans.tiles[key] = arr
        for (kind, key), arr in plan.local.items():
            if kind == TILES:
                scans.tiles[key] = arr

        # ---- round 2: edges
        if plan.edge_specs or any(k == EDGES for k, _ in plan.local):
            maps = _stmt_maps(graph, scans.tiles, segs)
            edge_parts = {}
            edge_jobs = []
            by_unit = {}
            for spec in plan.edge_specs:
                by_unit.setdefault(spec.key, []).append(spec)
            mapped: dict = {}
            for key, specs in by_unit.items():
                td = graph.tiled_deps[key]
                smap, tmap = maps[td.dep.src], maps[td.dep.tgt]
                mapped[key] = smap.usable and tmap.usable
                d = specs[0].poly.ndim
                total = sum(counts[s] for s in specs) if counts else None
                if total == 0:
                    z = np.zeros(0, dtype=np.int64)
                    if mapped[key]:
                        scans.edges_idx[key] = (z, z)
                    else:
                        scans.edges_raw[key] = np.empty((0, d),
                                                        dtype=np.int64)
                    continue
                shape = (2, total) if mapped[key] else (total, d)
                use = (total is not None and total
                       and segs.allocate((EDGES, key), shape))
                edge_parts[key] = [None] * len(specs)
                off = 0
                for s in specs:
                    slot = (segs.slot((EDGES, key), off, counts[s])
                            if use else _Slot(None, (), 0, -1))
                    edge_jobs.append(_EdgeJob(
                        spec=s, slot=slot,
                        ns=graph.tilings[td.dep.src].ndim,
                        self_dep=td.dep.src == td.dep.tgt,
                        smap=smap if mapped[key] else None,
                        tmap=tmap if mapped[key] else None))
                    if use:
                        off += counts[s]
            if edge_jobs:
                res, pool = run_round(_job_edge, edge_jobs, pool,
                                      round_no=2, **rr)
                _gather(res, edge_parts)
            for key, res in _merge_pickled(edge_parts).items():
                (scans.edges_idx if isinstance(res, tuple)
                 else scans.edges_raw)[key] = res
            for key in list(edge_parts):
                arr = segs.wrap((EDGES, key))
                if arr is None:
                    continue
                if mapped[key]:
                    scans.edges_idx[key] = (arr[0], arr[1])
                else:
                    scans.edges_raw[key] = arr
            for (kind, key), arr in plan.local.items():
                if kind == EDGES:
                    td = graph.tiled_deps[key]
                    if td.dep.src == td.dep.tgt and arr.shape[0]:
                        ns = graph.tilings[td.dep.src].ndim
                        arr = arr[(arr[:, :ns] != arr[:, ns:]).any(axis=1)]
                    scans.edges_raw[key] = arr
        scans.transport = "shm" if segs.enabled else "pickle"
    finally:
        segs.release()
        if own:
            pool.shutdown()
    return scans
