"""Parametric graph cache: one compile, many sizes, warm answers.

The paper's premise is that a *parametric* polyhedral program is compiled
once and instantiated at many sizes.  The scanning layer already honors
that one level down — compiled scan/count functions are cached by
canonical polyhedron (``scan_cache_info``) — but every ``index_graph`` /
``synthesize_indexed`` call still re-ran the scans per ``params``.
:class:`GraphCache` extends the caching one level up: finished graph
products, keyed by ``(canonical program fingerprint, params)``.

Per key the cache holds up to five products, filled lazily in dependency
order and each returned by reference on a warm hit:

  ``ig``        :class:`~.taskgraph.IndexedGraph`
  ``schedule``  :class:`~.wavefront.IndexedSchedule`
  ``dg``        :class:`~.device.DeviceGraph`  (pack_graph)
  ``ds``        :class:`~.device.DeviceSchedule` (pack_schedule)
  ``fo``        fused tile-origin columns (``fused.pack_origins``)

Eviction is LRU over whole entries, bounded by
:class:`~.config.CachePolicy` — ``max_entries`` and a hard
``max_bytes`` budget over every stored array.  ``graph_cache_info()``
exposes hit/miss/eviction counters across all live caches.

Incremental re-materialization
------------------------------
When a request misses but a cached entry exists at params differing only
in values, the cache asks each scan unit (statement tile nests, joint
dependence nests — :meth:`TiledTaskGraph.scan_units`) whether the changed
parameters are *outer-only* for it
(:meth:`~..poly.scanning.LoopNest.outer_only_params`: zero
coefficient in every inner-level bound row).  For such a unit, rows at a
fixed outer coordinate are identical across the change, so the unit's new
scan is stitched: the outer-range overlap is sliced out of the donor's
arrays (dependence rows are rebuilt from the donor graph via
``IndexedGraph.dep_spans`` — nothing extra is stored), and only the new
outer blocks are scanned, through the same ``__slo``/``__shi`` block
nests the shard engine uses (:meth:`LoopNest.block_nest`).  Units that
fail the test (or whose outer range is unbounded/infeasible) are
re-scanned in full — reuse is per-unit, and the merged result is
byte-identical to a cold scan by the same partition argument that makes
sharded merges exact (``docs/sharding.md``).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .config import CachePolicy, ExecutionConfig

#: Live caches, for module-level introspection (weakly held).
_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def _norm_value(name, value):
    """One param value, normalized to a plain Python scalar.

    ``{"N": np.int64(512)}`` (a sharded merge), ``{"N": 512}`` (a direct
    call), and the JSON-parsed values ``edt_serve`` feeds in must all land
    on ONE cache entry — so numpy scalars collapse to their Python
    equivalents before keying.  Unhashable values (arrays, lists, dicts)
    are rejected here with the offending name instead of surfacing as an
    opaque ``unhashable type`` deep inside a dict probe.
    """
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        v = float(value)
        return int(v) if v.is_integer() else v
    try:
        hash(value)
    except TypeError:
        raise TypeError(
            f"parameter {name!r} has unhashable value {value!r} "
            f"({type(value).__name__}); cache keys need scalar parameter "
            "values") from None
    return value


def _norm_params(params: dict) -> dict:
    """The params dict with every value scalar-normalized (see
    :func:`_norm_value`); entries store this form so donor comparisons and
    incremental stitching never see mixed numpy/Python scalar types."""
    return {k: _norm_value(k, v) for k, v in params.items()}


def _params_key(params: dict) -> tuple:
    return tuple(sorted(_norm_params(params).items()))


def _sched_nbytes(s) -> int:
    return int(s.level_of.nbytes + sum(lv.nbytes for lv in s.levels))


def _dg_nbytes(dg) -> int:
    return int(dg.indptr.nbytes + dg.succ.nbytes + dg.dec_src.nbytes
               + dg.dec_ptr.nbytes + dg.pred_n.nbytes)


def _ds_nbytes(ds) -> int:
    # ds.levels/level_of alias the IndexedSchedule's arrays — counted there
    return int(ds.order.nbytes + ds.task_ptr.nbytes + ds.lvl_tgt.nbytes
               + ds.edge_ptr.nbytes)


@dataclass
class _Entry:
    params: dict
    ig: object = None
    schedule: object = None
    dg: object = None
    ds: object = None
    fo: object = None        # fused tile-origin columns (i32[n+1, ndim])
    bytes: int = field(default=0)


class GraphCache:
    """LRU + byte-budget cache of graph products per (fingerprint, params).

    Thread-safe bookkeeping (an ``RLock`` guards the entry map and
    counters); materialization itself runs unlocked, so concurrent cold
    misses on different keys proceed in parallel.  Concurrent misses on
    the *same* key each materialize and the first store wins — callers
    that need exactly-once cold fills coalesce one level up
    (:class:`~.service.ScheduleService`).
    """

    def __init__(self, policy: Optional[CachePolicy] = None):
        self.policy = policy if policy is not None else CachePolicy()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.incremental_hits = 0
        self.units_reused = 0
        _CACHES.add(self)

    # ------------------------------------------------------------ plumbing
    def _key(self, graph, params: dict) -> tuple:
        return (graph.fingerprint(), _params_key(params))

    def _evict_locked(self) -> None:
        policy = self.policy
        while self._entries and (
                len(self._entries) > policy.max_entries
                or (policy.max_bytes is not None
                    and self._bytes > policy.max_bytes)):
            _, ent = self._entries.popitem(last=False)
            self._bytes -= ent.bytes
            self.evictions += 1

    def _store(self, key: tuple, params: dict, name: str, value, nbytes: int):
        """Install a product (first writer wins); returns the cached value."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = _Entry(params=_norm_params(params))
                self._entries[key] = ent
            if getattr(ent, name) is None:
                setattr(ent, name, value)
                ent.bytes += nbytes
                self._bytes += nbytes
            else:
                value = getattr(ent, name)
            self._entries.move_to_end(key)
            self._evict_locked()
            return value

    def _lookup(self, key: tuple, name: str):
        """Warm probe: returns the product and counts the hit/miss."""
        with self._lock:
            ent = self._entries.get(key)
            val = getattr(ent, name) if ent is not None else None
            if val is not None:
                self.hits += 1
                self._entries.move_to_end(key)
            else:
                self.misses += 1
            return val

    def peek(self, graph, params: dict, name: str = "schedule"):
        """Non-mutating warm check (no counters, no LRU touch)."""
        with self._lock:
            ent = self._entries.get(self._key(graph, params))
            return getattr(ent, name) if ent is not None else None

    #: product kind -> the entry fields that make up its return value
    #: (in return order; every field present ⇒ the whole answer is warm).
    PRODUCT_FIELDS = {"graph": ("ig",), "schedule": ("ig", "schedule"),
                     "packed": ("dg", "ds"), "fused": ("dg", "ds", "fo")}

    def lookup_product(self, graph, params: dict, kind: str):
        """Atomic warm hit for a whole product ``kind``, or ``None``.

        One probe under the cache lock returns every array the product
        needs (``graph`` → ig, ``schedule`` → (ig, schedule), ``packed`` →
        (dg, ds), ``fused`` → (dg, ds, fo)) — so a caller holding the
        result can never lose a component to a concurrent eviction, unlike
        a ``peek`` followed by a re-fetch.  A full hit counts one hit and
        touches the LRU; any missing component returns ``None`` without
        counting (the cold fill that follows counts its own misses).
        """
        fields = self.PRODUCT_FIELDS[kind]
        key = self._key(graph, params)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            vals = tuple(getattr(ent, f) for f in fields)
            if any(v is None for v in vals):
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return vals[0] if len(vals) == 1 else vals

    # ------------------------------------------------------------ products
    def graph(self, graph, params: dict,
              cfg: Optional[ExecutionConfig] = None):
        """The cached :class:`IndexedGraph`, materializing on a miss.

        A miss first tries incremental re-materialization from a cached
        sibling entry (same fingerprint, params differing only in values)
        before falling back to a cold scan under ``cfg``.
        """
        cfg = cfg if cfg is not None else ExecutionConfig(cache=self.policy)
        if not self.policy.enabled:
            with self._lock:
                self.misses += 1
            return graph._index_graph_cfg(params, cfg)
        key = self._key(graph, params)
        ig = self._lookup(key, "ig")
        if ig is not None:
            return ig
        donor = None
        if self.policy.incremental:
            with self._lock:
                donor = self._find_donor_locked(key, graph)
        if donor is not None:
            ig = self._incremental(graph, donor, params, cfg)
        if ig is None:
            ig = graph._index_graph_cfg(params, cfg)
        return self._store(key, params, "ig", ig, ig.nbytes)

    def schedule(self, graph, params: dict,
                 cfg: Optional[ExecutionConfig] = None):
        """``(IndexedGraph, IndexedSchedule)``, leveling at most once."""
        from .wavefront import schedule_from_graph
        ig = self.graph(graph, params, cfg)
        if not self.policy.enabled:
            return ig, schedule_from_graph(ig)
        key = self._key(graph, params)
        sched = self._lookup(key, "schedule")
        if sched is None:
            s = schedule_from_graph(ig)
            sched = self._store(key, params, "schedule", s, _sched_nbytes(s))
        return ig, sched

    def packed_graph(self, graph, params: dict,
                     cfg: Optional[ExecutionConfig] = None):
        """The cached :class:`DeviceGraph` (``pack_graph`` columns)."""
        from .device import pack_graph
        ig = self.graph(graph, params, cfg)
        if not self.policy.enabled:
            return pack_graph(ig)
        key = self._key(graph, params)
        dg = self._lookup(key, "dg")
        if dg is None:
            dg = pack_graph(ig)
            dg = self._store(key, params, "dg", dg, _dg_nbytes(dg))
        return dg

    def packed(self, graph, params: dict,
               cfg: Optional[ExecutionConfig] = None):
        """``(DeviceGraph, DeviceSchedule)`` — the sub-ms warm-hit unit.

        A warm hit is two dictionary probes returning device-ready arrays
        by reference; nothing is scanned, leveled, or packed.
        """
        from .device import pack_schedule
        ig, sched = self.schedule(graph, params, cfg)
        dg = self.packed_graph(graph, params, cfg)
        if not self.policy.enabled:
            return dg, pack_schedule(ig, sched)
        key = self._key(graph, params)
        ds = self._lookup(key, "ds")
        if ds is None:
            ds = pack_schedule(ig, sched)
            ds = self._store(key, params, "ds", ds, _ds_nbytes(ds))
        return dg, ds

    def fused(self, graph, params: dict,
              cfg: Optional[ExecutionConfig] = None):
        """``(DeviceGraph, DeviceSchedule, origin columns)`` — everything
        the fused executor reads, each by reference on a warm hit.

        The origin columns are packed from the cached index graph and the
        graph's own tile sizes (both already under this entry's
        fingerprint, which hashes the tilings), so the product needs no
        extra key material; its bytes count against the entry budget like
        every other product.
        """
        from .fused import graph_tile, pack_origins
        dg, ds = self.packed(graph, params, cfg)
        if not self.policy.enabled:
            ig = self.graph(graph, params, cfg)
            return dg, ds, pack_origins(ig, graph_tile(graph))
        key = self._key(graph, params)
        fo = self._lookup(key, "fo")
        if fo is None:
            ig = self.graph(graph, params, cfg)
            fo = pack_origins(ig, graph_tile(graph))
            fo = self._store(key, params, "fo", fo, int(fo.nbytes))
        return dg, ds, fo

    # --------------------------------------------------------- incremental
    def _find_donor_locked(self, key: tuple, graph):
        """Most-recent entry of the same program at different param values."""
        fp, _ = key
        names = set(graph.param_names)
        for k in reversed(self._entries):
            if k == key or k[0] != fp:
                continue
            ent = self._entries[k]
            if (ent.ig is not None and ent.ig.dep_spans is not None
                    and set(ent.params) == names):
                return ent.params, ent.ig
        return None

    def _incremental(self, graph, donor, params: dict,
                     cfg: ExecutionConfig):
        """Stitch a new index graph from a donor entry, unit by unit.

        Returns ``None`` when no unit is reusable (callers cold-scan).
        """
        from .shard import EDGES, ShardedScans, TILES
        donor_params, donor_ig = donor
        changed = frozenset(
            i for i, nm in enumerate(graph.param_names)
            if donor_params[nm] != params[nm])
        if not changed:
            return None
        pv = graph._pv(params)
        dpv = graph._pv(donor_params)
        tiles: dict = {}
        raw: dict = {}
        reused = 0
        for kind, ukey, nest in graph.scan_units():
            ok = nest.ndim > 0 and changed <= nest.outer_only_params()
            if ok:
                ob = nest.outer_bounds(dpv)
                nb = nest.outer_bounds(pv)
                ok = ob is not None and nb is not None
            if kind == TILES:
                if ok:
                    old = dict(donor_ig.stmt_blocks)[ukey]
                    tiles[ukey], did = _stitch_unit(nest, old, ob, nb, pv)
                    reused += did
                else:
                    tiles[ukey] = nest.iterate_array(pv)
            else:
                assert kind == EDGES
                if ok:
                    old = _dep_raw_rows(graph, donor_ig, ukey)
                    raw[ukey], did = _stitch_unit(nest, old, ob, nb, pv)
                    reused += did
                # not reusable: omitted → _edge_indices cold-scans the unit
        if not reused:
            return None
        ig = graph._index_graph_cfg(
            params, cfg, scans=ShardedScans(tiles=tiles, edges_raw=raw))
        with self._lock:
            self.incremental_hits += 1
            self.units_reused += reused
        return ig

    # -------------------------------------------------------- introspection
    def info(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.policy.max_entries,
                "max_bytes": self.policy.max_bytes,
                "enabled": self.policy.enabled,
                "incremental": self.policy.incremental,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "incremental_hits": self.incremental_hits,
                "units_reused": self.units_reused,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


def _stitch_unit(nest, old_rows: "np.ndarray", ob, nb, pv):
    """One unit's new scan: donor overlap slice + fresh outer blocks.

    ``old_rows`` is the donor's full scan of this unit (rows lex-sorted,
    column 0 = the outer coordinate, so the overlap is a ``searchsorted``
    slice).  New outer ranges scan through the unit's ``__slo``/``__shi``
    block nest — the same restricted scans the shard workers run, so
    concatenating [new-prefix, overlap, new-suffix] in outer order is
    byte-identical to a full scan.  Returns ``(rows, reused_flag)``.
    """
    lo_n, hi_n = nb
    ov_lo, ov_hi = max(ob[0], lo_n), min(ob[1], hi_n)
    if ov_hi < ov_lo:       # disjoint outer ranges: nothing to reuse
        return nest.iterate_array(pv), 0
    bn = nest.block_nest()
    parts = []
    if lo_n < ov_lo:
        parts.append(bn.iterate_array(list(pv) + [lo_n, ov_lo - 1]))
    col0 = old_rows[:, 0]
    s = int(np.searchsorted(col0, ov_lo, "left"))
    e = int(np.searchsorted(col0, ov_hi, "right"))
    parts.append(old_rows[s:e])
    if ov_hi < hi_n:
        parts.append(bn.iterate_array(list(pv) + [ov_hi + 1, hi_n]))
    return (np.concatenate(parts) if len(parts) > 1 else parts[0]), 1


def _dep_raw_rows(graph, ig, dep_idx: int) -> "np.ndarray":
    """A dependence's joint (src, tgt) coordinate rows, rebuilt from the
    cached graph — ``dep_spans`` slices the edge arrays, the statement
    blocks gather the coordinates.  Self pairs stay excluded (the
    downstream filter is idempotent); row order is the joint-scan lex
    order, so column 0 ascends."""
    td = graph.tiled_deps[dep_idx]
    start, stop = ig.dep_spans[dep_idx]
    src = ig.edge_src[start:stop]
    tgt = ig.edge_tgt[start:stop]
    off = 0
    base: dict = {}
    for name, arr in ig.stmt_blocks:
        base[name] = (off, arr)
        off += arr.shape[0]
    so, sarr = base[td.dep.src]
    to, tarr = base[td.dep.tgt]
    return np.concatenate([sarr[src - so], tarr[tgt - to]], axis=1)


def graph_cache_info() -> dict:
    """Aggregate hit/miss/byte counters across every live GraphCache."""
    caches = [c.info() for c in list(_CACHES)]
    return {
        "caches": len(caches),
        "entries": sum(c["entries"] for c in caches),
        "bytes": sum(c["bytes"] for c in caches),
        "hits": sum(c["hits"] for c in caches),
        "misses": sum(c["misses"] for c in caches),
        "evictions": sum(c["evictions"] for c in caches),
        "incremental_hits": sum(c["incremental_hits"] for c in caches),
        "units_reused": sum(c["units_reused"] for c in caches),
    }
