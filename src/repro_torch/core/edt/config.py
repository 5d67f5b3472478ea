"""Unified execution configuration: one frozen config, one session handle.

Graph generation has per-call knobs — ``backend=`` on graph construction,
``shards=``/``parallel=``/``pool=`` for the sharded scans and
``faults=``/``recovery=`` for injection and retry.  This module names them
once, in two objects:

* :class:`ExecutionConfig` — a frozen dataclass naming every execution
  knob once (generation backend, shard fan-out, pool, fault plan, retry
  policy, cache policy).  Every graph-level API accepts ``config=``; the
  legacy kwargs keep working through :func:`resolve_execution`, which
  builds the equivalent config and emits a :class:`DeprecationWarning`
  once per call-site.
* :class:`Session` — a handle that owns the process pool, a
  :class:`~.cache.GraphCache`, and the config defaults.  Graph products
  requested through a session are cached by ``(parametric-program
  fingerprint, params)`` and the pool amortizes across calls — the serving
  posture: compile once, answer many sizes warm.

The module is import-light on purpose (no numpy/torch, no graph types at
module scope): ``taskgraph``/``wavefront``/``device`` all import it, and it
reaches back into them lazily.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass
from typing import Any, Iterator, Optional

#: Names of the per-call kwargs superseded by :class:`ExecutionConfig`.
LEGACY_KWARGS = ("shards", "parallel", "pool", "faults", "recovery")


class _Unset:
    """Sentinel distinguishing "not passed" from an explicit ``None``."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<unset>"


UNSET = _Unset()

_DEPRECATION_MSG = (
    "legacy execution kwargs ({names}) are deprecated; pass "
    "config=ExecutionConfig(...) or session=Session(...) instead "
    "(see docs/backends.md, migration section)")


@dataclass(frozen=True)
class CachePolicy:
    """Eviction and reuse policy for a :class:`~.cache.GraphCache`.

    ``max_bytes`` is a hard budget over every cached array (graphs,
    schedules, packed device columns); ``max_entries`` bounds the LRU
    independently.  ``incremental`` enables outer-param re-materialization
    (stitch reusable outer-block scans from a cached neighbor instead of
    re-scanning from scratch); ``enabled=False`` turns the cache into a
    pass-through (every request materializes).
    """

    max_entries: int = 32
    max_bytes: Optional[int] = 2**30   # holds two 1,056,784-task entries
    incremental: bool = True
    enabled: bool = True


@dataclass(frozen=True)
class ExecutionConfig:
    """Every execution knob, named once, immutable.

    ``backend`` selects the scanning backend when a graph is *built*
    through :meth:`Session.graph` (graphs fix their backend at
    construction; per-call configs leave it untouched).  ``shards`` /
    ``parallel`` / ``pool`` drive the sharded generation engine;
    ``faults`` / ``recovery`` arm injection and retry in every API
    uniformly (``roots()`` included).  ``cache`` is the policy a
    :class:`Session` builds its :class:`~.cache.GraphCache` from.
    """

    backend: str = "compiled"
    shards: Optional[int] = None
    parallel: bool = False
    pool: Optional[Any] = None
    faults: Optional[Any] = None          # .faults.FaultPlan
    recovery: Optional[Any] = None        # .recovery.RetryPolicy
    cache: CachePolicy = CachePolicy()

    def replace(self, **kw) -> "ExecutionConfig":
        return dataclasses.replace(self, **kw)

    def resolve_shards(self) -> int:
        """Effective shard count (0 = in-process): ``parallel=True`` means
        one shard per core, an explicit ``shards=`` always wins."""
        if self.shards is None and self.parallel:
            return os.cpu_count() or 1
        return int(self.shards or 0)


#: Shared default — the in-process, cache-enabled baseline.
DEFAULT_CONFIG = ExecutionConfig()


def resolve_execution(config: Optional[ExecutionConfig],
                      session: Optional["Session"],
                      legacy: Optional[dict] = None,
                      stacklevel: int = 4):
    """Collapse ``config=`` / ``session=`` / legacy kwargs to one config.

    Returns ``(config, session_or_None)``.  Legacy kwargs (any value that
    is not :data:`UNSET`) build an equivalent :class:`ExecutionConfig` and
    emit a :class:`DeprecationWarning` attributed to the caller's call-site
    (so the default warning filter reports each site once); mixing them
    with the new kwargs is a :class:`TypeError`, as is passing both
    ``config=`` and ``session=``.
    """
    used = {k: v for k, v in (legacy or {}).items() if v is not UNSET}
    if used:
        if config is not None or session is not None:
            raise TypeError(
                "pass either config=/session= or the legacy kwargs "
                f"({', '.join(sorted(used))}), not both")
        warnings.warn(
            _DEPRECATION_MSG.format(
                names=", ".join(f"{k}=" for k in sorted(used))),
            DeprecationWarning, stacklevel=stacklevel)
        return ExecutionConfig(**used), None
    if config is not None and session is not None:
        raise TypeError("pass config= or session=, not both")
    if session is not None:
        return session.runtime_config(), session
    return (config if config is not None else DEFAULT_CONFIG), None


class Session:
    """Owns the pool, the graph cache, and the config defaults.

    The serving-side handle: one session amortizes one
    ``ProcessPoolExecutor`` and one :class:`~.cache.GraphCache` across
    every request, so repeated ``index_graph``/``schedule`` calls at the
    same ``(program, params)`` are warm dictionary hits instead of fresh
    polyhedral scans.  Usable as a context manager; ``close()`` shuts down
    a pool the session created (never one injected via ``config.pool``).

        with Session(ExecutionConfig(backend="numpy", shards=4)) as s:
            ig, sched = s.schedule(graph, {"T": 32, "N": 512})   # cold
            ig2, _ = s.schedule(graph, {"T": 32, "N": 512})      # warm hit

    The executors it builds (:meth:`executor`, :meth:`distributed`,
    :meth:`fused_executor`) take ``device=``: CUDA unless the caller names
    another device, raising where there is none, as the executors
    themselves do.  They take no kernel switch: on CUDA the discover
    sweep always steps through the hand-written ``wavefront_step`` kernel.
    """

    def __init__(self, config: Optional[ExecutionConfig] = None, **overrides):
        cfg = config if config is not None else ExecutionConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg
        from .cache import GraphCache   # deferred: cache imports graph types
        self.cache = GraphCache(cfg.cache)
        self._pool = cfg.pool
        self._own_pool = False

    # ------------------------------------------------------------- plumbing
    def pool(self):
        """The session's executor pool, created lazily and owned if so."""
        if self._pool is None:
            from concurrent.futures import ProcessPoolExecutor
            n = self.config.resolve_shards() or (os.cpu_count() or 1)
            self._pool = ProcessPoolExecutor(
                max_workers=max(1, min(n, os.cpu_count() or 1)))
            self._own_pool = True
        return self._pool

    def runtime_config(self) -> ExecutionConfig:
        """The per-call config: session defaults + the session's pool."""
        cfg = self.config
        if cfg.resolve_shards() > 1 and cfg.pool is None:
            cfg = cfg.replace(pool=self.pool())
        return cfg

    def close(self) -> None:
        if self._own_pool and self._pool is not None:
            self._pool.shutdown()
        self._pool = None
        self._own_pool = False

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ graph products
    def graph(self, program, tilings, method: str = "inflate"):
        """Build a :class:`TiledTaskGraph` on the session's backend."""
        from .taskgraph import TiledTaskGraph
        return TiledTaskGraph(program, tilings, method=method,
                              backend=self.config.backend)

    def index_graph(self, graph, params: dict):
        """Cached :meth:`TiledTaskGraph.index_graph` (cold miss materializes
        with the session's shards/pool/recovery)."""
        return self.cache.graph(graph, params, self.runtime_config())

    def schedule(self, graph, params: dict):
        """Cached ``(IndexedGraph, IndexedSchedule)`` — synthesize once."""
        return self.cache.schedule(graph, params, self.runtime_config())

    def packed(self, graph, params: dict):
        """Cached ``(DeviceGraph, DeviceSchedule)`` device columns."""
        return self.cache.packed(graph, params, self.runtime_config())

    def fused_packed(self, graph, params: dict):
        """Cached ``(DeviceGraph, DeviceSchedule, origin columns)`` for the
        fused executor — a warm hit packs nothing."""
        return self.cache.fused(graph, params, self.runtime_config())

    def materialize(self, graph, params: dict):
        """Uncached dict-graph materialization under the session config."""
        return graph._materialize_cfg(params, self.runtime_config())

    def roots(self, graph, params: dict) -> Iterator:
        """Roots under the session config; sharded runs reuse the cached
        index graph instead of re-scanning."""
        cfg = self.runtime_config()
        if cfg.resolve_shards() > 1:
            return graph._roots_indexed(self.index_graph(graph, params))
        return graph._roots_cfg(params, cfg)

    def synthesize(self, graph, params: dict):
        """Labelled wavefront schedule, leveled from the cached index graph."""
        from .wavefront import _synthesize_from_ig
        return _synthesize_from_ig(self.index_graph(graph, params))

    def executor(self, graph, params: dict, *, replay: bool = True,
                 device=None):
        """A :class:`~.device.DeviceExecutor` over the cached packed columns.

        ``replay=True`` packs (and validates) the cached schedule;
        ``replay=False`` builds the discover-mode executor, whose sweep
        launches ``wavefront_step`` once a level on CUDA.
        """
        from .device import DeviceExecutor
        ig = self.index_graph(graph, params)
        if replay:
            dg, ds = self.packed(graph, params)
            return DeviceExecutor(ig, packed=(dg, ds), device=device)
        dg = self.cache.packed_graph(graph, params, self.runtime_config())
        return DeviceExecutor(ig, packed=(dg, None), device=device)

    def distributed(self, graph, params: dict, *, ranks: int = 2,
                    device=None, **kw):
        """Distributed counted-sync run over the cached index graph —
        ``kw`` forwards ``engine=``/``transport=``/``timeout=``... to
        :func:`~.distributed.run_distributed`; the session's
        ``faults``/``recovery`` knobs arm injection and retry."""
        from .distributed import run_distributed
        ig = self.index_graph(graph, params)
        return run_distributed(ig, ranks=ranks, config=self.runtime_config(),
                               device=device, **kw)

    def fused_executor(self, graph, params: dict, *, replay: bool = True,
                       device=None, **kw):
        """A :class:`~.fused.FusedExecutor` over the cached fused packed
        columns (body/tile inferred from the graph; ``kw`` forwards
        ``state=``/``dtype=``/``validate=``...).
        """
        from .fused import FusedExecutor, graph_tile
        ig = self.index_graph(graph, params)
        dg, ds, fo = self.fused_packed(graph, params)
        kw.setdefault("body", getattr(graph.program, "name", "") or None)
        kw.setdefault("tile", graph_tile(graph))
        return FusedExecutor(ig, params, packed=(dg, ds if replay else None,
                                                 fo), device=device, **kw)
