"""Async schedule service: warm answers from the cache, cold fills coalesced.

Generated EDT code has to be competitive with hand-tuned runtimes *end to
end* — for a serving workload that means the answer to "give me the
frontier stream / packed schedule for program P at size N" has to be
sub-millisecond once warm.  :class:`ScheduleService` is that front end,
sitting on a :class:`~.config.Session`:

* **Warm hits** are answered inline on the event loop from the session's
  :class:`~.cache.GraphCache` — one atomic probe, no thread hop, no pool,
  no scans.
* **Cold misses** run on a small thread pool (the event loop never
  blocks on a scan) under the session's :class:`~.config.ExecutionConfig`
  — so a sharded config fans the polyhedral scans across the session's
  *process* pool with the shard recovery semantics (retry + backoff +
  pool rebuild, :mod:`.recovery`) exactly as a direct ``index_graph``
  call would.
* **Concurrent requests for the same key coalesce**: the first request
  registers an in-flight future before it ever awaits, later arrivals
  await that future, and exactly one materialization runs no matter how
  many clients ask (asserted by ``tests/test_torch_service.py``).

``launch/edt_serve.py`` wires this into a CLI; phase 16 of
``chip_smoke.py`` drives it at 1,056,784 tasks and feeds the served
columns to the card.
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Optional

from .cache import _params_key
from .config import ExecutionConfig, Session

#: product kinds the service answers (the cache's product-field map is the
#: authority on which stored arrays make each one warm).
_KINDS = ("graph", "schedule", "packed")


class ScheduleService:
    """Async batched front end over one session's graph cache.

    Construct around an existing :class:`Session` (shared cache/pool) or
    let the service own one built from ``config=``.  All request methods
    are coroutines and must run on a single event loop (the in-flight
    table relies on the loop's run-to-completion scheduling for its
    check-then-register atomicity).
    """

    def __init__(self, session: Optional[Session] = None, *,
                 config: Optional[ExecutionConfig] = None,
                 max_workers: int = 2):
        if session is not None and config is not None:
            raise TypeError("pass session= or config=, not both")
        self.session = session if session is not None else Session(config)
        self._own_session = session is None
        self._closed = False
        self._inflight: dict = {}
        self._exec = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="edt-serve")
        self.requests = 0
        self.warm = 0
        self.cold = 0
        self.coalesced = 0

    # ------------------------------------------------------------ requests
    async def index_graph(self, graph, params: dict):
        """The :class:`IndexedGraph` for ``(graph, params)``."""
        return await self._get(graph, params, "graph")

    async def schedule(self, graph, params: dict):
        """``(IndexedGraph, IndexedSchedule)`` for ``(graph, params)``."""
        return await self._get(graph, params, "schedule")

    async def packed(self, graph, params: dict):
        """``(DeviceGraph, DeviceSchedule)`` — the device-ready columns."""
        return await self._get(graph, params, "packed")

    async def frontiers(self, graph, params: dict) -> AsyncIterator:
        """The frontier stream: one int64 id array per wavefront level.

        The schedule resolves once (warm or coalesced-cold), then levels
        stream without further cache traffic — the async spelling of
        driving ``simulate_indexed`` level by level.
        """
        _, sched = await self._get(graph, params, "schedule")
        for level in sched.levels:
            yield level

    async def batch(self, graph, params_list, kind: str = "schedule"):
        """Resolve many sizes of one program concurrently (one result per
        request, same order).  Duplicate keys coalesce to one fill."""
        return await asyncio.gather(
            *(self._get(graph, p, kind) for p in params_list))

    # ------------------------------------------------------------ internals
    def _fill(self, graph, params: dict, kind: str):
        cache, cfg = self.session.cache, self.session.runtime_config()
        if kind == "graph":
            return cache.graph(graph, params, cfg)
        if kind == "schedule":
            return cache.schedule(graph, params, cfg)
        return cache.packed(graph, params, cfg)

    async def _get(self, graph, params: dict, kind: str):
        if self._closed:
            raise RuntimeError("ScheduleService is closed")
        self.requests += 1
        cache = self.session.cache
        # warm: one atomic probe returns the whole product — never touches
        # the pool or the executor.  (A peek-then-refetch pair would race
        # eviction: the entry can vanish between the two, silently turning
        # the "inline hit" into a full cold materialization ON the loop.)
        got = cache.lookup_product(graph, params, kind)
        if got is not None:
            self.warm += 1
            return got
        key = (graph.fingerprint(), _params_key(params), kind)
        fut = self._inflight.get(key)
        if fut is not None:
            self.coalesced += 1
            return await fut
        # cold: register the in-flight future synchronously (no await
        # between the miss check and this line), then materialize off-loop
        self.cold += 1
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(
            self._exec, self._fill, graph, dict(params), kind)
        self._inflight[key] = fut
        try:
            return await fut
        finally:
            self._inflight.pop(key, None)

    # ---------------------------------------------------------- lifecycle
    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "warm": self.warm,
            "cold": self.cold,
            "coalesced": self.coalesced,
            "hit_rate": (self.warm + self.coalesced) / max(1, self.requests),
            "inflight": len(self._inflight),
            "cache": self.session.cache.info(),
        }

    def close(self) -> None:
        """Drain in-flight fills, then tear down — idempotent.

        New requests are refused first (``_get`` checks ``_closed``), then
        the thread pool shuts down with ``wait=True`` — every registered
        in-flight fill runs entirely on that pool, so the shutdown IS the
        drain: when it returns, no fill can still be using the session, and
        an owned session (and its process pool) is safe to close under it.
        Clients already awaiting a drained future resolve normally.
        """
        if self._closed:
            return
        self._closed = True
        self._exec.shutdown(wait=True)
        self._inflight.clear()
        if self._own_session:
            self.session.close()

    async def __aenter__(self) -> "ScheduleService":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()
