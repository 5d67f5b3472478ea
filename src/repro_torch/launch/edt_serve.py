"""Schedule-service entry point: parametric graphs answered from the cache.

    PYTHONPATH=src python -m repro_torch.launch.edt_serve --program jacobi2d \
        --tile 2,2,2 --backend numpy --shards 2 --demo

Serves "give me the schedule / packed arrays for program P at size N"
requests through :class:`~..core.edt.service.ScheduleService`: cold
misses materialize on the sharded pool (with retry/backoff recovery when
``--retries`` is set), warm hits answer sub-millisecond from the graph
cache.  Two modes:

* ``--demo`` — a scripted burst: several sizes requested by many
  concurrent clients (duplicates coalesce), then the same sizes again
  (all warm); prints per-request latencies and the service stats.
* default — a line protocol on stdin, one JSON request per line::

      {"params": {"T": 8, "N": 64}, "kind": "schedule"}

  answered on stdout with task/edge/depth counts, warm/cold status, and
  latency; EOF prints the final stats.  (``kind`` ∈ graph | schedule |
  packed, default schedule.)

This is host code: it answers graph, schedule and packed-column requests
and launches nothing on the card (the columns it serves are what
``Session.executor`` hands to the device sweeps).  The LLM server
(``repro_torch.launch.serve``) is a different entry point.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from ..core import programs
from ..core.edt.config import CachePolicy, ExecutionConfig, Session
from ..core.edt.service import ScheduleService
from ..core.poly import Tiling


def build_session(args) -> tuple[Session, object]:
    recovery = None
    if args.retries:
        from ..core.edt.recovery import RetryPolicy
        recovery = RetryPolicy(max_retries=args.retries)
    cfg = ExecutionConfig(
        backend=args.backend, shards=args.shards or None, recovery=recovery,
        cache=CachePolicy(max_entries=args.cache_entries,
                          max_bytes=args.cache_bytes))
    session = Session(cfg)
    program = programs.PROGRAMS[args.program]()
    sizes = tuple(int(x) for x in args.tile.split(","))
    tilings = {name: Tiling(sizes) for name in program.statements}
    return session, session.graph(program, tilings)


def _describe(kind: str, result) -> dict:
    if kind == "graph":
        return {"tasks": result.n, "edges": result.n_edges}
    if kind == "schedule":
        ig, sched = result
        return {"tasks": ig.n, "edges": ig.n_edges, "depth": sched.depth}
    dg, ds = result
    return {"tasks": dg.n, "edges": dg.n_edges, "depth": ds.depth}


async def serve_stdin(service: ScheduleService, graph, out=sys.stdout) -> int:
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        t0 = time.perf_counter()
        try:
            req = json.loads(line)
            kind = req.get("kind", "schedule")
            warm = service.session.cache.peek(
                graph, req["params"],
                {"graph": "ig", "schedule": "schedule",
                 "packed": "ds"}[kind]) is not None
            result = await getattr(service, {"graph": "index_graph"}.get(
                kind, kind))(graph, req["params"])
            resp = {"ok": True, "warm": warm,
                    "ms": round((time.perf_counter() - t0) * 1e3, 3)}
            resp.update(_describe(kind, result))
        except Exception as e:  # noqa: BLE001 — protocol: report, keep serving
            resp = {"ok": False, "error": repr(e)}
        print(json.dumps(resp), file=out, flush=True)
    print(json.dumps({"stats": service.stats()}), file=out, flush=True)
    return 0


async def demo(service: ScheduleService, graph, args, out=sys.stdout) -> int:
    pnames = graph.param_names
    sizes = []
    for n in (args.size, args.size + args.size // 2, 2 * args.size):
        p = dict.fromkeys(pnames, n)
        if "T" in p:
            p["T"] = max(2, n // 4)
        sizes.append(p)

    async def one(params, kind):
        t0 = time.perf_counter()
        await getattr(service, kind)(graph, params)
        return (time.perf_counter() - t0) * 1e3

    # burst: every size requested by `--clients` concurrent clients
    reqs = [(p, "schedule") for p in sizes for _ in range(args.clients)]
    t0 = time.perf_counter()
    lat = await asyncio.gather(*(one(p, k) for p, k in reqs))
    cold_s = time.perf_counter() - t0
    print(f"cold burst: {len(reqs)} requests over {len(sizes)} keys in "
          f"{cold_s * 1e3:.1f} ms (max client latency {max(lat):.1f} ms)",
          file=out)
    # warm pass: same keys, now answered from the cache
    t0 = time.perf_counter()
    lat = await asyncio.gather(*(one(p, k) for p, k in reqs))
    warm_s = time.perf_counter() - t0
    print(f"warm burst: same {len(reqs)} requests in {warm_s * 1e3:.2f} ms "
          f"(max client latency {max(lat):.3f} ms)", file=out)
    print(json.dumps({"stats": service.stats()}, indent=2), file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--program", default="jacobi2d",
                    choices=sorted(programs.PROGRAMS))
    ap.add_argument("--tile", default="2,2,2",
                    help="comma-separated tile sizes (must match the "
                         "program's dimensionality)")
    ap.add_argument("--backend", default="numpy",
                    choices=["fraction", "compiled", "numpy"])
    ap.add_argument("--shards", type=int, default=0,
                    help="fan cold scans across N processes (0 = in-process)")
    ap.add_argument("--retries", type=int, default=0,
                    help="arm shard recovery with this retry budget")
    ap.add_argument("--cache-entries", type=int, default=32)
    ap.add_argument("--cache-bytes", type=int, default=2**30)
    ap.add_argument("--demo", action="store_true",
                    help="run the scripted concurrent burst instead of stdin")
    ap.add_argument("--size", type=int, default=24,
                    help="base parameter value for --demo sizes")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent clients per key in --demo")
    args = ap.parse_args(argv)

    session, graph = build_session(args)
    with session:
        service = ScheduleService(session)
        try:
            if args.demo:
                return asyncio.run(demo(service, graph, args))
            return asyncio.run(serve_stdin(service, graph))
        finally:
            service.close()


if __name__ == "__main__":
    sys.exit(main())
