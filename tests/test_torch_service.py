"""The port's execution config, graph cache and schedule service against
the reference's, on the CPU.

Both packages build the same programs' tile graphs and must agree:

* ``resolve_execution``: its defaults, the legacy kwargs warning
  (``pytest.warns``, which the suite's ``error:legacy execution kwargs``
  filter leaves alone) and building the config they spell, and the
  ``TypeError`` for mixing; the legacy spelling gives the graphs that
  ``config=`` gives, in both packages;
* ``fingerprint()`` hex digests for every program of ``PROGRAMS``, and
  ``scan_units()`` unit for unit;
* ``GraphCache``: warm hits are the cold products, byte-identical to the
  reference's ``index_graph`` in process and at two shards; eviction by
  bytes and by entries, pass-through, the incremental stitch and its
  inner-bound fallback, with ``info()`` equal to the reference cache's
  after the same requests; ``_params_key``;
* ``ScheduleService``: coalescing gated on an event (every client is
  registered before the one fill may finish, so the count is exact),
  distinct keys, the frontier stream, ``close`` draining and
  ``lookup_product`` under eviction;
* ``Session`` products and its executors on ``device="cpu"`` against the
  reference session's runs, and ``edt_serve``'s line protocol answer for
  answer.

Runs that need a pool share one module-scoped pool of two forked workers.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import io
import json
import sys
import threading
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import cache as ref_cache  # noqa: E402
from repro.core.edt import config as ref_config  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.launch import edt_serve as ref_serve  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import cache, config  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.launch import edt_serve  # noqa: E402

BACKENDS = ("fraction", "compiled", "numpy")
JACOBI = ("jacobi2d", (2, 2, 2), {"T": 6, "N": 10})
TRISOLV = ("trisolv", (4, 4))
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool():
    p = ProcessPoolExecutor(max_workers=2)
    p.submit(int, 0).result()
    yield p
    p.shutdown()


def _graphs(name, tiles, backend="numpy"):
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend=backend)
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend=backend)
    return rg, pg


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_graph(a, b):
    assert (a.n, a.n_edges) == (b.n, b.n_edges)
    for field in ("edge_src", "edge_tgt", "pred_n"):
        assert _same(getattr(a, field), getattr(b, field)), field
    assert [s for s, _ in a.stmt_blocks] == [s for s, _ in b.stmt_blocks]
    assert all(_same(x, y) for (_, x), (_, y) in zip(a.stmt_blocks,
                                                      b.stmt_blocks))
    assert a.dep_spans == b.dep_spans


def _same_sched(a, b):
    assert _same(a.level_of, b.level_of)
    assert len(a.levels) == len(b.levels)
    assert all(_same(x, y) for x, y in zip(a.levels, b.levels))


def _same_packed(got, want):
    (dg, ds), (rdg, rds) = got, want
    for f in ("indptr", "succ", "dec_src", "dec_ptr", "pred_n"):
        assert _same(getattr(dg, f), getattr(rdg, f)), f
    for f in ("order", "task_ptr", "lvl_tgt", "edge_ptr", "level_of"):
        assert _same(getattr(ds, f), getattr(rds, f)), f
    assert (ds.depth, ds.w_pad, ds.e_pad) == (rds.depth, rds.w_pad, rds.e_pad)


# ========================================================== resolution
def test_resolve_defaults_and_mixing_match_reference():
    cfg, sess = config.resolve_execution(None, None)
    assert cfg is config.DEFAULT_CONFIG and sess is None
    assert config.LEGACY_KWARGS == ref_config.LEGACY_KWARGS
    messages = []
    for mod in (config, ref_config):
        with pytest.raises(TypeError, match="not both") as e1:
            mod.resolve_execution(mod.ExecutionConfig(), None,
                                  legacy=dict(shards=2))
        with pytest.raises(TypeError, match="not both") as e2:
            mod.resolve_execution(mod.ExecutionConfig(), mod.Session())
        messages.append((str(e1.value), str(e2.value)))
    assert messages[0] == messages[1]
    for shards, parallel in ((None, False), (3, True), (None, True)):
        assert config.ExecutionConfig(
            shards=shards, parallel=parallel).resolve_shards() == \
            ref_config.ExecutionConfig(
                shards=shards, parallel=parallel).resolve_shards()
    for cls in ("ExecutionConfig", "CachePolicy"):
        assert _defaults(getattr(config, cls)) == \
            _defaults(getattr(ref_config, cls))


def _defaults(cls) -> list:
    """A config class's fields and defaults (the nested policy by value)."""
    return [(f.name, repr(vars(f.default)) if f.name == "cache"
             else repr(f.default)) for f in dataclasses.fields(cls)]


def test_legacy_kwargs_warn_and_build_the_config():
    legacy = dict(shards=3, parallel=config.UNSET, pool=config.UNSET,
                  faults=config.UNSET, recovery=config.UNSET)
    with pytest.warns(DeprecationWarning,
                      match="legacy execution kwargs") as got:
        cfg, sess = config.resolve_execution(None, None, legacy=legacy)
    rlegacy = {k: (ref_config.UNSET if v is config.UNSET else v)
               for k, v in legacy.items()}
    with pytest.warns(DeprecationWarning,
                      match="legacy execution kwargs") as want:
        ref_config.resolve_execution(None, None, legacy=rlegacy)
    assert str(got[0].message) == str(want[0].message)
    assert sess is None and cfg.shards == 3 and cfg.resolve_shards() == 3
    # omitting every kwarg never trips the shim
    _, pg = _graphs(*TRISOLV)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert edt.synthesize_indexed(pg, {"N": 12})[0].n > 0


def test_legacy_spelling_gives_the_config_graphs(pool):
    """Both packages' shims warn and give, byte for byte, what
    ``config=`` gives — the reference's own products included."""
    rg, pg = _graphs(*TRISOLV)
    params = {"N": 20}
    cfg = edt.ExecutionConfig(shards=2, pool=pool)
    want = rg.index_graph(params, config=ref.ExecutionConfig(shards=2,
                                                             pool=pool))
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        rlegacy = rg.index_graph(params, shards=2, pool=pool)
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        legacy = pg.index_graph(params, shards=2, pool=pool)
    for ig in (rlegacy, legacy, pg.index_graph(params, config=cfg)):
        _same_graph(ig, want)
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        m = pg.materialize(params, shards=2, pool=pool)
    assert m.succ == pg._materialize_cfg(params, cfg).succ
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        roots = list(pg.roots(params, shards=2, pool=pool))
    assert roots == list(pg.roots(params, config=cfg)) == \
        list(rg.roots(params))
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        ws = edt.synthesize(pg, params, shards=2, pool=pool)
    assert ws.levels == edt.synthesize(pg, params, config=cfg).levels
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        _, sched = edt.synthesize_indexed(pg, params, shards=2, pool=pool)
    _same_sched(sched, ref.synthesize_indexed(rg, params)[1])
    ig = pg.index_graph(params)
    with pytest.warns(DeprecationWarning, match="legacy execution kwargs"):
        run = edt.DeviceExecutor(ig, faults=None, device="cpu").run()
    assert run.counters.tasks_finished == ig.n
    with pytest.raises(TypeError, match="not both"):
        pg.index_graph(params, shards=2, config=edt.ExecutionConfig())
    with pytest.raises(TypeError, match="not both"):
        pg.roots(params, pool=None, session=edt.Session())


# ============================================================ identity
def test_fingerprint_matches_reference_for_every_program():
    assert sorted(PROGRAMS) == sorted(REF_PROGRAMS)
    seen = {}
    for name in sorted(PROGRAMS):
        ndim = next(iter(PROGRAMS[name]().statements.values())).ndim
        rg, pg = _graphs(name, (2,) * ndim)
        fp = pg.fingerprint()
        assert len(fp) == 64 and fp == rg.fingerprint(), name
        assert fp not in seen.values(), (name, seen)
        seen[name] = fp


def test_fingerprint_shared_across_backends_not_tilings():
    fps = {b: _graphs(*JACOBI[:2], backend=b)[1].fingerprint()
           for b in BACKENDS}
    assert len(set(fps.values())) == 1
    assert _graphs(*TRISOLV)[1].fingerprint() != fps["numpy"]
    other = _graphs("jacobi2d", (2, 2, 4))
    assert other[1].fingerprint() != fps["numpy"]
    assert other[1].fingerprint() == other[0].fingerprint()


@pytest.mark.parametrize("name,tiles", [JACOBI[:2], TRISOLV,
                                        ("diamond", (2, 2))])
def test_scan_units_match_reference(name, tiles):
    rg, pg = _graphs(name, tiles)
    got, want = pg.scan_units(), rg.scan_units()
    assert [(k, u) for k, u, _ in got] == [(k, u) for k, u, _ in want]
    pv = list(range(6, 6 + len(pg.param_names)))
    for (_, _, n), (_, _, rn) in zip(got, want):
        assert (n.ndim, n.nparam) == (rn.ndim, rn.nparam)
        assert repr((n.poly.ineqs, n.poly.eqs)) == \
            repr((rn.poly.ineqs, rn.poly.eqs))
        assert n.outer_only_params() == rn.outer_only_params()
        assert n.outer_bounds(pv) == rn.outer_bounds(pv)


# ========================================================= graph cache
@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_hit_is_cold_and_matches_reference(backend):
    name, tiles, params = JACOBI
    rg, pg = _graphs(name, tiles, backend)
    c = edt.GraphCache(edt.CachePolicy(incremental=False))
    cold = c.graph(pg, params)
    _same_graph(cold, rg.index_graph(params))
    assert c.graph(pg, params) is cold
    ig, sched = c.schedule(pg, params)
    assert ig is cold and c.schedule(pg, params)[1] is sched
    _same_sched(sched, ref.synthesize_indexed(rg, params)[1])
    dg, ds = c.packed(pg, params)
    dg2, ds2 = c.packed(pg, params)
    assert dg2 is dg and ds2 is ds
    rc = ref.GraphCache(ref.CachePolicy(incremental=False))
    for fn in ("graph", "graph", "schedule", "schedule", "packed",
               "packed"):
        getattr(rc, fn)(rg, params)
    _same_packed((dg, ds), rc.packed(rg, params))
    c.packed(pg, params)
    assert c.info() == rc.info()


def test_warm_hit_is_cold_sharded(pool):
    name, tiles, params = JACOBI
    rg, pg = _graphs(name, tiles)
    c = edt.GraphCache()
    cold = c.graph(pg, params, edt.ExecutionConfig(shards=2, pool=pool))
    _same_graph(cold, rg.index_graph(params))
    assert c.graph(pg, params, edt.ExecutionConfig(shards=2,
                                                   pool=pool)) is cold


def _same_sequence(calls, policy):
    """Run ``calls`` ((product, params) pairs on trisolv) through a port
    cache and a reference cache; their ``info()`` must agree."""
    rg, pg = _graphs(*TRISOLV)
    c = edt.GraphCache(edt.CachePolicy(**policy))
    rc = ref.GraphCache(ref.CachePolicy(**policy))
    for fn, params in calls:
        got, want = getattr(c, fn)(pg, params), getattr(rc, fn)(rg, params)
        if fn == "graph":
            _same_graph(got, want)
    assert c.info() == rc.info()
    return c


def test_eviction_by_bytes_matches_reference():
    budget = 20_000
    c = _same_sequence([("packed", {"N": n}) for n in range(8, 32, 2)],
                       dict(max_entries=64, max_bytes=budget,
                            incremental=False))
    info = c.info()
    assert info["bytes"] <= budget and info["evictions"] > 0
    assert info["entries"] < 12


def test_eviction_by_entries_matches_reference():
    c = _same_sequence([("graph", {"N": n}) for n in range(8, 20, 2)]
                       + [("graph", {"N": 18})],
                       dict(max_entries=3, incremental=False))
    assert c.info()["entries"] == 3 and c.info()["hits"] == 1


def test_disabled_cache_is_pass_through():
    c = _same_sequence([("graph", {"N": 10})] * 2 + [("packed", {"N": 10})],
                       dict(enabled=False))
    assert c.info()["entries"] == 0 and c.info()["bytes"] == 0
    _, pg = _graphs(*TRISOLV)
    a, b = c.graph(pg, {"N": 10}), c.graph(pg, {"N": 10})
    assert a is not b
    _same_graph(a, b)


@pytest.mark.parametrize("name,tiles,old,new", [
    ("jacobi2d", (2, 2, 2), {"T": 6, "N": 12}, {"T": 9, "N": 12}),
    ("jacobi2d", (2, 2, 2), {"T": 9, "N": 12}, {"T": 5, "N": 12}),
    ("stencil1d", (2, 2), {"T": 8, "N": 14}, {"T": 12, "N": 14}),
], ids=["grow_T", "shrink_T", "stencil1d"])
def test_incremental_matches_full_rescan_and_reference(name, tiles, old,
                                                       new):
    """The stitched graph, its schedule and its packed columns equal a
    cold full scan and the reference cache's, with the same counters."""
    rg, pg = _graphs(name, tiles)
    c, rc = edt.GraphCache(), ref.GraphCache()
    c.packed(pg, old), rc.packed(rg, old)
    got, want = c.packed(pg, new), rc.packed(rg, new)
    info = c.info()
    assert info["incremental_hits"] == 1 and info["units_reused"] >= 1
    assert info == rc.info()
    _same_packed(got, want)
    ig = c.graph(pg, new)
    _same_graph(ig, _graphs(name, tiles)[1].index_graph(new))
    _same_graph(ig, rc.graph(rg, new))
    assert c.info() == rc.info()


def test_incremental_falls_back_when_param_bounds_inner_dims():
    rg, pg = _graphs("diamond", (2, 2))
    c, rc = edt.GraphCache(), ref.GraphCache()
    for g, cc in ((pg, c), (rg, rc)):
        cc.graph(g, {"K": 8})
        cc.graph(g, {"K": 12})
    assert c.info()["incremental_hits"] == 0 and c.info() == rc.info()
    _same_graph(c.graph(pg, {"K": 12}), rg.index_graph({"K": 12}))


def test_params_key_normalizes_like_reference():
    for params in ({"N": 24, "T": 4}, {"T": np.int64(4), "N": np.float64(24)},
                   {"flag": np.bool_(True)}, {"x": 2.5}):
        got = cache._params_key(params)
        assert got == ref_cache._params_key(params)
        assert [type(v) for _, v in got] == \
            [type(v) for _, v in ref_cache._params_key(params)]
    assert cache._params_key({"N": 24, "T": 4}) == \
        cache._params_key({"T": np.int64(4), "N": np.float64(24.0)})
    for bad, match in (({"N": [24]}, "'N'.*unhashable"),
                       ({"N": 24, "tiles": {"S": 2}}, "'tiles'")):
        with pytest.raises(TypeError, match=match) as got:
            cache._params_key(bad)
        with pytest.raises(TypeError) as want:
            ref_cache._params_key(bad)
        assert str(got.value) == str(want.value)
    _, pg = _graphs(*TRISOLV)
    c = edt.GraphCache(edt.CachePolicy(incremental=False))
    cold = c.graph(pg, {"N": 24})
    assert c.graph(pg, {"N": np.int64(24)}) is cold
    assert c.graph(pg, {"N": np.float64(24.0)}) is cold
    assert c.info()["entries"] == 1 and c.info()["hits"] == 2


def test_lookup_product_is_atomic_under_eviction():
    _, pg = _graphs(*TRISOLV)
    c = edt.GraphCache(edt.CachePolicy(incremental=False))
    ig, sched = c.schedule(pg, {"N": 16})
    got = c.lookup_product(pg, {"N": 16}, "schedule")
    c.clear()
    assert got is not None and got[0] is ig and got[1] is sched
    c.graph(pg, {"N": 20})
    assert c.lookup_product(pg, {"N": 20}, "schedule") is None
    assert c.lookup_product(pg, {"N": 20}, "graph") is not None
    assert edt.graph_cache_info()["caches"] >= 1


# ============================================================= service
def test_service_coalesces_gated_cold_fill():
    """8 clients ask for one cold key; the one fill waits on an event
    that is set only once all 8 requests are registered, so exactly one
    fill runs and 7 requests coalesce onto it."""
    rg, pg = _graphs(*TRISOLV)
    params = {"N": 24}
    gate, fills = threading.Event(), []
    inner = pg._index_graph_cfg

    def gated(params, cfg, scans=None):
        fills.append(threading.current_thread().name)
        assert gate.wait(30), "the gate never opened"
        return inner(params, cfg, scans=scans)

    pg._index_graph_cfg = gated

    async def burst(service):
        async def release():
            while service.requests < 8:
                await asyncio.sleep(0)
            gate.set()
        *got, _ = await asyncio.gather(
            *(service.packed(pg, params) for _ in range(8)), release())
        return got

    with edt.Session(edt.ExecutionConfig(backend="numpy")) as session:
        service = edt.ScheduleService(session)
        try:
            got = asyncio.run(burst(service))
        finally:
            service.close()
        stats = service.stats()
        assert (stats["cold"], stats["coalesced"], stats["warm"]) == (1, 7, 0)
        assert len(fills) == 1 and fills[0].startswith("edt-serve")
        assert len({(id(a), id(b)) for a, b in got}) == 1
        _same_packed(got[0], ref.GraphCache().packed(rg, params))
        again = edt.ScheduleService(session)
        try:
            asyncio.run(again.batch(pg, [params] * 4, kind="packed"))
        finally:
            again.close()
        assert len(fills) == 1 and again.stats()["warm"] == 4


def test_service_distinct_keys_and_frontiers():
    rg, pg = _graphs(*TRISOLV)

    async def go(service):
        a, b, a2 = await service.batch(pg, [{"N": 16}, {"N": 20}, {"N": 16}])
        levels = [lv async for lv in service.frontiers(pg, {"N": 20})]
        return a, b, a2, levels

    service = edt.ScheduleService(config=edt.ExecutionConfig())
    try:
        a, b, a2, levels = asyncio.run(go(service))
    finally:
        service.close()
    assert a[0] is a2[0] and a[0] is not b[0]
    stats = service.stats()
    assert stats["cold"] == 2 and stats["warm"] + stats["coalesced"] == 2
    want = ref.synthesize_indexed(rg, {"N": 20})[1].levels
    assert len(levels) == len(want)
    assert all(_same(x, y) for x, y in zip(levels, want))


def test_service_close_drains_inflight_fill():
    _, pg = _graphs(*TRISOLV)
    started, release = threading.Event(), threading.Event()
    inner = pg._index_graph_cfg

    def slow(params, cfg, scans=None):
        started.set()
        release.wait(10)
        return inner(params, cfg, scans=scans)

    pg._index_graph_cfg = slow
    service = edt.ScheduleService(config=edt.ExecutionConfig())
    results = {}
    client = threading.Thread(target=lambda: results.update(
        r=asyncio.run(service.schedule(pg, {"N": 24}))))
    client.start()
    try:
        assert started.wait(10)
        closer = threading.Thread(target=service.close)
        closer.start()
        closer.join(0.1)
        assert closer.is_alive()        # draining, not tearing down
    finally:
        release.set()
    closer.join(10)
    client.join(10)
    assert not closer.is_alive() and results["r"][1].depth > 0
    service.close()                     # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        asyncio.run(service.schedule(pg, {"N": 30}))


# ============================================================= session
def test_session_products_match_direct_calls():
    rg, pg = _graphs(*TRISOLV)
    params = {"N": 20}
    with edt.Session(edt.ExecutionConfig(backend="numpy")) as s:
        ig = s.index_graph(pg, params)
        _same_graph(ig, rg.index_graph(params))
        assert s.index_graph(pg, params) is ig
        assert pg.index_graph(params, session=s) is ig
        assert edt.synthesize_indexed(pg, params, session=s)[0] is ig
        assert list(s.roots(pg, params)) == list(rg.roots(params))
        assert s.synthesize(pg, params).levels == \
            ref.synthesize(rg, params).levels
        assert s.materialize(pg, params).succ == rg.materialize(params).succ
        assert s.graph(PROGRAMS["trisolv"](),
                       {"S": Tiling((4, 4))}).backend == "numpy"
    s = edt.Session(cache=edt.CachePolicy(max_entries=1))
    assert s.cache.policy.max_entries == 1
    s.close()


def test_session_executors_match_reference_session():
    """The session's executors on ``device="cpu"`` against the reference
    session's schedule and runs: integer levels byte-identical, the fused
    grid within the f32 ladder."""
    name, tiles, params = JACOBI
    rg, pg = _graphs(name, tiles)
    with edt.Session(edt.ExecutionConfig(backend="numpy")) as s, \
            ref.Session(ref.ExecutionConfig(backend="numpy")) as rs:
        _, rsched = rs.schedule(rg, params)
        disc = s.executor(pg, params, replay=False, device="cpu").run()
        assert disc.mode == "discover"
        assert _same(disc.level_of, rsched.level_of)
        rep = s.executor(pg, params, device="cpu").run()
        assert rep.mode == "replay" and _same(rep.level_of, rsched.level_of)
        assert rep.counters.tasks_finished == s.index_graph(pg, params).n
        want = rs.fused_executor(rg, params).run()
        got = s.fused_executor(pg, params, device="cpu").run()
        np.testing.assert_allclose(got.final.cpu().numpy(),
                                   np.asarray(want.final), **F32_TOL)
        assert _same(got.level_of, want.level_of)
        rdist = rs.distributed(rg, params, ranks=2, engine="numpy",
                               transport="inline")
        dist = s.distributed(pg, params, ranks=2, engine="device",
                             device="cpu")
        assert _same(dist.level_of, rdist.level_of)
        keys = ("entries", "bytes", "misses")
        assert [s.cache.info()[k] for k in keys] == \
            [rs.cache.info()[k] for k in keys]


# ================================================================ CLI
def _serve(module, monkeypatch, lines):
    args = argparse.Namespace(
        program="jacobi2d", tile="2,2,2", backend="numpy", shards=0,
        retries=0, cache_entries=32, cache_bytes=2**30)
    session, graph = module.build_session(args)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(lines)))
    with session:
        service = module.ScheduleService(session)
        try:
            assert asyncio.run(module.serve_stdin(service, graph, out)) == 0
        finally:
            service.close()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_edt_serve_answers_like_reference(monkeypatch):
    lines = [json.dumps({"params": {"T": 6, "N": 12}, "kind": k}) + "\n"
             for k in ("packed", "packed", "schedule", "graph")]
    lines += ["\n", json.dumps({"params": {"T": 6}}) + "\n",
              json.dumps({"params": {"T": 8, "N": 12}}) + "\n"]
    got = _serve(edt_serve, monkeypatch, lines)
    want = _serve(ref_serve, monkeypatch, lines)
    for answer in got + want:
        answer.pop("ms", None)
    assert got == want
    assert [a.get("warm") for a in got[:4]] == [False, True, True, True]
    assert got[4]["ok"] is False and got[5]["ok"] is True
    assert got[-1]["stats"]["cache"]["incremental_hits"] == 1


def test_edt_serve_demo_runs():
    out = io.StringIO()
    args = argparse.Namespace(
        program="trisolv", tile="4,4", backend="numpy", shards=0,
        retries=0, cache_entries=32, cache_bytes=2**30, size=12, clients=3)
    session, graph = edt_serve.build_session(args)
    with session:
        service = edt_serve.ScheduleService(session)
        try:
            assert asyncio.run(edt_serve.demo(service, graph, args, out)) == 0
        finally:
            service.close()
    text = out.getvalue()
    assert "cold burst: 9 requests over 3 keys" in text
    stats = json.loads(text[text.index("{"):])["stats"]
    # a fill this small may land before a later client of its key looks,
    # which then hits warm instead of coalescing: only the cold fills and
    # the totals are exact here
    assert stats["requests"] == 18 and stats["cold"] == 3
    assert stats["cold"] + stats["coalesced"] + stats["warm"] == 18
    assert stats["cache"]["entries"] == 3
