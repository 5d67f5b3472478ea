"""The port's sharded generation scan against the reference's, on the CPU.

Both packages build the same programs' tile graphs and must agree:

* the deterministic partition (``plan_shards``): every block's kind, key,
  parameters, outer range, merge position and sharded polyhedron;
* the exact block counts of round 0 against the reference's block scans;
* the merged scan products of ``scan_sharded`` over shared memory and
  over the pickle transport, byte for byte, and the port's own fallback
  to pickle when ``/dev/shm`` has too little room;
* the graph products through the entry points (``index_graph``,
  ``materialize``, ``roots``, ``synthesize_indexed``, ``DeviceExecutor``
  on ``device="cpu"``) at ``config=ExecutionConfig(shards=2)``;
* the faults: one recoverable fault of each kind recovered byte for byte
  with the plan's record of what fired, the unrecoverable ones with the
  reference's report, a hard crash in a caller's pool refused, and
  ``FaultPlan.random`` drawing the reference's plans.

One module-scoped pool of two workers serves every run that neither
breaks nor owns a pool; leaks are checked by the names of the segments
that these runs' own ``_Segments`` created, never by a listing of the
whole ``/dev/shm`` (other test processes share it).
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import shard as ref_shard  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import faults, recovery, shard  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402

CASES = {
    "trisolv": ((2, 2), {"N": 21}),
    "seidel1d": ((2, 3), {"T": 12, "N": 30}),
    "stencil1d": ((2, 2), {"T": 6, "N": 15}),
}
FAST = dict(max_retries=2, base_delay=0.001, timeout=5.0)


@functools.cache
def _graphs(name):
    tiles, params = CASES[name]
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    return rg, pg, dict(params)


@functools.cache
def _oracle(name):
    """The reference's in-process index graph and schedule."""
    rg, _, params = _graphs(name)
    return ref.synthesize_indexed(rg, params)


@pytest.fixture(scope="module")
def pool():
    with ProcessPoolExecutor(max_workers=2) as p:
        yield p


@pytest.fixture
def segment_names(monkeypatch):
    """Names of every segment either package's ``_Segments`` creates in the
    test; none may be left in ``/dev/shm`` when it ends."""
    names = []
    for mod in (shard, ref_shard):
        def _new(self, nbytes, _orig=mod._Segments._new):
            shm = _orig(self, nbytes)
            if shm is not None:
                names.append(shm.name)
            return shm
        monkeypatch.setattr(mod._Segments, "_new", _new)
    yield names
    gc.collect()
    left = [n for n in names if os.path.exists(os.path.join(shard.SHM_DIR, n))]
    assert not left, f"leaked shm segments: {left}"


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _same_graph(ig, rig) -> None:
    assert ig.n == rig.n and ig.dep_spans == rig.dep_spans
    for field in ("edge_src", "edge_tgt", "pred_n"):
        assert _same(getattr(ig, field), getattr(rig, field)), field
    assert [s for s, _ in ig.stmt_blocks] == [s for s, _ in rig.stmt_blocks]
    for (_, a), (_, b) in zip(ig.stmt_blocks, rig.stmt_blocks):
        assert _same(a, b)


def _poly_rows(p) -> tuple:
    return (p.dim_names, p.param_names, p.ineqs, p.eqs)


def _spec_row(s) -> tuple:
    return (s.kind, s.key, s.pv, s.lo, s.hi, s.seq, _poly_rows(s.poly))


# ============================================================ partition
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_shards_matches_reference(name, shards):
    rg, pg, params = _graphs(name)
    want = ref_shard.plan_shards(rg, params, shards)
    got = shard.plan_shards(pg, params, shards)
    assert got.tile_specs and got.edge_specs
    assert [_spec_row(s) for s in got.tile_specs] == \
        [_spec_row(s) for s in want.tile_specs]
    assert [_spec_row(s) for s in got.edge_specs] == \
        [_spec_row(s) for s in want.edge_specs]
    assert got.local.keys() == want.local.keys()
    assert got.n_shards == want.n_shards


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_shard_matches_block_scan(name):
    """Round 0's exact counts equal the rows the reference's block scans
    leave after dropping tile-level self pairs."""
    rg, pg, params = _graphs(name)
    plan = shard.plan_shards(pg, params, 3)
    rplan = ref_shard.plan_shards(rg, params, 3)
    for spec, rspec in zip(plan.tile_specs, rplan.tile_specs):
        got = shard._count_shard(shard._CountJob(spec, None))
        assert got == ref_shard._block_scan(rspec).shape[0]
    for spec, rspec in zip(plan.edge_specs, rplan.edge_specs):
        td = pg.tiled_deps[spec.key]
        self_dep = td.dep.src == td.dep.tgt
        diag = shard._diag_shard_poly(pg, spec.key) if self_dep else None
        rows = ref_shard._block_scan(rspec)
        if self_dep and rows.shape[0]:
            ns = pg.tilings[td.dep.src].ndim
            rows = rows[(rows[:, :ns] != rows[:, ns:]).any(axis=1)]
        assert shard._count_shard(shard._CountJob(spec, diag)) == rows.shape[0]


# ================================================================ scans
def _same_scans(got, want) -> None:
    for part in ("tiles", "edges_idx", "edges_raw"):
        g, w = getattr(got, part), getattr(want, part)
        assert sorted(g, key=str) == sorted(w, key=str), part
        for k in w:
            if isinstance(w[k], tuple):
                assert all(_same(a, b) for a, b in zip(g[k], w[k])), (part, k)
            else:
                assert _same(g[k], w[k]), (part, k)


@pytest.mark.parametrize("name,shards,use_shm", [
    ("trisolv", 2, True), ("trisolv", 2, False), ("trisolv", 4, True),
    ("trisolv", 4, False), ("seidel1d", 2, True), ("stencil1d", 4, False)])
def test_scan_sharded_matches_reference(name, shards, use_shm, pool,
                                        segment_names):
    rg, pg, params = _graphs(name)
    want = ref_shard.scan_sharded(rg, params, shards, pool=pool,
                                  use_shm=use_shm)
    got = shard.scan_sharded(pg, params, shards, pool=pool, use_shm=use_shm)
    _same_scans(got, want)
    assert got.transport == ("shm" if use_shm else "pickle")
    assert bool(segment_names) == use_shm
    rig, _ = _oracle(name)
    if use_shm:     # round 0 counted exactly what the segments hold
        assert got.shm_bytes == 8 * (
            sum(arr.shape[0] * (arr.shape[1] + 1) for _, arr in rig.stmt_blocks)
            + 2 * rig.n_edges)


def test_small_shm_falls_back_to_pickle(pool, segment_names, monkeypatch):
    """A ``/dev/shm`` with less room than the counted plan needs carries
    the blocks by pickle, byte-identical, and makes no result segment."""
    rg, pg, params = _graphs("trisolv")
    want = shard.scan_sharded(pg, params, 2, pool=pool)
    assert want.transport == "shm"
    made = len(segment_names)
    monkeypatch.setattr(shard, "shm_room", lambda: (64 << 20, 1024))
    got = shard.scan_sharded(pg, params, 2, pool=pool)
    assert got.transport == "pickle" and got.shm_bytes > 1024
    assert len(segment_names) == made
    _same_scans(got, want)


# ============================================================== graphs
@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_entry_points_sharded_match_reference(name, pool,
                                                   segment_names):
    rg, pg, params = _graphs(name)
    cfg = ref.ExecutionConfig(shards=2, pool=pool)
    rig, rsched = ref.synthesize_indexed(rg, params, config=cfg)
    pcfg = edt.ExecutionConfig(shards=2, pool=pool)
    ig, sched = edt.synthesize_indexed(pg, params, config=pcfg)
    _same_graph(ig, rig)
    _same_graph(ig, _oracle(name)[0])
    assert _same(sched.level_of, rsched.level_of)
    assert all(_same(a, b) for a, b in zip(sched.levels, rsched.levels))
    _same_graph(pg.index_graph(params, config=pcfg),
                rg.index_graph(params, config=cfg))
    m, rm = pg.materialize(params, config=pcfg), rg.materialize(
        params, config=cfg)
    assert (m.tasks, m.succ, m.pred_n) == (rm.tasks, rm.succ, rm.pred_n)
    assert list(pg.roots(params, config=pcfg)) == \
        list(rg.roots(params, config=cfg)) == list(rg.roots(params))


@pytest.mark.parametrize("shards,parallel", [
    (None, False), (0, True), (None, True), (3, True)])
def test_resolve_shards_matches_reference(shards, parallel):
    _, pg, _ = _graphs("trisolv")
    assert pg._resolve_shards(shards, parallel) == ref.ExecutionConfig(
        shards=shards, parallel=parallel).resolve_shards()


def test_device_executor_sharded_levels(pool, segment_names):
    """``DeviceExecutor(graph, params, config=ExecutionConfig(shards=2))``:
    the discover sweep over the pool-built graph levels it as the
    reference's schedule, and a shard fault in ``config.faults`` reaches
    the generation scans."""
    _, pg, params = _graphs("seidel1d")
    rig, rsched = _oracle("seidel1d")
    run = edt.DeviceExecutor(
        pg, params, config=edt.ExecutionConfig(shards=2, pool=pool),
        device="cpu").run()
    assert _same(run.level_of, rsched.level_of)
    plan = faults.FaultPlan(faults=(faults.Fault(
        kind=faults.WORKER_CRASH, round=2, index=1),))
    ex = edt.DeviceExecutor(
        pg, params, config=edt.ExecutionConfig(shards=2, pool=pool,
                                               faults=plan),
        device="cpu")
    _same_graph(ex.ig, rig)
    assert [f[:3] for f in plan.fired] == [("shard_failure", (2, 1), 0)]
    assert _same(ex.run().level_of, rsched.level_of)


# =============================================================== faults
RECOVERABLE = {
    "soft_crash": (faults.Fault(kind=faults.WORKER_CRASH, round=1, index=1,
                                times=2), FAST, True),
    "hard_crash": (faults.Fault(kind=faults.WORKER_CRASH, round=1, index=0,
                                hard=True), FAST, False),
    "hang": (faults.Fault(kind=faults.WORKER_HANG, round=1, index=0,
                          delay=1.0),
             dict(max_retries=3, base_delay=0.001, timeout=0.4), True),
    "attach_failure": (faults.Fault(kind=faults.SHM_ATTACH_FAIL, round=2,
                                    index=1, times=2), FAST, True),
}


def _ref_plan(plan):
    return ref.FaultPlan(faults=tuple(
        ref.Fault(**dataclasses.asdict(f)) for f in plan.faults))


@pytest.mark.parametrize("kind", sorted(RECOVERABLE))
def test_recoverable_fault_is_byte_identical(kind, pool, segment_names):
    """A fault within the retry budget: the re-scanned blocks land
    byte-identical, and the plan records that it fired.  The soft crash
    and the attach failure fire where the reference's do; the hard crash
    breaks the pool, so it runs on a pool the scan owns and rebuilds."""
    fault, policy, shared = RECOVERABLE[kind]
    rg, pg, params = _graphs("trisolv")
    plan = faults.FaultPlan(faults=(fault,))
    ig = pg.index_graph(params, config=edt.ExecutionConfig(
        shards=2, pool=pool if shared else None, faults=plan,
        recovery=recovery.RetryPolicy(**policy)))
    _same_graph(ig, _oracle("trisolv")[0])
    assert plan.fired, "the fault never fired"
    assert (fault.round, fault.index) in {f[1] for f in plan.fired}
    if kind in ("soft_crash", "attach_failure"):
        rplan = _ref_plan(plan)
        rg.index_graph(params, config=ref.ExecutionConfig(
            shards=2, pool=pool, faults=rplan,
            recovery=ref.RetryPolicy(**policy)))
        assert plan.fired == rplan.fired


@pytest.mark.parametrize("fault,policy", [
    (faults.Fault(kind=faults.WORKER_CRASH, round=2, index=1, times=99),
     FAST),
    (faults.Fault(kind=faults.WORKER_CRASH, round=1, index=0),
     dict(max_retries=0, base_delay=0.001))], ids=["exhausted", "zero_retry"])
def test_unrecoverable_fault_reports_like_reference(fault, policy, pool,
                                                     segment_names):
    rg, pg, params = _graphs("trisolv")
    plan = faults.FaultPlan(faults=(fault,))
    with pytest.raises(recovery.ShardRecoveryError) as got:
        pg.index_graph(params, config=edt.ExecutionConfig(
            shards=2, pool=pool, faults=plan,
            recovery=recovery.RetryPolicy(**policy)))
    rplan = _ref_plan(plan)
    with pytest.raises(ref.ShardRecoveryError) as want:
        rg.index_graph(params, config=ref.ExecutionConfig(
            shards=2, pool=pool, faults=rplan,
            recovery=ref.RetryPolicy(**policy)))
    rep, rrep = got.value.report, want.value.report
    assert rep.summary() == rrep.summary()
    assert rep.failed == rrep.failed and rep.attempts == rrep.attempts
    assert rep.attempts[(fault.round, fault.index)] == policy["max_retries"] + 1
    assert "injected worker crash" in rep.failed[0][1]
    assert str(got.value) == str(want.value)
    assert plan.fired == rplan.fired


def test_hard_crash_in_caller_pool_is_refused(segment_names):
    """A hard crash breaks the pool; the scan does not rebuild a pool it
    does not own, and says so in its report."""
    _, pg, params = _graphs("trisolv")
    plan = faults.FaultPlan(faults=(faults.Fault(
        kind=faults.WORKER_CRASH, round=0, index=0, hard=True),))
    with ProcessPoolExecutor(max_workers=2) as own:
        with pytest.raises(recovery.ShardRecoveryError) as err:
            pg.index_graph(params, config=edt.ExecutionConfig(
                shards=2, pool=own, faults=plan,
                recovery=recovery.RetryPolicy(**FAST)))
    assert err.value.report.context == "sharded"
    assert "cannot rebuild" in err.value.report.failed[0][1]


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_fault_plan_random_matches_reference(seed):
    tasks = [("S", (i, i + 1)) for i in range(9)]
    for kw in ({}, {"n_jobs": 2, "kinds": (faults.WORKER_CRASH,
                                          faults.SHM_ATTACH_FAIL)},
               {"tasks": tasks, "kinds": faults.KINDS, "n_faults": 4}):
        got = faults.FaultPlan.random(seed, **kw)
        want = ref.FaultPlan.random(seed, **kw)
        assert got.seed == want.seed
        assert [dataclasses.astuple(f) for f in got.faults] == \
            [dataclasses.astuple(f) for f in want.faults]


def test_maybe_inject_matches_reference():
    for kind, err in ((faults.WORKER_CRASH, faults.InjectedWorkerCrash),
                      (faults.SHM_ATTACH_FAIL, faults.InjectedAttachFailure)):
        fault = faults.Fault(kind=kind, round=1, index=3, times=2)
        faults.maybe_inject(fault, 2)           # past its budget: no fire
        with pytest.raises(err) as got:
            faults.maybe_inject(fault, 1)
        with pytest.raises(Exception) as want:
            ref_shard.maybe_inject(ref.Fault(**dataclasses.asdict(fault)), 1)
        assert str(got.value) == str(want.value)
        assert type(got.value).__name__ == type(want.value).__name__


def test_segments_finalizer_sweeps_by_name(segment_names):
    """A ``_Segments`` dropped without ``release()`` still unlinks its
    result and key-table segments (``weakref.finalize``)."""
    segs = shard._Segments(enabled=True)
    assert segs.allocate(("S", 0), (8,))
    assert segs.publish(np.arange(5, dtype=np.int64)) is not None
    assert len(segment_names) == 2
    assert all(os.path.exists(os.path.join(shard.SHM_DIR, n))
               for n in segment_names)
    del segs
    gc.collect()
    assert not [n for n in segment_names
                if os.path.exists(os.path.join(shard.SHM_DIR, n))]
