"""The port's distributed rank engines against the reference's, on the CPU.

Both packages build the same programs' index graphs, and must agree:

* the partition, array for array, and through
  ``convert.rank_slices_from_reference`` the very same partition fed to
  the port's engines;
* the merged ``level_of``, levels and execution order, byte for byte, for
  the inline NumPy engine and the device engine (its step the plain torch
  version of ``wavefront_step`` on ``device="cpu"``), with the same rank
  statistics;
* exactly-once delivery under duplicated batches;
* the faults: a rank crash and a lost message batch recovered byte for
  byte, and the failures without a retry policy raising the reference's
  exception types with the reference's payloads.

Process transports are forked twice (a recovered soft crash, a hard crash
without a policy); everything else runs inline.
"""
from __future__ import annotations

import functools
import json
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_distributed import CASES, RETRY  # noqa: E402

from repro.core import edt as ref  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import distributed as dist  # noqa: E402
from repro_torch.core.edt import faults, recovery  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402

JACOBI = CASES[0]
PORT_RETRY = recovery.RetryPolicy(max_retries=RETRY.max_retries,
                                  base_delay=RETRY.base_delay)
SLICE_FIELDS = ("bounds", "indeg", "l_indptr", "l_tgt", "r_indptr", "r_tgt")
STAT_FIELDS = ("rank", "n_local", "started", "supersteps", "msgs_out",
               "msgs_in", "batches_out", "batches_in", "duplicates")


@functools.cache
def _both(name, tiles, params):
    """The index graph of one program, from each package's front end."""
    params = dict(params)
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    rig, pig = rg.index_graph(params), pg.index_graph(params)
    assert pig.pred_n.tobytes() == rig.pred_n.tobytes()
    return rig, pig


def _graphs(case):
    name, tiles, params = case
    return _both(name, tuple(tiles), tuple(sorted(params.items())))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def assert_runs_identical(got, want):
    assert (got.ranks, got.engine, got.transport, got.attempts) == (
        want.ranks, want.engine, want.transport, want.attempts)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        assert _same(a, b)
    assert _same(got.level_of, want.level_of)
    assert _same(got.exec_order, want.exec_order)
    assert [[getattr(s, f) for f in STAT_FIELDS] for s in got.rank_stats] \
        == [[getattr(s, f) for f in STAT_FIELDS] for s in want.rank_stats]
    assert got.summary() == want.summary()


def _ref_run(rig, plan=None, policy=None, **kw):
    cfg = ref.ExecutionConfig(faults=plan, recovery=policy)
    return ref.run_distributed(rig, config=cfg, **kw)


def _merge(slices, engines) -> np.ndarray:
    level_of = np.empty(int(slices[-1].hi), dtype=np.int64)
    for sl, eng in zip(slices, engines):
        level_of[sl.lo:sl.hi] = eng.level
    return level_of


# ---------------------------------------------------------------- partition
@pytest.mark.parametrize("ranks", [1, 2, 3, 5])
def test_partition_matches_reference(ranks):
    rig, pig = _graphs(JACOBI)
    assert _same(edt.plan_ranks(pig.n, ranks), ref.plan_ranks(rig.n, ranks))
    want = ref.partition_graph(rig, ranks)
    got = edt.partition_graph(pig, ranks)
    carried = convert.rank_slices_from_reference(want)
    assert len(got) == len(want) == len(carried) == ranks
    for g, c, w in zip(got, carried, want):
        for sl in (g, c):
            assert (sl.rank, sl.ranks, sl.lo, sl.hi, sl.expected_in,
                    sl.n_local) == (w.rank, w.ranks, w.lo, w.hi,
                                    w.expected_in, w.n_local)
            for f in SLICE_FIELDS:
                assert _same(getattr(sl, f), getattr(w, f)), f
    with pytest.raises(ValueError, match="at least one rank"):
        edt.plan_ranks(10, 0)


def test_rank_slices_from_reference_checks_columns():
    rig, _ = _graphs(JACOBI)
    want = ref.partition_graph(rig, 2)
    bad = ref.partition_graph(rig, 2)
    bad[1].l_tgt = bad[1].l_tgt.astype(np.int32)
    with pytest.raises(ValueError, match="l_tgt: want int64"):
        convert.rank_slices_from_reference(bad)
    bad = ref.partition_graph(rig, 2)
    bad[0].indeg = bad[0].indeg[:-1]
    with pytest.raises(ValueError, match="indeg"):
        convert.rank_slices_from_reference(bad)
    with pytest.raises(ValueError, match="slice 0"):
        convert.rank_slices_from_reference(want[1:])


# ------------------------------------------------------------- differential
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_inline_numpy_matches_reference(case, ranks):
    rig, pig = _graphs(case)
    want = ref.run_distributed(rig, ranks=ranks, engine="numpy",
                               transport="inline")
    got = edt.run_distributed(pig, ranks=ranks, engine="numpy",
                              transport="inline")
    assert_runs_identical(got, want)
    assert got.level_of.tobytes() == \
        edt.schedule_from_graph(pig).level_of.tobytes()


@pytest.mark.parametrize("ranks", [2, 3])
def test_device_engine_matches_reference_and_executor(ranks):
    rig, pig = _graphs(JACOBI)
    want = ref.run_distributed(rig, ranks=ranks, engine="device",
                               transport="inline")
    got = edt.run_distributed(pig, ranks=ranks, engine="device",
                              device="cpu")
    assert_runs_identical(got, want)
    single = edt.DeviceExecutor(pig, device="cpu").run()
    assert _same(got.level_of, single.level_of)
    assert _same(got.exec_order, single.exec_order)
    cross = sum(sl.r_tgt.size for sl in edt.partition_graph(pig, ranks))
    assert sum(s.msgs_out for s in got.rank_stats) == cross > 0
    assert sum(s.started for s in got.rank_stats) == pig.n
    # the superstep index is the global level: a rank steps once a level
    # it holds tasks of
    for sl, st in zip(edt.partition_graph(pig, ranks), got.rank_stats):
        assert st.supersteps == np.unique(got.level_of[sl.lo:sl.hi]).size


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_same_partition_through_convert(engine):
    """The reference's own partition, carried across, drives the port's
    engines to the reference's bytes; a TiledTaskGraph input agrees."""
    rig, pig = _graphs(CASES[2])
    want = ref.run_distributed(rig, ranks=3, engine=engine,
                               transport="inline")
    slices = convert.rank_slices_from_reference(ref.partition_graph(rig, 3))
    engines = dist._run_inline(slices, engine, None, 0, "cpu")
    assert _merge(slices, engines).tobytes() == want.level_of.tobytes()
    name, tiles, params = CASES[2]
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    got = edt.run_distributed(pg, params, ranks=3, engine=engine,
                              transport="inline", device="cpu")
    assert_runs_identical(got, want)


def test_more_ranks_than_tasks():
    """Ranks with no tasks and ranks with no local edges: the device
    engine steps an edgeless rank without a kernel and idles empty ones."""
    rig, pig = _both("trisolv", (2, 2), (("N", 8),))
    ranks = pig.n + 2
    want = ref.run_distributed(rig, ranks=ranks, engine="numpy",
                               transport="inline")
    for engine in ("numpy", "device"):
        got = edt.run_distributed(pig, ranks=ranks, engine=engine,
                                  transport="inline", device="cpu")
        assert _same(got.level_of, want.level_of)
        assert _same(got.exec_order, want.exec_order)
        assert [s.n_local for s in got.rank_stats][-2:] == [0, 0]


def test_empty_graph_and_validation():
    rig, pig = _both("trisolv", (2, 2), (("N", 8),))
    empty = edt.IndexedGraph(stmt_blocks=[], n=0,
                             edge_src=np.zeros(0, np.int64),
                             edge_tgt=np.zeros(0, np.int64),
                             pred_n=np.zeros(0, np.int64))
    run = edt.run_distributed(empty, engine="device", device="cpu")
    assert run.depth == 0 and _same(run.level_of, np.zeros(0, np.int64))
    for mod, ig in ((ref, rig), (edt, pig)):
        with pytest.raises(ValueError, match="inline transport"):
            mod.run_distributed(ig, ranks=2, engine="device",
                                transport="processes")
        with pytest.raises(ValueError, match="transport"):
            mod.run_distributed(ig, ranks=2, transport="telepathy")
        with pytest.raises(ValueError, match="engine"):
            mod.run_distributed(ig, ranks=2, engine="abacus",
                                transport="inline")
    pg = edt.TiledTaskGraph(PROGRAMS["trisolv"](), {"S": Tiling((2, 2))},
                            backend="numpy")
    with pytest.raises(TypeError, match="params required"):
        edt.run_distributed(pg, transport="inline")


# ------------------------------------------------------------- exactly-once
def test_mailbox_admits_each_sequence_once():
    mb = edt.Mailbox(ranks=2)
    b0 = edt.MsgBatch(src=1, dst=0, seq=0, tgt=np.array([3, 4]),
                      lvl=np.array([1, 1]))
    b1 = edt.MsgBatch(src=1, dst=0, seq=1, tgt=np.array([5]),
                      lvl=np.array([2]))
    assert mb.admit(b0) and mb.admit(b1)
    assert not mb.admit(b0) and not mb.admit(b1)
    assert (mb.duplicates, mb.admitted_msgs, mb.admitted_batches) == (2, 3, 2)


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_duplicate_batches_never_double_decrement(engine):
    """Every batch delivered twice: the mailboxes drop every replay and
    the merged levels stay the reference's."""
    rig, pig = _graphs(JACOBI)
    slices = edt.partition_graph(pig, 2)
    engines = [dist._make_engine(sl, engine, "cpu") for sl in slices]
    queues = [deque(), deque()]
    while not all(e.done for e in engines):
        for eng, q in zip(engines, queues):
            while q:
                eng.apply(q.popleft())
        moved = any(e.pending_size for e in engines)
        for eng in engines:
            for b in eng.superstep():
                queues[b.dst].append(b)
                queues[b.dst].append(edt.MsgBatch(
                    src=b.src, dst=b.dst, seq=b.seq, tgt=b.tgt.copy(),
                    lvl=b.lvl.copy()))
        assert moved or any(queues) or all(e.done for e in engines)
    sent = sum(e.batches_out for e in engines)
    assert sent > 0
    assert sum(e.mail.duplicates for e in engines) == sent
    assert sum(e.mail.admitted_batches for e in engines) == sent
    assert _merge(slices, engines).tobytes() == \
        ref.schedule_from_graph(rig).level_of.tobytes()


# ---------------------------------------------------------- fault recovery
def _plans(kind):
    """The same fault in both packages' plans."""
    kw = ({"index": 1, "times": 2} if kind == faults.RANK_CRASH
          else {"round": 0, "index": 1, "times": 1})
    return (ref.FaultPlan(faults=(ref.Fault(kind=kind, **kw),)),
            edt.FaultPlan(faults=(edt.Fault(kind=kind, **kw),)))


@pytest.mark.parametrize("engine", ["numpy", "device"])
@pytest.mark.parametrize("kind", [faults.RANK_CRASH, faults.MESSAGE_LOSS])
def test_fault_recovers_byte_identical(kind, engine):
    rig, pig = _graphs(JACOBI)
    rplan, pplan = _plans(kind)
    assert pplan.recoverable(PORT_RETRY.max_retries)
    assert not pplan.recoverable(0)
    want = _ref_run(rig, rplan, RETRY, ranks=2, engine=engine,
                    transport="inline")
    got = edt.run_distributed(pig, ranks=2, engine=engine,
                              transport="inline", faults=pplan,
                              recovery=PORT_RETRY, device="cpu")
    assert got.attempts == (2 if kind == faults.RANK_CRASH else 1)
    assert_runs_identical(got, want)
    assert pplan.fired == rplan.fired and pplan.fired[0][0] == kind


def _assert_same_stall(got, want):
    g, w = got.report, want.report
    assert isinstance(got, edt.StallError)
    assert (g.context, g.started, g.finished, g.in_flight, g.note) == (
        w.context, w.started, w.finished, w.in_flight, w.note)
    assert g.undrained == w.undrained and g.undrained
    assert "decrement" in g.note
    gj, wj = json.loads(g.to_json()), json.loads(w.to_json())
    assert sorted(gj) == sorted(wj)
    gj.pop("elapsed"), wj.pop("elapsed")
    assert gj == wj


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_message_loss_without_policy_stalls_like_reference(engine):
    rig, pig = _graphs(JACOBI)
    rplan, pplan = _plans(faults.MESSAGE_LOSS)
    with pytest.raises(ref.StallError) as want:
        _ref_run(rig, rplan, ranks=2, engine=engine, transport="inline")
    with pytest.raises(edt.StallError) as got:
        edt.run_distributed(pig, ranks=2, engine=engine, transport="inline",
                            faults=pplan, device="cpu")
    _assert_same_stall(got.value, want.value)
    assert pplan.fired == rplan.fired


def test_crash_beyond_retry_budget_raises():
    _, pig = _graphs(JACOBI)
    plan = edt.FaultPlan(faults=(edt.Fault(kind=faults.RANK_CRASH, index=0,
                                           times=5),))
    assert not plan.recoverable(PORT_RETRY.max_retries)
    with pytest.raises(edt.InjectedRankCrash, match="rank 0, attempt 1"):
        edt.run_distributed(pig, ranks=2, engine="device", faults=plan,
                            recovery=recovery.RetryPolicy(
                                max_retries=1, base_delay=0.001),
                            device="cpu")
    assert [f[2] for f in plan.fired] == [0, 1]


# ---------------------------------------------------------- process fabric
def test_process_transport_recovers_soft_crash():
    """One OS process per rank: a soft crash fails the attempt, the driver
    rebuilds the fired log the dead worker took with it, and the retry is
    byte-identical."""
    rig, pig = _graphs(JACOBI)
    kw = {"kind": faults.RANK_CRASH, "index": 1, "times": 1}
    rplan = ref.FaultPlan(faults=(ref.Fault(**kw),))
    pplan = edt.FaultPlan(faults=(edt.Fault(**kw),))
    want = _ref_run(rig, rplan, RETRY, ranks=2, transport="processes",
                    timeout=15.0)
    got = edt.run_distributed(pig, ranks=2, faults=pplan,
                              recovery=PORT_RETRY, timeout=15.0)
    assert got.transport == "processes" and got.attempts == 1
    assert _same(got.level_of, want.level_of)
    assert _same(got.exec_order, want.exec_order)
    assert [f[:3] for f in pplan.fired] == [f[:3] for f in rplan.fired] \
        == [(faults.RANK_CRASH, 1, 0)]


def test_hard_crash_without_policy_reports_like_reference():
    rig, pig = _graphs(JACOBI)
    kw = {"kind": faults.RANK_CRASH, "index": 0, "times": 1, "hard": True}
    with pytest.raises(ref.RankFailureError) as want:
        _ref_run(rig, ref.FaultPlan(faults=(ref.Fault(**kw),)), ranks=2,
                 transport="processes", timeout=15.0)
    with pytest.raises(edt.RankFailureError) as got:
        edt.run_distributed(pig, ranks=2, transport="processes",
                            faults=edt.FaultPlan(faults=(edt.Fault(**kw),)),
                            timeout=15.0)
    g, w = got.value.report, want.value.report
    assert isinstance(g, edt.FailureReport)
    assert g.failed == w.failed == [(("rank", 0), "exitcode 1")]
    assert (g.context, g.total, g.attempts) == (w.context, w.total,
                                                w.attempts)
    assert sorted(json.loads(g.to_json())) == sorted(json.loads(w.to_json()))
    assert str(got.value) == str(want.value)
