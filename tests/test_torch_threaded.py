"""The port's threaded autodec runtime and quarantined Sim against the
reference's, on the CPU.

* Stress: a wide diamond mesh runs repeatedly at worker counts above the
  core count; every task runs exactly once, after its predecessors, and
  every counter is created once and collected at schedule time.
* Faults, for the same :class:`FaultPlan` in both packages: failed task
  bodies aggregate into one ``TaskGroupError`` with the reference's
  failed set, poisoned cone and undrained counters; a hung body becomes a
  ``StallError`` in the ``threaded`` context; a dropped decrement is
  diagnosed with its starved counter named; the quarantined Sim cancels
  exactly ``poisoned_cone`` of the failure, as the reference's does.

Every run passes an explicit ``stall_timeout`` (0.4 s against a 3 s hang,
5 s for the dropped decrement, 10 s elsewhere), and the threads a hung
body leaves behind are joined before the test ends.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt.recovery import (  # noqa: E402
    cone_from_successors as ref_cone)
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt.recovery import cone_from_successors  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402

STALL = 10.0          # seconds without progress before a run is a stall
HANG_DELAY, HANG_STALL = 3.0, 0.4
DROP_STALL = 5.0


def _diamond(k_tiles=(1, 1)):
    return edt.TiledTaskGraph(PROGRAMS["diamond"](), {"S": Tiling(k_tiles)})


def _trisolv():
    """The reference fault suite's graph (``tests/test_faults.py``)."""
    params = {"N": 21}
    rg = ref.TiledTaskGraph(REF_PROGRAMS["trisolv"](), {"S": RefTiling((2, 2))},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS["trisolv"](), {"S": Tiling((2, 2))},
                            backend="numpy")
    return rg, pg, params


def _join_new_threads(before, timeout):
    """Join every thread started since ``before``; none may outlive
    ``timeout``."""
    for t in set(threading.enumerate()) - before:
        t.join(timeout)
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.is_alive()]
    assert not alive, f"threads outlived the run: {alive}"


# ================================================================ stress
@pytest.mark.parametrize("workers", [8, 32])
def test_diamond_mesh_exactly_once_and_topological(workers):
    g = _diamond()
    params = {"K": 20}
    m = g.materialize(params)
    for _ in range(4):
        order = edt.run_graph_threaded(g, params, workers=workers,
                                       stall_timeout=STALL)
        assert len(order) == len(m.tasks) and set(order) == set(m.tasks)
        pos = {t: i for i, t in enumerate(order)}
        for t, succs in m.succ.items():
            for s in succs:
                assert pos[s] > pos[t], f"dependence violated {t}->{s}"


def test_counter_table_drains_and_single_creator():
    g = _diamond()
    params = {"K": 12}
    created, lock = [], threading.Lock()

    def counted_pred(t):
        with lock:
            created.append(t)
        return g.pred_count(t, params)

    rt = edt.ThreadedAutodec(
        pred_count=counted_pred,
        successors=lambda t: list(g.successors(t, params)),
        body=lambda t: None, workers=16)
    rt.preschedule_all(g.tasks(params))
    assert rt.wait(timeout=STALL)
    rt.shutdown()
    n = g.num_tasks(params)
    assert not rt.errors and len(rt.executed) == n
    assert len(created) == len(set(created)) == n
    assert not rt.counter_snapshot()
    assert rt.progress() == (n, n)


def test_failing_body_does_not_wedge():
    g = _diamond()
    params = {"K": 8}
    bad = ("S", (3, 3))

    def body(t):
        if t == bad:
            raise RuntimeError("boom")

    rt = edt.ThreadedAutodec(
        pred_count=lambda t: g.pred_count(t, params),
        successors=lambda t: list(g.successors(t, params)),
        body=body, workers=24)
    rt.preschedule_all(g.tasks(params))
    assert rt.wait(timeout=STALL), "runtime wedged on task failure"
    rt.shutdown()
    assert [k for k, _ in rt.errors] == [bad]
    assert len(rt.executed) == len(set(rt.executed)) and bad not in rt.executed
    report = rt.failure_report(total=g.num_tasks(params))
    want = cone_from_successors(lambda t: g.successors(t, params), [bad])
    assert want == ref_cone(lambda t: g.successors(t, params), [bad])
    assert set(report.poisoned) == want
    assert set(rt.executed) == set(g.tasks(params)) - want - {bad}


# ============================================================ threaded faults
def _body_plan(pkg, graph, params):
    """Two body faults on a wide level, from the package's own schedule."""
    tasks = list(graph.tasks(params))
    _, sched = pkg.synthesize_indexed(graph, params)
    wide = next(lv for lv in sched.levels if len(lv) >= 2)
    victims = [tasks[int(i)] for i in wide[:2]]
    return victims, pkg.FaultPlan(faults=tuple(
        pkg.Fault(kind=pkg.TASK_BODY_ERROR, task=t) for t in victims))


def _sorted_failed(report):
    return sorted(report.failed, key=repr)


def test_task_group_error_matches_reference():
    rg, pg, params = _trisolv()
    rvictims, rplan = _body_plan(ref, rg, params)
    victims, plan = _body_plan(edt, pg, params)
    assert victims == rvictims
    with pytest.raises(ref.TaskGroupError) as want:
        ref.run_graph_threaded(rg, params, workers=4, faults=rplan,
                               stall_timeout=STALL)
    with pytest.raises(edt.TaskGroupError) as got:
        edt.run_graph_threaded(pg, params, workers=4, faults=plan,
                               stall_timeout=STALL)
    assert {k for k, _ in got.value.failures} == set(victims)
    assert sorted(map(repr, (e for _, e in got.value.failures))) == sorted(
        map(repr, (e for _, e in want.value.failures)))
    g, w = got.value.report, want.value.report
    assert (g.context, g.poisoned, g.undrained, g.executed, g.total) == (
        w.context, w.poisoned, w.undrained, w.executed, w.total)
    assert _sorted_failed(g) == _sorted_failed(w)
    assert sorted(plan.fired) == sorted(rplan.fired)


def test_quarantine_matches_reference_and_cone_oracle():
    rg, pg, params = _trisolv()
    tasks = list(pg.tasks(params))
    victim = tasks[len(tasks) // 3]
    want = ref.run_graph_threaded_resilient(
        rg, params, workers=4, stall_timeout=STALL,
        faults=ref.FaultPlan(faults=(ref.Fault(kind=ref.TASK_BODY_ERROR,
                                               task=victim),)))
    got = edt.run_graph_threaded_resilient(
        pg, params, workers=4, stall_timeout=STALL,
        faults=edt.FaultPlan(faults=(edt.Fault(kind=edt.TASK_BODY_ERROR,
                                               task=victim),)))
    assert not got.ok and got.stall is None
    g, w = got.failure, want.failure
    assert (g.failed, g.poisoned, g.undrained, g.executed, g.total) == (
        w.failed, w.poisoned, w.undrained, w.executed, w.total)
    assert g.to_json() == w.to_json()
    cone, frontier = set(), [victim]
    while frontier:
        nxt = []
        for t in frontier:
            for s in pg.successors(t, params):
                if s != victim and s not in cone:
                    cone.add(s)
                    nxt.append(s)
        frontier = nxt
    assert set(g.poisoned) == cone
    assert set(got.executed) == set(tasks) - cone - {victim}


def test_hang_becomes_stall_error():
    rg, pg, params = _trisolv()
    victim = list(pg.roots(params))[0]
    before = set(threading.enumerate())
    reports = []
    for pkg, graph in ((ref, rg), (edt, pg)):
        plan = pkg.FaultPlan(faults=(pkg.Fault(kind=pkg.WORKER_HANG,
                                               task=victim,
                                               delay=HANG_DELAY),))
        with pytest.raises(pkg.StallError) as ei:
            pkg.run_graph_threaded(graph, params, workers=2, faults=plan,
                                   stall_timeout=HANG_STALL)
        reports.append(ei.value.report)
        assert plan.fired[0][:2] == ("worker_hang", victim)
    want, got = reports
    assert got.context == want.context == "threaded"
    assert got.in_flight >= 1
    assert got.note == want.note
    _join_new_threads(before, timeout=HANG_DELAY + 5.0)


def test_dropped_decrement_is_diagnosed():
    rg, pg, params = _trisolv()
    tasks = list(pg.tasks(params))
    victim = tasks[len(tasks) // 2]
    runs = [pkg.run_graph_threaded_resilient(
        graph, params, workers=4, stall_timeout=DROP_STALL,
        faults=pkg.FaultPlan(faults=(pkg.Fault(kind=pkg.DROPPED_DECREMENT,
                                               task=victim),)))
        for pkg, graph in ((ref, rg), (edt, pg))]
    want, got = runs
    assert got.stall is not None and "decrement was dropped" in got.stall.note
    assert victim in got.stall.undrained and victim not in got.executed
    assert got.stall.undrained == want.stall.undrained
    assert got.stall.note == want.stall.note
    assert set(got.executed) == set(want.executed)


def test_clean_run_unchanged_under_fault_machinery():
    _, pg, params = _trisolv()
    plain = edt.run_graph_threaded(pg, params, workers=4, stall_timeout=STALL)
    res = edt.run_graph_threaded_resilient(pg, params, workers=4,
                                           faults=edt.FaultPlan(),
                                           stall_timeout=STALL)
    assert res.ok and set(res.executed) == set(plain)


# ====================================================== the quarantined Sim
def test_resilient_sim_clean_is_byte_identical():
    rg, pg, params = _trisolv()
    ig, sched = edt.synthesize_indexed(pg, params)
    res = edt.simulate_indexed_resilient(ig, sched)
    plain = edt.simulate_indexed(sched)
    rplain = ref.simulate_indexed(ref.synthesize_indexed(rg, params)[1])
    assert res.ok
    assert res.sim.exec_order == plain.exec_order == rplain.exec_order
    assert res.sim.now == plain.now == rplain.now


@pytest.mark.parametrize("level", [1, 3])
def test_resilient_sim_quarantine_matches_reference(level):
    rg, pg, params = _trisolv()
    rig, rsched = ref.synthesize_indexed(rg, params)
    ig, sched = edt.synthesize_indexed(pg, params)
    victim = int(sched.levels[level][0])
    want = ref.simulate_indexed_resilient(
        rig, rsched, workers=3, faults=ref.FaultPlan(faults=(
            ref.Fault(kind=ref.TASK_BODY_ERROR, task=victim),)))
    got = edt.simulate_indexed_resilient(
        ig, sched, workers=3, faults=edt.FaultPlan(faults=(
            edt.Fault(kind=edt.TASK_BODY_ERROR, task=victim),)))
    cone = edt.poisoned_cone(ig.n, ig.edge_src, ig.edge_tgt, [victim])
    rcone = ref.poisoned_cone(rig.n, rig.edge_src, rig.edge_tgt, [victim])
    assert cone.tobytes() == rcone.tobytes()
    rep = got.report
    assert rep.poisoned == sorted(int(t) for t in cone)
    assert rep.to_json() == want.report.to_json()
    assert got.sim.exec_order == want.sim.exec_order
    assert set(got.sim.exec_order) == set(range(ig.n)) - set(cone.tolist())
    assert rep.executed + len(rep.poisoned) == ig.n


def test_poisoned_cone_edge_cases_match_reference():
    rng = np.random.default_rng(20261017)
    n = 300
    a, b = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    keep = a != b
    src, tgt = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    for failed in ([], [0], [5, 17, 250], [n - 1]):
        got = edt.poisoned_cone(n, src, tgt, failed)
        want = ref.poisoned_cone(n, src, tgt, failed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert edt.poisoned_cone(0, src[:0], tgt[:0], [1]).size == 0
