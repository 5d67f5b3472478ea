"""The port's ``DeviceExecutor`` against the reference's, on the CPU.

Both packages get the same inputs — graphs from the same programs, or the
reference's own index graph — and must agree byte for byte: levels,
``level_of``, counters and execution order in both sweep modes; the
packed columns; and the failures, which must raise the same exception
types with the same payloads (kind, level, task ids, counters).
"""
from __future__ import annotations

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_backend_differential import _build_program  # noqa: E402

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import device as ref_device  # noqa: E402
from repro.core.edt import faults as ref_faults  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import faults  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402

NAMED = [
    ("trisolv", (2, 2), {"N": 21}),
    ("seidel1d", (3, 3), {"T": 9, "N": 21}),
    ("diamond", (1, 1), {"K": 9}),
    ("pipeline", (1, 1), {"M": 12, "S": 5}),
    ("embarrassing", (3,), {"N": 17}),
]


def _both(name, tiles, params):
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    return ref.synthesize_indexed(rg, params), edt.synthesize_indexed(
        pg, params)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def assert_runs_identical(port_run, ref_run):
    assert port_run.mode == ref_run.mode
    assert len(port_run.levels) == len(ref_run.levels)
    for a, b in zip(port_run.levels, ref_run.levels):
        assert _same(a, b)
    assert _same(port_run.level_of, ref_run.level_of)
    assert _same(port_run.exec_order, ref_run.exec_order)
    pc, rc = port_run.counters, ref_run.counters
    assert (pc.tasks_started, pc.tasks_finished, pc.max_in_flight,
            pc.depth) == (rc.tasks_started, rc.tasks_finished,
                          int(rc.max_in_flight), rc.depth)
    assert _same(pc.level_widths, rc.level_widths)
    assert pc.summary() == rc.summary()


def _check_both_modes(rig, rsched, pig, psched):
    for r_s, p_s in ((None, None), (rsched, psched)):
        want = ref.DeviceExecutor(rig, schedule=r_s).run()
        got = edt.DeviceExecutor(pig, schedule=p_s, device="cpu").run()
        assert_runs_identical(got, want)


def test_random_programs_same_index_graph():
    """Seeded random programs (the backend differential generator): the
    reference's own index graph and schedule fed to both executors."""
    rng = random.Random(20260731)
    for _ in range(6):
        prog, tilings, params = _build_program(rng)
        g = ref.TiledTaskGraph(prog, tilings, backend="numpy")
        rig, rsched = ref.synthesize_indexed(g, params)
        _check_both_modes(rig, rsched, rig, rsched)


@pytest.mark.parametrize("name,tiles,params", NAMED)
def test_named_programs_both_front_ends(name, tiles, params):
    (rig, rsched), (pig, psched) = _both(name, tiles, params)
    _check_both_modes(rig, rsched, pig, psched)


def test_packing_byte_identical():
    (rig, rsched), (pig, psched) = _both(*NAMED[1])
    rdg, pdg = ref_device.pack_graph(rig), edt.pack_graph(pig)
    for f in ("indptr", "succ", "dec_src", "dec_ptr", "pred_n"):
        assert _same(getattr(pdg, f), getattr(rdg, f)), f
    assert (pdg.n, pdg.n_edges) == (rdg.n, rdg.n_edges)
    rds = ref_device.pack_schedule(rig, rsched)
    pds = edt.pack_schedule(pig, psched)
    for f in ("order", "task_ptr", "lvl_tgt", "edge_ptr", "level_of"):
        assert _same(getattr(pds, f), getattr(rds, f)), f
    assert (pds.depth, pds.w_pad, pds.e_pad) == (rds.depth, rds.w_pad,
                                                 rds.e_pad)


def test_executor_from_tiled_graph_and_packed():
    name, tiles, params = NAMED[0]
    (rig, rsched), (pig, psched) = _both(name, tiles, params)
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    want = ref.DeviceExecutor(rig).run()
    assert_runs_identical(
        edt.DeviceExecutor(pg, params, device="cpu").run(), want)
    packed = (edt.pack_graph(pig), edt.pack_schedule(pig, psched))
    ex = edt.DeviceExecutor(pig, packed=packed, device="cpu")
    assert_runs_identical(ex.run(), ref.DeviceExecutor(rig,
                                                       schedule=rsched).run())
    assert_runs_identical(ex.run(), ref.DeviceExecutor(rig,
                                                       schedule=rsched).run())
    with pytest.raises(TypeError, match="params required"):
        edt.DeviceExecutor(pg, device="cpu")
    with pytest.raises(TypeError, match="not both"):
        edt.DeviceExecutor(pig, schedule=psched, packed=packed, device="cpu")


def test_empty_graph():
    (rig, _), (pig, _) = _both("embarrassing", (3,), {"N": 0})
    assert pig.n == 0
    assert_runs_identical(edt.DeviceExecutor(pig, device="cpu").run(),
                          ref.DeviceExecutor(rig).run())


# ------------------------------------------------------------- failures
def _cycle(mod):
    return mod.IndexedGraph(
        stmt_blocks=[("S", np.asarray([[0], [1]], dtype=np.int64))], n=2,
        edge_src=np.asarray([0, 1], dtype=np.int64),
        edge_tgt=np.asarray([1, 0], dtype=np.int64),
        pred_n=np.asarray([1, 1], dtype=np.int64))


def _assert_same_stall(port_err, ref_err):
    assert isinstance(port_err, edt.StallError)
    assert str(port_err) == str(ref_err)
    assert port_err.report.summary() == ref_err.report.summary()
    assert port_err.report.undrained == ref_err.report.undrained
    assert port_err.report.to_json() == ref_err.report.to_json()


def test_cycle_stalls_like_reference():
    with pytest.raises(ref.StallError) as want:
        ref.DeviceExecutor(_cycle(ref)).run()
    with pytest.raises(edt.StallError, match="cycle") as got:
        edt.DeviceExecutor(_cycle(edt), device="cpu").run()
    assert got.value.report.context == "device-discover"
    _assert_same_stall(got.value, want.value)


def test_dropped_decrement_stalls_like_reference():
    (rig, _), (pig, _) = _both(*NAMED[1])
    rplan = ref_faults.FaultPlan(
        [ref_faults.Fault(ref_faults.DROPPED_DECREMENT, task=5)])
    pplan = faults.FaultPlan([faults.Fault(faults.DROPPED_DECREMENT, task=5)])
    with pytest.raises(ref.StallError) as want:
        ref.DeviceExecutor(rig, config=ref.ExecutionConfig(faults=rplan)).run()
    with pytest.raises(edt.StallError) as got:
        edt.DeviceExecutor(pig, faults=pplan, device="cpu").run()
    _assert_same_stall(got.value, want.value)
    assert pplan.fired == rplan.fired == [("dropped_decrement", 5, 0, None)]


def _corrupt(sched, mod, how):
    lv = sched.level_of.copy()
    if how == "delayed":
        lv[sched.levels[1][0]] += 2        # push one task two levels late
    else:
        a, b = sched.levels[1][0], sched.levels[3][0]
        lv[a], lv[b] = lv[b], lv[a]        # order violation across levels
    return mod.IndexedSchedule(levels=mod.levels_from_array(lv), level_of=lv)


@pytest.mark.parametrize("how", ["delayed", "swapped"])
def test_corrupt_schedule_refused_like_reference(how):
    """The corrupt-schedule cases of tests/test_device_exec.py: the same
    kind, level, task ids and counter summary (device tallies included)."""
    (rig, rsched), (pig, psched) = _both("diamond", (1, 1), {"K": 6})
    with pytest.raises(ref.ScheduleValidationError) as want:
        ref.DeviceExecutor(rig, schedule=_corrupt(rsched, ref, how)).run()
    with pytest.raises(edt.ScheduleValidationError) as got:
        edt.DeviceExecutor(pig, schedule=_corrupt(psched, edt, how),
                           device="cpu").run()
    g, w = got.value, want.value
    assert (g.kind, g.level) == (w.kind, w.level)
    assert g.kind == "not-ready"
    assert _same(g.task_ids, w.task_ids)
    assert g.counters == w.counters
    assert str(g) == str(w)


def test_pack_schedule_rejects_duplicate_ids():
    _, (pig, psched) = _both("diamond", (1, 1), {"K": 4})
    lv = psched.levels[0]
    levels = [np.concatenate([lv, lv[:1]])] + psched.levels[1:]
    with pytest.raises(ValueError, match="exactly-once"):
        edt.pack_schedule(pig, edt.IndexedSchedule(
            levels=levels, level_of=psched.level_of))
