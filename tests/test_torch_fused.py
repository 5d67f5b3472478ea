"""The port's ``FusedExecutor`` against the reference's, float32, on the CPU.

Both sweep modes, all four stencil bodies: the final grid against the
reference ``FusedExecutor`` and ``host_execute`` at the reference's
float32 tolerance, the frontiers byte for byte; the NumPy oracles the port
copied, bit for bit; the torch ``handwritten_solve`` against
``reference_solve``; and the failures, with the reference's payloads.
The float64 ladder is in ``test_torch_fused_f64.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import faults as ref_faults  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.kernels import stencils as ref_stencils  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import faults  # noqa: E402
from repro_torch.core.edt.fused import SENTINEL_ORIGIN  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.kernels.stencils import (SPECS, default_state,  # noqa: E402
                                          handwritten_solve, reference_solve)

#: tests/test_fused_exec.py CASES and tolerances
CASES = [
    ("stencil1d", (2, 2), {"T": 6, "N": 15}),
    ("jacobi2d", (2, 2, 2), {"T": 5, "N": 11}),
    ("heat3d", (2, 2, 2, 2), {"T": 3, "N": 7}),
    ("seidel1d", (2, 3), {"T": 6, "N": 14}),
]
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _both(name, tiles, params):
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    return ref.synthesize_indexed(rg, params), edt.synthesize_indexed(
        pg, params)


@pytest.mark.parametrize("name,tiles,params", CASES)
@pytest.mark.parametrize("mode", ["replay", "discover"])
def test_fused_matches_reference_f32(name, tiles, params, mode):
    (rig, rsched), (pig, psched) = _both(name, tiles, params)
    state = default_state(SPECS[name], params["N"], np.float32)
    want = ref.FusedExecutor(rig, params, body=name, tile=tiles, state=state,
                             schedule=rsched if mode == "replay" else None
                             ).run()
    got = edt.FusedExecutor(pig, params, body=name, tile=tiles, state=state,
                            schedule=psched if mode == "replay" else None,
                            device="cpu").run()
    assert got.mode == mode and got.final.dtype == torch.float32
    np.testing.assert_allclose(got.final.numpy(), want.final, **F32_TOL)
    np.testing.assert_allclose(got.state.numpy(), want.state, **F32_TOL)
    host = edt.host_execute(SPECS[name], tiles, params["T"], params["N"],
                            edt.pack_origins(pig, tiles), psched.levels,
                            state)
    np.testing.assert_allclose(got.final.numpy(), host, **F32_TOL)
    assert np.array_equal(got.level_of, want.level_of)
    for a, b in zip(got.levels, want.levels):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.counters.summary() == want.counters.summary()


@pytest.mark.parametrize("name,tiles,params", CASES)
def test_numpy_oracles_bitwise(name, tiles, params):
    """The copied oracles: ``host_execute`` and ``reference_solve`` equal
    the reference's bit for bit, and each other (level-major ==
    time-major)."""
    (rig, rsched), (pig, psched) = _both(name, tiles, params)
    spec, rspec = SPECS[name], ref_stencils.SPECS[name]
    assert dataclasses.astuple(spec) == dataclasses.astuple(rspec)
    state = default_state(spec, params["N"], np.float32)
    assert np.array_equal(state, ref_stencils.default_state(
        rspec, params["N"], np.float32))
    fo = edt.pack_origins(pig, tiles)
    assert np.array_equal(fo, ref.pack_origins(rig, tiles))
    host = edt.host_execute(spec, tiles, params["T"], params["N"], fo,
                            psched.levels, state)
    want = ref.host_execute(rspec, tiles, params["T"], params["N"], fo,
                            rsched.levels, state)
    assert host.tobytes() == want.tobytes()
    sol = reference_solve(spec, state, params["T"])
    assert sol.tobytes() == ref_stencils.reference_solve(
        rspec, state, params["T"]).tobytes()
    assert sol.tobytes() == host.tobytes()


@pytest.mark.parametrize("name,tiles,params", CASES)
def test_handwritten_solve_torch(name, tiles, params):
    spec = SPECS[name]
    state = default_state(spec, params["N"], np.float32)
    got = handwritten_solve(spec, state, params["T"], device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = reference_solve(spec, state, params["T"])
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(
        got.numpy(), ref_stencils.handwritten_solve(
            ref_stencils.SPECS[name], state, params["T"]), **F32_TOL)
    # a tensor state keeps its device
    assert handwritten_solve(spec, torch.from_numpy(state), 1).device.type \
        == "cpu"


def test_custom_state_rerun_and_zero_steps():
    name, tiles, params = CASES[0]
    spec = SPECS[name]
    g = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                           backend="numpy")
    ex = edt.FusedExecutor(g, params, device="cpu")   # body/tile inferred
    s1 = default_state(spec, params["N"], np.float32)
    s2 = s1[::-1]                       # a strided NumPy view
    for s in (s1, s2, torch.from_numpy(s1.copy())):
        np.testing.assert_allclose(
            ex.run(s).final.numpy(),
            reference_solve(spec, np.asarray(s), params["T"]), **F32_TOL)
    run = edt.FusedExecutor(g, {"T": 0, "N": 9}, state=default_state(
        spec, 9, np.float32), device="cpu").run()
    assert run.levels == [] and run.counters.depth == 0
    assert np.array_equal(run.final.numpy(),
                          default_state(spec, 9, np.float32))


def test_validate_false_same_answer():
    name, tiles, params = CASES[1]
    _, (pig, psched) = _both(name, tiles, params)
    a, b = (edt.FusedExecutor(pig, params, body=name, tile=tiles,
                              schedule=psched, validate=v,
                              device="cpu").run() for v in (True, False))
    assert torch.equal(a.final, b.final)


def test_corrupt_schedule_refused_like_reference():
    name, tiles, params = CASES[0]
    (rig, rsched), (pig, psched) = _both(name, tiles, params)
    bad = {}
    for mod, sched in ((ref, rsched), (edt, psched)):
        lv = sched.level_of.copy()
        lv[sched.levels[1][0]] += 2
        bad[mod] = mod.IndexedSchedule(levels=mod.levels_from_array(lv),
                                       level_of=lv)
    with pytest.raises(ref.ScheduleValidationError) as want:
        ref.FusedExecutor(rig, params, body=name, tile=tiles,
                          schedule=bad[ref]).run()
    with pytest.raises(edt.ScheduleValidationError) as got:
        edt.FusedExecutor(pig, params, body=name, tile=tiles,
                          schedule=bad[edt], device="cpu").run()
    g, w = got.value, want.value
    assert (g.kind, g.level, g.counters) == (w.kind, w.level, w.counters)
    assert np.array_equal(g.task_ids, w.task_ids)


def test_dropped_decrement_stalls_fused_discover_like_reference():
    name, tiles, params = CASES[0]
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    rplan = ref_faults.FaultPlan(
        [ref_faults.Fault(ref_faults.DROPPED_DECREMENT, task=3)])
    pplan = faults.FaultPlan([faults.Fault(faults.DROPPED_DECREMENT, task=3)])
    with pytest.raises(ref.StallError) as want:
        ref.FusedExecutor(rg, params,
                          config=ref.ExecutionConfig(faults=rplan)).run()
    with pytest.raises(edt.StallError) as got:
        edt.FusedExecutor(pg, params,
                          config=edt.ExecutionConfig(faults=pplan),
                          device="cpu").run()
    assert got.value.report.context == "fused-discover"
    assert str(got.value) == str(want.value)
    assert got.value.report.to_json() == want.value.report.to_json()
    assert pplan.fired == rplan.fired


def test_packed_layout_and_constructor_errors():
    name, tiles, params = CASES[0]
    _, (pig, psched) = _both(name, tiles, params)
    fo = edt.pack_origins(pig, tiles)
    assert fo.shape == (pig.n + 1, len(tiles)) and fo.dtype == np.int32
    assert (fo[-1] == SENTINEL_ORIGIN).all()
    g = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                           backend="numpy")
    assert edt.graph_tile(g) == tiles
    packed = (edt.pack_graph(pig), edt.pack_schedule(pig, psched,
                                                     origins=fo), None)
    run = edt.FusedExecutor(pig, params, body=name, tile=tiles,
                            packed=packed, device="cpu").run()
    assert run.mode == "replay"
    cpu = dict(device="cpu")
    with pytest.raises(TypeError, match="params required"):
        edt.FusedExecutor(g, **cpu)
    with pytest.raises(TypeError, match="tile="):
        edt.FusedExecutor(pig, params, body=name, **cpu)
    with pytest.raises(TypeError, match="body="):
        edt.FusedExecutor(pig, params, tile=tiles, **cpu)
    with pytest.raises(TypeError, match="unknown stencil body"):
        edt.FusedExecutor(pig, params, body="nope", tile=tiles, **cpu)
    with pytest.raises(ValueError, match="tile dims"):
        edt.FusedExecutor(pig, params, body=name, tile=(2, 2, 2), **cpu)
    with pytest.raises(TypeError, match="not both"):
        edt.FusedExecutor(pig, params, body=name, tile=tiles,
                          schedule=psched, packed=packed, **cpu)
    with pytest.raises(ValueError, match="state shape"):
        edt.FusedExecutor(pig, params, body=name, tile=tiles,
                          state=np.zeros((3, 3), np.float32), **cpu)
    with pytest.raises(TypeError, match="float32 or float64"):
        edt.FusedExecutor(pig, params, body=name, tile=tiles,
                          dtype=np.int32, **cpu)
    with pytest.raises(ValueError, match="single-statement"):
        edt.pack_origins(edt.IndexedGraph(
            stmt_blocks=[("A", np.zeros((1, 2), np.int64)),
                         ("B", np.zeros((1, 2), np.int64))],
            n=2, edge_src=np.zeros(0, np.int64),
            edge_tgt=np.zeros(0, np.int64), pred_n=np.zeros(2, np.int64)),
            tiles)
