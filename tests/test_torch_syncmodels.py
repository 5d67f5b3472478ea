"""The port's synchronization models, schedules and emitters against the
reference's, on the CPU.

Both packages build the same programs' tile graphs and must agree value
for value:

* the six §2 models on the instrumented simulator: the start order with
  its times, every Table-2 counter, and ``validate_order``'s verdict,
  including its ``AssertionError`` message on a broken order;
* the static schedules: ``synthesize`` on the scalar and the NumPy
  backends, ``simulate_schedule`` and ``simulate_indexed`` (levels,
  ``level_of``, execution order, makespan), and the closed-form level of
  uniform dependences;
* the generated code of Figs 3-5 and the fused sweep, byte for byte, and
  against the golden files;
* which fault plans a retrying run can recover from.

Everything is host code: no test here touches a tensor.
"""
from __future__ import annotations

import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import codegen as ref_codegen  # noqa: E402
from repro.core.edt import wavefront as ref_wavefront  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import codegen, faults, wavefront  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.kernels.stencils import SPECS  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
#: the four program classes of the models' comparison, at small sizes
MODEL_CASES = {
    "diamond": ((1, 1), {"K": 6}),
    "stencil1d": ((2, 2), {"T": 8, "N": 8}),
    "cholesky_like": ((1, 1, 1), {"N": 5}),
    "fanout2": ((1, 1), {"L": 4, "W": 8}),
}
SCHEDULE_CASES = {
    "stencil1d": ((2, 2), {"T": 8, "N": 9}),
    "jacobi2d": ((2, 2, 2), {"T": 4, "N": 6}),
    "diamond": ((2, 2), {"K": 7}),
    "cholesky_like": ((1, 1, 1), {"N": 5}),
}


def _graphs(name, tiles, backend="compiled"):
    return (ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                               backend=backend),
            edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                               backend=backend))


# ================================================================ models
@pytest.mark.parametrize("model", sorted(ref.MODELS))
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_matches_reference(name, model):
    tiles, params = MODEL_CASES[name]
    rg, pg = _graphs(name, tiles)
    want = ref.run_model(model, rg, params, workers=3)
    got = edt.run_model(model, pg, params, workers=3)
    assert (got.model, got.n_tasks, got.n_edges) == (
        want.model, want.n_tasks, want.n_edges)
    assert got.order == want.order
    assert got.counters.summary() == want.counters.summary()
    ref.validate_order(rg, params, want)
    edt.validate_order(pg, params, got)


def _broken_orders(graph, params, order):
    """The same run with one dependent pair's start times swapped, with a
    task run twice, and with a task missing."""
    pos = {t: i for i, (t, _) in enumerate(order)}
    t = next(t for t, _ in order if list(graph.successors(t, params)))
    s = next(iter(graph.successors(t, params)))
    swapped = list(order)
    (_, at_t), (_, at_s) = swapped[pos[t]], swapped[pos[s]]
    swapped[pos[t]], swapped[pos[s]] = (t, at_s), (s, at_t)
    return {"swapped": swapped, "twice": order + [order[0]],
            "missing": order[1:]}


@pytest.mark.parametrize("broken", ["swapped", "twice", "missing"])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_validate_order_refuses_what_the_reference_refuses(name, broken):
    tiles, params = MODEL_CASES[name]
    rg, pg = _graphs(name, tiles)
    run = ref.run_counted(rg, params)
    order = _broken_orders(rg, params, run.order)[broken]
    with pytest.raises(AssertionError) as want:
        ref.validate_order(rg, params, ref.RunResult(
            "counted", run.counters, order, run.n_tasks))
    with pytest.raises(AssertionError) as got:
        edt.validate_order(pg, params, edt.RunResult(
            "counted", edt.Counters(), order, run.n_tasks))
    assert str(got.value) == str(want.value)


def test_models_registry_and_sim_guard():
    assert list(edt.MODELS) == list(ref.MODELS)
    sim = edt.Sim(workers=1)
    sim.make_ready_ids([3, 4], lambda: None)
    with pytest.raises(ValueError, match="already made ready"):
        sim.make_ready(4, lambda: None)


# ============================================================= schedules
@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_schedules_match_reference(name):
    tiles, params = SCHEDULE_CASES[name]
    scalar = _graphs(name, tiles)
    array = _graphs(name, tiles, backend="numpy")
    want = ref.synthesize(scalar[0], params)
    for g in (scalar[1], array[1]):
        got = edt.synthesize(g, params)
        assert got.levels == want.levels and got.level_of == want.level_of
        assert got.stats() == want.stats()
    rsim = ref.simulate_schedule(want, workers=3, task_dur=0.5)
    psim = edt.simulate_schedule(edt.synthesize(array[1], params), workers=3,
                                 task_dur=0.5)
    assert psim.exec_order == rsim.exec_order
    assert psim.counters.summary() == rsim.counters.summary()

    rig, rsched = ref.synthesize_indexed(array[0], params)
    _, psched = edt.synthesize_indexed(array[1], params)
    assert psched.level_of.tobytes() == rsched.level_of.tobytes()
    rsim = ref.simulate_indexed(rsched, workers=5)
    psim = edt.simulate_indexed(psched, workers=5)
    assert psim.exec_order == rsim.exec_order
    assert (psim.now, psim.counters.summary()) == (
        rsim.now, rsim.counters.summary())


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_closed_form_level_matches_reference(name):
    tiles, params = SCHEDULE_CASES[name]
    rg, pg = _graphs(name, tiles)
    want = ref_wavefront.uniform_distance_vectors(rg)
    assert wavefront.uniform_distance_vectors(pg) == want
    rf = ref_wavefront.closed_form_level(rg)
    pf = wavefront.closed_form_level(pg)
    assert (pf is None) == (rf is None)
    if rf is not None:
        tasks = list(rg.tasks(params))
        assert [pf(c) for _, c in tasks] == [rf(c) for _, c in tasks]


def test_synthesize_refuses_sharded_generation():
    _, pg = _graphs("stencil1d", (2, 2))
    with pytest.raises(NotImplementedError, match="not ported"):
        edt.synthesize(pg, {"T": 4, "N": 4}, shards=2)


# =============================================================== codegen
CODEGEN_CASES = {"diamond": (1, 1), "stencil1d": (2, 4)}


def _render(emit, graph, has_body):
    parts = [emit.emit_prescribed(graph), "",
             emit.emit_tags(graph, method=2), "",
             emit.emit_tags(graph, method=1), "",
             emit.emit_autodec(graph), ""]
    if has_body:
        parts += [emit.emit_fused(graph), ""]
    return "\n".join(parts)


@pytest.mark.parametrize("name", sorted(CODEGEN_CASES))
def test_codegen_matches_reference_and_golden(name):
    rg, pg = _graphs(name, CODEGEN_CASES[name])
    has_body = name in SPECS   # a fused form only for a stencil body
    got = _render(codegen, pg, has_body)
    assert got == _render(ref_codegen, rg, has_body)
    assert got == (GOLDEN_DIR / f"codegen_{name}.txt").read_text()


def test_fused_emitter_matches_reference_on_seidel():
    rg, pg = _graphs("seidel1d", (2, 3))
    assert codegen.emit_fused(pg) == ref_codegen.emit_fused(rg)
    _, diamond = _graphs("diamond", (1, 1))
    with pytest.raises(ValueError, match="no stencil body"):
        codegen.emit_fused(diamond)


# ================================================================ faults
def _plans(pkg):
    """Plans mixing every task-level and distributed kind, as each package
    spells them."""
    F = pkg.Fault
    hang = F(kind=pkg.WORKER_HANG, task=("S", (0, 0)), delay=0.1)
    body = F(kind=pkg.TASK_BODY_ERROR, task=("S", (1, 1)))
    drop = F(kind=pkg.DROPPED_DECREMENT, task=("S", (2, 1)))
    crash = F(kind=pkg.RANK_CRASH, index=1, times=2)
    loss = F(kind=pkg.MESSAGE_LOSS, round=0, index=1, times=1)
    return [(), (hang,), (F(kind=pkg.WORKER_HANG, task=7, times=2),),
            (body, drop), (crash,), (loss,), (hang, body, drop, loss),
            (hang, crash), (body, drop, crash, loss)]


@pytest.mark.parametrize("max_retries", [0, 1, 2])
def test_recoverable_matches_reference(max_retries):
    want = [ref.FaultPlan(faults=p).recoverable(max_retries)
            for p in _plans(ref)]
    got = [edt.FaultPlan(faults=p).recoverable(max_retries)
           for p in _plans(edt)]
    assert got == want
    # a plan with one task hang of times=1 is not recoverable without a
    # retry: the hang is a shard kind, and it counts against the budget
    hang = edt.FaultPlan(faults=(edt.Fault(kind=edt.WORKER_HANG, task=3),))
    assert hang.recoverable(max_retries) == (max_retries >= 1)


def test_fault_kinds_and_accessors_match_reference():
    assert faults.KINDS == ref.faults.KINDS
    assert faults.SHARD_KINDS == ref.faults.SHARD_KINDS
    plan = edt.FaultPlan(faults=_plans(edt)[-3])
    rplan = ref.FaultPlan(faults=_plans(ref)[-3])
    for task in (("S", (0, 0)), ("S", (1, 1)), ("S", (2, 1))):
        for acc in ("body_fault", "hang_fault"):
            got, want = getattr(plan, acc)(task), getattr(rplan, acc)(task)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.kind, got.task, got.delay) == (
                    want.kind, want.task, want.delay)
    assert [f.kind for f in plan.shard_kinds()] == [
        f.kind for f in rplan.shard_kinds()]
    err, rerr = edt.InjectedTaskError(("S", (1, 1))), \
        ref.InjectedTaskError(("S", (1, 1)))
    assert (repr(err), err.task) == (repr(rerr), rerr.task)
