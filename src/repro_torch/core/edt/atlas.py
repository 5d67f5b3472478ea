"""Synchronization-overhead atlas: the paper's Table-2 evaluation, measured.

The paper prices each §2 synchronization model on five overhead axes —
sequential start-up, in-flight task and dependence management, space for
sync objects, and garbage collection — as asymptotic classes over the task
count ``n``, edge count ``e``, and maximum ready-set size ``r``.  This
module turns the instrumented models of :mod:`.syncmodels` into that
table: a synthetic workload sweep over

* **program class** — the diamond grid (single dominator, the prescribed
  model's worst case), a dense-LA Cholesky DAG, a time-skewed stencil, and
  banded fan-out "trees" whose depth / width / fan-out are independent
  knobs (all from :data:`repro_torch.core.programs.PROGRAMS`),
* **size** — an ascending parameter ladder per workload; the reference
  curves n(s), e(s), r(s) are measured from the materialized graph, never
  assumed,
* **task grain** — the simulated task duration relative to the fixed
  master-op cost (fine grain exposes sequential start-up; coarse grain
  hides it in the makespan),
* **sync model** — all six registered models.

Every measured run is validated (:func:`~.syncmodels.validate_order`:
exactly-once, dependence-respecting) before its counters are recorded, and
the output is plain row dicts with string keys, ready for JSON; the rows,
fits and growth factors are the reference package's value for value.

:func:`fit_rows` fits each counter's growth across the size ladder against
the candidate classes ``{1, r, n, e, n^2}`` (least squares in log space
with a free constant) and checks the winner against the paper's expected
class, treating classes the workload cannot distinguish (e.g. ``n`` vs
``e`` when edges grow linearly with tasks, or ``r`` vs ``n`` on a
fixed-depth band sweep) as equivalent — the distinguishability test is
data-driven, from the measured reference curves themselves.

:func:`crossover` records where this sweep overlaps the real execution
engines: host ``simulate_indexed`` vs :class:`~.device.DeviceExecutor`
replay on the card vs two-rank :func:`~.distributed.run_distributed`, per
task across an ascending size ladder, with the first size at which each
engine beats the host marked as the crossover point.  It is the only part
of this module that touches the card.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

from ..poly import Tiling
from .syncmodels import MODELS, run_model, validate_order
from .taskgraph import TiledTaskGraph


def _program(name: str):
    # Imported at call time: programs.py itself imports the edt package
    # (taskgraph), so a module-level import here would be circular.
    from ..programs import PROGRAMS
    return PROGRAMS[name]()

# The five Table-2 overhead axes, as keyed in ``Counters.summary()``.
ATLAS_COUNTERS = ("startup_ops", "spatial_peak", "inflight_tasks_peak",
                  "inflight_deps_peak", "garbage_peak")

# Candidate asymptotic classes: constant, max ready-set size, tasks,
# edges, tasks squared.
CLASSES = ("1", "r", "n", "e", "n2")

SETUP_COST = 0.01      # master-op cost (the grain denominator)
GRAINS = (0.2, 1.0, 5.0)
SMOKE_GRAINS = (1.0,)
# The overhead sweep runs with workers that always bind: the paper's r-class
# peaks (ready-backlog-shaped counters like counted/autodec garbage) are
# realized only when the machine is narrower than the frontier, so tasks
# actually queue.  The engine crossover uses a realistic width instead.
WORKERS = 2
CROSSOVER_WORKERS = 8


@dataclass(frozen=True)
class AtlasWorkload:
    """One program class in the sweep: a size ladder plus its knobs."""
    program: str                  # PROGRAMS registry key
    family: str                   # graph | dense_la | stencil | tree
    tiles: tuple                  # tile sizes (unit tiles: task = point)
    sizes: tuple                  # ascending param dicts (full ladder)
    smoke_sizes: tuple            # ascending param dicts (smoke ladder)
    fanout: Optional[int] = None  # band radius for the tree family


WORKLOADS = (
    AtlasWorkload("diamond", "graph", (1, 1),
                  ({"K": 6}, {"K": 12}, {"K": 24}),
                  ({"K": 4}, {"K": 8})),
    AtlasWorkload("cholesky_like", "dense_la", (1, 1, 1),
                  ({"N": 5}, {"N": 8}, {"N": 12}),
                  # three smoke points: a 2-point dense-LA ladder is too
                  # short to separate r from e at these sizes
                  ({"N": 3}, {"N": 5}, {"N": 7})),
    AtlasWorkload("stencil1d", "stencil", (1, 1),
                  ({"T": 6, "N": 6}, {"T": 12, "N": 12}, {"T": 24, "N": 24}),
                  ({"T": 4, "N": 4}, {"T": 8, "N": 8})),
    # Fixed depth, growing width: a pure wavefront-width sweep at two
    # dependence fan-outs (band radius 2 vs 8).
    AtlasWorkload("fanout2", "tree", (1, 1),
                  ({"L": 6, "W": 8}, {"L": 6, "W": 24}, {"L": 6, "W": 64}),
                  ({"L": 4, "W": 4}, {"L": 4, "W": 10}), fanout=2),
    AtlasWorkload("fanout8", "tree", (1, 1),
                  ({"L": 6, "W": 8}, {"L": 6, "W": 24}, {"L": 6, "W": 64}),
                  ({"L": 4, "W": 4}, {"L": 4, "W": 10}), fanout=8),
)

# Paper Table 2, in this harness's measurable symbols.  Values are the
# expected asymptotic class of each counter's peak, read as an UPPER BOUND:
# the checker fails a fit only when the measured class grows strictly
# faster than every expected class (up to what the workload's own reference
# curves can distinguish, :func:`_indistinct`).  A measured peak *below*
# its table class is recorded (``relation == "below"``) but is not a
# failure — e.g. autodec's in-flight dependence peak is bounded by
# workers x fan-out on a narrow machine, well under its r bound.
#
# Notes tying the symbols back to the table: the prescribed master declares
# every task and edge before anything runs (start-up n+e ~ e); tags and
# autodec start in O(1); counted start-up is the n counter initializations.
# Space/in-flight track edges for the tag models and the prescribed graph,
# tasks for counted (one counter per task, live until its task starts) and
# for autodec-without-src (the master preschedules all n concurrently), but
# only the ready frontier r for autodec-with-src.  tags2 space is still e,
# not n: the tags are one-per-producer but the outstanding get records are
# per-edge.  Garbage drains continuously everywhere except tags2, whose
# one-tag-per-producer objects are disposable only at graph completion
# (~n dead tags); prescribed garbage (satisfied-but-unconsumed edges) is
# the edge-cut of the completion frontier — Θ(r) on local-dependence
# programs but up to Θ(e) on dense-LA / wide-band DAGs, so its bound is e.
EXPECTED = {
    "prescribed": {"startup_ops": ("e",), "spatial_peak": ("e",),
                   "inflight_tasks_peak": ("n",),
                   "inflight_deps_peak": ("e",), "garbage_peak": ("e",)},
    "tags1": {"startup_ops": ("1",), "spatial_peak": ("e",),
              "inflight_tasks_peak": ("n",),
              "inflight_deps_peak": ("e",), "garbage_peak": ("1",)},
    "tags2": {"startup_ops": ("1",), "spatial_peak": ("e",),
              "inflight_tasks_peak": ("n",),
              "inflight_deps_peak": ("e",), "garbage_peak": ("n",)},
    "counted": {"startup_ops": ("n",), "spatial_peak": ("n",),
                "inflight_tasks_peak": ("n",),
                "inflight_deps_peak": ("n",), "garbage_peak": ("r",)},
    "autodec": {"startup_ops": ("1",), "spatial_peak": ("r",),
                "inflight_tasks_peak": ("r",),
                "inflight_deps_peak": ("r",), "garbage_peak": ("r",)},
    "autodec_nosrc": {"startup_ops": ("1",), "spatial_peak": ("n",),
                      "inflight_tasks_peak": ("r",),
                      "inflight_deps_peak": ("n",), "garbage_peak": ("r",)},
}

# Growth-rate order of the candidate classes on this module's workloads:
# r <= n always (the frontier is a subset of the tasks), and every program
# in WORKLOADS has e >= n - 1 (connected DAGs), so the order is total.
_RANK = {"1": 0, "r": 1, "n": 2, "e": 3, "n2": 4}


@dataclass
class Instance:
    """One (workload, params) point: the graph and its measured shape."""
    workload: AtlasWorkload
    graph: TiledTaskGraph
    params: dict
    n_tasks: int
    n_edges: int
    width: int            # r: max tasks simultaneously ready
    depth: int            # wavefront levels
    max_fanout: int       # max out-degree

    @property
    def size_label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.params.items())


def build_instances(workload: AtlasWorkload,
                    smoke: bool = False) -> list[Instance]:
    """Materialize the workload's size ladder and measure its shape.

    The reference curves (n, e, r, depth, fan-out) come from the explicit
    graph — the fit layer never assumes a formula for them.
    """
    g = TiledTaskGraph(_program(workload.program),
                       {"S": Tiling(workload.tiles)})
    out = []
    for params in (workload.smoke_sizes if smoke else workload.sizes):
        m = g.materialize(params)
        ws = m.wavefronts()
        out.append(Instance(
            workload=workload, graph=g, params=dict(params),
            n_tasks=len(m.tasks), n_edges=m.n_edges,
            width=max((len(w) for w in ws), default=0), depth=len(ws),
            max_fanout=m.max_out_degree()))
    return out


def measure(inst: Instance, model: str, grain: float = 1.0,
            workers: int = WORKERS) -> dict:
    """One atlas row: run ``model`` on the instance, validated, flattened.

    ``grain`` is the simulated task duration; the master-op cost stays at
    :data:`SETUP_COST`, so grain/SETUP_COST is the task-to-setup cost
    ratio the start-up columns are priced against.
    """
    res = run_model(model, inst.graph, inst.params, workers=workers,
                    task_dur=grain, setup_cost=SETUP_COST)
    validate_order(inst.graph, inst.params, res, task_dur=grain)
    w = inst.workload
    row = {"program": w.program, "family": w.family, "model": model,
           "size": inst.size_label, "params": dict(inst.params),
           "grain": grain, "workers": workers,
           "n_tasks": inst.n_tasks, "n_edges": inst.n_edges,
           "width": inst.width, "depth": inst.depth,
           "max_fanout": inst.max_fanout, "band": w.fanout}
    row.update(_counter_fields(res))
    return row


def _counter_fields(res) -> dict:
    s = res.counters.summary()
    s["makespan"] = round(s["makespan"], 4)
    return s


# ------------------------------------------------------------------ fitting
def _logs(vals) -> list[float]:
    # Zero-valued counters are clamped to 0.5 so log space stays defined;
    # all-zero series short-circuit to class "1" before reaching here.
    return [math.log(max(float(v), 0.5)) for v in vals]


def reference_curves(insts: list[Instance]) -> dict[str, list[float]]:
    return {"1": [1.0] * len(insts),
            "r": [float(i.width) for i in insts],
            "n": [float(i.n_tasks) for i in insts],
            "e": [float(max(i.n_edges, 1)) for i in insts],
            "n2": [float(i.n_tasks) ** 2 for i in insts]}


def fit_class(ys, refs: dict[str, list[float]]) -> dict:
    """Best asymptotic class for the series ``ys`` over the size ladder.

    Least squares in log space with a free multiplicative constant per
    candidate; the winner is the minimal-residual class, with near-ties
    (within 0.05 log-residual) resolved toward the candidate whose
    constant is closest to 1 — so a counter that *equals* n beats one that
    merely grows like it.
    """
    if max(ys) == 0:
        return {"cls": "1", "scale": 0.0, "resid": 0.0}
    ly = _logs(ys)
    cands = []
    for cls in CLASSES:
        lc = _logs(refs[cls])
        la = sum(a - b for a, b in zip(ly, lc)) / len(ly)
        resid = math.sqrt(sum((a - b - la) ** 2
                              for a, b in zip(ly, lc)) / len(ly))
        cands.append((resid, abs(la), cls, math.exp(la)))
    cands.sort()
    best_resid = cands[0][0]
    near = sorted(c for c in cands if c[0] <= best_resid + 0.05)
    _, _, cls, scale = min(near, key=lambda c: c[1])
    return {"cls": cls, "scale": round(scale, 4),
            "resid": round(best_resid, 4)}


def _indistinct(refs: dict[str, list[float]], c1: str, c2: str,
                tol: float = 0.2) -> bool:
    """True when the workload's own curves cannot separate two classes.

    Two candidates are equivalent for fitting exactly when their log-ratio
    is (nearly) constant across the ladder — e.g. n vs e on any program
    whose edge count grows linearly with tasks, or r vs n on a fixed-depth
    width sweep.  Measured, not declared per program.
    """
    if c1 == c2:
        return True
    d = [a - b for a, b in zip(_logs(refs[c1]), _logs(refs[c2]))]
    mean = sum(d) / len(d)
    return max(abs(x - mean) for x in d) < tol


def fit_rows(rows: list[dict], insts_by_program: dict[str, list[Instance]],
             grain: float = 1.0) -> list[dict]:
    """Fit every (program, model, counter) series measured at ``grain``.

    Each output row records the fitted class, the paper's expected classes,
    the relation of fit to bound (``match`` up to the workload's own
    distinguishability, ``below``, or ``above``), and ``ok`` — the Table-2
    classes are upper bounds, so only ``above`` fails.
    """
    out = []
    for program, insts in insts_by_program.items():
        refs = reference_curves(insts)
        labels = [i.size_label for i in insts]
        for model in MODELS:
            series = {r["size"]: r for r in rows
                      if r["program"] == program and r["model"] == model
                      and r["grain"] == grain}
            if len(series) != len(labels):
                continue
            for counter in ATLAS_COUNTERS:
                ys = [series[lbl][counter] for lbl in labels]
                fit = fit_class(ys, refs)
                expected = EXPECTED[model][counter]
                if any(_indistinct(refs, fit["cls"], e) for e in expected):
                    relation = "match"
                elif _RANK[fit["cls"]] < min(_RANK[e] for e in expected):
                    relation = "below"
                else:
                    relation = "above"
                out.append({"program": program, "model": model,
                            "counter": counter, "values": ys,
                            "cls": fit["cls"], "scale": fit["scale"],
                            "resid": fit["resid"],
                            "expected": list(expected),
                            "relation": relation,
                            "ok": relation != "above"})
    return out


def growth_rows(rows: list[dict], grain: float = 1.0) -> list[dict]:
    """Growth factors between the smallest and largest size per model.

    The task ratio comes from the *measured* ``n_tasks`` (not a per-program
    closed form), and genuinely-zero counters are reported as such: 0 -> 0
    is factor 1.0, 0 -> b is factor None (born at scale) — never masked by
    a max(1, ...) floor.
    """
    by_pm: dict[tuple, list[dict]] = {}
    for r in rows:
        if r["grain"] != grain:
            continue
        by_pm.setdefault((r["program"], r["model"]), []).append(r)
    out = []
    for (program, model), rs in by_pm.items():
        rs = sorted(rs, key=lambda r: r["n_tasks"])
        lo, hi = rs[0], rs[-1]
        g: dict = {"program": program, "model": model,
                   "size_lo": lo["size"], "size_hi": hi["size"],
                   "task_factor": round(hi["n_tasks"] / lo["n_tasks"], 2),
                   "edge_factor": round(hi["n_edges"] / max(1, lo["n_edges"]), 2),
                   "width_factor": round(hi["width"] / max(1, lo["width"]), 2)}
        for counter in ATLAS_COUNTERS:
            a, b = lo[counter], hi[counter]
            if a == 0:
                g[counter] = 1.0 if b == 0 else None
            else:
                g[counter] = round(b / a, 2)
        out.append(g)
    return out


def sweep(smoke: bool = False, grains: Optional[tuple] = None,
          workers: int = WORKERS, emit=None) -> dict:
    """The full atlas: rows + fits + growth factors, ready for JSON.

    The default grain (1.0) runs at every size (the asymptotic ladder);
    the other grains run at the largest size only (the grain axis prices
    start-up dominance, not growth).
    """
    if grains is None:
        grains = SMOKE_GRAINS if smoke else GRAINS
    say = emit or (lambda *a, **k: None)
    rows: list[dict] = []
    insts_by_program: dict[str, list[Instance]] = {}
    say("program,family,model,size,grain,n_tasks,n_edges,width,"
        + ",".join(ATLAS_COUNTERS) + ",makespan")
    for w in WORKLOADS:
        insts = build_instances(w, smoke=smoke)
        insts_by_program[w.program] = insts
        for inst in insts:
            for model in MODELS:
                for grain in grains:
                    if grain != 1.0 and inst is not insts[-1]:
                        continue
                    row = measure(inst, model, grain=grain, workers=workers)
                    rows.append(row)
                    say(f"{row['program']},{row['family']},{model},"
                        f"{row['size']},{grain},{row['n_tasks']},"
                        f"{row['n_edges']},{row['width']},"
                        + ",".join(str(row[c]) for c in ATLAS_COUNTERS)
                        + f",{row['makespan']}")
    fits = fit_rows(rows, insts_by_program)
    growth = growth_rows(rows)
    return {"rows": rows, "fits": fits, "growth": growth,
            "counters": list(ATLAS_COUNTERS), "classes": list(CLASSES),
            "grains": list(grains), "workers": workers,
            "fit_failures": [f for f in fits if not f["ok"]]}


# -------------------------------------------------------- engine crossover
# Where the sweep overlaps the real engines: the counted model is what
# DeviceExecutor and run_distributed execute, so the same graphs are priced
# per task through the host Sim, the device replay sweep, and a two-rank
# inline distributed run, across an ascending ladder.
CROSSOVER_SIZES = ({"T": 4, "N": 32}, {"T": 8, "N": 64}, {"T": 16, "N": 128})
CROSSOVER_SMOKE = ({"T": 4, "N": 24},)
CROSSOVER_TILES = (2, 2, 2)


def crossover(smoke: bool = False, workers: int = CROSSOVER_WORKERS,
              emit=None, device=None) -> dict:
    """Per-task engine cost across sizes + first size each engine wins.

    Rows: ``{program, size, n_tasks, path, seconds, per_task_us,
    verified}`` with ``path`` in {host_sim, device_replay,
    distributed_inline_2}.  The device path is warm (second run: dispatch
    cost, not the first run's column upload).  ``device`` is where the
    replay sweep runs: CUDA unless the caller passes ``device="cpu"``; it
    raises where there is no CUDA, and a failed device or distributed run
    raises rather than becoming a row.  ``points`` maps each non-host path
    to the first size label where it beat the host, or None within this
    ladder.
    """
    import numpy as np

    from .device import DeviceExecutor
    from .distributed import run_distributed
    from .wavefront import simulate_indexed, synthesize_indexed

    say = emit or (lambda *a, **k: None)
    sizes = CROSSOVER_SMOKE if smoke else CROSSOVER_SIZES
    g = TiledTaskGraph(_program("jacobi2d"), {"S": Tiling(CROSSOVER_TILES)},
                       backend="numpy")
    rows: list[dict] = []
    say("program,size,n_tasks,path,seconds,per_task_us,verified")

    def row(size_label, n, path, seconds, verified):
        r = {"program": "jacobi2d", "size": size_label, "n_tasks": n,
             "path": path, "seconds": round(seconds, 4),
             "per_task_us": round(1e6 * seconds / max(1, n), 3),
             "verified": bool(verified)}
        rows.append(r)
        say(f"jacobi2d,{size_label},{n},{path},{r['seconds']},"
            f"{r['per_task_us']},{r['verified']}")
        return r

    for params in sizes:
        label = ",".join(f"{k}={v}" for k, v in params.items())
        ig, sched = synthesize_indexed(g, params)
        t0 = time.perf_counter()
        sim = simulate_indexed(sched, workers=workers)
        host_s = time.perf_counter() - t0
        host_order = np.asarray(sim.exec_order)
        row(label, ig.n, "host_sim", host_s, len(sim.exec_order) == ig.n)

        dev = DeviceExecutor(ig, schedule=sched, device=device)
        dev.run()                              # cold: column upload
        t0 = time.perf_counter()
        run = dev.run()                        # warm: dispatch cost
        dev_s = time.perf_counter() - t0
        ok = np.array_equal(run.exec_order, host_order)
        row(label, ig.n, "device_replay", dev_s, ok)

        t0 = time.perf_counter()
        drun = run_distributed(ig, ranks=2, engine="numpy",
                               transport="inline")
        dist_s = time.perf_counter() - t0
        ok = np.array_equal(drun.level_of, sched.level_of)
        row(label, ig.n, "distributed_inline_2", dist_s, ok)

    points: dict[str, Optional[str]] = {}
    host = {r["size"]: r["per_task_us"] for r in rows
            if r["path"] == "host_sim"}
    for path in ("device_replay", "distributed_inline_2"):
        points[path] = next(
            (r["size"] for r in rows
             if r["path"] == path and r["verified"]
             and r["per_task_us"] < host[r["size"]]), None)
        say(f"# crossover {path}: {points[path]}")
    return {"rows": rows, "points": points}


# Package-level aliases: ``sweep`` / ``crossover`` are too generic to
# re-export bare from :mod:`repro_torch.core.edt`.
atlas_sweep = sweep
atlas_crossover = crossover
