#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — polyhedral program, index graph, wavefront
schedule, counted-sync sweeps on the card, fused stencil tiles — at the
size of the reference's acceptance runs (jacobi2d, tiles (2,2,2),
T=32, N=512: 1,056,784 tasks), and checks every result:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the CUDA kernel from ``src/repro_torch/csrc`` and its time;
3. the kernel against its plain torch version on the card, byte for byte,
   on every frontier of a real discover sweep, on an edgeless graph, an
   empty frontier and a seeded random DAG;
4. ``DeviceExecutor`` discover: ``level_of`` byte-identical to the host
   schedule, and one kernel launch per level;
5. ``DeviceExecutor`` replay, and a corrupted schedule refused;
6. ``FusedExecutor`` replay and discover in float32 against the torch
   ``handwritten_solve`` and the NumPy ``reference_solve``, and in float64
   at small sizes;
7. phase times, a ``kernels`` JSON line with each kernel's launches on the
   main path (phases 4-6), its agreement with its plain version, its time
   (CUDA events, median), the plain version's time and the least time the
   card could take for the same work.

Every failed check raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SLICE = ("jacobi2d", (2, 2, 2), {"T": 32, "N": 512})
SLICE_DEPTH, SLICE_WIDTH = 558, 3920
#: float64 sizes of the reference's fused suite (tests/test_fused_exec.py)
CASES = [
    ("stencil1d", (2, 2), {"T": 6, "N": 15}),
    ("jacobi2d", (2, 2, 2), {"T": 5, "N": 11}),
    ("heat3d", (2, 2, 2, 2), {"T": 3, "N": 7}),
    ("seidel1d", (2, 3), {"T": 6, "N": 14}),
]
F32_TOL = dict(rtol=1e-4, atol=1e-5)    # the reference's at-scale tolerance
F64_TOL = dict(rtol=1e-12, atol=1e-13)
HBM_BYTES_PER_S = 3.35e12               # H100 SXM device memory rate
REPS, INNER = 25, 20                    # timing: medians of 25 x 20 launches
SLEEP_CYCLES = 20_000_000               # ~10 ms of device sleep, a head start


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, flush=None) -> float:
    """Device time of one call: median over REPS of INNER-call means.

    A device-side sleep is queued first, so the host has enqueued every
    call before the card reaches the start event, and the events time the
    card alone, not the host's launch path.  With ``flush`` (a tensor
    larger than L2), every call is preceded by a write of it, outside its
    own pair of events, so the call finds a cold L2."""
    import torch

    samples = []
    for _ in range(REPS + 2):
        torch.cuda._sleep(SLEEP_CYCLES)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 * INNER if flush is not None else 2)]
        if flush is None:
            ev[0].record()
            for _ in range(INNER):
                fn()
            ev[1].record()
        else:
            for i in range(INNER):
                flush.add_(1)
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        torch.cuda.synchronize()
        samples.append(sum(ev[i].elapsed_time(ev[i + 1])
                           for i in range(0, len(ev), 2)) / INNER)
    return statistics.median(samples[2:])


def host_us(fn) -> float:
    """Host time of one call, the card left to run behind (median)."""
    import torch

    samples = []
    for _ in range(REPS + 2):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(INNER):
            fn()
        samples.append((time.perf_counter() - t0) / INNER * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples[2:])


def device_profile(fn):
    """``(wall s, device-busy s, kernels, top 3 kernels by device time)``
    of one call under ``torch.profiler`` (one stream: kernel times add)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    count = 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            count += 1
    busy = sum(by_name.values()) / 1e6
    top = [(k, round(v / 1e3, 3)) for k, v in by_name.most_common(3)]
    return wall, busy, count, top


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.edt import (DeviceExecutor, FusedExecutor,
                                      IndexedGraph, IndexedSchedule,
                                      ScheduleValidationError,
                                      TiledTaskGraph, levels_from_array,
                                      pack_graph, synthesize_indexed)
    from repro_torch.core.edt.device import (upload, wavefront_step,
                                             wavefront_step_torch)
    from repro_torch.core.poly import Tiling
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels import build
    from repro_torch.kernels.stencils import (SPECS, default_state,
                                              handwritten_solve,
                                              reference_solve)

    dev = torch.device("cuda")
    # ---------------------------------------------------------- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    lib_path = build.compile_library("wavefront_step")
    build.load("wavefront_step")
    log(f"phase 2 build: {lib_path.name} in "
        f"{time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------------- host graph
    name, tiles, params = SLICE
    t0 = time.perf_counter()
    graph = TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                           backend="numpy")
    ig, sched = synthesize_indexed(graph, params)
    dg = pack_graph(ig)
    t_graph = time.perf_counter() - t0
    log(f"host graph {name} tiles {tiles} {params}: n={ig.n} "
        f"E={ig.n_edges} depth={sched.depth} width={sched.max_width} "
        f"in {t_graph:.3f} s")
    if (sched.depth, sched.max_width) != (SLICE_DEPTH, SLICE_WIDTH):
        raise AssertionError(f"host schedule depth/width "
                             f"{sched.depth}/{sched.max_width}, want "
                             f"{SLICE_DEPTH}/{SLICE_WIDTH}")

    # ---------------------------------- 3. kernel == plain version, on card
    dec_src, dec_ptr = upload(dg.dec_src, dev), upload(dg.dec_ptr, dev)

    def check_step(indeg, frontier, src, ptr, what):
        k = wavefront_step(indeg, frontier, src, ptr)
        p = wavefront_step_torch(indeg, frontier, src, ptr)
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError(f"kernel != plain version on {what}")
        return p, int((k[0] - p[0]).abs().max()) if k[0].numel() else 0

    indeg = upload(dg.pred_n, dev)
    frontier = indeg == 0
    steps, max_err, widest = 0, 0, (0, None)
    while bool(frontier.any()):
        w = int(frontier.sum())
        if w > widest[0]:
            widest = (w, (indeg.clone(), frontier.clone()))
        (indeg, frontier), err = check_step(indeg, frontier, dec_src,
                                            dec_ptr, f"frontier {steps}")
        max_err = max(max_err, err)
        steps += 1
    if steps != sched.depth or bool((indeg != 0).any()):
        raise AssertionError(f"step sweep took {steps} steps, want "
                             f"{sched.depth}, or left counters undrained")
    # an empty frontier at slice size: nothing decrements, nothing readies
    pred = upload(dg.pred_n, dev)
    (ind, newly), _ = check_step(pred, torch.zeros_like(pred, dtype=torch.bool),
                                 dec_src, dec_ptr, "an empty frontier")
    if not torch.equal(ind, pred) or bool(newly.any()):
        raise AssertionError("a step on an empty frontier changed state")
    # an edgeless graph: no launch, indeg unchanged
    n0 = 1000
    edgeless = pack_graph(IndexedGraph(
        stmt_blocks=[("S", np.zeros((n0, 1), np.int64))], n=n0,
        edge_src=np.zeros(0, np.int64), edge_tgt=np.zeros(0, np.int64),
        pred_n=np.zeros(n0, np.int64)))
    e_pred = upload(edgeless.pred_n, dev)
    (ind, newly), _ = check_step(e_pred, e_pred == 0,
                                 upload(edgeless.dec_src, dev),
                                 upload(edgeless.dec_ptr, dev),
                                 "an edgeless graph")
    if not torch.equal(ind, e_pred) or bool(newly.any()):
        raise AssertionError("an edgeless step changed state")
    # a seeded random DAG with random frontiers
    rng = np.random.default_rng(20261017)
    rn, re_ = 50_000, 400_000
    a, b = rng.integers(0, rn, re_), rng.integers(0, rn, re_)
    keep = a != b
    src, tgt = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    rdg = pack_graph(IndexedGraph(
        stmt_blocks=[("S", np.zeros((rn, 1), np.int64))], n=rn,
        edge_src=src, edge_tgt=tgt, pred_n=np.bincount(tgt, minlength=rn)))
    r_src, r_ptr = upload(rdg.dec_src, dev), upload(rdg.dec_ptr, dev)
    r_pred = upload(rdg.pred_n, dev)
    for k in range(8):
        mask = torch.from_numpy(rng.random(rn) < 0.1 * (k + 1)).to(dev)
        _, err = check_step(r_pred, mask, r_src, r_ptr, f"random DAG {k}")
        max_err = max(max_err, err)
    log(f"phase 3 kernel == plain version: {steps} frontiers at n={ig.n} "
        f"E={ig.n_edges}, empty frontier, edgeless graph, 8 random-DAG "
        f"frontiers (n={rn} E={src.size}); max_abs_err {max_err}")

    # ----------------------------------------- main path: phases 4 to 6
    wavefront_step.launches = 0
    ex = DeviceExecutor(ig, device=dev)
    run, t_disc = timed(ex.run)
    disc_launches = wavefront_step.launches
    _, t_disc_warm = timed(ex.run)
    if run.mode != "discover" or not np.array_equal(run.level_of,
                                                    sched.level_of):
        raise AssertionError("discover level_of differs from the host "
                             "schedule")
    if len(run.levels) != sched.depth or any(
            not np.array_equal(x, y) for x, y in zip(run.levels,
                                                      sched.levels)):
        raise AssertionError("discover frontiers differ from the host "
                             "schedule")
    c = run.counters
    if (c.depth, c.max_in_flight, c.tasks_started) != (
            SLICE_DEPTH, SLICE_WIDTH, ig.n):
        raise AssertionError(f"discover counters {c.summary()}")
    if disc_launches != c.depth:
        raise AssertionError(f"{disc_launches} kernel launches for "
                             f"{c.depth} discover steps")
    log(f"phase 4 DeviceExecutor discover: depth {c.depth} width "
        f"{c.max_in_flight} level_of byte-identical; kernel launches "
        f"{disc_launches} == steps {c.depth}")

    rex = DeviceExecutor(ig, schedule=sched, device=dev)
    rrun, t_replay = timed(rex.run)
    _, t_replay_warm = timed(rex.run)
    rc = rrun.counters
    if (rrun.mode, rc.depth, rc.max_in_flight, rc.tasks_finished) != (
            "replay", SLICE_DEPTH, SLICE_WIDTH, ig.n):
        raise AssertionError(f"replay counters {rc.summary()}")
    lv = sched.level_of.copy()
    swapped = lv.copy()
    swapped[lv == 1], swapped[lv == 2] = 2, 1      # levels 1 and 2 swapped
    bad = IndexedSchedule(levels=levels_from_array(swapped), level_of=swapped)
    try:
        DeviceExecutor(ig, schedule=bad, device=dev).run()
    except ScheduleValidationError as e:
        refused = f"{e.kind} at level {e.level}, {e.task_ids.size} task(s)"
    else:
        raise AssertionError("a schedule with two levels swapped passed "
                             "validation")
    log(f"phase 5 DeviceExecutor replay: validated depth {rc.depth} width "
        f"{rc.max_in_flight}; swapped levels refused: {refused}")

    spec = SPECS[name]
    state = default_state(spec, params["N"], np.float32)
    fex = FusedExecutor(ig, params, body=name, tile=tiles, schedule=sched,
                        state=state, device=dev)
    frep, t_fused_replay = timed(fex.run)
    _, t_fused_replay_warm = timed(fex.run)
    fdex = FusedExecutor(ig, params, body=name, tile=tiles, state=state,
                         device=dev)
    before = wavefront_step.launches
    fdis, t_fused_disc = timed(fdex.run)
    fused_launches = wavefront_step.launches - before
    _, t_fused_disc_warm = timed(fdex.run)
    main_launches = wavefront_step.launches
    hand = handwritten_solve(spec, state, params["T"], device=dev)
    _, t_hand = timed(lambda: handwritten_solve(spec, state, params["T"],
                                                device=dev))
    ref = reference_solve(spec, state, params["T"])
    for label, r in (("replay", frep), ("discover", fdis)):
        got = r.final.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"fused {label}: bad final grid")
        np.testing.assert_allclose(got, hand.cpu().numpy(), **F32_TOL)
        np.testing.assert_allclose(got, ref, **F32_TOL)
        if not np.array_equal(r.level_of, sched.level_of):
            raise AssertionError(f"fused {label} frontiers differ")
    if fused_launches != fdis.counters.depth:
        raise AssertionError(f"{fused_launches} kernel launches for "
                             f"{fdis.counters.depth} fused discover steps")
    err_hand = float(np.abs(fdis.final.cpu().numpy()
                            - hand.cpu().numpy()).max())
    err_ref = float(np.abs(fdis.final.cpu().numpy() - ref).max())
    log(f"phase 6 FusedExecutor f32 replay+discover at n={ig.n}: final "
        f"within rtol 1e-4/atol 1e-5 of handwritten_solve (max abs "
        f"{err_hand:.3e}) and reference_solve (max abs {err_ref:.3e}); "
        f"fused discover kernel launches {fused_launches}")

    for cname, ctiles, cparams in CASES:
        cg = TiledTaskGraph(PROGRAMS[cname](), {"S": Tiling(ctiles)},
                            backend="numpy")
        cig, csched = synthesize_indexed(cg, cparams)
        cstate = default_state(SPECS[cname], cparams["N"], np.float64)
        want = reference_solve(SPECS[cname], cstate, cparams["T"])
        for sarg in (csched, None):
            got = FusedExecutor(cig, cparams, body=cname, tile=ctiles,
                                schedule=sarg, state=cstate,
                                device=dev).run().final
            np.testing.assert_allclose(got.cpu().numpy(), want, **F64_TOL)
    log(f"phase 6 FusedExecutor f64 replay+discover on {len(CASES)} "
        f"stencils within rtol 1e-12/atol 1e-13 of reference_solve")

    # ------------------------------------------------- 7. times, kernels
    w, (t_indeg, t_front) = widest
    step_ms = event_ms(lambda: wavefront_step(t_indeg, t_front, dec_src,
                                              dec_ptr))
    plain_ms = event_ms(lambda: wavefront_step_torch(t_indeg, t_front,
                                                     dec_src, dec_ptr))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    step_cold_ms = event_ms(lambda: wavefront_step(t_indeg, t_front, dec_src,
                                                   dec_ptr), flush=flush)
    del flush
    step_host_us = host_us(lambda: wavefront_step(t_indeg, t_front, dec_src,
                                                  dec_ptr))
    n, e = ig.n, ig.n_edges
    step_bytes = 4 * e + 4 * (n + 1) + 4 * n + n + 5 * n
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase times (s): host graph {t_graph:.3f}; discover "
        f"{t_disc:.3f} (warm {t_disc_warm:.3f}); replay {t_replay:.3f} "
        f"(warm {t_replay_warm:.3f}); fused replay {t_fused_replay:.3f} "
        f"(warm {t_fused_replay_warm:.3f}); fused discover "
        f"{t_fused_disc:.3f} (warm {t_fused_disc_warm:.3f}); "
        f"handwritten_solve {t_hand:.4f}")
    log(f"wavefront_step at the widest frontier ({w} tasks): kernel "
        f"{step_ms * 1e3:.2f} us (cold L2 {step_cold_ms * 1e3:.2f} us), "
        f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({step_bytes} bytes at 3.35 TB/s); wrapper host path "
        f"{step_host_us:.2f} us a call; on {card}")
    for label, fn in (("discover", ex.run), ("replay", rex.run),
                      ("fused replay", fex.run), ("fused discover", fdex.run)):
        wall, busy, count, top = device_profile(fn)
        log(f"profile {label}: wall {wall:.3f} s under the profiler, device "
            f"busy {busy:.4f} s ({100 * busy / wall:.1f}%) in {count} "
            f"kernels; top (name, ms): {top}")
    log(json.dumps({"kernels": [{
        "name": "wavefront_step", "route": "cuda",
        "source": "src/repro_torch/csrc/wavefront_step.cu",
        "replaces": "src/repro/core/edt/device.py:225",
        "launches": main_launches, "matched": True,
        "frontiers_checked": steps, "max_abs_err": max_err,
        "ms": step_ms, "ms_cold_l2": step_cold_ms, "plain_ms": plain_ms,
        "host_us": step_host_us,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
