#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths and checks every result.  The EDT path:
polyhedral program, index graph, wavefront schedule, counted-sync sweeps
on the card and fused stencil tiles, at the size of the reference's
acceptance runs (jacobi2d, tiles (2,2,2), T=32, N=512: 1,056,784 tasks).
The serving path: llama3.2-1b, rwkv6-1.6b and zamba2-7b (Mamba2 + shared
attention) at full width and depth, f32 weights drawn from a seed.

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the four CUDA kernels from ``src/repro_torch/csrc``, one
   ``nvcc`` each, all started together, and their times;
3. ``wavefront_step`` against its plain torch version on the card, byte
   for byte, on every frontier of a real discover sweep, on an edgeless
   graph, an empty frontier and a seeded random DAG;
4. ``DeviceExecutor`` discover: ``level_of`` byte-identical to the host
   schedule, and one kernel launch per level;
5. ``DeviceExecutor`` replay, and a corrupted schedule refused;
6. ``FusedExecutor`` replay and discover in float32 against the torch
   ``handwritten_solve`` and the NumPy ``reference_solve``, and in float64
   at small sizes;
7. EDT phase times, the wavefront kernel's times and a profile per sweep;
8. flash attention, WKV6 and SSD against their plain torch versions on
   the card, in f32 and bf16, at the reference's test shapes (SSD's
   state handoff too) and at the serving path's shapes;
9. llama3.2-1b: ``make_prefill_step`` at B=2, S=4096 through the flash
   kernel (one launch a layer) against the same step on the plain chunked
   attention; the serve loop (B=4, prompt 512, 32 tokens); incremental
   decode against the full forward;
10. rwkv6-1.6b: the serve loop at the same sizes (one WKV6 launch a layer
    in prefill); prefill logits and every layer's final state against the
    plain recurrence; incremental decode against the full forward;
11. kernel times (CUDA events, median, warm and with L2 flushed),
    plain-version times, the time of one PyTorch call computing the same
    function where there is one, the least time the card could take, and
    a ``kernels`` JSON line with each kernel's launches on its main path
    (counts set to 0 just before that path and read just after);
12. zamba2-7b (68 Mamba2 layers, one shared attention+MLP block applied
    13 times, 5,736,919,872 parameters): ``make_prefill_step`` at B=2,
    S=4096 through the SSD kernel (one launch a Mamba2 layer) against the
    same step on the plain chunked scan; the serve loop (B=4, prompt 512,
    32 tokens) with prefill logits and every layer's SSM state and conv
    cache against the plain route; teacher-forced decode against the full
    forward; and the 4,096-slot ring cache (B=1, a prompt of exactly the
    window, 32 tokens, decode wrapping from its first step) against the
    full windowed forward.  Phase 12 runs before phase 11.

Every failed check raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
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
F32_FLOP_PER_S = 67e12                  # H100 SXM f32 outside tensor cores
REPS, INNER = 25, 20                    # timing: medians of 25 x 20 launches
SLEEP_CYCLES = 20_000_000               # ~10 ms of device sleep, a head start
KERNELS = ("wavefront_step", "flash_attention", "wkv6", "ssd")

# ------------------------------------------------------- the serving path
LLAMA, RWKV, ZAMBA = "llama3.2-1b", "rwkv6-1.6b", "zamba2-7b"
ZAMBA_PARAMS = 5_736_919_872
ZAMBA_LAYERS = (68, 13)                 # Mamba2 layers, attention uses
RING_B = 1                              # ring cache: prompt = the window
PREFILL_B, PREFILL_S = 2, 4096          # make_prefill_step, flash on path
SERVE_B, SERVE_LP, SERVE_G = 4, 512, 32  # the serve loop
#: flash cases (B, H, Hkv, Sq, Skv, D, causal): tests/test_kernels.py's
#: shapes, then llama3.2-1b's prefill layer and a non-causal Sq != Skv
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True), (2, 4, 2, 256, 256, 64, True),
    (1, 3, 1, 384, 384, 128, True), (1, 2, 2, 128, 256, 64, False),
    (2, 32, 8, 4096, 4096, 64, True), (2, 32, 8, 512, 2048, 64, False),
]
FLASH_PATH = FLASH_CASES[4]
#: wkv6 cases (B, S, H, D, with init_state): tests/test_kernels.py's
#: shapes, then rwkv6-1.6b's serve prefill with and without a state
WKV_CASES = [
    (1, 32, 1, 8, False), (2, 64, 2, 16, False), (1, 128, 2, 64, False),
    (4, 512, 32, 64, False), (4, 512, 32, 64, True),
]
WKV_PATH = WKV_CASES[4]
#: ssd cases (B, S, H, P, N, chunk, with init_state): tests/test_kernels.py's
#: shapes, then zamba2-7b's serve prefill with and without a state and its
#: make_prefill_step (the handoff case of tests/test_kernels.py is SSD_HANDOFF)
SSD_CASES = [
    (1, 32, 1, 16, 8, 8, False), (2, 64, 2, 32, 16, 16, False),
    (1, 128, 4, 64, 64, 32, False),
    (4, 512, 112, 64, 64, 256, True), (4, 512, 112, 64, 64, 256, False),
    (2, 4096, 112, 64, 64, 256, False),
]
SSD_PATH, SSD_PREFILL = SSD_CASES[3], SSD_CASES[5]
SSD_HANDOFF = (1, 64, 2, 16, 8, 16)
#: Kernel vs plain version, both computing in f32 from the same inputs:
#: f32 outputs differ only in summation order (the reference's TOL in
#: tests/test_kernels.py, 2e-4).  bf16 outputs are one rounding of those
#: f32 values, so they differ by at most one bf16 ulp, at most 2^-7 =
#: 7.8e-3 of the value: rtol 8e-3, and atol 1e-3 for outputs near zero.
#: The reference's bf16 TOL of 2e-2 is as large as a typical output of a
#: long causal row (about 0.03 at S=4096) and stays with the CPU tests
#: against the Pallas interpreter.  SSD's kernel walks time in chunks of
#: SSD_KERNEL_CHUNK whatever the caller's chunk, so it is held at
#: KERNEL_TOL against its plain version run with that chunk (the same
#: order of sums).  Against the plain version at the caller's chunk (256
#: on the path: another order, over terms of up to about 100 whose sum
#: may be near 0) the path case is held to the reference's f32 SSD
#: tolerance (tests/test_kernels.py:106-107), SSD_CHUNK_TOL.  WKV6's and
#: SSD's final states are f32 arithmetic on the same (widened) inputs in
#: both dtypes: the reference's f32 1e-3.
KERNEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
              "bfloat16": dict(rtol=8e-3, atol=1e-3)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
SSD_KERNEL_CHUNK = 64
SSD_CHUNK_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
                 "bfloat16": KERNEL_TOL["bfloat16"]}
#: Two f32 routes of one full-width model (kernel vs plain attention or
#: recurrence, prefill-with-cache plus decode vs one full forward): the
#: same arithmetic summed in other orders through 16-81 layers.  The
#: reference's own tolerance for two routes of one model
#: (tests/test_arch_smoke.py:72-74).
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, flush=None, reps: int = REPS, inner: int = INNER) -> float:
    """Device time of one call: median over ``reps`` of ``inner``-call means.

    A device-side sleep is queued first, so the host has enqueued every
    call before the card reaches the start event, and the events time the
    card alone, not the host's launch path.  With ``flush`` (a tensor
    larger than L2), every call is preceded by a write of it, outside its
    own pair of events, so the call finds a cold L2."""
    import torch

    samples = []
    for _ in range(reps + 2):
        torch.cuda._sleep(SLEEP_CYCLES)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 * inner if flush is not None else 2)]
        if flush is None:
            ev[0].record()
            for _ in range(inner):
                fn()
            ev[1].record()
        else:
            for i in range(inner):
                flush.add_(1)
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        torch.cuda.synchronize()
        samples.append(sum(ev[i].elapsed_time(ev[i + 1])
                           for i in range(0, len(ev), 2)) / inner)
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


def edt_path(dev, card) -> dict:
    """Phases 3 to 7, the EDT path.  Returns the wavefront kernel's record
    (its launches counted over phases 4 to 6)."""
    import torch

    from repro_torch.core.edt import (DeviceExecutor, FusedExecutor,
                                      IndexedGraph, IndexedSchedule,
                                      ScheduleValidationError,
                                      TiledTaskGraph, levels_from_array,
                                      pack_graph, synthesize_indexed)
    from repro_torch.core.edt.device import (upload, wavefront_step,
                                             wavefront_step_torch)
    from repro_torch.core.poly import Tiling
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.stencils import (SPECS, default_state,
                                              handwritten_solve,
                                              reference_solve)

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
    return {
        "name": "wavefront_step", "route": "cuda",
        "source": "src/repro_torch/csrc/wavefront_step.cu",
        "replaces": "src/repro/core/edt/device.py:225",
        "launches": main_launches, "matched": True,
        "frontiers_checked": steps, "max_abs_err": max_err,
        "ms": step_ms, "ms_cold_l2": step_cold_ms, "plain_ms": plain_ms,
        "host_us": step_host_us,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }


def check_kernels(dev) -> dict:
    """Phase 8: the three serving kernels against their plain versions on
    the card.  Returns the max abs error at each kernel's path shape
    (f32)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_hm,
                                                     flash_attention_hm_torch)
    from repro_torch.kernels.ssd import ssd, ssd_torch
    from repro_torch.kernels.wkv6 import wkv6, wkv6_torch

    gen = torch.Generator(dev).manual_seed(20261017)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(got, want, tol, what):
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"{what}: {m}")
        return err

    path_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        errs = []
        for case in FLASH_CASES:
            B, H, Hkv, Sq, Skv, D, causal = case
            q = randn(B, H, Sq, D, dtype=dtype)
            k, v = (randn(B, Hkv, Skv, D, dtype=dtype) for _ in range(2))
            got = flash_attention_hm(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = flash_attention_hm_torch(q, k, v, causal=causal)
            err = compare(got, want, KERNEL_TOL[tname], f"flash {tname} {case}")
            errs.append(err)
            if case == FLASH_PATH and dtype == torch.float32:
                path_err["flash_attention_hm"] = err
        log(f"phase 8 flash_attention {tname} == plain version at "
            f"{len(FLASH_CASES)} shapes (B,H,Hkv,Sq,Skv,D,causal) "
            f"{FLASH_CASES}: max abs err {[f'{e:.3e}' for e in errs]} "
            f"(tol {KERNEL_TOL[tname]})")
        errs, st_errs = [], []
        # bf16 streams also with an f32 decay, as the RWKV6 layer makes it
        wdtypes = (dtype,) if dtype == torch.float32 else (dtype, torch.float32)
        for case in WKV_CASES:
            B, S, H, D, with_state = case
            for wdtype in wdtypes:
                r, k, v = (randn(B, S, H, D, dtype=dtype) for _ in range(3))
                w = torch.sigmoid(randn(B, S, H, D) - 1.0).to(wdtype)
                u = 0.1 * randn(H, D)
                s0 = randn(B, H, D, D) if with_state else None
                out, st = wkv6(r, k, v, w, u, s0)
                torch.cuda.synchronize()
                want, want_st = wkv6_torch(r, k, v, w, u, s0)
                what = f"wkv6 {tname} w {wdtype} {case}"
                err = compare(out, want, KERNEL_TOL[tname], what)
                st_errs.append(compare(st, want_st, STATE_TOL,
                                       what + " state"))
                errs.append(err)
                if case == WKV_PATH and dtype == torch.float32:
                    path_err["wkv6"] = err
        log(f"phase 8 wkv6 {tname} == plain version at {len(WKV_CASES)} "
            f"shapes (B,S,H,D,init_state) {WKV_CASES}"
            f"{' (w bf16 and f32)' if len(wdtypes) > 1 else ''}: max abs "
            f"err {[f'{e:.3e}' for e in errs]} (tol {KERNEL_TOL[tname]}), "
            f"state {[f'{e:.3e}' for e in st_errs]} (tol {STATE_TOL})")

        def ssd_inputs(B, S, H, P, N, with_state, dt_scale=0.5):
            x = randn(B, S, H, P, dtype=dtype)
            dt = F.softplus(randn(B, S, H)) * dt_scale
            A = -torch.exp(0.2 * randn(H))
            bm, cm = (randn(B, S, N, dtype=dtype) for _ in range(2))
            return x, dt, A, bm, cm, randn(B, H, P, N) if with_state else None

        def plain(*args):
            """The plain version in the kernel's own chunk of 64: the same
            order of sums, so held at KERNEL_TOL."""
            return ssd_torch(*args,
                             chunk=min(SSD_KERNEL_CHUNK, args[0].shape[1]))

        errs, st_errs = [], []
        for case in SSD_CASES:
            *shape, chunk, with_state = case
            args = ssd_inputs(*shape, with_state)
            y, st = ssd(*args, chunk=chunk)
            torch.cuda.synchronize()
            want, want_st = plain(*args)
            what = f"ssd {tname} {case}"
            err = compare(y, want, KERNEL_TOL[tname], what)
            st_errs.append(compare(st, want_st, STATE_TOL, what + " state"))
            errs.append(err)
            if case == SSD_PATH:
                # the reference's chunk rule: the caller's chunk of 256
                want, want_st = ssd_torch(*args, chunk=chunk)
                chunk_err = compare(y, want, SSD_CHUNK_TOL[tname],
                                    what + f" vs plain chunk {chunk}")
                compare(st, want_st, STATE_TOL,
                        what + f" state vs plain chunk {chunk}")
                if dtype == torch.float32:
                    path_err["ssd"] = err
            del args, y, st, want, want_st
        # tests/test_kernels.py's handoff: two halves with the carried
        # state, each against the plain version, and together == the whole
        B, S, H, P, N, chunk = SSD_HANDOFF
        x, dt, A, bm, cm, _ = ssd_inputs(B, S, H, P, N, False)
        full, _ = ssd(x, dt, A, bm, cm, chunk=chunk)
        h = S // 2
        y1, st1 = ssd(x[:, :h].contiguous(), dt[:, :h].contiguous(), A,
                      bm[:, :h].contiguous(), cm[:, :h].contiguous(),
                      chunk=chunk)
        tail = [t[:, h:].contiguous() for t in (x, dt, bm, cm)]
        y2, _ = ssd(tail[0], tail[1], A, tail[2], tail[3], st1, chunk=chunk)
        torch.cuda.synchronize()
        want2, _ = plain(tail[0], tail[1], A, tail[2], tail[3], st1)
        compare(y2, want2, KERNEL_TOL[tname], f"ssd {tname} handoff half")
        hand_err = compare(torch.cat([y1, y2], 1), full, KERNEL_TOL[tname],
                           f"ssd {tname} handoff vs whole")
        # dt·|A| of about 28 a step: exp overflows above the diagonal, and
        # cum reaches about -1,800 in a chunk of 64, where an f32 ulp is
        # 1.2e-4: each exp(cum[t] - cum[s]) then differs by that much
        # between the kernel's warp scan and the plain cumsum, on terms of
        # up to about 30 that may sum to near 0.  So the error is held to
        # the tolerance times the output's largest magnitude, not each
        # element's.
        args = ssd_inputs(1, 256, 2, 64, 64, False, dt_scale=40.0)
        y, _ = ssd(*args, chunk=256)
        torch.cuda.synchronize()
        want = plain(*args)[0].float()
        big_err = float((y.float() - want).abs().max())
        scale = float(want.abs().max())
        if not bool(torch.isfinite(y).all()) or not (
                big_err <= KERNEL_TOL[tname]["rtol"] * scale):
            raise AssertionError(f"ssd {tname} large dt: max abs err "
                                 f"{big_err} at outputs up to {scale}")
        log(f"phase 8 ssd {tname} == plain version in chunks of "
            f"{SSD_KERNEL_CHUNK} at {len(SSD_CASES)} shapes "
            f"(B,S,H,P,N,chunk,init_state) {SSD_CASES}: max abs err "
            f"{[f'{e:.3e}' for e in errs]} (tol {KERNEL_TOL[tname]}), state "
            f"{[f'{e:.3e}' for e in st_errs]} (tol {STATE_TOL}); {SSD_PATH} "
            f"vs plain chunk {SSD_PATH[5]}: {chunk_err:.3e} (tol "
            f"{SSD_CHUNK_TOL[tname]}); handoff {SSD_HANDOFF}: halves vs whole "
            f"{hand_err:.3e}; dt x40 (1,256,2,64,64): finite, max abs err "
            f"{big_err:.3e} at |y| up to {scale:.1f} (tol "
            f"{KERNEL_TOL[tname]['rtol']} x that)")
    return path_err


@contextlib.contextmanager
def plain_refused(module, name: str):
    """``module.name`` (a kernel's plain version) raises while inside: a
    main path on CUDA tensors must launch the kernel, never fall back."""
    saved = getattr(module, name)

    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} was reached on a CUDA main path")

    setattr(module, name, refuse)
    try:
        yield
    finally:
        setattr(module, name, saved)


def decode_profile(model, params, prompts, label: str) -> None:
    """One decode step after a prefill, under the profiler."""
    import torch

    caches = model.init_cache(SERVE_B, SERVE_LP + SERVE_G + 1, torch.float32,
                              prompts.device)
    logits, caches = model.forward(params, prompts, caches=caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    model.decode_step(params, tok, caches, SERVE_LP)          # warm
    wall, busy, count, top = device_profile(
        lambda: model.decode_step(params, tok, caches, SERVE_LP))
    log(f"profile {label} decode step (B={SERVE_B}, cache "
        f"{SERVE_LP + SERVE_G + 1}): wall {wall * 1e3:.2f} ms under the "
        f"profiler, device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")


def free_model(label: str) -> None:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated()} "
        f"bytes ({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def teacher_forced(model_xla, params, prompts, res, label: str) -> float:
    """Incremental decode (the serve loop's per-step logits) against one
    full forward over the prompt and the generated tokens."""
    import torch

    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    full, _ = model_xla.forward(params, seq)
    want = full[:, prompts.shape[1] - 1:]
    del full
    got = torch.stack(res.logits, dim=1)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: decode logits {tuple(got.shape)}, "
                             f"want {tuple(want.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"{label} teacher-forced: {m}")
    return err


def serve_line(label: str, res, t_first: float, B: int = 0,
               Lp: int = 0) -> str:
    B, Lp = B or SERVE_B, Lp or SERVE_LP
    return (f"{label} serve B={B} prompt {Lp} gen {SERVE_G}: "
            f"prefill {res.prefill_s * 1e3:.2f} ms (first run "
            f"{t_first * 1e3:.2f} ms), {B * Lp / res.prefill_s:.0f}"
            f" prompt tok/s; decode {res.decode_s_per_step * 1e3:.3f} "
            f"ms/step, {B / res.decode_s_per_step:.1f} tok/s")


def llama_path(dev) -> int:
    """Phase 9: llama3.2-1b at full width.  Returns the flash launches of
    one ``make_prefill_step`` call (counts set to 0 just before it)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = get_config(LLAMA)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    gen = torch.Generator(dev).manual_seed(0)
    params = build_model(cfg_cuda).init(gen, torch.float32, dev)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), device=dev,
                           generator=gen)
    step_cuda = make_prefill_step(build_model(cfg_cuda))
    step_xla = make_prefill_step(build_model(cfg_xla))

    flash_attention_hm.launches = 0
    with plain_refused(fa_mod, "flash_attention_hm_torch"):
        got, t_cuda = timed(lambda: step_cuda(params, {"tokens": tokens}))
    launches = flash_attention_hm.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches in a prefill step "
                             f"of {cfg.n_layers} layers")
    want, t_xla = timed(lambda: step_xla(params, {"tokens": tokens}))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"llama prefill cuda vs xla: {m}")
    _, t_cuda_warm = timed(lambda: step_cuda(params, {"tokens": tokens}))
    _, t_xla_warm = timed(lambda: step_xla(params, {"tokens": tokens}))
    del got, want
    wall, busy, count, top = device_profile(
        lambda: step_cuda(params, {"tokens": tokens}))
    log(f"profile {LLAMA} make_prefill_step cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    log(f"phase 9 {LLAMA} ({cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, f32) make_prefill_step B={PREFILL_B} S={PREFILL_S}: "
        f"{launches} flash launches; last-position logits cuda vs xla max "
        f"abs {err:.3e} (tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} ms "
        f"cuda, {t_xla_warm * 1e3:.1f} ms xla (first runs "
        f"{t_cuda * 1e3:.1f} / {t_xla * 1e3:.1f} ms)")

    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts)
    res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                prompts=prompts)
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")
    tf_err = teacher_forced(build_model(cfg_xla), params, prompts, res, LLAMA)
    log(f"phase 9 {serve_line(LLAMA, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward max abs {tf_err:.3e} (tol {MODEL_TOL}); "
        f"sample ids {res.tokens[0, :8].tolist()}")
    decode_profile(build_model(cfg_cuda), params, prompts, LLAMA)
    del params, first, res
    free_model(f"phase 9 {LLAMA}")
    return launches


def rwkv_path(dev) -> int:
    """Phase 10: rwkv6-1.6b at full width.  Returns the WKV6 launches of
    one serve run (counts set to 0 just before it)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as wkv6_mod
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(RWKV)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    gen = torch.Generator(dev).manual_seed(0)
    params = m_cuda.init(gen, torch.float32, dev)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts)
    wkv6.launches = 0
    with plain_refused(wkv6_mod, "wkv6_torch"):
        res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                    prompts=prompts)
    launches = wkv6.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} wkv6 launches in a serve run of "
                             f"{cfg.n_layers} layers")
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")

    def prefill(model):
        caches = model.init_cache(SERVE_B, SERVE_LP + SERVE_G + 1,
                                  torch.float32, dev)
        return timed(lambda: model.forward(params, prompts, caches=caches))

    (lg_c, c_c), t_c = prefill(m_cuda)
    (lg_x, c_x), t_x = prefill(m_xla)
    err = float((lg_c - lg_x).abs().max())
    torch.testing.assert_close(lg_c, lg_x, **MODEL_TOL,
                               msg=lambda m: f"rwkv prefill cuda vs xla: {m}")
    st_err = 0.0
    for i in range(cfg.n_layers):
        a, b = c_c["tm"]["wkv"][i], c_x["tm"]["wkv"][i]
        st_err = max(st_err, float((a - b).abs().max()))
        torch.testing.assert_close(
            a, b, **STATE_TOL,
            msg=lambda m, i=i: f"rwkv layer {i} wkv state: {m}")
    del lg_c, lg_x, c_c, c_x
    tf_err = teacher_forced(m_xla, params, prompts, res, RWKV)
    log(f"phase 10 {RWKV} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv.head_dim} heads of {cfg.rwkv.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, f32): {launches} wkv6 "
        f"launches in a serve run; prefill logits cuda vs xla max abs "
        f"{err:.3e} (tol {MODEL_TOL}), all {cfg.n_layers} final wkv states "
        f"max abs {st_err:.3e} (tol {STATE_TOL}); prefill with "
        f"cache {t_c * 1e3:.1f} ms cuda, {t_x * 1e3:.1f} ms xla")
    log(f"phase 10 {serve_line(RWKV, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward max abs {tf_err:.3e} (tol {MODEL_TOL}); "
        f"sample ids {res.tokens[0, :8].tolist()}")
    wall, busy, count, top = device_profile(lambda: prefill(m_cuda))
    log(f"profile {RWKV} prefill with cache, cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    decode_profile(m_cuda, params, prompts, RWKV)
    del params, first, res
    free_model(f"phase 10 {RWKV}")
    return launches


def zamba_path(dev) -> dict:
    """Phase 12: zamba2-7b at full width and depth.  Returns the SSD
    launches of one ``make_prefill_step`` call and of one serve run
    (counts set to 0 just before each)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, hybrid

    cfg = get_config(ZAMBA)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    n_ssm, n_attn = hybrid._n_ssm(cfg), hybrid._n_attn(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    params, t_init = timed(lambda: m_cuda.init(gen, torch.float32, dev))

    def leaves(t):
        for v in t.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    n_params = sum(t.numel() for t in leaves(params))
    if n_params != ZAMBA_PARAMS or (n_ssm, n_attn) != ZAMBA_LAYERS:
        raise AssertionError(f"{ZAMBA}: {n_params} parameters, {n_ssm} "
                             f"Mamba2 layers, {n_attn} attention "
                             f"applications")
    log(f"phase 12 {ZAMBA}: {n_params} f32 parameters "
        f"({4 * n_params / 1e9:.2f} GB) drawn in {t_init:.2f} s; {n_ssm} "
        f"Mamba2 layers (d {cfg.d_model}, {2 * cfg.d_model // cfg.ssm.head_dim}"
        f" SSD heads of {cfg.ssm.head_dim}, state {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk}), shared attention ({cfg.n_heads} heads of "
        f"{cfg.hd()}, window {cfg.sliding_window}) + MLP (d_ff {cfg.d_ff}) "
        f"applied {n_attn} times, vocab {cfg.vocab}")

    # ------------------------------------------ make_prefill_step B=2 S=4096
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), device=dev,
                           generator=gen)
    step_cuda = make_prefill_step(m_cuda)
    step_xla = make_prefill_step(m_xla)
    ssd.launches = 0
    with plain_refused(ssd_mod, "ssd_torch"):
        got, t_cuda = timed(lambda: step_cuda(params, {"tokens": tokens}))
    step_launches = ssd.launches
    if step_launches != n_ssm:
        raise AssertionError(f"{step_launches} ssd launches in a prefill "
                             f"step of {n_ssm} Mamba2 layers")
    want, t_xla = timed(lambda: step_xla(params, {"tokens": tokens}))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"zamba prefill cuda vs xla: {m}")
    del got, want
    _, t_cuda_warm = timed(lambda: step_cuda(params, {"tokens": tokens}))
    _, t_xla_warm = timed(lambda: step_xla(params, {"tokens": tokens}))
    wall, busy, count, top = device_profile(
        lambda: step_cuda(params, {"tokens": tokens}))
    log(f"profile {ZAMBA} make_prefill_step cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    log(f"phase 12 {ZAMBA} make_prefill_step B={PREFILL_B} S={PREFILL_S}: "
        f"{step_launches} ssd launches; last-position logits cuda vs xla max "
        f"abs {err:.3e} (tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} ms "
        f"cuda, {t_xla_warm * 1e3:.1f} ms xla (first runs "
        f"{t_cuda * 1e3:.1f} / {t_xla * 1e3:.1f} ms), "
        f"{PREFILL_B * PREFILL_S / t_cuda_warm:.0f} tok/s")
    del tokens
    free_model(f"phase 12 {ZAMBA} prefill step")

    # ------------------------------------ serve B=4, prompt 512, 32 tokens
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts)
    ssd.launches = 0
    with plain_refused(ssd_mod, "ssd_torch"):
        res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                    prompts=prompts)
    serve_launches = ssd.launches
    if serve_launches != n_ssm:
        raise AssertionError(f"{serve_launches} ssd launches in a serve run "
                             f"of {n_ssm} Mamba2 layers")
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")

    def prefill(model):
        caches = model.init_cache(SERVE_B, SERVE_LP + SERVE_G + 1,
                                  torch.float32, dev)
        if "pos" in caches["attn"]:
            raise AssertionError("a serve cache below the window is a ring")
        return timed(lambda: model.forward(params, prompts, caches=caches))

    (lg_c, c_c), t_c = prefill(m_cuda)
    (lg_x, c_x), t_x = prefill(m_xla)
    err = float((lg_c - lg_x).abs().max())
    torch.testing.assert_close(lg_c, lg_x, **MODEL_TOL,
                               msg=lambda m: f"zamba prefill cuda vs xla: {m}")
    st_err = conv_err = 0.0
    for i in range(n_ssm):
        a, b = c_c["ssm"]["ssm"][i], c_x["ssm"]["ssm"][i]
        st_err = max(st_err, float((a - b).abs().max()))
        torch.testing.assert_close(
            a, b, **STATE_TOL,
            msg=lambda m, i=i: f"zamba layer {i} ssm state: {m}")
        a, b = c_c["ssm"]["conv"][i], c_x["ssm"]["conv"][i]
        conv_err = max(conv_err, float((a - b).abs().max()))
        torch.testing.assert_close(
            a, b, **MODEL_TOL,
            msg=lambda m, i=i: f"zamba layer {i} conv cache: {m}")
    del lg_c, lg_x, c_c, c_x
    tf_err = teacher_forced(m_xla, params, prompts, res, ZAMBA)
    log(f"phase 12 {ZAMBA}: {serve_launches} ssd launches in a serve run; "
        f"prefill logits cuda vs xla max abs {err:.3e} (tol {MODEL_TOL}), "
        f"all {n_ssm} final ssm states max abs {st_err:.3e} (tol "
        f"{STATE_TOL}), conv caches {conv_err:.3e}; prefill with cache "
        f"{t_c * 1e3:.1f} ms cuda, {t_x * 1e3:.1f} ms xla")
    log(f"phase 12 {serve_line(ZAMBA, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward ({SERVE_LP + SERVE_G - 1} tokens, dt=0 "
        f"padding) max abs {tf_err:.3e} (tol {MODEL_TOL}); sample ids "
        f"{res.tokens[0, :8].tolist()}")
    decode_profile(m_cuda, params, prompts, ZAMBA)
    del first, res, prompts
    free_model(f"phase 12 {ZAMBA} serve")

    # ---------------- the ring cache: B=1, a prompt of exactly the window
    W = cfg.sliding_window
    ring = m_cuda.init_cache(RING_B, W + SERVE_G + 1, torch.float32, dev)
    if "pos" not in ring["attn"] or tuple(
            ring["attn"]["k"].shape[:3]) != (n_attn, RING_B, W):
        raise AssertionError(f"cache of {W + SERVE_G + 1} slots is not a "
                             f"{W}-slot ring: {ring['attn']['k'].shape}")
    del ring
    prompts = torch.randint(0, cfg.vocab, (RING_B, W), device=dev,
                            generator=gen)
    ring_res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                     prompts=prompts)
    tf_ring = teacher_forced(m_xla, params, prompts, ring_res,
                             f"{ZAMBA} ring")
    log(f"phase 12 {serve_line(ZAMBA + ' ring', ring_res, ring_res.prefill_s, RING_B, W)}"
        f"; {n_attn} ring caches of {W} slots, decode wrapping from its "
        f"first step; teacher-forced decode vs full windowed forward "
        f"({W + SERVE_G - 1} tokens) max abs {tf_ring:.3e} (tol "
        f"{MODEL_TOL}), all logits finite")
    del params, ring_res, prompts
    free_model(f"phase 12 {ZAMBA}")
    return {"prefill_step": step_launches, "serve": serve_launches}


def serving_kernel_records(dev, launches: dict, path_err: dict) -> list:
    """Phase 11: times and bounds of the two serving kernels at their path
    shapes, in f32 as the serving path runs them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_hm,
                                                     flash_attention_hm_torch)
    from repro_torch.kernels.wkv6 import wkv6, wkv6_torch

    gen = torch.Generator(dev).manual_seed(7)
    B, H, Hkv, S, _, D, _ = FLASH_PATH
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev)
            for _ in range(2))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    fa = {
        "ms": event_ms(lambda: flash_attention_hm(q, k, v), reps=7, inner=5),
        "ms_cold_l2": event_ms(lambda: flash_attention_hm(q, k, v),
                               flush=flush, reps=7, inner=5),
        "plain_ms": event_ms(lambda: flash_attention_hm_torch(q, k, v),
                             reps=5, inner=2),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=7, inner=5),
    }
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    fa["ms_bf16"] = event_ms(lambda: flash_attention_hm(qb, kb, vb), reps=7,
                             inner=5)
    fa["library_ms_bf16"] = event_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, enable_gqa=True), reps=7, inner=5)
    fa_q, fa_kv = q.shape, k.shape
    del q, k, v, qb, kb, vb
    flops = 4 * B * H * D * S * (S + 1) // 2           # causal QK^T and PV
    nbytes = 4 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    fa_bound = (flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

    B, S, H, D, _ = WKV_PATH
    r, kk, vv = (torch.randn((B, S, H, D), generator=gen, device=dev)
                 for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, D), generator=gen, device=dev))
    u = 0.1 * torch.randn((H, D), generator=gen, device=dev)
    s0 = torch.zeros((B, H, D, D), device=dev)   # a fresh serve cache's
    wk = {
        "ms": event_ms(lambda: wkv6(r, kk, vv, w, u, s0), reps=15, inner=10),
        "ms_cold_l2": event_ms(lambda: wkv6(r, kk, vv, w, u, s0),
                               flush=flush, reps=15, inner=10),
        "plain_ms": event_ms(lambda: wkv6_torch(r, kk, vv, w, u, s0),
                             reps=5, inner=2),
        "library_ms": None,
    }
    del flush
    # r . S, k v and the decay a (step, d, e); r u k summed and v * bonus
    # added a (step, d)
    wops = 5 * B * S * H * D * (D + 1)
    wbytes = 4 * (5 * B * S * H * D + H * D + 2 * B * H * D * D)
    wk_bound = (wops / F32_FLOP_PER_S, wbytes / HBM_BYTES_PER_S)

    recs = []
    for name, src, ref, t, (ops_s, bytes_s), extra in (
            ("flash_attention_hm", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:76", fa, fa_bound,
             {"shape": f"q {list(fa_q)} k/v {list(fa_kv)} f32 causal",
              "flops": flops, "bytes": nbytes}),
            ("wkv6", "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/wkv6.py:62", wk, wk_bound,
             {"shape": f"r/k/v/w {list(r.shape)} f32, init_state "
                       f"{list(s0.shape)}", "flops": wops, "bytes": wbytes})):
        recs.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            "launches": launches[name], "matched": True,
            "max_abs_err": path_err[name],
            **t, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            **extra})
        log(f"phase 11 {name} ({extra['shape']}): kernel {t['ms']:.4f} ms "
            f"(cold L2 {t['ms_cold_l2']:.4f} ms), plain {t['plain_ms']:.4f} "
            f"ms, library {t['library_ms']}, bound "
            f"{max(ops_s, bytes_s) * 1e3:.4f} ms ({extra['flops']} flop at "
            f"67 TFLOP/s: {ops_s * 1e3:.4f} ms; {extra['bytes']} bytes at "
            f"3.35 TB/s: {bytes_s * 1e3:.4f} ms)")
    log(f"phase 11 flash bf16: kernel {fa['ms_bf16']:.4f} ms, "
        f"scaled_dot_product_attention bf16 {fa['library_ms_bf16']:.4f} ms")
    return recs


def ssd_least_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """The least f32 operations SSD needs: the chunked form at its best
    chunk L.  A (step, head) costs 2 P N for C . state and 2 P N for the
    state update, P N / L for decaying the state once a chunk, and for
    each of its (L + 1) / 2 pairs at or below the diagonal 2 P for M x,
    2 for the decay and dt, and 2 N for C . B, which all H heads share."""
    per = min(4 * P * N + P * N / L + (L + 1) * (P + 1 + N / H)
              for L in range(1, S + 1))
    return round(B * S * H * per)


def ssd_record(dev, launches: dict, path_err: dict) -> dict:
    """Phase 11 for SSD: times and bounds at the serve prefill's shape
    (with the fresh cache's zero state, as a serve run passes it) and at
    ``make_prefill_step``'s (no state), in f32 as the path runs them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd, ssd_torch

    gen = torch.Generator(dev).manual_seed(8)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    out = {}
    for key, case in (("serve", SSD_PATH), ("prefill_step", SSD_PREFILL)):
        B, S, H, P, N, chunk, with_state = case
        x = torch.randn((B, S, H, P), generator=gen, device=dev)
        dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
        A = -torch.ones(H, device=dev)      # zamba2's A_log init is 0
        bm, cm = (torch.randn((B, S, N), generator=gen, device=dev)
                  for _ in range(2))
        s0 = torch.zeros((B, H, P, N), device=dev) if with_state else None
        args = (x, dt, A, bm, cm, s0)
        t = {
            "ms": event_ms(lambda: ssd(*args, chunk=chunk), reps=15,
                           inner=10),
            "ms_cold_l2": event_ms(lambda: ssd(*args, chunk=chunk),
                                   flush=flush, reps=15, inner=10),
            "plain_ms": event_ms(lambda: ssd_torch(*args, chunk=chunk),
                                 reps=5, inner=2),
        }
        flops = ssd_least_flops(B, S, H, P, N)
        nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
                      + (2 if with_state else 1) * B * H * P * N)
        ops_s, bytes_s = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        t.update({
            "launches": launches[key], "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "shape": f"x {[B, S, H, P]} Bm/Cm {[B, S, N]} f32, chunk "
                     f"{chunk}, init_state {with_state}",
            "flops": flops, "bytes": nbytes})
        out[key] = t
        log(f"phase 11 ssd ({t['shape']}): kernel {t['ms']:.4f} ms (cold L2 "
            f"{t['ms_cold_l2']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"library None, bound {t['bound_ms']:.4f} ms ({flops} flop at "
            f"67 TFLOP/s: {ops_s * 1e3:.4f} ms; {nbytes} bytes at 3.35 "
            f"TB/s: {bytes_s * 1e3:.4f} ms); {launches[key]} launches in "
            f"one {key.replace('_', ' ')}")
        del x, dt, bm, cm, s0, args
    del flush
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:27", "matched": True,
            "max_abs_err": path_err["ssd"], **out["serve"],
            "library_ms": None, "at_prefill_step": out["prefill_step"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # full f32 products, as the reference's f32 tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    def build_one(name):
        t0 = time.perf_counter()
        path = build.compile_library(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        built = {n: ex.submit(build_one, n) for n in KERNELS}
        built = {n: f.result() for n, f in built.items()}
    for name in KERNELS:
        build.load(name)
    log(f"phase 2 build: {len(KERNELS)} kernels in parallel in "
        f"{time.perf_counter() - t0:.3f} s: " + ", ".join(
            f"{p.name} {s:.3f} s" for p, s in built.values()))

    records = [edt_path(dev, card)]
    path_err = check_kernels(dev)
    launches = {"flash_attention_hm": llama_path(dev),
                "wkv6": rwkv_path(dev)}
    ssd_launches = zamba_path(dev)
    records += serving_kernel_records(dev, launches, path_err)
    records.append(ssd_record(dev, ssd_launches, path_err))
    log(f"kernel times on {card}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
