#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths and checks every result.  The EDT path:
polyhedral program, index graph, wavefront schedule, counted-sync sweeps
on the card and fused stencil tiles, at the size of the reference's
acceptance runs (jacobi2d, tiles (2,2,2), T=32, N=512: 1,056,784 tasks),
and the same graph split over ranks by the distributed engine.
The serving path: llama3.2-1b, rwkv6-1.6b, zamba2-7b (Mamba2 + shared
attention) and granite-moe-1b-a400m (MoE) at full width and depth, and
deepseek-v3-671b (MLA, MoE) at full width cut to two layers,
whisper-tiny (encoder-decoder) at full width and depth, and internvl2-26b
(a decoder behind 256 patch embeddings) at full width cut to four layers,
f32 weights drawn from a seed.  The training path: llama3.2-1b and
whisper-tiny at full width, all three dense-or-recurrent families at tiny
width, and under meshes llama3.2-1b data-parallel and
granite-moe-1b-a400m expert-parallel at full width and depth.
Parallelism: four ranks of ``torch.distributed``, and tensor-parallel
serving of internvl2-26b (all 48 layers with four cards) and
llama3.2-1b.

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the four CUDA kernels from ``src/repro_torch/csrc``, one
   ``nvcc`` each, all started together, and their times; the HMMA
   (tensor-core) instructions in each library's SASS (``cuobjdump``), which
   the SSD and flash kernels must have; the registers, spills, shared
   memory and blocks an SM of the three serving kernels (flash's f32
   variants at head dims 64 and 128 both on paths), and their grids'
   waves at the path shapes (none may spill);
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
8. the distributed rank engine (``run_distributed``) on the same graph:
   the device engine at 2 and 4 ranks (every rank on the one card,
   stepping through ``wavefront_step``), byte-identical to the host
   schedule and the discover sweep, one kernel launch a superstep of a
   rank with local edges, one message a cross-rank edge, and in a third
   run the kernel held byte for byte against its plain version on every
   rank's every frontier (outside the counted runs); the NumPy engine
   inline and over two spawned processes, byte-identical; a rank crash
   and a lost message batch recovered byte-identical, and the loss
   without a retry policy refused as a stall; a profile of a warm run;
9. flash attention, WKV6 and SSD against their plain torch versions on
   the card, in f32 and bf16, at the reference's test shapes (SSD's
   state handoff too) and at the serving path's shapes (flash's at
   llama3.2-1b's, granite-moe-1b-a400m's, whisper-tiny's and
   internvl2-26b's prefill layers and phase 24's per-rank layers; WKV6's
   also with
   decays of exactly 0 and 1, a sequence shorter than its stretch and
   D=128);
10. llama3.2-1b: ``make_prefill_step`` at B=2, S=4096 through the flash
   kernel (one launch a layer) against the same step on the plain chunked
   attention; the serve loop (B=4, prompt 512, 32 tokens); incremental
   decode against the full forward;
11. rwkv6-1.6b: ``make_prefill_step`` at B=2, S=4096 through the WKV6
    kernel (one launch a layer) against the same step on the plain
    recurrence; the serve loop at the same sizes as llama's (one WKV6
    launch a layer in prefill); prefill logits and every layer's final
    state against the plain recurrence; incremental decode against the
    full forward;
12. kernel times (CUDA events, median, warm and with L2 flushed),
    plain-version times, the time of one PyTorch call computing the same
    function where there is one, the least time the card could take (for
    the tensor-core kernels at the rate of their accuracy, 3xTF32 for f32,
    with the f32 SIMT bound beside it), no kernel faster than its bound,
    WKV6 faster than the kernel it replaced at both its shapes, and a
    ``kernels`` JSON line with each kernel's launches on its main paths
    (counts set to 0 just before each path and read just after);
13. zamba2-7b (68 Mamba2 layers, one shared attention+MLP block applied
    13 times, 5,736,919,872 parameters): ``make_prefill_step`` at B=2,
    S=4096 through the SSD kernel (one launch a Mamba2 layer) against the
    same step on the plain chunked scan; the serve loop (B=4, prompt 512,
    32 tokens) with prefill logits and every layer's SSM state and conv
    cache against the plain route; teacher-forced decode against the full
    forward; and the 4,096-slot ring cache (B=1, a prompt of exactly the
    window, 32 tokens, decode wrapping from its first step) against the
    full windowed forward.  Phase 13 runs before phase 12;
14. the paper's synchronization models and the engine crossover: the
    Table-2 overhead atlas over its full ladder (five programs, six
    models, grains 0.2, 1 and 5; every row validated, no fit failure; the
    fitted class of each counter beside the expected one), the
    reference's crossover ladder (578, 4,356 and 33,800 tasks: the host
    Sim, the replay sweep on the card and the two-rank NumPy engine, every
    row verified; seven runs, with each row's spread and each run's
    points), the same three priced per task at the slice's 1,056,784
    tasks (three runs of the Sim and the warm replay, the replay
    validated by the card's violation counters and the Sim's execution
    order equal to the schedule's; phase 8's NumPy inline run read, not
    run again), and the threaded autodec runtime at 33,800 tasks (each
    task exactly once, every successor after its predecessor).  Phase 14 runs right after
    phase 16, outside every kernel's counted launches;
15. the slice's graph generated on a process pool (the sharded scan of
    ``core/edt/shard.py``), right after phase 8: the host's cores and
    ``/dev/shm`` room; ``synthesize_indexed(graph, params,
    config=ExecutionConfig(shards=s))`` at 2 and 4 shards and twice at 4
    on one pool of the caller's, the host seconds of each and the
    transport (shared memory or pickle) that carried the blocks, each
    graph and schedule byte-identical to the in-process ones;
    ``DeviceExecutor(graph, params, config=ExecutionConfig(shards=4))``'s
    discover sweep through ``wavefront_step`` with ``level_of``
    byte-identical to phase 4's and one launch a level (counted into the
    kernel's record); a worker crash at 2 shards recovered byte-identical
    with no segment of the phase left in ``/dev/shm``;
16. the schedule service (``core/edt/{config,cache,service}.py``), right
    after phase 15: a ``Session(ExecutionConfig(backend="numpy",
    shards=4))`` and its ``ScheduleService`` over the slice's program.
    Eight concurrent clients ask for the packed columns at T=28 (one cold
    fill on the session's fork pool, seven coalesced), then eight at T=32,
    filled incrementally from the T=28 entry (outer blocks reused) and
    byte-identical to phase 4's graph and schedule, timed against a cold
    fill of the same key on the same pool; 64 warm requests answered
    inline, their latencies, and the cache's entries and bytes.  The
    served columns then drive the card: ``session.executor`` discover
    through ``wavefront_step`` (one launch a level, byte-identical to
    phase 4; its construction timed), replay validated,
    ``session.fused_executor``'s f32 replay grid bit-identical to phase
    6's and ``session.distributed``'s two-rank device run byte-identical
    to phase 8's (launches counted into the kernel's record).  Last the
    CLI ``python -m repro_torch.launch.edt_serve`` at the slice size over
    stdin (a cold answer, a warm answer, a malformed request refused while
    the server keeps serving) and its ``--demo``;
17. the training path (``optim``, ``data``, ``checkpoint``, ``runtime``,
    ``launch/train.py``), last, with no kernel on it (the reference trains
    on its plain route): for llama3.2-1b, rwkv6-1.6b and zamba2-7b at the
    reference's ``--width tiny``, 3 steps of ``make_train_step`` on the
    card against the same steps on the CPU from the same seeded params
    (and with ``microbatches=2``), and each family's kernel route refusing
    grad mode on CUDA tensors with no launch; llama3.2-1b at full width
    (f32, B=8, S=256, remat) for 20 steps of ``TrainDriver``, built as
    ``launch.train --width full`` builds it, with its loss going down, ms a
    step, tokens a second, peak memory, forward+backward and the AdamW
    update timed apart, and its one 14.8 GB checkpoint's bytes, snapshot
    and write seconds, restored bit-identical onto the card; the CLI at
    tiny width; a restart drill (a fault before step 9 of 12, checkpoints
    every 4) replaying step 8 with the same loss;
18. the MoE and MLA half of the decoder family, after phase 17.
    granite-moe-1b-a400m (24 layers, 32 experts top-8, every layer MoE,
    the grouped one-hot einsum dispatch): ``make_prefill_step`` at B=2,
    S=4096 through the flash kernel (one launch a layer, counted into its
    record) against the same step on the plain attention, with each MoE
    layer's top-k experts compared between the routes; a profile that
    splits the device time into the one-hot dispatch and combine einsums,
    the expert GEMMs and the ``x @ W`` GEMMs; the flash kernel timed at
    its shape against its bound and ``scaled_dot_product_attention``; the
    serve loop (B=4, prompt 512, 32 tokens); one MoE layer on the card
    against the same code on the CPU at T=512.  deepseek-v3-671b, every
    width as published, depth cut to one dense and one MoE layer
    (13,944,094,720 parameters, 55.8 GB): ``make_prefill_step`` at B=2,
    S=4096 (8,192 tokens: ``moe_ep_apply``; MLA's head dims 192/128 take
    the plain attention, no flash launch) with its peak memory; the serve
    loop (the einsum dispatch at capacity 20 in prefill, 1 in decode, so
    tokens are dropped, and the absorbed MLA decode) held step by step
    against the materialised decode on the same tokens; its MLA layer and
    its MoE layer (both forms) on the card against the CPU at T=512.
    Incremental decode is not held against the full forward here: at
    capacity factor 1.25 the reference drops tokens, so the two differ by
    its own semantics (the CPU tests hold that at drop-free smoke
    configs);
19. the encoder-decoder family, after phase 18: whisper-tiny (4 encoder
    and 4 decoder layers, d 384, 6 heads, 1,536 frame embeddings drawn
    from a seed) at full width and depth.  ``make_prefill_step`` at B=2,
    4,096 text tokens plus the frames through the flash kernel against
    the same step on the plain attention: one launch a decoder layer
    (its causal self-attention, counted into the kernel's record), none
    in the encoder (bidirectional) or the cross-attention (no ``impl``,
    as in the reference), and a profile; the serve loop (B=4, prompt
    512, 32 tokens: encode once, the prompt decoded into the caches,
    decode steps given ``enc_out``) with a profile of a decode step and
    teacher-forced decode against the full ``decode``; the flash kernel
    timed at its shape (G = 1) against its bound and
    ``scaled_dot_product_attention``; one encoder and one decoder layer
    on the card against the CPU; three ``make_train_step`` steps at full
    width (B=2, 512 text tokens, the frames from ``SyntheticLM``) on the
    plain route, with the peak memory;
20. the multimodal-prefix family, after phase 19: internvl2-26b (d 6144,
    48/8 heads of 128, SwiGLU FF 16,384, vocab 92,553, 256 patch
    embeddings drawn from a seed) with every width as published and its
    **depth cut from 48 layers to 4** (2,697,627,648 parameters, 10.8 GB
    of f32 weights; all 48 would be 79.4 GB).  ``make_prefill_step`` at
    B=2, S=4096 (``configs.input_specs``: 256 patches and 3,840 text
    tokens) through the flash kernel's f32 head-dim-128 variant (one
    launch a layer, counted into its record) against the same step on
    the plain attention, with a profile and the peak memory; the serve
    loop (B=4, the patches and a 512-token prompt, 32 tokens) with its
    decode held teacher-forced against the full forward over prefix,
    prompt and generated tokens, and a profile of a decode step; the
    flash kernel timed at its shape (q ``[2,48,4096,128]``, G = 6)
    against its bound and ``scaled_dot_product_attention``.
21. parallelism on ``torch.distributed``, after phase 20: one
    ``run_ranks`` call of four ranks, NCCL with each rank on its own card
    when the host has four, else gloo with the four sharing the card and
    every exchange staged through the host (the transport and the card
    count logged); the ranks load the flash library built in phase 2.
    (a) llama3.2-1b at full width and depth, f32, as 4 pipeline stages
    of 4 layers (``build_schedule(8, 4, tile_m=2)``: 4 tiles of B=2,
    S=4096, 7 wavefronts; 28 flash launches a rank, counted) against
    ``sequential_reference`` on the card in the parent (64 launches),
    within ``MODEL_TOL`` and whether bit-identical; the wall times and
    each rank's peak memory.  (b) training through the pipeline at
    ``examples/pipeline_train.py``'s size, 30 SGD steps: the loss below
    0.7 of its first value, the first step's gradients within 1e-5 of
    autograd through ``sequential_reference``.  (c)
    ``compressed_psum_grads`` over a 4-rank data axis on gradients of
    llama3.2-1b's shapes (1,235,814,400 f32 values a rank): every leaf
    within the reference test's bound of the exact mean, the wire bytes
    against an f32 all-reduce's and both times.  (d) one
    deepseek-v3-671b MoE layer (256 experts top-8, d 7168) at B=2,
    S=4096 on ``make_debug_mesh(1, 4)``, 64 experts a rank, against the
    same layer at one shard in the parent: dropped slots of both forms,
    the outputs within ``test_torch_moe.py``'s tolerance where none
    drop, the all-to-alls' and the expert GEMMs' times.
22. what a step costs, after phase 21 (``launch/op_cost.py``, the
    counterpart of the reference's ``hlo_cost.py``): llama3.2-1b's,
    rwkv6-1.6b's and zamba2-7b's ``make_prefill_step`` at B=2, S=4096
    through flash, WKV6 and SSD, llama3.2-1b's full-width train step
    (phase 17's) and granite-moe-1b-a400m's decode step, each counted once
    on the card under ``op_cost`` and walked on ``meta`` at the same
    shapes, the FLOPs, bytes, launches and kernel calls equal; a line a
    step with its FLOPs, ms, TFLOP/s against the f32 SIMT peak, bytes a
    second against 3.35 TB/s, the profiler's kernels beside the counted
    launches and the walk's peak beside ``max_memory_allocated``; then
    ``launch/dryrun.py``'s cells of ``--all --single-pod`` on ``meta``
    (the train cells among them, rank 0's step under the mesh) on a pool
    of three spawned processes, started before phase 17 and walking
    beside phases 17-22 (so that phases 23 and 24 find the host's cores
    free), less the four whose walk takes over a minute
    (``DRYRUN_LEFT_OUT``), none failing, read after phase 24.
23. the train step under a mesh, after phase 22, through ``run_ranks``
    (no kernel is on a training path): (a) llama3.2-1b at full width and
    depth, data-parallel, on a (4, 1) (data, model) mesh over NCCL when
    the host has four cards, else (2, 1) over gloo on the one card, 3
    steps of phase 17's B=8 S=256 global batch; (b) granite-moe-1b-a400m
    at full width and depth with ``impl="ep_a2a"`` on a (2, 2) mesh (its
    32 experts over data x model, 8 a rank), 2 steps of B=8 S=512 (4,096
    tokens, its ``ep_threshold``) at capacity 4.0, drop-free, then one
    at its 1.25.  Each is first run on one rank in this process; every
    rank's loss within 1e-5 of it, its first step's gradient leaves
    within 1e-4 of their largest, the params after the steps within
    ``TRAIN_STATE_RTOL``'s update norm; logged with the transport, the
    card count, step ms, the exchange's seconds and bytes, each rank's
    peak memory and (b)'s dropped slots at 1.25.  On one card (a) runs
    llama3.2-1b at 8 of its 16 layers and (b) granite at 8 of its 24
    (the depth cuts logged), so that the script keeps its time limit with
    phase 24 beside it.
24. tensor-parallel serving, after phase 23, through one ``run_ranks``
    call of four ranks (NCCL with four cards, else gloo on the one card;
    the transport and the card count logged), each rank drawing its
    params as ``param_specs`` cuts them over 'model' one layer at a time
    (``model.init(..., mesh=)``), f32, ``attn_impl="cuda"``: (a)
    internvl2-26b, every width as published, cut to 8 layers, on a (1, 4)
    mesh: ``make_prefill_step`` at B=2, S=4096 (256 patches + 3,840 text
    tokens) against the one-rank step of the same params run first in
    this process (and freed before the ranks start), the serve loop (B=4,
    the patches and a 512-token prompt, 32 tokens) with each decode step
    teacher-forced on the one-rank tokens against its logits, and the
    greedy tokens that agree; (b) the same two at all 48 layers with four
    cards (12 on one card, the depth cut logged), its decode held against
    the tensor-parallel forward over prefix, prompt and generated tokens;
    (c) llama3.2-1b at full width and depth on (2, 2), its prefill step
    against the one-rank step.  Each within ``MODEL_TOL``, with each
    rank's held param bytes equal to ``param_specs``', its peak memory,
    prefill and decode ms, all-reduces and flash launches (one a layer on
    every rank, counted into flash's record; its plain version refused);
    the kernel at internvl2-26b's per-rank shape (q ``[2,12,4096,128]``,
    k/v ``[2,2,4096,128]``) timed against its bound.

Every failed check raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.

    python3 chip_smoke.py --ablation

runs only what bounds the kernels, as no profiler of the card can run
beside it: ``ssd``, ``flash_attention_hm`` and ``wkv6`` rebuilt with a
part taken out (the ``REPRO_ABLATE_*`` macros the sources read) and
timed at their paths' shapes; a JSON object of the times is its last
line.

    python3 chip_smoke.py --ablation --replaced DIR

also builds the ``wkv6`` and ``flash_attention`` kernels of the checkout
at ``DIR`` (an earlier commit, from ``git archive``), times each in turns
with this one, and compares the two flash libraries' head-dim-64 kernels
instruction by instruction (``cuobjdump -sass``).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SLICE = ("jacobi2d", (2, 2, 2), {"T": 32, "N": 512})
SLICE_DEPTH, SLICE_WIDTH = 558, 3920
CROSSOVER_REPEATS = 7                   # phase 14: runs of the crossover ladder
SLICE_PRICE_REPEATS = 3                 # phase 14: of the slice's Sim and replay
SHARD_ROUND_TIMEOUT = 120.0             # phase 15: seconds a pool round may take
SERVICE_DONOR_T = 28                    # phase 16: the cold entry's T
SERVICE_CLIENTS = 8                     # phase 16: clients a burst
SERVICE_WARM = 64                       # phase 16: warm requests
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
#: f32 accuracy on the tensor cores: three TF32 products (3xTF32) for each
#: f32 one, at a third of the H100 SXM's 495 TFLOP/s of dense TF32
TF32X3_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12                # H100 SXM dense bf16 tensor cores
#: exponentials on the special function units: 16 a clock on each of the
#: 132 SMs at the 1.83 GHz at which the tensor-core rates are quoted
SFU_EXP_PER_S = 16 * 132 * 1.83e9
#: the kernels whose products run on the tensor cores, checked in their
#: SASS for HMMA instructions
TENSOR_CORE_KERNELS = ("ssd", "flash_attention")
#: What the redesigned kernels replaced: the earlier kernels' times at the
#: path shapes (PERF.md's kernel table, chip_smoke.py on an NVIDIA H100
#: 80GB HBM3 at 700 W; medians of CUDA-event means, warm L2).  wkv6's is
#: PR 13's kernel, timed by ``--ablation --replaced`` in turns beside its
#: successor (the mean of its two turns)
REPLACED_MS = {"flash_attention_hm": {"ms": 4.829, "ms_bf16": 4.796},
               "ssd": {"serve": 0.3462, "prefill_step": 1.3072},
               "wkv6": {"serve": 0.2084, "prefill_step": 1.5980}}
REPS, INNER = 25, 20                    # timing: medians of 25 x 20 launches
SLEEP_CYCLES = 20_000_000               # ~10 ms of device sleep, a head start
KERNELS = ("wavefront_step", "flash_attention", "wkv6", "ssd")
#: --ablation: the macros that take a part out of the kernels (their
#: results are then wrong, but for "one column a thread"; only their times
#: mean something), and the libraries that read each
ABLATIONS = {"as built": (), "one TF32 term": ("REPRO_ABLATE_SMALL_TERMS",),
             "no products": ("REPRO_ABLATE_PRODUCTS",),
             "no staging": ("REPRO_ABLATE_STAGING",),
             "one column a thread": ("REPRO_ABLATE_COLUMN_BLOCKING",)}
ABLATED = {"as built": ("ssd", "flash_attention", "wkv6"),
           "one TF32 term": ("ssd", "flash_attention"),
           "no products": ("ssd", "flash_attention"),
           "no staging": ("ssd", "wkv6"),
           "one column a thread": ("wkv6",)}

# ------------------------------------------------------- the serving path
LLAMA, RWKV, ZAMBA = "llama3.2-1b", "rwkv6-1.6b", "zamba2-7b"
ZAMBA_PARAMS = 5_736_919_872
ZAMBA_LAYERS = (68, 13)                 # Mamba2 layers, attention uses
RING_B = 1                              # ring cache: prompt = the window
PREFILL_B, PREFILL_S = 2, 4096          # make_prefill_step, flash on path
SERVE_B, SERVE_LP, SERVE_G = 4, 512, 32  # the serve loop
#: flash cases (B, H, Hkv, Sq, Skv, D, causal): tests/test_kernels.py's
#: shapes, then llama3.2-1b's prefill layer, a non-causal Sq != Skv, a
#: length that is not a multiple of the kernel's 64-row tiles,
#: granite-moe-1b-a400m's prefill layer, whisper-tiny's decoder
#: self-attention in its prefill step (G = 1), internvl2-26b's prefill
#: layer (head dim 128, G = 6) and phase 24's per-rank layers
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True), (2, 4, 2, 256, 256, 64, True),
    (1, 3, 1, 384, 384, 128, True), (1, 2, 2, 128, 256, 64, False),
    (2, 32, 8, 4096, 4096, 64, True), (2, 32, 8, 512, 2048, 64, False),
    (1, 2, 1, 100, 100, 64, True), (2, 16, 8, 4096, 4096, 64, True),
    (2, 6, 6, 4096, 4096, 64, True), (2, 48, 8, 4096, 4096, 128, True),
    (2, 12, 2, 4096, 4096, 128, True), (1, 16, 4, 4096, 4096, 64, True),
]
FLASH_PATH, FLASH_GRANITE, FLASH_WHISPER, FLASH_INTERNVL = (
    FLASH_CASES[4], FLASH_CASES[7], FLASH_CASES[8], FLASH_CASES[9])
#: phase 24's per-rank shapes: internvl2-26b's 12 query and 2 kv heads on
#: (1, 4), llama3.2-1b's row block, 16 and 4 heads, on (2, 2)
FLASH_INTERNVL_TP, FLASH_LLAMA_TP = FLASH_CASES[10], FLASH_CASES[11]
#: wkv6 cases (B, S, H, D, with init_state): tests/test_kernels.py's
#: shapes, then rwkv6-1.6b's serve prefill with and without a state and
#: its make_prefill_step, then a sequence shorter than the kernel's
#: stretch of 16 steps with an odd head count, and D=128 with a state.
#: The serve prefill also runs with decays of exactly 0 and 1 (WKV_EDGE)
WKV_CASES = [
    (1, 32, 1, 8, False), (2, 64, 2, 16, False), (1, 128, 2, 64, False),
    (4, 512, 32, 64, False), (4, 512, 32, 64, True),
    (2, 4096, 32, 64, False), (3, 37, 5, 64, True), (2, 256, 4, 128, True),
]
WKV_PATH, WKV_PREFILL = WKV_CASES[4], WKV_CASES[5]
WKV_EDGE = WKV_PATH
#: state columns a block of the wkv6 kernel at D=64 (csrc/wkv6.cu, Split)
WKV_BLOCK_COLUMNS = 32
#: ssd cases (B, S, H, P, N, chunk, with init_state): tests/test_kernels.py's
#: shapes, then zamba2-7b's serve prefill with and without a state and its
#: make_prefill_step (the handoff case of tests/test_kernels.py is
#: SSD_HANDOFF), then odd P and N (rows not a multiple of 16 bytes: the
#: kernel's element-wise loads) and a tail shorter than its chunk of 64
SSD_CASES = [
    (1, 32, 1, 16, 8, 8, False), (2, 64, 2, 32, 16, 16, False),
    (1, 128, 4, 64, 64, 32, False),
    (4, 512, 112, 64, 64, 256, True), (4, 512, 112, 64, 64, 256, False),
    (2, 4096, 112, 64, 64, 256, False),
    (2, 64, 3, 17, 9, 64, True), (1, 100, 2, 40, 24, 100, True),
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


def op_chain(op):
    """A profiler CPU event and its parents, innermost first."""
    while op is not None:
        yield op
        op = op.cpu_parent


def device_profile(fn, classify=None):
    """``(wall s, device-busy s, kernels, top 3 kernels by device time)``
    of one call under ``torch.profiler`` (one stream: kernel times add).

    With ``classify`` (a profiler CPU event to a class name; shapes are
    recorded) a fifth item, ``{class: device ms}``: each kernel counts
    once, classed by the innermost aten op of its correlation id, and the
    device time no aten op launched (the hand-written kernels, through
    ctypes) is "outside aten ops"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=classify is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    count = 0
    launched = collections.defaultdict(list)    # correlation id -> CPU events
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            count += 1
        elif classify is not None and e.kernels:
            launched[e.id].append(e)
    busy = sum(by_name.values()) / 1e6
    top = [(k, round(v / 1e3, 3)) for k, v in by_name.most_common(3)]
    if classify is None:
        return wall, busy, count, top
    # every CPU event of one correlation id lists the same kernels: count
    # them once, with the innermost aten op among those events
    split = collections.Counter()
    for same in launched.values():
        aten = [a for a in same if a.name.startswith("aten::")] or same
        op = max(aten, key=lambda a: len(list(op_chain(a))))
        split[classify(op)] += sum(k.duration for k in same[0].kernels)
    split["outside aten ops"] = sum(by_name.values()) - sum(split.values())
    return wall, busy, count, top, {k: round(v / 1e3, 3)
                                    for k, v in split.most_common()}


def edt_path(dev, card) -> tuple[dict, dict]:
    """Phases 3 to 8, 15 and 16, the EDT path.  Returns the slice's graph,
    schedule and phase 8's two-rank NumPy inline seconds (for phase 14),
    and the wavefront kernel's record (its launches counted over phases 4
    to 6, phase 8's device runs, phase 15's sharded discover sweep and
    phase 16's served runs)."""
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
    t1 = time.perf_counter()
    ig, sched = synthesize_indexed(graph, params)
    t_synth = time.perf_counter() - t1
    dg = pack_graph(ig)
    t_graph = time.perf_counter() - t0
    log(f"host graph {name} tiles {tiles} {params}: n={ig.n} "
        f"E={ig.n_edges} depth={sched.depth} width={sched.max_width} "
        f"in {t_graph:.3f} s (synthesize_indexed in process "
        f"{t_synth:.3f} s)")
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
    fused_grid = frep.final.cpu().numpy()
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
    rank_launches, rank_steps, rank_err, inline_s, rank_level_of = \
        rank_path(dev, ig, sched, run.level_of, check_step)
    max_err = max(max_err, rank_err)
    shard_launches = shard_path(dev, graph, params, ig, sched, run.level_of,
                                t_synth)
    service_launches = service_path(dev, ig, sched, run.level_of,
                                    fused_grid, rank_level_of)
    slice_run = {"ig": ig, "sched": sched, "inline_s": inline_s}
    return slice_run, {
        "name": "wavefront_step", "route": "cuda",
        "source": "src/repro_torch/csrc/wavefront_step.cu",
        "replaces": "src/repro/core/edt/device.py:225",
        "launches": (main_launches + sum(rank_launches.values())
                     + shard_launches + service_launches),
        "launches_rank_engine": rank_launches,
        "launches_sharded_discover": shard_launches,
        "launches_service": service_launches, "matched": True,
        "frontiers_checked": steps + rank_steps, "max_abs_err": max_err,
        "ms": step_ms, "ms_cold_l2": step_cold_ms, "plain_ms": plain_ms,
        "host_us": step_host_us,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }


def rank_path(dev, ig, sched, disc_level_of, check_step):
    """Phase 8: the distributed rank engine on the slice's graph.  Returns
    ``wavefront_step``'s launches in the first device run at each rank
    count (the count set to 0 just before each run, read just after), the
    rank frontiers on which the kernel was held against its plain version
    (``check_step``), the largest difference there, and the seconds of the
    two-rank NumPy engine's inline run, and the two-rank device run's
    ``level_of`` (for phase 16)."""
    import importlib

    from repro_torch.core.edt import (MESSAGE_LOSS, RANK_CRASH,
                                      ExecutionConfig, Fault, FaultPlan,
                                      RetryPolicy, StallError,
                                      partition_graph, run_distributed)
    from repro_torch.core.edt.device import wavefront_step

    dist_mod = importlib.import_module("repro_torch.core.edt.distributed")

    want = sched.level_of.tobytes()
    if disc_level_of.tobytes() != want:
        raise AssertionError("discover level_of differs from the host "
                             "schedule")

    def check(run, label, cross):
        if run.level_of.tobytes() != want:
            raise AssertionError(f"{label}: level_of differs from the host "
                                 "schedule and the discover sweep")
        if len(run.levels) != sched.depth or any(
                not np.array_equal(x, y) for x, y in zip(run.levels,
                                                          sched.levels)):
            raise AssertionError(f"{label}: levels differ from the host "
                                 "schedule")
        st = run.rank_stats
        if sum(s.started for s in st) != ig.n:
            raise AssertionError(f"{label}: {sum(s.started for s in st)} "
                                 f"tasks started, want {ig.n}")
        msgs = sum(s.msgs_out for s in st)
        if msgs != cross or sum(s.msgs_in for s in st) != cross:
            raise AssertionError(f"{label}: {msgs} messages, want the "
                                 f"{cross} cross-rank edges")
        return (f"supersteps {[s.supersteps for s in st]}, messages {msgs} "
                f"in {sum(s.batches_out for s in st)} batches, ranks' loop "
                f"{max(s.seconds for s in st):.3f} s")

    launches, cross_of, warm_of, run_s = {}, {}, {}, {}
    rank_steps, rank_err = 0, 0
    for ranks in (2, 4):
        t0 = time.perf_counter()
        slices = partition_graph(ig, ranks)
        t_part = time.perf_counter() - t0
        cross_of[ranks] = cross = sum(int(sl.r_tgt.size) for sl in slices)
        edged = [sl.rank for sl in slices if sl.l_tgt.size]
        wavefront_step.launches = 0
        run, t_first = timed(lambda: run_distributed(
            ig, ranks=ranks, engine="device", device=dev))
        launches[f"ranks_{ranks}"] = n_launch = wavefront_step.launches
        line = check(run, f"device engine, {ranks} ranks", cross)
        steps = sum(run.rank_stats[k].supersteps for k in edged)
        if n_launch != steps:
            raise AssertionError(f"{n_launch} kernel launches for {steps} "
                                 "supersteps of ranks with local edges")
        warm_of[ranks], t_warm = timed(lambda: run_distributed(
            ig, ranks=ranks, engine="device", device=dev))
        check(warm_of[ranks], f"warm device engine, {ranks} ranks", cross)
        # kernel == plain version on every rank's every frontier of a
        # third run, outside the counted window: each engine's step goes
        # through check_step on the same (indeg, frontier, dec_src,
        # dec_ptr) the run gives the kernel
        checked = {"steps": 0, "err": 0, "shapes": set()}

        def checked_step(indeg, frontier, src, ptr):
            out, err = check_step(indeg, frontier, src, ptr,
                                  f"{ranks}-rank frontier {checked['steps']}")
            checked["steps"] += 1
            checked["err"] = max(checked["err"], err)
            checked["shapes"].add((indeg.numel(), src.numel()))
            return out

        saved, dist_mod.wavefront_step = dist_mod.wavefront_step, checked_step
        try:
            krun = run_distributed(ig, ranks=ranks, engine="device",
                                   device=dev)
        finally:
            dist_mod.wavefront_step = saved
        check(krun, f"checked device engine, {ranks} ranks", cross)
        if checked["steps"] != sum(s.supersteps for s in krun.rank_stats):
            raise AssertionError(f"{checked['steps']} checked steps for "
                                 f"{ranks} ranks' supersteps")
        rank_steps += checked["steps"]
        rank_err = max(rank_err, checked["err"])
        log(f"phase 8 device engine, {ranks} ranks: level_of byte-identical "
            f"to the host schedule and discover; partition {t_part:.3f} s; "
            f"run {t_first:.3f} s (warm {t_warm:.3f}); {line}; kernel "
            f"launches {n_launch} == supersteps of ranks with local edges "
            f"{steps}; kernel == plain version on all {checked['steps']} "
            f"rank frontiers at (n, E) {sorted(checked['shapes'])}, max_abs_err "
            f"{checked['err']}")
    for label, kw in (("numpy engine inline", {"transport": "inline"}),
                      ("numpy engine, 2 spawned processes",
                       {"transport": "processes", "start_method": "spawn",
                        "timeout": 120.0})):
        t0 = time.perf_counter()
        nrun = run_distributed(ig, ranks=2, engine="numpy", **kw)
        t_run = run_s[label] = time.perf_counter() - t0
        line = check(nrun, label, cross_of[2])
        if nrun.level_of.tobytes() != warm_of[2].level_of.tobytes():
            raise AssertionError(f"{label}: differs from the device engine")
        log(f"phase 8 {label}, 2 ranks: byte-identical to the device "
            f"engine; run {t_run:.3f} s; {line}")

    policy = RetryPolicy(max_retries=3, base_delay=0.001)
    crash = FaultPlan(faults=(Fault(kind=RANK_CRASH, index=1, times=1),))
    crun, t_crash = timed(lambda: run_distributed(
        ig, ranks=2, engine="device", device=dev,
        config=ExecutionConfig(faults=crash, recovery=policy)))
    check(crun, "rank crash recovered", cross_of[2])
    if crun.attempts != 1 or [f[0] for f in crash.fired] != [RANK_CRASH]:
        raise AssertionError(f"rank crash: {crun.attempts} attempts, fired "
                             f"{crash.fired}")
    loss = FaultPlan(faults=(Fault(kind=MESSAGE_LOSS, round=0, index=1,
                                   times=1),))
    t0 = time.perf_counter()
    try:
        run_distributed(ig, ranks=2, engine="device", device=dev,
                        config=ExecutionConfig(faults=loss))
    except StallError as e:
        report = e.report
    else:
        raise AssertionError("a lost message batch without a retry policy "
                             "did not stall")
    t_stall = time.perf_counter() - t0
    if not report.undrained or "decrement" not in report.note:
        raise AssertionError(f"message-loss stall report: {report.summary()}")
    loss = FaultPlan(faults=loss.faults)
    lrun, t_loss = timed(lambda: run_distributed(
        ig, ranks=2, engine="device", device=dev,
        config=ExecutionConfig(faults=loss, recovery=policy)))
    check(lrun, "message loss recovered", cross_of[2])
    if lrun.attempts != 1 or [f[0] for f in loss.fired] != [MESSAGE_LOSS]:
        raise AssertionError(f"message loss: {lrun.attempts} attempts, "
                             f"fired {loss.fired}")
    log(f"phase 8 faults, device engine, 2 ranks: rank crash recovered in "
        f"{crun.attempts} retry, byte-identical ({t_crash:.3f} s); message "
        f"loss without a policy: StallError after {t_stall:.3f} s, "
        f"{len(report.undrained)} undrained counter(s) named, note "
        f"{report.note!r}; with the policy recovered in {lrun.attempts} "
        f"retry, byte-identical ({t_loss:.3f} s)")
    wall, busy, count, top = device_profile(lambda: run_distributed(
        ig, ranks=2, engine="device", device=dev))
    log(f"profile device engine, 2 ranks: wall {wall:.3f} s under the "
        f"profiler, device busy {busy:.4f} s ({100 * busy / wall:.1f}%) in "
        f"{count} kernels; top (name, ms): {top}")
    return (launches, rank_steps, rank_err, run_s["numpy engine inline"],
            warm_of[2].level_of)


def shard_path(dev, graph, params, ig, sched, disc_level_of,
               t_synth) -> int:
    """Phase 15: the slice's graph generated on a process pool.

    ``synthesize_indexed(graph, params, config=ExecutionConfig(shards=s))``
    at 2 and 4 shards on pools of its own and twice at 4 on one pool of
    the caller's, each byte-identical to the in-process graph and schedule
    of the host graph section (``t_synth`` its seconds);
    ``DeviceExecutor(graph, params, config=ExecutionConfig(shards=4))``'s
    discover sweep, whose ``wavefront_step`` launches it
    returns (the count set to 0 just before the run, read just after);
    and a worker crash recovered byte-identical, with no segment of the
    phase left in ``/dev/shm``.  Every ``synthesize_indexed`` build runs
    under a retry policy with a round timeout, so a wedged worker ends in
    ``ShardRecoveryError``, not a hang (``DeviceExecutor`` takes no
    policy, as the reference's does not).  The worker entry points use
    NumPy only, so the pools keep the platform's default start method
    (fork on Linux) after CUDA is initialised.  ``scan_sharded`` and the
    segment allocator are wrapped to read which transport carried the
    blocks, the seconds of the scan and of each of its pool rounds, and
    the names of the shared-memory segments each run made."""
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core.edt import (WORKER_CRASH, DeviceExecutor,
                                      ExecutionConfig, Fault, FaultPlan,
                                      RetryPolicy, schedule_from_graph,
                                      synthesize_indexed)
    from repro_torch.core.edt import shard
    from repro_torch.core.edt.device import wavefront_step

    t_phase = time.perf_counter()
    room = shard.shm_room()
    log(f"phase 15 host: os.cpu_count() {os.cpu_count()}, "
        f"sched_getaffinity {len(os.sched_getaffinity(0))} cores; "
        f"/dev/shm " + (f"size {room[0]} B, free {room[1]} B" if room
                        else "absent"))
    runs, names, rounds = [], [], []
    scan_sharded, new_segment = shard.scan_sharded, shard._Segments._new
    run_round = shard.run_round

    def recording_round(*args, **kw):
        t0 = time.perf_counter()
        out = run_round(*args, **kw)
        rounds.append(time.perf_counter() - t0)
        return out

    def recording_scan(*args, **kw):
        rounds.clear()
        t0 = time.perf_counter()
        scans = scan_sharded(*args, **kw)
        runs.append((scans.transport, scans.shm_bytes,
                     time.perf_counter() - t0, list(rounds)))
        return scans

    def recording_new(self, nbytes):
        shm = new_segment(self, nbytes)
        if shm is not None:
            names.append(shm.name)
        return shm

    def left_in_shm() -> list:
        gc.collect()
        return [n for n in names
                if os.path.exists(os.path.join(shard.SHM_DIR, n))]

    blocks = [(s, a.tobytes()) for s, a in ig.stmt_blocks]

    def check(got, got_sched, label):
        for field in ("edge_src", "edge_tgt", "pred_n"):
            if getattr(got, field).tobytes() != getattr(ig, field).tobytes():
                raise AssertionError(f"{label}: {field} differs from the "
                                     "in-process graph")
        if [(s, a.tobytes()) for s, a in got.stmt_blocks] != blocks:
            raise AssertionError(f"{label}: stmt_blocks differ")
        if got_sched.level_of.tobytes() != sched.level_of.tobytes() or len(
                got_sched.levels) != sched.depth or any(
                a.tobytes() != b.tobytes()
                for a, b in zip(got_sched.levels, sched.levels)):
            raise AssertionError(f"{label}: schedule differs from the "
                                 "in-process one")

    policy = RetryPolicy(max_retries=2, timeout=SHARD_ROUND_TIMEOUT)
    lines = []
    t0 = time.perf_counter()
    schedule_from_graph(ig)
    t_level = time.perf_counter() - t0
    shard.scan_sharded, shard._Segments._new = recording_scan, recording_new
    shard.run_round = recording_round
    try:
        def build(label, **kw):
            t0 = time.perf_counter()
            got, got_sched = synthesize_indexed(
                graph, params, config=ExecutionConfig(recovery=policy, **kw))
            t = time.perf_counter() - t0
            check(got, got_sched, label)
            transport, need, t_scan, secs = runs[-1]
            lines.append(f"{label} {t:.3f} s (scan {t_scan:.3f} s, its pool "
                         f"rounds {'/'.join(f'{x:.3f}' for x in secs)}) by "
                         f"{transport}")
            return t, need

        for s in (2, 4):
            _, need = build(f"shards={s}", shards=s)
        with ProcessPoolExecutor(max_workers=4) as pool:
            for k in ("first", "second"):
                build(f"shards=4 on the caller's pool, {k} build",
                      shards=4, pool=pool)
        log(f"phase 15 synthesize_indexed at n={ig.n} E={ig.n_edges}: "
            f"byte-identical to the in-process graph and schedule "
            f"(in process {t_synth:.3f} s, of which leveling "
            f"{t_level:.3f} s, serial in every build; the pool rounds "
            f"count, tile, edge): " + "; ".join(lines)
            + f"; the counted plan needs {need} B of shared memory"
            + (f" against {room[1]} B free" if room else ""))

        t0 = time.perf_counter()
        ex = DeviceExecutor(graph, params, config=ExecutionConfig(shards=4),
                            device=dev)
        t_build = time.perf_counter() - t0
        wavefront_step.launches = 0
        drun, t_run = timed(ex.run)
        launches = wavefront_step.launches
        if drun.level_of.tobytes() != disc_level_of.tobytes():
            raise AssertionError("sharded DeviceExecutor: level_of differs "
                                 "from phase 4's discover sweep")
        if launches != drun.counters.depth:
            raise AssertionError(f"sharded DeviceExecutor: {launches} kernel "
                                 f"launches for {drun.counters.depth} steps")
        log(f"phase 15 DeviceExecutor(graph, params, "
            f"config=ExecutionConfig(shards=4)): graph and "
            f"packing {t_build:.3f} s by {runs[-1][0]}; discover "
            f"{t_run:.3f} s, level_of byte-identical to phase 4's; kernel "
            f"launches {launches} == steps {drun.counters.depth}")
        del ex, drun

        plan = FaultPlan(faults=(Fault(kind=WORKER_CRASH, round=1, index=0,
                                       times=1),))
        t0 = time.perf_counter()
        got, got_sched = synthesize_indexed(
            graph, params, config=ExecutionConfig(shards=2, faults=plan,
                                                  recovery=policy))
        t_fault = time.perf_counter() - t0
        check(got, got_sched, "worker crash recovered")
        del got, got_sched
        if [f[:3] for f in plan.fired] != [("shard_failure", (1, 0), 0)]:
            raise AssertionError(f"worker crash: fired {plan.fired}")
        left = left_in_shm()
        if left:
            raise AssertionError(f"segments left in /dev/shm: {left}")
        log(f"phase 15 worker crash (round 1, job 0, once) at shards=2: "
            f"recovered byte-identical in {t_fault:.3f} s by {runs[-1][0]}; "
            f"fired {[f[:3] for f in plan.fired]}; of the {len(names)} "
            f"segments the phase's runs made, none left in /dev/shm")
    finally:
        shard.scan_sharded, shard._Segments._new = scan_sharded, new_segment
        shard.run_round = run_round
    log(f"phase 15 wall {time.perf_counter() - t_phase:.3f} s")
    return launches

def service_path(dev, ig, sched, disc_level_of, fused_grid,
                 rank_level_of) -> int:
    """Phase 16: the schedule service over the slice's program.

    A ``Session(ExecutionConfig(backend="numpy", shards=4))`` owns the
    fork pool (NumPy-only workers, as in phase 15) and the graph cache;
    its ``ScheduleService`` answers concurrent clients.  Every check
    raises.  Returns ``wavefront_step``'s launches in the served discover
    sweep and the served two-rank device run (the count set to 0 just
    before each, read just after)."""
    import asyncio
    import os

    from repro_torch.core.edt import (CachePolicy, ExecutionConfig,
                                      GraphCache, ScheduleService, Session,
                                      shard)
    from repro_torch.core.edt.cache import (_dg_nbytes, _ds_nbytes,
                                            _sched_nbytes)
    from repro_torch.core.edt.device import wavefront_step
    from repro_torch.core.poly import Tiling
    from repro_torch.core.programs import PROGRAMS

    t_phase = time.perf_counter()
    name, tiles, params = SLICE
    early = dict(params, T=SERVICE_DONOR_T)
    session = Session(ExecutionConfig(backend="numpy", shards=4))
    service = ScheduleService(session)
    graph = session.graph(PROGRAMS[name](), {"S": Tiling(tiles)})
    rounds, run_round = [], shard.run_round

    def recording_round(*args, **kw):
        t0 = time.perf_counter()
        out = run_round(*args, **kw)
        rounds.append(time.perf_counter() - t0)
        return out

    async def burst(p, n):
        t0 = time.perf_counter()
        got = await asyncio.gather(*(service.packed(graph, p)
                                     for _ in range(n)))
        return got, time.perf_counter() - t0

    def counts():
        st = service.stats()
        return st["cold"], st["coalesced"], st["warm"]

    shard.run_round = recording_round
    try:
        # ------------------------------------- 1. cold, coalesced, sharded
        got, t_cold = asyncio.run(burst(early, SERVICE_CLIENTS))
        cold_rounds = list(rounds)
        if counts() != (1, SERVICE_CLIENTS - 1, 0):
            raise AssertionError(f"cold burst: (cold, coalesced, warm) "
                                 f"{counts()}, want 1 cold fill for "
                                 f"{SERVICE_CLIENTS} clients")
        if len({(id(dg), id(ds)) for dg, ds in got}) != 1:
            raise AssertionError("cold burst: clients hold different "
                                 "objects")
        early_n = got[0][0].n
        log(f"phase 16 cold burst: {SERVICE_CLIENTS} clients, packed at "
            f"{early} ({early_n} tasks): one fill on the session's fork "
            f"pool at 4 shards ({os.cpu_count()} cores), "
            f"{SERVICE_CLIENTS - 1} coalesced, wall {t_cold:.3f} s; its "
            f"pool rounds (count, tile, edge; the first starts the "
            f"workers) {'/'.join(f'{x:.3f}' for x in cold_rounds)} s")

        rounds.clear()
        info0 = session.cache.info()
        got, t_inc = asyncio.run(burst(params, SERVICE_CLIENTS))
        info1 = session.cache.info()
        if counts() != (2, 2 * (SERVICE_CLIENTS - 1), 0):
            raise AssertionError(f"incremental burst: (cold, coalesced, "
                                 f"warm) {counts()}")
        reused = info1["units_reused"] - info0["units_reused"]
        if info1["incremental_hits"] - info0["incremental_hits"] != 1 or \
                reused <= 0:
            raise AssertionError(f"the T={params['T']} fill was not "
                                 f"incremental: {info1}")
        changed = frozenset(i for i, nm in enumerate(graph.param_names)
                            if early[nm] != params[nm])
        units = [(kind, key) for kind, key, nest in graph.scan_units()
                 if nest.ndim > 0 and changed <= nest.outer_only_params()]
        dg, ds = got[0]
        sig, ssched = session.schedule(graph, params)
        for field in ("edge_src", "edge_tgt", "pred_n"):
            if getattr(sig, field).tobytes() != getattr(ig, field).tobytes():
                raise AssertionError(f"served graph: {field} differs from "
                                     "phase 4's")
        if [(n, a.tobytes()) for n, a in sig.stmt_blocks] != [
                (n, a.tobytes()) for n, a in ig.stmt_blocks]:
            raise AssertionError("served graph: stmt_blocks differ from "
                                 "phase 4's")
        if ssched.level_of.tobytes() != sched.level_of.tobytes() or \
                ds.level_of.tobytes() != sched.level_of.tobytes():
            raise AssertionError("served schedule differs from the host "
                                 "schedule")
        inc_rounds = list(rounds)
        rounds.clear()
        cold_cache = GraphCache(CachePolicy(incremental=False))
        (cdg, cds), t_full = timed(lambda: cold_cache.packed(
            graph, params, session.runtime_config()))
        if cdg.dec_src.tobytes() != dg.dec_src.tobytes() or \
                cds.lvl_tgt.tobytes() != ds.lvl_tgt.tobytes():
            raise AssertionError("cold fill differs from the incremental "
                                 "one")
        log(f"phase 16 incremental burst: {SERVICE_CLIENTS} clients, packed "
            f"at {params} (n={sig.n} E={sig.n_edges} depth {ssched.depth}): "
            f"one fill stitched from the T={early['T']} entry, "
            f"{reused} of {len(graph.scan_units())} scan units reused "
            f"{units}, the rest scanned in process, wall {t_inc:.3f} s "
            f"(pool rounds: {len(inc_rounds)}); a cold fill "
            f"of the same key on the same pool {t_full:.3f} s (rounds "
            f"{'/'.join(f'{x:.3f}' for x in rounds)} s); graph and "
            f"schedule byte-identical to phase 4's")
        del cold_cache, cdg, cds
    finally:
        shard.run_round = run_round

    # ------------------------------------------------------------- 2. warm
    async def warm(n):
        lat = []
        for _ in range(n):
            t0 = time.perf_counter()
            got = await service.packed(graph, params)
            lat.append(time.perf_counter() - t0)
            if got[0] is not dg or got[1] is not ds:
                raise AssertionError("a warm answer is not the cached one")
        return lat

    before = counts()
    lat = asyncio.run(warm(SERVICE_WARM))
    if counts() != (before[0], before[1], before[2] + SERVICE_WARM):
        raise AssertionError(f"warm requests: (cold, coalesced, warm) "
                             f"{before} -> {counts()}")

    def cache_line():
        info = session.cache.info()
        per = []
        for p in (early, params):
            parts = {"ig": session.cache.peek(graph, p, "ig"),
                     "schedule": session.cache.peek(graph, p, "schedule"),
                     "dg": session.cache.peek(graph, p, "dg"),
                     "ds": session.cache.peek(graph, p, "ds"),
                     "fo": session.cache.peek(graph, p, "fo")}
            sizes = {"ig": parts["ig"].nbytes,
                     "schedule": _sched_nbytes(parts["schedule"]),
                     "dg": _dg_nbytes(parts["dg"]),
                     "ds": _ds_nbytes(parts["ds"]),
                     "fo": (int(parts["fo"].nbytes)
                            if parts["fo"] is not None else 0)}
            per.append(f"T={p['T']} {sum(sizes.values())} B {sizes}")
        return (f"{info['entries']} entries, {info['bytes']} B of "
                f"max_bytes {info['max_bytes']} ({'; '.join(per)}); hits "
                f"{info['hits']} misses {info['misses']} evictions "
                f"{info['evictions']}")

    lat_us = sorted(x * 1e6 for x in lat)
    log(f"phase 16 warm: {SERVICE_WARM} requests answered inline, latency "
        f"median {statistics.median(lat_us):.1f} us, max {lat_us[-1]:.1f} "
        f"us; cache {cache_line()}")

    # --------------------------------------- 3. the served columns, on card
    t0 = time.perf_counter()
    ex = session.executor(graph, params, replay=False, device=dev)
    t_build = time.perf_counter() - t0
    wavefront_step.launches = 0
    drun, t_disc = timed(ex.run)
    launches = disc_launches = wavefront_step.launches
    if drun.level_of.tobytes() != disc_level_of.tobytes():
        raise AssertionError("served discover: level_of differs from "
                             "phase 4's")
    if disc_launches != drun.counters.depth or drun.counters.depth != \
            SLICE_DEPTH:
        raise AssertionError(f"served discover: {disc_launches} kernel "
                             f"launches for {drun.counters.depth} steps")
    rex = session.executor(graph, params, replay=True, device=dev)
    rrun, t_replay = timed(rex.run)
    if (rrun.mode, rrun.counters.tasks_finished, rrun.counters.depth) != (
            "replay", ig.n, SLICE_DEPTH):
        raise AssertionError(f"served replay: {rrun.counters.summary()}")
    t0 = time.perf_counter()
    fex = session.fused_executor(graph, params, device=dev)
    t_fbuild = time.perf_counter() - t0
    frun, t_fused = timed(fex.run)
    got = frun.final.cpu().numpy()
    if got.dtype != fused_grid.dtype or got.tobytes() != fused_grid.tobytes():
        raise AssertionError("served fused replay grid differs from phase "
                             "6's")
    wavefront_step.launches = 0
    dist, t_dist = timed(lambda: session.distributed(
        graph, params, ranks=2, engine="device", device=dev))
    launches += wavefront_step.launches
    if dist.level_of.tobytes() != rank_level_of.tobytes():
        raise AssertionError("served 2-rank device run differs from "
                             "phase 8's")
    log(f"phase 16 served columns on the card: executor construction "
        f"{t_build * 1e3:.3f} ms (packs nothing); discover {t_disc:.3f} s, "
        f"level_of byte-identical to phase 4's, kernel launches "
        f"{disc_launches} == steps {drun.counters.depth}; replay "
        f"validated {t_replay:.3f} s; fused executor construction "
        f"{t_fbuild:.3f} s (origins packed once into the entry), f32 "
        f"replay {t_fused:.3f} s, grid bit-identical to phase 6's; "
        f"2-rank device run {t_dist:.3f} s, byte-identical to phase 8's, "
        f"kernel launches {launches - disc_launches}")
    log(f"phase 16 cache after the card's products: {cache_line()}")
    service.close()
    session.close()
    del ex, rex, fex, drun, rrun, frun, dist

    # ------------------------------------------------------------- 4. CLI
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    key = {"T": params["T"], "N": params["N"]}
    lines = [json.dumps({"params": key, "kind": "packed"})] * 2 + [
        json.dumps({"params": {"T": params["T"]}, "kind": "packed"})]
    cmd = [sys.executable, "-m", "repro_torch.launch.edt_serve",
           "--program", name, "--tile", ",".join(map(str, tiles)),
           "--backend", "numpy", "--shards", "4"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, input="\n".join(lines) + "\n", env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    t_cli = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"edt_serve exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    answers = [json.loads(x) for x in out.stdout.splitlines()]
    if len(answers) != 4:
        raise AssertionError(f"edt_serve answered {out.stdout!r}")
    want = {"ok": True, "tasks": ig.n, "edges": ig.n_edges,
            "depth": SLICE_DEPTH}
    for a, w in zip(answers[:2], (False, True)):
        if {k: a.get(k) for k in want} != want or a.get("warm") is not w:
            raise AssertionError(f"edt_serve answer {a}, want {want} with "
                                 f"warm {w}")
    if answers[2].get("ok") is not False or "N" not in answers[2]["error"]:
        raise AssertionError(f"edt_serve took a request without N: "
                             f"{answers[2]}")
    stats = answers[3]["stats"]
    # the request without N is a miss whose fill raises: it counts cold,
    # and the cache holds only the one real fill
    if (stats["requests"], stats["cold"], stats["warm"],
            stats["cache"]["entries"]) != (3, 2, 1, 1):
        raise AssertionError(f"edt_serve stats {stats}")
    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edt_serve", "--demo"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_demo = time.perf_counter() - t0
    if demo.returncode != 0 or "warm burst" not in demo.stdout:
        raise AssertionError(f"edt_serve --demo exited {demo.returncode}: "
                             f"{demo.stderr[-2000:]}")
    dstats = json.loads(demo.stdout[demo.stdout.index("{"):])["stats"]
    log(f"phase 16 CLI at {key}: cold answer {answers[0]['ms']} ms, warm "
        f"{answers[1]['ms']} ms, {answers[0]['tasks']} tasks "
        f"{answers[0]['edges']} edges depth {answers[0]['depth']}; the "
        f"request without N refused ({answers[2]['error']}) and the server "
        f"kept serving; final stats requests {stats['requests']} cold "
        f"{stats['cold']} (one fill) warm {stats['warm']}; process "
        f"{t_cli:.3f} s; --demo {t_demo:.3f} s: "
        + " / ".join(x for x in demo.stdout.splitlines()
                     if x.startswith(("cold burst", "warm burst")))
        + f"; demo cold {dstats['cold']} coalesced {dstats['coalesced']} "
        f"warm {dstats['warm']}")
    log(f"phase 16 wall {time.perf_counter() - t_phase:.3f} s")
    return launches


def atlas_path(dev, card, ig, sched, inline_s) -> None:
    """Phase 14: the synchronization atlas and the engine crossover.

    The six §2 models over the atlas's full ladder (every row validated,
    no fit failure), the reference's crossover ladder with the replay
    sweep on the card, the three engines priced per task at the slice's
    size (phase 8's NumPy inline run is read, not run again), and the
    threaded autodec runtime at 33,800 tasks.  No kernel launches here:
    the replay sweep decrements with ``index_add_``."""
    from repro_torch.core.edt import (DeviceExecutor, TiledTaskGraph, atlas,
                                      run_graph_threaded, simulate_indexed)
    from repro_torch.core.poly import Tiling
    from repro_torch.core.programs import PROGRAMS

    t_phase = time.perf_counter()
    # ------------------------------------------------------- the atlas
    t0 = time.perf_counter()
    res = atlas.sweep()
    t_atlas = time.perf_counter() - t0
    if res["fit_failures"]:
        raise AssertionError(f"atlas fit failures: {res['fit_failures']}")
    n_rows = len(res["rows"])
    want_rows = len(atlas.MODELS) * sum(len(w.sizes) + len(atlas.GRAINS) - 1
                                        for w in atlas.WORKLOADS)
    if n_rows != want_rows:
        raise AssertionError(f"atlas: {n_rows} rows, want {want_rows}")
    for model in atlas.MODELS:
        fits = [f for f in res["fits"] if f["model"] == model]
        log(f"phase 14 atlas {model}: " + "; ".join(
            f"{c} " + "/".join(f["cls"] for f in fits if f["counter"] == c)
            + f" (expected {','.join(atlas.EXPECTED[model][c])})"
            for c in atlas.ATLAS_COUNTERS))
    log(f"phase 14 atlas: {n_rows} rows over {len(atlas.WORKLOADS)} "
        f"programs, {len(atlas.MODELS)} models, grains {res['grains']}, "
        f"each validated; fits per program in "
        f"{[w.program for w in atlas.WORKLOADS]}; no fit failure; "
        f"{t_atlas:.3f} s")

    # --------------------------------------------------- the crossover
    # A ladder row is one host timing of 0.7-45 ms, so one run's noise can
    # move a point: the ladder runs CROSSOVER_REPEATS times, and each
    # row's spread and every repeat's points are printed.
    t0 = time.perf_counter()
    runs = []
    for rep in range(CROSSOVER_REPEATS):
        cross = atlas.crossover(
            device=dev, emit=(lambda line: log(f"phase 14 crossover {line}"))
            if rep == 0 else None)
        bad = [r for r in cross["rows"]
               if not r["verified"] or "skipped" in r]
        sizes = list(dict.fromkeys(r["size"] for r in cross["rows"]))
        if bad or len(sizes) != len(atlas.CROSSOVER_SIZES) or len(
                cross["rows"]) != 3 * len(sizes):
            raise AssertionError(f"crossover rows {cross['rows']}")
        runs.append(cross)
    t_cross = time.perf_counter() - t0
    us = collections.defaultdict(list)
    for cross in runs:
        for r in cross["rows"]:
            us[r["size"], r["path"]].append(r["per_task_us"])
    paths = ("host_sim", "device_replay", "distributed_inline_2")
    for size in sizes:
        log(f"phase 14 crossover {size} us a task min/median/max over "
            f"{CROSSOVER_REPEATS}: " + "; ".join(
                f"{p} {min(us[size, p])}/{statistics.median(us[size, p])}"
                f"/{max(us[size, p])}" for p in paths))
    for p in paths[1:]:
        tally = collections.Counter(str(c["points"][p]) for c in runs)
        at_median = next((s for s in sizes if statistics.median(us[s, p])
                          < statistics.median(us[s, "host_sim"])), None)
        log(f"phase 14 crossover point {p}: {dict(tally)} over "
            f"{CROSSOVER_REPEATS} repeats; on the medians {at_median}")
    log(f"phase 14 crossover: {CROSSOVER_REPEATS} x {len(sizes) * 3} rows "
        f"all verified; {t_cross:.3f} s on {card}")

    # ------------------------------------- the three engines per task
    # The slice's row is priced as atlas.crossover prices one size (the
    # Sim on its workers, then the replay cold and warm), though not
    # through it: its ladder is fixed, and it would build this graph again
    # and rerun the two-rank engine that phase 8 timed.  The replay is
    # checked by the card's own violation counters (replay_result raises
    # on any); the order compared is the Sim's against the schedule's
    # levels, which a replay returns.
    n = ig.n
    rex = DeviceExecutor(ig, schedule=sched, device=dev)
    t_sim, t_replay = [], []
    for rep in range(SLICE_PRICE_REPEATS):
        t0 = time.perf_counter()
        sim = simulate_indexed(sched, workers=atlas.CROSSOVER_WORKERS)
        t_sim.append(time.perf_counter() - t0)
        if rep == 0:
            rex.run()                          # cold: the column upload
        t0 = time.perf_counter()
        rrun = rex.run()                       # warm
        t_replay.append(time.perf_counter() - t0)
        if (rrun.counters.tasks_finished != n
                or not np.array_equal(rrun.exec_order, sim.exec_order)):
            raise AssertionError("the Sim's exec_order differs from the "
                                 "replayed schedule's")

    def spread(ts):
        return (f"{'/'.join(f'{1e6 * t / n:.3f}' for t in sorted(ts))} us "
                f"({'/'.join(f'{t:.4f}' for t in sorted(ts))} s)")

    log(f"phase 14 per task at n={n}, sorted over {SLICE_PRICE_REPEATS} "
        f"runs: host Sim ({atlas.CROSSOVER_WORKERS} workers) "
        f"{spread(t_sim)}; warm device replay {spread(t_replay)}, validated "
        f"by the card's violation counters, the Sim's exec_order equal to "
        f"the schedule's; two-rank NumPy inline (phase 8, one run) "
        f"{spread([inline_s])}; on {card}")
    del sim, rex, rrun

    # ------------------------------------------- the threaded runtime
    params = {"T": 16, "N": 128}
    graph = TiledTaskGraph(PROGRAMS["jacobi2d"](),
                           {"S": Tiling(atlas.CROSSOVER_TILES)})
    tig = graph.index_graph(params)
    t0 = time.perf_counter()
    order = run_graph_threaded(graph, params, workers=8, stall_timeout=60.0)
    t_thr = time.perf_counter() - t0
    index = {t: i for i, t in enumerate(tig.tasks)}
    ids = np.asarray([index[t] for t in order], dtype=np.int64)
    if ids.size != tig.n or np.unique(ids).size != tig.n:
        raise AssertionError(f"threaded: {ids.size} runs of {tig.n} tasks, "
                             f"{np.unique(ids).size} distinct")
    pos = np.empty(tig.n, dtype=np.int64)
    pos[ids] = np.arange(tig.n)
    if not (pos[tig.edge_tgt] > pos[tig.edge_src]).all():
        raise AssertionError("threaded: a successor ran before its "
                             "predecessor")
    log(f"phase 14 threaded autodec: {tig.n} tasks, {tig.n_edges} edges, "
        f"8 workers, each task exactly once, every successor after its "
        f"predecessor; {t_thr:.3f} s, {tig.n / t_thr:.0f} tasks/s")
    log(f"phase 14 wall {time.perf_counter() - t_phase:.3f} s")


def check_kernels(dev) -> dict:
    """Phase 9: the three serving kernels against their plain versions on
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
            if case == FLASH_GRANITE and dtype == torch.float32:
                path_err["flash_attention_hm_granite"] = err
            if case == FLASH_WHISPER and dtype == torch.float32:
                path_err["flash_attention_hm_whisper"] = err
            if case == FLASH_INTERNVL and dtype == torch.float32:
                path_err["flash_attention_hm_internvl"] = err
            if case == FLASH_INTERNVL_TP and dtype == torch.float32:
                path_err["flash_attention_hm_internvl_tp"] = err
            if case == FLASH_LLAMA_TP and dtype == torch.float32:
                path_err["flash_attention_hm_llama_tp"] = err
        log(f"phase 9 flash_attention {tname} == plain version at "
            f"{len(FLASH_CASES)} shapes (B,H,Hkv,Sq,Skv,D,causal) "
            f"{FLASH_CASES}: max abs err {[f'{e:.3e}' for e in errs]} "
            f"(tol {KERNEL_TOL[tname]})")
        errs, st_errs = [], []
        # bf16 streams also with an f32 decay, as the RWKV6 layer makes it
        wdtypes = (dtype,) if dtype == torch.float32 else (dtype, torch.float32)
        for case, edge in [(c, False) for c in WKV_CASES] + [(WKV_EDGE, True)]:
            B, S, H, D, with_state = case
            for wdtype in wdtypes:
                r, k, v = (randn(B, S, H, D, dtype=dtype) for _ in range(3))
                w = torch.sigmoid(randn(B, S, H, D) - 1.0)
                if edge:    # channels that forget at once, and never
                    w[..., 0::4], w[..., 1::4] = 0.0, 1.0
                w = w.to(wdtype)
                u = 0.1 * randn(H, D)
                s0 = randn(B, H, D, D) if with_state else None
                out, st = wkv6(r, k, v, w, u, s0)
                torch.cuda.synchronize()
                want, want_st = wkv6_torch(r, k, v, w, u, s0)
                what = f"wkv6 {tname} w {wdtype} {case}{' w 0/1' * edge}"
                err = compare(out, want, KERNEL_TOL[tname], what)
                st_errs.append(compare(st, want_st, STATE_TOL,
                                       what + " state"))
                errs.append(err)
                if not edge and dtype == torch.float32:
                    if case == WKV_PATH:
                        path_err["wkv6"] = err
                    if case == WKV_PREFILL:
                        path_err["wkv6 prefill_step"] = err
                del r, k, v, w, s0, out, st, want, want_st
        log(f"phase 9 wkv6 {tname} == plain version at {len(WKV_CASES)} "
            f"shapes (B,S,H,D,init_state) {WKV_CASES} and {WKV_EDGE} with "
            f"decays of exactly 0 and 1 in half the channels"
            f"{' (w bf16 and f32)' if len(wdtypes) > 1 else ''}: max abs "
            f"err {[f'{e:.3e}' for e in errs]} (tol {KERNEL_TOL[tname]}), "
            f"state {[f'{e:.3e}' for e in st_errs]} (tol {STATE_TOL})")

        def ssd_inputs(B, S, H, P, N, with_state, dt_scale=0.5):
            x = randn(B, S, H, P, dtype=dtype)
            dt = F.softplus(randn(B, S, H)) * dt_scale
            A = -torch.exp(0.2 * randn(H))
            bm, cm = (randn(B, S, N, dtype=dtype) for _ in range(2))
            return x, dt, A, bm, cm, randn(B, H, P, N) if with_state else None

        def plain(x, dt, A, bm, cm, s0=None):
            """The plain version in the kernel's own chunk of 64, a tail
            padded with dt = 0 as the kernel pads it: the same order of
            sums, so held at KERNEL_TOL."""
            S = x.shape[1]
            L = min(SSD_KERNEL_CHUNK, S)
            pad = -S % L
            if pad:
                x, dt, bm, cm = (torch.cat([t, t.new_zeros(
                    (t.shape[0], pad) + t.shape[2:])], 1)
                    for t in (x, dt, bm, cm))
            y, st = ssd_torch(x, dt, A, bm, cm, s0, chunk=L)
            return y[:, :S], st

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
        log(f"phase 9 ssd {tname} == plain version in chunks of "
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
def swapped(obj, name: str, value):
    """``obj.name`` set to ``value`` while inside."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def plain_refused(module, name: str):
    """``module.name`` (a kernel's plain version) raises while inside: a
    main path on CUDA tensors must launch the kernel, never fall back."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} was reached on a CUDA main path")

    return swapped(module, name, refuse)


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
    """Phase 10: llama3.2-1b at full width.  Returns the flash launches of
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
    log(f"phase 10 {LLAMA} ({cfg.n_layers} layers, d {cfg.d_model}, heads "
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
    log(f"phase 10 {serve_line(LLAMA, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward max abs {tf_err:.3e} (tol {MODEL_TOL}); "
        f"sample ids {res.tokens[0, :8].tolist()}")
    decode_profile(build_model(cfg_cuda), params, prompts, LLAMA)
    del params, first, res
    free_model(f"phase 10 {LLAMA}")
    return launches


def rwkv_path(dev) -> dict:
    """Phase 11: rwkv6-1.6b at full width.  Returns the WKV6 launches of
    one ``make_prefill_step`` call and of one serve run (counts set to 0
    just before each)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as wkv6_mod
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = get_config(RWKV)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    gen = torch.Generator(dev).manual_seed(0)
    params = m_cuda.init(gen, torch.float32, dev)

    # ------------------------------------------ make_prefill_step B=2 S=4096
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), device=dev,
                           generator=gen)
    step_cuda = make_prefill_step(m_cuda)
    step_xla = make_prefill_step(m_xla)
    wkv6.launches = 0
    with plain_refused(wkv6_mod, "wkv6_torch"):
        got, t_cuda = timed(lambda: step_cuda(params, {"tokens": tokens}))
    step_launches = wkv6.launches
    if step_launches != cfg.n_layers:
        raise AssertionError(f"{step_launches} wkv6 launches in a prefill "
                             f"step of {cfg.n_layers} layers")
    # the plain route walks 4,096 steps a layer from the host: one run
    want, t_xla = timed(lambda: step_xla(params, {"tokens": tokens}))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"rwkv prefill cuda vs xla: {m}")
    del got, want
    _, t_cuda_warm = timed(lambda: step_cuda(params, {"tokens": tokens}))
    wall, busy, count, top = device_profile(
        lambda: step_cuda(params, {"tokens": tokens}))
    log(f"profile {RWKV} make_prefill_step cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    log(f"phase 11 {RWKV} make_prefill_step B={PREFILL_B} S={PREFILL_S}: "
        f"{step_launches} wkv6 launches; last-position logits cuda vs xla "
        f"max abs {err:.3e} (tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} "
        f"ms cuda (first run {t_cuda * 1e3:.1f} ms), {t_xla * 1e3:.1f} ms "
        f"xla, {PREFILL_B * PREFILL_S / t_cuda_warm:.0f} tok/s")
    del tokens
    free_model(f"phase 11 {RWKV} prefill step")

    # ------------------------------------ serve B=4, prompt 512, 32 tokens
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
    log(f"phase 11 {RWKV} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv.head_dim} heads of {cfg.rwkv.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, f32): {launches} wkv6 "
        f"launches in a serve run; prefill logits cuda vs xla max abs "
        f"{err:.3e} (tol {MODEL_TOL}), all {cfg.n_layers} final wkv states "
        f"max abs {st_err:.3e} (tol {STATE_TOL}); prefill with "
        f"cache {t_c * 1e3:.1f} ms cuda, {t_x * 1e3:.1f} ms xla")
    log(f"phase 11 {serve_line(RWKV, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward max abs {tf_err:.3e} (tol {MODEL_TOL}); "
        f"sample ids {res.tokens[0, :8].tolist()}")
    wall, busy, count, top = device_profile(lambda: prefill(m_cuda))
    log(f"profile {RWKV} prefill with cache, cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    decode_profile(m_cuda, params, prompts, RWKV)
    del params, first, res
    free_model(f"phase 11 {RWKV}")
    return {"prefill_step": step_launches, "serve": launches}


def zamba_path(dev) -> dict:
    """Phase 13: zamba2-7b at full width and depth.  Returns the SSD
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
    log(f"phase 13 {ZAMBA}: {n_params} f32 parameters "
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
    log(f"phase 13 {ZAMBA} make_prefill_step B={PREFILL_B} S={PREFILL_S}: "
        f"{step_launches} ssd launches; last-position logits cuda vs xla max "
        f"abs {err:.3e} (tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} ms "
        f"cuda, {t_xla_warm * 1e3:.1f} ms xla (first runs "
        f"{t_cuda * 1e3:.1f} / {t_xla * 1e3:.1f} ms), "
        f"{PREFILL_B * PREFILL_S / t_cuda_warm:.0f} tok/s")
    del tokens
    free_model(f"phase 13 {ZAMBA} prefill step")

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
    log(f"phase 13 {ZAMBA}: {serve_launches} ssd launches in a serve run; "
        f"prefill logits cuda vs xla max abs {err:.3e} (tol {MODEL_TOL}), "
        f"all {n_ssm} final ssm states max abs {st_err:.3e} (tol "
        f"{STATE_TOL}), conv caches {conv_err:.3e}; prefill with cache "
        f"{t_c * 1e3:.1f} ms cuda, {t_x * 1e3:.1f} ms xla")
    log(f"phase 13 {serve_line(ZAMBA, res, first.prefill_s)}; teacher-forced "
        f"decode vs full forward ({SERVE_LP + SERVE_G - 1} tokens, dt=0 "
        f"padding) max abs {tf_err:.3e} (tol {MODEL_TOL}); sample ids "
        f"{res.tokens[0, :8].tolist()}")
    decode_profile(m_cuda, params, prompts, ZAMBA)
    del first, res, prompts
    free_model(f"phase 13 {ZAMBA} serve")

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
    log(f"phase 13 {serve_line(ZAMBA + ' ring', ring_res, ring_res.prefill_s, RING_B, W)}"
        f"; {n_attn} ring caches of {W} slots, decode wrapping from its "
        f"first step; teacher-forced decode vs full windowed forward "
        f"({W + SERVE_G - 1} tokens) max abs {tf_ring:.3e} (tol "
        f"{MODEL_TOL}), all logits finite")
    del params, ring_res, prompts
    free_model(f"phase 13 {ZAMBA}")
    return {"prefill_step": step_launches, "serve": serve_launches}


# ------------------------------------------------------ the training path
TRAIN_FAMILIES = (LLAMA, RWKV, ZAMBA)
TRAIN_TINY_B, TRAIN_TINY_S, TRAIN_TINY_STEPS = 4, 64, 3
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 20   # llama3.2-1b at full width
TRAIN_SPLIT_STEPS = 3                   # forward+backward vs update, apart
#: CUDA against the CPU at tiny width: the same f32 steps (TF32 off),
#: summed in other orders (the card's embedding backward adds with atomics)
TRAIN_TOL = 1e-4
#: the AdamW state after those steps, leaf by leaf: the relative L2 gap
#: ||card - cpu|| / ||cpu|| of each moment leaf and of each param leaf's
#: update p - p0, by microbatches.  In the norm, as Adam's m / sqrt(v)
#: turns the summation noise of a gradient near zero into a change of up
#: to lr in that one element, and bf16 sums (microbatches 2) move an
#: element by its last bit.  Measured on the H100 (PR 23): moments at most
#: 2.6e-5 / 2.4e-3, updates 9.7e-4 / 3.0e-3 (microbatches 1 / 2); a fault
#: in a leaf's gradient or update moves its gap to order 1
TRAIN_STATE_RTOL = {1: {"moments": 2e-4, "updates": 1e-2},
                    2: {"moments": 2e-2, "updates": 3e-2}}


def tree_to(tree, dev):
    """A copy of a dict of tensors on ``dev``."""
    from repro_torch.tree import leaves, rebuild

    return rebuild(tree, [t.detach().to(dev, copy=True) for t in leaves(tree)])


def train_state_gap(got, want, start, rtol: dict, label: str) -> dict:
    """The params and AdamW state ``got`` on the card against ``want`` on
    the CPU, both reached from the params ``start``: each moment leaf and
    each param leaf's update within ``rtol["moments"]`` and
    ``rtol["updates"]`` in the relative L2 norm, the int32 step equal.
    Returns the worst gap for the params and each moment field."""
    import torch

    from repro_torch.optim import _zip

    (gp, gs), (wp, ws) = got, want
    if int(gs["step"]) != int(ws["step"]):
        raise AssertionError(f"phase 17 {label}: step {int(gs['step'])} "
                             f"on the card, {int(ws['step'])} on the cpu")
    worst = {}
    for p0, gleaf, wleaf, gmv, wmv in _zip(start, gp, wp, gs["mv"],
                                           ws["mv"]):
        p0 = p0.double()
        pairs = [("params", gleaf.detach().cpu().double() - p0,
                  wleaf.detach().double() - p0)]
        pairs += [(kind, a.detach().cpu().double(), b.detach().double())
                  for kind, a, b in zip(gmv._fields, gmv, wmv)
                  if b is not None]
        for kind, a, b in pairs:
            gap = float(torch.linalg.vector_norm(a - b))
            norm = float(torch.linalg.vector_norm(b))
            rel = gap / norm if norm > 0 else 0.0 if gap == 0 else np.inf
            tol = rtol["updates" if kind == "params" else "moments"]
            if not bool(torch.isfinite(a).all()) or not rel <= tol:
                raise AssertionError(
                    f"phase 17 {label}: a {kind} leaf {tuple(a.shape)} "
                    f"differs by {rel:.3e} of its norm (rtol {tol})")
            worst[kind] = max(worst.get(kind, 0.0), rel)
    return {k: float(f"{v:.2e}") for k, v in worst.items()}


def tiny_training(dev) -> None:
    """Phase 17, tiny width: each family's reference ``--width tiny`` config,
    3 steps of ``make_train_step`` on the card against the same steps on
    the CPU (and with ``microbatches=2``), then the kernel routes refusing
    grad mode on CUDA tensors."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves

    cpu = torch.device("cpu")
    # warmup 1: every step's update moves the next loss at the full lr
    opt_cfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=TRAIN_STEPS)
    for name in TRAIN_FAMILIES:
        cfg = tiny_config(get_config(name))
        model = build_model(cfg)
        seed_params = model.init(torch.Generator().manual_seed(0),
                                 torch.float32, cpu)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_TINY_S,
                          global_batch=TRAIN_TINY_B)
        worst, state_worst = {}, {}
        for mb in (1, 2):
            losses, finals = {}, {}
            for key, d in (("card", dev), ("cpu", cpu)):
                params = tree_to(seed_params, d)
                state = init_state(opt_cfg, params)
                step = make_train_step(model, opt_cfg, microbatches=mb)
                src = SyntheticLM(dcfg, device=d)
                losses[key] = [float(step(params, state, src.batch_at(i))[2])
                               for i in range(TRAIN_TINY_STEPS)]
                finals[key] = (params, state)
            got, want = losses["card"], losses["cpu"]
            if not all(np.isfinite(got)) or not np.allclose(
                    got, want, rtol=TRAIN_TOL, atol=0):
                raise AssertionError(f"phase 17 {name} tiny, microbatches "
                                     f"{mb}: cuda losses {got}, cpu {want}")
            worst[mb] = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            state_worst[mb] = train_state_gap(
                finals["card"], finals["cpu"], seed_params,
                TRAIN_STATE_RTOL[mb], f"{name} tiny, microbatches {mb}")
            first = got
        log(f"phase 17 {name} tiny (d {cfg.d_model}, {cfg.n_layers} layers, "
            f"vocab {cfg.vocab}, B={TRAIN_TINY_B} S={TRAIN_TINY_S}, lr "
            f"{opt_cfg.lr} warmup {opt_cfg.warmup}): {TRAIN_TINY_STEPS} "
            f"steps cuda vs cpu, losses {first} (last run, microbatches 2), "
            f"max rel diff {worst[1]:.2e} (microbatches 1), {worst[2]:.2e} "
            f"(2); rtol {TRAIN_TOL}; after the steps, the worst relative "
            f"L2 gap of a leaf's update and moments: microbatches 1 "
            f"{state_worst[1]}, 2 {state_worst[2]} (rtol "
            f"{TRAIN_STATE_RTOL})")

        # the kernel routes refuse grad mode on CUDA tensors
        kmodel = build_model(cfg.replace(attn_impl="cuda"))
        params = tree_to(seed_params, dev)
        S = 128 if name == LLAMA else 64
        tokens = torch.randint(0, cfg.vocab, (2, S), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        for p in leaves(params):
            p.requires_grad_(True)
        before = (flash_attention_hm.launches, wkv6.launches, ssd.launches)
        try:
            kmodel.loss(params, {"tokens": tokens, "labels": tokens})
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused = str(e).split(":")[0]
        else:
            raise AssertionError(f"{name}: a kernel route ran with grad on")
        if (flash_attention_hm.launches, wkv6.launches,
                ssd.launches) != before:
            raise AssertionError(f"{name}: a kernel launched with grad on")
        log(f"phase 17 {name} attn_impl=cuda with grad on: {refused} refused "
            f"on CUDA tensors, no launch")


def timing_wrapped(obj, name: str, record: list):
    """``obj.name`` wrapped to append each call's host seconds to
    ``record`` while inside."""
    saved = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return saved(*args, **kwargs)
        finally:
            record.append(time.perf_counter() - t0)

    return swapped(obj, name, wrapped)


def train_profile(fn):
    """``(wall s, device-busy s, kernels, GEMM s, top 8 kernels)`` of one
    call under ``torch.profiler``; a GEMM is a kernel whose name holds
    ``gemm`` (cuBLAS's and CUTLASS's names do)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            us[e.name[:60]] += e.time_range.elapsed_us()
            n[e.name[:60]] += 1
    busy = sum(us.values()) / 1e6
    gemm = sum(v for k, v in us.items() if "gemm" in k.lower()) / 1e6
    top = [(k, round(v / 1e3, 3), n[k]) for k, v in us.most_common(8)]
    return wall, busy, sum(n.values()), gemm, top


def train_path(dev, card) -> None:
    """Phase 17: the training path (``launch/train.py``, the driver, the
    loss, AdamW, data and checkpoints).  No kernel is on it: the
    reference trains on its plain route."""
    import shutil
    import tempfile

    import torch

    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.runtime import DriverConfig, TrainDriver
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    tiny_training(dev)

    # ---------- llama3.2-1b at full width: what `train --width full` builds
    cfg = get_config(LLAMA)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)

    def init_fn():
        params = model.init(torch.Generator(dev).manual_seed(0),
                            torch.float32, dev)
        return params, init_state(opt_cfg, params)

    train_step = make_train_step(model, opt_cfg)
    step_s, kept = [], {}

    def step(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        kept["state"] = out
        return out

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                          global_batch=TRAIN_B)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    n_params = sum(t.numel() for t in leaves(
        model.init(torch.Generator(), torch.float32, "meta")))
    ckpt_bytes_want = 12 * n_params          # params and two f32 moments
    free = shutil.disk_usage(build).free
    if free < 1.2 * ckpt_bytes_want:
        raise AssertionError(f"phase 17: {free} bytes free under {build}, "
                             f"the full-width checkpoint needs about "
                             f"{ckpt_bytes_want}")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build, prefix="train_ckpt_") as tmp:
        driver = TrainDriver(
            DriverConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                         ckpt_dir=tmp), data_cfg, step, init_fn)
        snap_s, write_s = [], []
        t0 = time.perf_counter()
        with timing_wrapped(checkpoint.AsyncCheckpointer, "submit", snap_s), \
                timing_wrapped(checkpoint, "save_sync", write_s):
            hist = driver.run()
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [h.loss for h in hist]
        if [h.step for h in hist] != list(range(TRAIN_STEPS)) or not all(
                np.isfinite(losses)) or driver.restarts:
            raise AssertionError(f"phase 17 {LLAMA} full: steps "
                                 f"{[h.step for h in hist]}, losses {losses}")
        first, last5 = losses[0], sum(losses[-5:]) / 5
        if not last5 < first:
            raise AssertionError(f"phase 17 {LLAMA} full: loss did not go "
                                 f"down: {losses}")
        if checkpoint.latest_step(tmp) != TRAIN_STEPS - 1 or len(
                write_s) != 1 or len(snap_s) != 1:
            raise AssertionError(f"phase 17: checkpoints {write_s}, latest "
                                 f"{checkpoint.latest_step(tmp)}")
        ck = Path(tmp) / f"step_{TRAIN_STEPS - 1:08d}"
        ck_bytes = sum(f.stat().st_size for f in ck.iterdir())
        ms = statistics.median(step_s[1:]) * 1e3
        flop = 8 * n_params * TRAIN_B * TRAIN_S  # 6 N T, and remat's forward
        log(f"phase 17 {LLAMA} full width ({n_params} f32 parameters, "
            f"B={TRAIN_B} S={TRAIN_S}, remat, AdamW lr 1e-3 warmup 20): "
            f"{TRAIN_STEPS} driver steps in {t_run:.3f} s; loss {first:.4f} "
            f"-> {last5:.4f} (mean of the last five; each step {losses}); "
            f"step median of steps 2-{TRAIN_STEPS} {ms:.2f} ms (first "
            f"{step_s[0] * 1e3:.1f} ms, min {min(step_s[1:]) * 1e3:.2f}, max "
            f"{max(step_s[1:]) * 1e3:.2f}), {TRAIN_B * TRAIN_S / ms * 1e3:.0f}"
            f" tokens/s, {flop / (ms / 1e3) / 1e12:.1f} TFLOP/s of 8 N T; "
            f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) on "
            f"{card}")
        log(f"phase 17 checkpoint at step {TRAIN_STEPS - 1}: {ck_bytes} bytes "
            f"in {len(list(ck.glob('arr_*.npy')))} files; snapshot (device "
            f"to host) {snap_s[0]:.3f} s, write {write_s[0]:.3f} s "
            f"({ck_bytes / write_s[0] / 1e9:.2f} GB/s), free under build/ "
            f"{free} bytes before")

        params, opt_state, _ = kept.pop("state")
        target = dict(zip(("params", "opt"), init_fn()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpoint.restore(tmp, TRAIN_STEPS - 1, target)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        del target
        want = leaves({"params": params, "opt": opt_state})
        got = leaves(restored)
        if len(got) != len(want) or not all(
                a.device.type == dev.type and a.dtype == b.dtype
                and torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("phase 17: the restored checkpoint differs "
                                 "from the final state")
        log(f"phase 17 restore of step {TRAIN_STEPS - 1} onto the card: "
            f"{len(got)} leaves bit-identical to the final params and "
            f"moments in {t_restore:.3f} s ({ck_bytes / t_restore / 1e9:.2f} "
            f"GB/s; the files just written, so the read was warm)")
        del restored, got, want

    # ------ forward+backward and the optimizer update, timed apart
    src = SyntheticLM(data_cfg, device=dev)
    fb, upd = [], []
    for i in range(TRAIN_SPLIT_STEPS):
        batch = src.batch_at(TRAIN_STEPS + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        apply_updates(opt_cfg, params, grads, opt_state)
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        upd.append(time.perf_counter() - t1)
        del grads
    log(f"phase 17 {LLAMA} full width, {TRAIN_SPLIT_STEPS} steps apart: "
        f"forward+backward {[round(t * 1e3, 2) for t in fb]} ms, AdamW "
        f"update {[round(t * 1e3, 2) for t in upd]} ms "
        f"(median {statistics.median(fb) * 1e3:.2f} / "
        f"{statistics.median(upd) * 1e3:.2f} ms; loss {float(loss):.4f})")
    batch = src.batch_at(TRAIN_STEPS + TRAIN_SPLIT_STEPS)
    wall, busy, count, gemm, top = train_profile(
        lambda: apply_updates(opt_cfg, params,
                              value_and_grad(model, params, batch)[1],
                              opt_state))
    log(f"profile {LLAMA} full-width train step (forward+backward and the "
        f"AdamW update): wall {wall * 1e3:.1f} ms under the profiler, device "
        f"busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%) in {count} "
        f"kernels; GEMM kernels {gemm * 1e3:.1f} ms ({100 * gemm / busy:.1f}% "
        f"of busy); top (name, ms, launches): {top}")
    del params, opt_state, kept, loss, batch
    free_model(f"phase 17 {LLAMA} full width")

    # ------------------------------------------------- the CLI, tiny width
    with tempfile.TemporaryDirectory(dir=build, prefix="train_cli_") as tmp:
        t0 = time.perf_counter()
        if train.main(["--arch", LLAMA, "--width", "tiny", "--steps", "12",
                       "--ckpt-every", "6", "--ckpt-dir", tmp,
                       "--device", dev.type]) != 0:
            raise AssertionError("launch.train.main failed")
        log(f"phase 17 python -m repro_torch.launch.train --arch {LLAMA} "
            f"--width tiny --steps 12 on the card: {time.perf_counter() - t0:.3f}"
            f" s, latest checkpoint {checkpoint.latest_step(tmp)}")

    # ---------------------------- restart drill: a fault before step 9
    tcfg = train.tiny_config(get_config(LLAMA))
    tmodel = build_model(tcfg)
    topt = AdamWConfig(lr=1e-2, warmup=2, total_steps=12)

    def tiny_init():
        params = tmodel.init(torch.Generator(dev).manual_seed(0),
                             torch.float32, dev)
        return params, init_state(topt, params)

    fired = []

    def fault(step_i):
        if step_i == 9 and not fired:
            fired.append(step_i)
            raise RuntimeError("injected node failure")

    with tempfile.TemporaryDirectory(dir=build, prefix="train_drill_") as tmp:
        drv = TrainDriver(DriverConfig(total_steps=12, ckpt_every=4,
                                       ckpt_dir=tmp, max_restarts=3),
                          DataConfig(vocab=tcfg.vocab, seq_len=64,
                                     global_batch=4),
                          make_train_step(tmodel, topt), tiny_init,
                          fault_hook=fault)
        hist = drv.run()
        steps = [h.step for h in hist]
        l8 = [h.loss for h in hist if h.step == 8]
        latest = checkpoint.latest_step(tmp)
        if drv.restarts != 1 or steps.count(8) != 2 or steps.count(9) != 1 \
                or steps[-1] != 11 or abs(l8[0] - l8[1]) >= 1e-6 \
                or latest != 11:
            raise AssertionError(f"phase 17 restart drill: restarts "
                                 f"{drv.restarts}, steps {steps}, step 8 "
                                 f"losses {l8}, latest {latest}")
    log(f"phase 17 restart drill ({LLAMA} tiny, 12 steps, checkpoints every "
        f"4, a fault before step 9): 1 restart from step 7, steps {steps}, "
        f"step 8 losses {l8[0]!r} and {l8[1]!r}, latest step {latest}")
    log(f"phase 17 wall {time.perf_counter() - t_phase:.3f} s")


# ------------------------------------------------ phase 18: MoE and MLA
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v3-671b"
GRANITE_PARAMS = 1_334_578_176
#: deepseek-v3-671b with every width as published and its depth cut to
#: its first (dense) layer and one MoE layer: 61 layers of f32 weights
#: are 2.7 TB; these two are 55.8 GB of the card's 80 GB
DEEPSEEK_CUT = dict(n_layers=2, n_dense_layers=1)
DEEPSEEK_PARAMS = 13_944_094_720
#: one MoE layer and one MLA layer on the card against the same code on
#: the CPU, at this many tokens (B=1), both in f32 from the same params:
#: the CPU tests' tolerance for a function's output
LAYER_T = 512
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


@contextlib.contextmanager
def routing_recorded(record: list):
    """Each MoE layer's top-k expert ids (``layers.route``), one
    ``[tokens, k]`` tensor a call, appended to ``record`` while inside."""
    from repro_torch.models import layers

    route = layers.route

    def recorded(router, xt, k):
        gate, idx = route(router, xt, k)
        record.append(idx.reshape(-1, k).clone())
        return gate, idx

    with swapped(layers, "route", recorded):
        yield


def expert_sets_differ(a: list, b: list) -> list:
    """Per MoE call, the tokens whose set of top-k experts differs."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b, strict=True)]


def moe_classes(cfg, T: int):
    """A ``device_profile`` classifier of a MoE model's kernels at ``T``
    tokens, by the outermost ``aten::bmm`` or ``aten::mm`` around the op.
    A ``bmm`` is classed by its shape: the grouped dispatch's one-hot
    dispatch (batch G, contraction Tg) and combine (G, E·C) einsums and
    its routing one-hots (G·Tg, top-k), the expert GEMMs (batch E over
    d_model and d_ff_expert), or another ``bmm`` (attention's); an ``mm``
    is one of the ``x @ W`` GEMMs; every other kernel is in "rest"."""
    from repro_torch.models.layers import moe_groups

    mo = cfg.moe
    G, Tg, C = moe_groups(cfg, T)
    classes = {(G, Tg): "one-hot dispatch einsum",
               (G, mo.n_experts * C): "one-hot combine einsum",
               (G * Tg, mo.top_k): "routing one-hots"}
    expert = {cfg.d_model, mo.d_ff_expert}

    def label(op):
        outer = [a for a in op_chain(op)
                 if a.name in ("aten::bmm", "aten::mm")]
        if not outer:
            return "rest"
        if outer[-1].name == "aten::mm":
            return "x @ W GEMMs"
        (b, _, k), (_, _, n) = outer[-1].input_shapes[:2]
        if b == mo.n_experts and {k, n} == expert:
            return "expert GEMMs"
        return classes.get((b, k), "other bmm")

    return label


def einsum_ms(dev, cfg, T: int) -> dict:
    """Device ms of one MoE layer's one-hot dispatch and combine einsums
    and its three expert GEMMs at ``T`` tokens (``moe_einsum_apply``'s
    shapes and einsum strings, f32, CUDA events)."""
    import torch

    from repro_torch.models.layers import moe_groups

    mo = cfg.moe
    G, Tg, C = moe_groups(cfg, T)
    E, d, f = mo.n_experts, cfg.d_model, mo.d_ff_expert
    gen = torch.Generator(dev).manual_seed(9)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    xt, disp, comb = rand(G, Tg, d), rand(G, Tg, E, C), rand(G, Tg, E, C)
    xe, h = rand(G, E, C, d), rand(G, E, C, f)
    wg, wd = rand(E, d, f), rand(E, f, d)
    return {
        "dispatch": event_ms(lambda: torch.einsum("gtd,gtec->gecd", xt, disp),
                             reps=7, inner=5),
        "combine": event_ms(lambda: torch.einsum("gecd,gtec->gtd", xe, comb),
                            reps=7, inner=5),
        "experts": 2 * event_ms(lambda: torch.einsum("gecd,edf->gecf", xe,
                                                     wg), reps=7, inner=5)
        + event_ms(lambda: torch.einsum("gecf,efd->gecd", h, wd), reps=7,
                   inner=5),
    }


def profile_line(label: str, prof) -> str:
    wall, busy, count, top, split = prof
    return (f"profile {label}: wall {wall * 1e3:.1f} ms under the profiler, "
            f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%) in "
            f"{count} kernels; device ms by product: {split}; top (name, "
            f"ms): {top}")


def check_generated(res, vocab: int, label: str) -> None:
    import torch

    logits = torch.stack(res.logits, dim=1)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite serve logits")
    if not bool(((res.tokens >= 0) & (res.tokens < vocab)).all()):
        raise AssertionError(f"{label}: generated ids outside the vocabulary")
    if tuple(res.tokens.shape) != (SERVE_B, SERVE_G):
        raise AssertionError(f"{label}: generated {tuple(res.tokens.shape)}")


def layer_vs_cpu(fn, p, p_cpu, x, label: str) -> float:
    """``fn(p, x)`` on the card against ``fn(p_cpu, x)`` on the CPU (the
    same code; ``p_cpu`` a copy of ``p``), within ``LAYER_TOL``; the top-k
    expert sets of any MoE call must agree.  Returns the max abs
    difference."""
    import torch

    routes = {"card": [], "cpu": []}
    with routing_recorded(routes["card"]):
        got = fn(p, x).cpu()
    with routing_recorded(routes["cpu"]):
        want = fn(p_cpu, x.cpu())
    differ = expert_sets_differ([r.cpu() for r in routes["card"]],
                                routes["cpu"])
    if any(differ):
        raise AssertionError(f"{label}: top-k experts differ between card "
                             f"and CPU for {differ} tokens")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **LAYER_TOL,
                               msg=lambda m: f"{label} card vs CPU: {m}")
    return err


def flash_at(dev, cfg, label: str) -> dict:
    """The flash kernel at a model's prefill-step shape (f32, causal): its
    time (warm and with L2 flushed), the plain version's,
    ``scaled_dot_product_attention``'s and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (cost,
                                                     flash_attention_hm,
                                                     flash_attention_hm_torch)

    gen = torch.Generator(dev).manual_seed(8)
    B, H, Hkv, S, D = (PREFILL_B, cfg.n_heads, cfg.n_kv_heads, PREFILL_S,
                       cfg.hd())
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev)
            for _ in range(2))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    rec = {
        "shape": f"q {list(q.shape)} k/v {list(k.shape)} f32 causal",
        "ms": event_ms(lambda: flash_attention_hm(q, k, v), reps=7, inner=5),
        "ms_cold_l2": event_ms(lambda: flash_attention_hm(q, k, v),
                               flush=flush, reps=7, inner=5),
        "plain_ms": event_ms(lambda: flash_attention_hm_torch(q, k, v),
                             reps=5, inner=2),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=7, inner=5),
    }
    del flush
    work = cost(q.shape, k.shape)                   # causal, f32
    flops, nbytes = work["flops"], work["bytes"]
    ops_s, bytes_s = flops / TF32X3_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    rec.update(flops=flops, bytes=nbytes,
               bound_ms=max(ops_s, bytes_s) * 1e3,
               bound_by="operations" if ops_s >= bytes_s else "bytes")
    log(f"{label} flash_attention_hm at {cfg.name}'s shape ({rec['shape']}):"
        f" kernel {rec['ms']:.4f} ms (cold L2 {rec['ms_cold_l2']:.4f} ms), "
        f"plain {rec['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention f32 {rec['library_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({flops} flop at 165 TFLOP/s "
        f"(3xTF32): {ops_s * 1e3:.4f} ms; {nbytes} bytes at 3.35 TB/s: "
        f"{bytes_s * 1e3:.4f} ms)")
    return rec


def granite_path(dev) -> tuple[int, dict]:
    """Phase 18, granite-moe-1b-a400m at full width and depth (every layer
    MoE, the grouped einsum dispatch).  Returns the flash launches of one
    ``make_prefill_step`` call (counts set to 0 just before it) and the
    flash kernel's record at its shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, layers, transformer
    from repro_torch.tree import leaves

    cfg = get_config(GRANITE)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    gen = torch.Generator(dev).manual_seed(0)
    params = m_cuda.init(gen, torch.float32, dev)
    n_params = sum(t.numel() for t in leaves(params))   # norms too
    if cfg.n_params() != GRANITE_PARAMS:
        raise AssertionError(f"{GRANITE}: {cfg.n_params()} parameters")

    # ------------------------------------------ make_prefill_step B=2 S=4096
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), device=dev,
                           generator=gen)
    step_cuda, step_xla = make_prefill_step(m_cuda), make_prefill_step(m_xla)
    routes = {"cuda": [], "xla": []}
    flash_attention_hm.launches = 0
    with plain_refused(fa_mod, "flash_attention_hm_torch"), \
            routing_recorded(routes["cuda"]):
        got, t_cuda = timed(lambda: step_cuda(params, {"tokens": tokens}))
    launches = flash_attention_hm.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches in a prefill step "
                             f"of {cfg.n_layers} layers")
    with routing_recorded(routes["xla"]):
        want, t_xla = timed(lambda: step_xla(params, {"tokens": tokens}))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    differ = expert_sets_differ(routes["cuda"], routes["xla"])
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **MODEL_TOL):
        log(f"phase 18 {GRANITE} prefill step cuda vs xla: max abs {err:.3e}"
            f" over {MODEL_TOL}; tokens whose top-k experts differ between "
            f"the routes, layer by layer: {differ}")
    torch.testing.assert_close(
        got, want, **MODEL_TOL,
        msg=lambda m: f"{GRANITE} prefill cuda vs xla: {m}")
    del got, want
    _, t_cuda_warm = timed(lambda: step_cuda(params, {"tokens": tokens}))
    _, t_xla_warm = timed(lambda: step_xla(params, {"tokens": tokens}))
    T = PREFILL_B * PREFILL_S
    prof = device_profile(lambda: step_cuda(params, {"tokens": tokens}),
                          moe_classes(cfg, T))
    log(profile_line(f"{GRANITE} make_prefill_step cuda", prof))
    layer = einsum_ms(dev, cfg, T)
    G, Tg, C = layers.moe_groups(cfg, T)
    log(f"phase 18 {GRANITE} one MoE layer's products at the prefill step's "
        f"shapes (G={G} Tg={Tg} E={cfg.moe.n_experts} C={C}), CUDA events, "
        f"ms: "
        f"{ {k: round(v, 4) for k, v in layer.items()} }; x {cfg.n_layers} "
        f"layers: dispatch + combine {cfg.n_layers * (layer['dispatch'] + layer['combine']):.1f} "
        f"ms, experts {cfg.n_layers * layer['experts']:.1f} ms, of "
        f"{prof[1] * 1e3:.1f} ms device busy")
    log(f"phase 18 {GRANITE} ({cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff_expert}, vocab {cfg.vocab}, "
        f"{n_params} f32 parameters) make_prefill_step B={PREFILL_B} "
        f"S={PREFILL_S}: {launches} flash launches; last-position logits "
        f"cuda vs xla max abs {err:.3e} (tol {MODEL_TOL}); tokens whose "
        f"top-k experts differ between the routes, layer by layer: {differ};"
        f" step {t_cuda_warm * 1e3:.1f} ms cuda, {t_xla_warm * 1e3:.1f} ms "
        f"xla (first runs {t_cuda * 1e3:.1f} / {t_xla * 1e3:.1f} ms), "
        f"{T / t_cuda_warm:.0f} tok/s")
    del tokens
    free_model(f"phase 18 {GRANITE} prefill step")
    flash = flash_at(dev, cfg, "phase 18")

    # ------------------------------------ serve B=4, prompt 512, 32 tokens
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts)
    res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                prompts=prompts)
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")
    check_generated(res, cfg.vocab, GRANITE)
    log(f"phase 18 {serve_line(GRANITE, res, first.prefill_s)}; sample ids "
        f"{res.tokens[0, :8].tolist()}")
    decode_profile(m_cuda, params, prompts, GRANITE)

    # ------------------------------ one MoE layer, card against the CPU
    x = torch.randn((1, LAYER_T, cfg.d_model), generator=gen, device=dev)
    p_moe = transformer.layer(params["moe_layers"], 0)["moe"]
    err = layer_vs_cpu(lambda p, x: layers.moe_einsum_apply(p, x, cfg),
                       p_moe, tree_to(p_moe, "cpu"), x,
                       f"{GRANITE} MoE layer 0")
    log(f"phase 18 {GRANITE} MoE layer 0 (einsum dispatch, T={LAYER_T}) on "
        f"the card vs the CPU: top-k experts identical, max abs {err:.3e} "
        f"(tol {LAYER_TOL})")
    del params, first, res, p_moe
    free_model(f"phase 18 {GRANITE}")
    return launches, flash


def deepseek_path(dev) -> None:
    """Phase 18, deepseek-v3-671b at full width, two layers (one dense, one
    MoE): the prefill step through the expert-parallel form, the serve loop
    through the einsum dispatch and the absorbed MLA decode, held against
    the materialised decode; one MLA and one MoE layer (both forms)
    against the CPU."""
    import functools

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, layers, transformer
    from repro_torch.tree import leaves

    cfg = get_config(DEEPSEEK).replace(**DEEPSEEK_CUT, attn_impl="cuda")
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, torch.float32, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))   # norms too
    if cfg.n_params() != DEEPSEEK_PARAMS:
        raise AssertionError(f"{DEEPSEEK}: {cfg.n_params()} parameters")
    weights = torch.cuda.memory_allocated()

    # ------------------------------------------ make_prefill_step B=2 S=4096
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), device=dev,
                           generator=gen)
    step = make_prefill_step(model)
    forms = {"ep": [], "einsum": []}
    torch.cuda.reset_peak_memory_stats()
    flash_attention_hm.launches = 0
    with timing_wrapped(transformer, "moe_ep_apply", forms["ep"]), \
            timing_wrapped(transformer, "moe_einsum_apply", forms["einsum"]):
        got, t_first = timed(lambda: step(params, {"tokens": tokens}))
    peak = torch.cuda.max_memory_allocated()
    if (len(forms["ep"]), len(forms["einsum"])) != (1, 0):
        raise AssertionError(f"prefill step MoE forms {forms}: want one "
                             f"moe_ep_apply")
    if flash_attention_hm.launches:
        raise AssertionError("MLA's head dims reached the flash kernel")
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    del got
    _, t_warm = timed(lambda: step(params, {"tokens": tokens}))
    T = PREFILL_B * PREFILL_S
    log(profile_line(f"{DEEPSEEK} make_prefill_step", device_profile(
        lambda: step(params, {"tokens": tokens}), moe_classes(cfg, T))))
    log(f"phase 18 {DEEPSEEK} cut to {cfg.n_layers} layers ({cfg.n_dense_layers}"
        f" dense; d {cfg.d_model}, {cfg.n_heads} MLA heads, q/kv rank "
        f"{cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}, {cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k} + {cfg.moe.n_shared} shared, dense d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {cfg.n_params()} f32 parameters, "
        f"{n_params} with the norms, "
        f"{weights} bytes on the card, drawn in {t_init:.3f} s) "
        f"make_prefill_step B={PREFILL_B} S={PREFILL_S}: moe_ep_apply "
        f"{len(forms['ep'])} call ({forms['ep'][0] * 1e3:.1f} ms host clock, "
        f"first run), no flash launch (MLA's q/k head dim "
        f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim} against v's "
        f"{cfg.mla.v_head_dim}: the plain route); step {t_warm * 1e3:.1f} ms "
        f"(first run {t_first * 1e3:.1f} ms), {T / t_warm:.0f} tok/s; peak "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    del tokens
    free_model(f"phase 18 {DEEPSEEK} prefill step")

    # ------------------------------------ serve B=4, prompt 512, 32 tokens
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    first = serve(cfg, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts)
    forms = {"ep": [], "einsum": []}
    with timing_wrapped(transformer, "moe_ep_apply", forms["ep"]), \
            timing_wrapped(transformer, "moe_einsum_apply", forms["einsum"]):
        res = serve(cfg, gen=SERVE_G, device=dev, params=params,
                    prompts=prompts)
    if (len(forms["ep"]), len(forms["einsum"])) != (0, SERVE_G):
        raise AssertionError(f"serve MoE forms {forms}: want {SERVE_G} "
                             f"einsum dispatches")
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")
    check_generated(res, cfg.vocab, DEEPSEEK)

    # the materialised decode on the absorbed run's tokens, step by step
    materialised = functools.partial(layers.mla_apply, absorbed_decode=False)
    with swapped(transformer, "mla_apply", materialised):
        caches = model.init_cache(SERVE_B, SERVE_LP + SERVE_G + 1,
                                  torch.float32, dev)
        logits, caches = model.forward(params, prompts, caches=caches)
        mat = [logits[:, -1]]
        del logits
        for i in range(SERVE_G - 1):
            logits, caches = model.decode_step(
                params, res.tokens[:, i:i + 1], caches, SERVE_LP + i)
            mat.append(logits)
    got, want = torch.stack(res.logits, 1), torch.stack(mat, 1)
    mla_err = float((got - want).abs().max())
    torch.testing.assert_close(
        got, want, **MODEL_TOL,
        msg=lambda m: f"{DEEPSEEK} absorbed vs materialised decode: {m}")
    del got, want, mat, caches
    caps = [layers.moe_groups(cfg, SERVE_B * n)[2] for n in (SERVE_LP, 1)]
    log(f"phase 18 {serve_line(DEEPSEEK, res, first.prefill_s)}; einsum "
        f"dispatch on every MoE call (C={caps[0]} in prefill, {caps[1]} in "
        f"decode); absorbed "
        f"vs materialised MLA decode (prefill and {SERVE_G - 1} steps) max "
        f"abs {mla_err:.3e} (tol {MODEL_TOL}); sample ids "
        f"{res.tokens[0, :8].tolist()}")
    decode_profile(model, params, prompts, DEEPSEEK)
    del first, res

    # ---------------------- one MLA and one MoE layer, card against the CPU
    x = torch.randn((1, LAYER_T, cfg.d_model), generator=gen, device=dev)
    p_mla = transformer.layer(params["layers"], 0)["attn"]
    mla_err = layer_vs_cpu(
        lambda p, x: layers.mla_apply(
            p, x, cfg, positions=torch.arange(LAYER_T, device=x.device))[0],
        p_mla, tree_to(p_mla, "cpu"), x, f"{DEEPSEEK} MLA layer 0")
    p_moe = transformer.layer(params["moe_layers"], 0)["moe"]
    t0 = time.perf_counter()
    p_cpu = tree_to(p_moe, "cpu")
    t_copy = time.perf_counter() - t0
    errs = {name: layer_vs_cpu(lambda p, x, fn=fn: fn(p, x, cfg), p_moe,
                               p_cpu, x, f"{DEEPSEEK} MoE layer 1 {name}")
            for name, fn in (("einsum", layers.moe_einsum_apply),
                             ("ep", layers.moe_ep_apply))}
    del p_cpu
    log(f"phase 18 {DEEPSEEK} on the card vs the CPU at T={LAYER_T}: MLA "
        f"layer 0 max abs {mla_err:.3e}; MoE layer 1, top-k experts "
        f"identical, max abs {errs} (tol {LAYER_TOL}); the MoE layer's "
        f"copy to the host {t_copy:.1f} s, both forms on both devices "
        f"{time.perf_counter() - t0 - t_copy:.1f} s")
    del params, p_mla, p_moe, x
    free_model(f"phase 18 {DEEPSEEK}")


def moe_path(dev) -> tuple[int, dict]:
    """Phase 18: the MoE and MLA half of the decoder family.  Returns the
    flash launches of granite's prefill step and the kernel's record at
    its shape."""
    t_phase = time.perf_counter()
    launches, flash = granite_path(dev)
    deepseek_path(dev)
    log(f"phase 18 wall {time.perf_counter() - t_phase:.3f} s")
    return launches, flash


# --------------------------------------- phase 19: the encoder-decoder
WHISPER = "whisper-tiny"
WHISPER_PARAMS = 56_347_392
#: frame embeddings drawn from a seed at the data stream's scale
FRAME_SCALE = 0.02
#: make_train_step at full width: B, text tokens, steps (1,536 frames)
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 2, 512, 3


@contextlib.contextmanager
def flash_launches_in(module, name: str, record: list):
    """``module.name`` wrapped to append the flash kernel's launches made
    inside each of its calls to ``record`` while inside."""
    from repro_torch.kernels.flash_attention import flash_attention_hm

    saved = getattr(module, name)

    def wrapped(*args, **kwargs):
        before = flash_attention_hm.launches
        try:
            return saved(*args, **kwargs)
        finally:
            record.append(flash_attention_hm.launches - before)

    with swapped(module, name, wrapped):
        yield


def whisper_path(dev) -> tuple[int, dict]:
    """Phase 19, whisper-tiny at full width and depth: the prefill step
    through the flash kernel (the decoder's causal self-attention only),
    the serve loop (encode once, the prompt decoded into the caches, decode
    steps given ``enc_out``), the kernel at its shape, one encoder and one
    decoder layer on the card against the CPU, and three train steps on
    the plain route.  Returns the flash launches of one
    ``make_prefill_step`` call (counts set to 0 just before it) and the
    kernel's record at its shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model, encdec
    from repro_torch.models.transformer import layer
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER)
    if cfg.n_params() != WHISPER_PARAMS:
        raise AssertionError(f"{WHISPER}: {cfg.n_params()} parameters")
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    gen = torch.Generator(dev).manual_seed(0)
    params = m_cuda.init(gen, torch.float32, dev)
    n_params = sum(t.numel() for t in leaves(params))   # norms, positions

    def frames(b):
        return FRAME_SCALE * torch.randn((b, cfg.frontend_seq, cfg.d_model),
                                         generator=gen, device=dev)

    # --------------------------- (a) make_prefill_step B=2 S=4096 + frames
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                     device=dev, generator=gen),
             "extra_embeds": frames(PREFILL_B)}
    step_cuda, step_xla = make_prefill_step(m_cuda), make_prefill_step(m_xla)
    enc_l, cross_l = [], []
    flash_attention_hm.launches = 0
    with plain_refused(fa_mod, "flash_attention_hm_torch"), \
            flash_launches_in(encdec, "encode", enc_l), \
            flash_launches_in(encdec, "_cross_attend", cross_l):
        got, t_cuda = timed(lambda: step_cuda(params, batch))
    launches = flash_attention_hm.launches
    if launches != cfg.n_layers or any(enc_l) or any(cross_l) \
            or (len(enc_l), len(cross_l)) != (1, cfg.n_layers):
        raise AssertionError(
            f"{launches} flash launches in a prefill step of {cfg.n_layers} "
            f"decoder layers; in the encoder {enc_l}, in the "
            f"cross-attentions {cross_l}: want one a decoder layer, none "
            f"elsewhere")
    want, t_xla = timed(lambda: step_xla(params, batch))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(
        got, want, **MODEL_TOL,
        msg=lambda m: f"{WHISPER} prefill cuda vs xla: {m}")
    del got, want
    _, t_cuda_warm = timed(lambda: step_cuda(params, batch))
    _, t_xla_warm = timed(lambda: step_xla(params, batch))
    wall, busy, count, top = device_profile(lambda: step_cuda(params, batch))
    log(f"profile {WHISPER} make_prefill_step cuda: wall {wall * 1e3:.1f} "
        f"ms under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    T = PREFILL_B * PREFILL_S
    log(f"phase 19 {WHISPER} ({cfg.n_encoder_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{n_params} f32 parameters) make_prefill_step B={PREFILL_B} "
        f"S={PREFILL_S} text + {cfg.frontend_seq} frames: {launches} flash "
        f"launches (the decoder's self-attention; encoder {sum(enc_l)}, "
        f"cross-attention {sum(cross_l)}); last-position logits cuda vs xla "
        f"max abs {err:.3e} (tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} "
        f"ms cuda, {t_xla_warm * 1e3:.1f} ms xla (first runs "
        f"{t_cuda * 1e3:.1f} / {t_xla * 1e3:.1f} ms), "
        f"{T / t_cuda_warm:.0f} text tok/s")
    del batch
    free_model(f"phase 19 {WHISPER} prefill step")

    # ---------------- (b) serve B=4, prompt 512, 32 tokens, given the frames
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    fr = frames(SERVE_B)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts, frames=fr)
    flash_attention_hm.launches = 0
    res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                prompts=prompts, frames=fr)
    serve_launches = flash_attention_hm.launches
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")
    check_generated(res, cfg.vocab, WHISPER)
    enc = encdec.encode(cfg_xla, params, fr)
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    full, _ = encdec.decode(cfg_xla, params, seq, enc)
    want = full[:, SERVE_LP - 1:]
    del full
    got = torch.stack(res.logits, dim=1)
    tf_err = float((got - want).abs().max())
    torch.testing.assert_close(
        got, want, **MODEL_TOL,
        msg=lambda m: f"{WHISPER} teacher-forced: {m}")
    del got, want
    caches = m_cuda.init_cache(SERVE_B, SERVE_LP + SERVE_G + 1, torch.float32,
                               dev)
    logits, caches = encdec.decode(cfg_cuda, params, prompts, enc,
                                   caches=caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    m_cuda.decode_step(params, tok, caches, SERVE_LP, enc_out=enc)  # warm
    wall, busy, count, top = device_profile(
        lambda: m_cuda.decode_step(params, tok, caches, SERVE_LP,
                                   enc_out=enc))
    log(f"profile {WHISPER} decode step (B={SERVE_B}, cache "
        f"{SERVE_LP + SERVE_G + 1}, {cfg.frontend_seq} frames): wall "
        f"{wall * 1e3:.2f} ms under the profiler, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%) in {count} kernels;"
        f" top (name, ms): {top}")
    log(f"phase 19 {serve_line(WHISPER, res, first.prefill_s)} (prefill = "
        f"encode {cfg.frontend_seq} frames + decode the prompt into the "
        f"caches); {count} kernels a decode step, device busy "
        f"{100 * busy / wall:.1f}%; {serve_launches} flash launches (a "
        f"prompt of {SERVE_LP} into {SERVE_LP + SERVE_G + 1} slots is not "
        f"Sq == Skv); teacher-forced decode vs full decode max abs "
        f"{tf_err:.3e} (tol {MODEL_TOL}); sample ids "
        f"{res.tokens[0, :8].tolist()}")
    del first, res, caches, enc, fr, prompts
    free_model(f"phase 19 {WHISPER} serve")

    # ----------------------------------- (c) the flash kernel at its shape
    flash = flash_at(dev, cfg, "phase 19")

    # ------------------- (d) one encoder and one decoder layer vs the CPU
    enc_in = frames(1)
    x = torch.randn((1, SERVE_LP, cfg.d_model), generator=gen, device=dev)
    p_enc = layer(params["enc_layers"], 0)
    p_dec = layer(params["dec_layers"], 0)

    def enc_layer(p, h):
        return encdec.enc_block(cfg_xla, p, h,
                                torch.arange(h.shape[1], device=h.device))

    def dec_layer(p, h):
        return encdec.dec_block(cfg_xla, p, h, enc_in.to(h.device),
                                torch.arange(h.shape[1], device=h.device))[0]

    enc_err = layer_vs_cpu(enc_layer, p_enc, tree_to(p_enc, "cpu"), enc_in,
                           f"{WHISPER} encoder layer 0")
    dec_err = layer_vs_cpu(dec_layer, p_dec, tree_to(p_dec, "cpu"), x,
                           f"{WHISPER} decoder layer 0")
    log(f"phase 19 {WHISPER} on the card vs the CPU: encoder layer 0 at "
        f"{cfg.frontend_seq} frames max abs {enc_err:.3e}; decoder layer 0 "
        f"(self-attention, cross-attention to {cfg.frontend_seq} frames, "
        f"MLP) at {SERVE_LP} tokens max abs {dec_err:.3e} (tol {LAYER_TOL})")
    del enc_in, x, p_enc, p_dec

    # -------------- (e) three train steps at full width, the plain route
    model = build_model(cfg.replace(remat=True))
    tparams = model.init(torch.Generator(dev).manual_seed(1), torch.float32,
                         dev)
    before = [t.clone() for t in leaves(tparams)]
    opt = AdamWConfig(lr=1e-3, warmup=1, total_steps=WHISPER_TRAIN_STEPS)
    state = init_state(opt, tparams)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=WHISPER_TRAIN_S,
        global_batch=WHISPER_TRAIN_B, frontend_seq=cfg.frontend_seq,
        d_model=cfg.d_model), device=dev)
    step = make_train_step(model, opt)
    free_model(f"phase 19 {WHISPER} before training")
    losses, secs = [], []
    for i in range(WHISPER_TRAIN_STEPS):
        b = data.batch_at(i)
        (tparams, state, loss), t = timed(lambda: step(tparams, state, b))
        losses.append(float(loss.detach()))
        secs.append(t)
    peak = torch.cuda.max_memory_allocated()
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(before, leaves(tparams), strict=True))
    if not all(np.isfinite(losses)) or changed != len(before) \
            or int(state["step"]) != WHISPER_TRAIN_STEPS:
        raise AssertionError(f"{WHISPER} train steps: losses {losses}, "
                             f"{changed} of {len(before)} leaves changed, "
                             f"step {int(state['step'])}")
    log(f"phase 19 {WHISPER} make_train_step at full width (f32, remat, "
        f"attn_impl=xla; B={WHISPER_TRAIN_B}, {WHISPER_TRAIN_S} text tokens, "
        f"{cfg.frontend_seq} bf16 frames from SyntheticLM): losses "
        f"{[round(v, 4) for v in losses]}, all {changed} leaves changed, "
        f"step s {[round(v, 4) for v in secs]}, peak device memory {peak} "
        f"bytes ({peak / 2**30:.2f} GiB)")
    del params, tparams, before, state, model
    free_model(f"phase 19 {WHISPER}")
    log(f"phase 19 wall {time.perf_counter() - t_phase:.3f} s")
    return launches, flash


# ------------------------------------- phase 20: the multimodal prefix
VLM = "internvl2-26b"
#: internvl2-26b with every width as published and its depth cut from 48
#: layers to 4: 48 layers of f32 weights are 79.4 GB (19,861,260,288
#: parameters); these four, the untied embedding and unembedding and the
#: norms are 2,697,627,648 parameters, 10.8 GB
VLM_CUT = dict(n_layers=4)
VLM_PARAMS = 2_697_627_648


def vlm_path(dev) -> tuple[int, dict]:
    """Phase 20, internvl2-26b at full width cut to 4 layers: the prefill
    step through the flash kernel's f32 head-dim-128 variant, its inputs
    sized by ``configs.input_specs`` (the 256 patch embeddings and the
    rest of the sequence as text), against the plain route; the serve
    loop behind the patch prefix, its decode held teacher-forced against
    the full forward over prefix, prompt and generated tokens; the kernel
    at its shape.  Returns the flash launches of one ``make_prefill_step``
    call (counts set to 0 just before it) and the kernel's record at its
    shape."""
    import torch

    from repro_torch.configs import ShapeSpec, get_config, input_specs
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config(VLM).replace(**VLM_CUT)
    cfg_cuda, cfg_xla = (cfg.replace(attn_impl=a) for a in ("cuda", "xla"))
    m_cuda, m_xla = build_model(cfg_cuda), build_model(cfg_xla)
    gen = torch.Generator(dev).manual_seed(0)
    params, t_init = timed(lambda: m_cuda.init(gen, torch.float32, dev))
    n_params = sum(t.numel() for t in leaves(params))   # norms too
    if n_params != VLM_PARAMS:
        raise AssertionError(f"{VLM} cut to {cfg.n_layers} layers: "
                             f"{n_params} parameters")
    P = cfg.frontend_seq

    def prefix(b):
        return FRAME_SCALE * torch.randn((b, P, cfg.d_model), generator=gen,
                                         device=dev)

    # ---------- (a) make_prefill_step B=2 S=4096: 256 patches + 3,840 text
    spec = input_specs(cfg, ShapeSpec("prefill_step", PREFILL_S, PREFILL_B,
                                      "prefill"), torch.float32)
    St = spec["tokens"].shape[1]
    if (St + P, tuple(spec["extra_embeds"].shape)) != (
            PREFILL_S, (PREFILL_B, P, cfg.d_model)):
        raise AssertionError(f"input_specs: {St} text tokens and "
                             f"{tuple(spec['extra_embeds'].shape)} patches")
    batch = {"tokens": torch.randint(0, cfg.vocab, tuple(spec["tokens"].shape),
                                     device=dev, generator=gen),
             "extra_embeds": prefix(PREFILL_B)}
    step_cuda, step_xla = make_prefill_step(m_cuda), make_prefill_step(m_xla)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_hm.launches = 0
    with plain_refused(fa_mod, "flash_attention_hm_torch"):
        got, t_cuda = timed(lambda: step_cuda(params, batch))
    launches = flash_attention_hm.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches in a prefill step "
                             f"of {cfg.n_layers} layers")
    want, t_xla = timed(lambda: step_xla(params, batch))
    if got.shape != (PREFILL_B, cfg.vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite")
    err = float((got - want).abs().max())
    torch.testing.assert_close(
        got, want, **MODEL_TOL, msg=lambda m: f"{VLM} prefill cuda vs xla: {m}")
    del got, want
    _, t_cuda_warm = timed(lambda: step_cuda(params, batch))
    _, t_xla_warm = timed(lambda: step_xla(params, batch))
    wall, busy, count, top = device_profile(lambda: step_cuda(params, batch))
    log(f"profile {VLM} make_prefill_step cuda: wall {wall * 1e3:.1f} ms "
        f"under the profiler, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f}%) in {count} kernels; top (name, ms): "
        f"{top}")
    T = PREFILL_B * St
    log(f"phase 20 {VLM} cut to {cfg.n_layers} of 48 layers (d "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head dim "
        f"{cfg.hd()}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params} f32 "
        f"parameters drawn in {t_init:.3f} s) make_prefill_step "
        f"B={PREFILL_B} S={PREFILL_S} ({P} patches + {St} text tokens, by "
        f"input_specs): {launches} flash launches (f32, head dim "
        f"{cfg.hd()}); last-position logits cuda vs xla max abs {err:.3e} "
        f"(tol {MODEL_TOL}); step {t_cuda_warm * 1e3:.1f} ms cuda, "
        f"{t_xla_warm * 1e3:.1f} ms xla (first runs {t_cuda * 1e3:.1f} / "
        f"{t_xla * 1e3:.1f} ms), {T / t_cuda_warm:.0f} text tok/s; peak "
        f"device memory of the first cuda step {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    del batch
    free_model(f"phase 20 {VLM} prefill step")

    # ------- (b) serve B=4, 256 patches + a 512-token prompt, 32 tokens
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP), device=dev,
                            generator=gen)
    pre = prefix(SERVE_B)
    first = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                  prompts=prompts, extra_embeds=pre)
    res = serve(cfg_cuda, gen=SERVE_G, device=dev, params=params,
                prompts=prompts, extra_embeds=pre)
    if not torch.equal(res.tokens, first.tokens):
        raise AssertionError("two serve runs of one prompt differ")
    check_generated(res, cfg.vocab, VLM)
    # decode after the prefix prefill, teacher-forced: the full forward
    # over prefix, prompt and the generated tokens it was fed
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    full, _ = m_xla.forward(params, seq, extra_embeds=pre)
    want = full[:, P + SERVE_LP - 1:]
    del full
    got = torch.stack(res.logits, dim=1)
    if got.shape != want.shape:
        raise AssertionError(f"decode logits {tuple(got.shape)}, want "
                             f"{tuple(want.shape)}")
    tf_err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **MODEL_TOL,
                               msg=lambda m: f"{VLM} teacher-forced: {m}")
    del got, want
    cache_len = P + SERVE_LP + SERVE_G + 1
    caches = m_cuda.init_cache(SERVE_B, cache_len, torch.float32, dev)
    logits, caches = m_cuda.forward(params, prompts, extra_embeds=pre,
                                    caches=caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    pos = P + SERVE_LP
    m_cuda.decode_step(params, tok, caches, pos)                 # warm
    wall, busy, count, top = device_profile(
        lambda: m_cuda.decode_step(params, tok, caches, pos))
    log(f"profile {VLM} decode step (B={SERVE_B}, cache {cache_len}, "
        f"position {pos}): wall {wall * 1e3:.2f} ms under the profiler, "
        f"device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%) in "
        f"{count} kernels; top (name, ms): {top}")
    log(f"phase 20 {serve_line(VLM, res, first.prefill_s)} (prefill = "
        f"{P} patches + the prompt into a cache of {cache_len}; decode step "
        f"i at position {P} + {SERVE_LP} + i); teacher-forced decode vs the "
        f"full forward max abs {tf_err:.3e} (tol {MODEL_TOL}); sample ids "
        f"{res.tokens[0, :8].tolist()}")
    del first, res, caches, pre, prompts, params
    free_model(f"phase 20 {VLM}")

    # ------------------------------------ (c) the flash kernel at its shape
    flash = flash_at(dev, cfg, "phase 20")
    log(f"phase 20 wall {time.perf_counter() - t_phase:.3f} s")
    return launches, flash


# ------------------------------------------------- phase 21: parallelism
PAR_RANKS = 4
PIPE_MICRO, PIPE_STAGES, PIPE_TILE = 8, 4, 2    # (a), (b): 4 tiles, 7 steps
PIPE_SEED = 21
#: (b) at the size of examples/pipeline_train.py: D 64, tiles of 2 x 4
EXAMPLE_D, EXAMPLE_B_TILE, EXAMPLE_STEPS, EXAMPLE_LR = 64, 4, 30, 0.05
PIPE_GRAD_TOL = 1e-5                    # of the largest gradient
GRAD_SEED = 2200                        # (c): rank r's gradients
#: (c): every leaf of llama3.2-1b's tree: n_params()'s 1,235,746,816 and
#: its 33 norm vectors of 2,048
LLAMA_GRAD_VALUES = 1_235_814_400
EP_B, EP_S = 2, 4096                    # (d): T = 8,192 >= ep_threshold
EP_SEED = 2300
EP_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_torch_moe.py


def llama_stage_params(cfg, dev, first: int, n: int) -> dict:
    """Layers ``first .. first+n-1`` of llama3.2-1b stacked ``[n, ...]``,
    f32, each drawn from its own seed (so a rank's stage and the parent's
    whole stack hold the same weights)."""
    import torch

    from repro_torch.models import transformer

    seeds = iter(range(first, first + n))
    return transformer.stacked(n, lambda: transformer._layer_params(
        torch.Generator(dev).manual_seed(PIPE_SEED * 1000 + next(seeds)),
        cfg, torch.float32, dev, False))


def llama_microbatches(cfg, dev):
    """The embedded hidden states of seeded tokens, tiled
    ``[tiles, tile_m, S, d]`` (4 x 2 x 4096 x 2048, 268 MB)."""
    import torch

    from repro_torch.models.layers import normal

    gen = torch.Generator(dev).manual_seed(PIPE_SEED)
    embed = normal(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                   torch.float32, dev)
    tokens = torch.randint(0, cfg.vocab, (PIPE_MICRO, PREFILL_S),
                           generator=gen, device=dev)
    x = embed[tokens]
    del embed
    return x.reshape(PIPE_MICRO // PIPE_TILE, PIPE_TILE, PREFILL_S,
                     cfg.d_model)


def llama_stage(cfg, n: int):
    """One pipeline stage: ``n`` decoder blocks (``transformer._block``)."""
    import torch

    from repro_torch.models import transformer

    def stage(p, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in transformer.unstack(p, n):
            x = transformer._block(cfg, lp, x, positions, None, False)[0]
        return x

    return stage


def example_stage(p, x):
    """examples/pipeline_train.py's stage: a residual tanh MLP."""
    import torch

    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def example_inputs(dev) -> dict:
    """(b)'s stacked stage params, microbatches and targets, from a NumPy
    seed."""
    import torch

    rng = np.random.default_rng(PIPE_SEED)
    S, D = PIPE_STAGES, EXAMPLE_D
    shape = (PIPE_MICRO // PIPE_TILE, EXAMPLE_B_TILE * PIPE_TILE, D)
    arrays = {"w1": 0.3 * rng.standard_normal((S, D, D)),
              "b1": np.zeros((S, D)),
              "w2": 0.3 * rng.standard_normal((S, D, D)),
              "mbs": rng.standard_normal(shape),
              "targets": rng.standard_normal(shape)}
    return {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in arrays.items()}


def deepseek_moe(cfg, dev, experts: range):
    """One deepseek-v3-671b MoE layer's weights, f32: the routed experts
    ``experts`` (each drawn from its own seed, so a rank's slice equals the
    full stack's rows), the router and the shared expert; and the hidden
    states [EP_B, EP_S, d]."""
    import torch

    from repro_torch.models.layers import mlp_params, normal

    mo, d = cfg.moe, cfg.d_model
    ff, n = mo.d_ff_expert, len(experts)
    p = {"wg": torch.empty((n, d, ff), device=dev),
         "wu": torch.empty((n, d, ff), device=dev),
         "wd": torch.empty((n, ff, d), device=dev)}
    for i, e in enumerate(experts):
        gen = torch.Generator(dev).manual_seed(EP_SEED + 1 + e)
        p["wg"][i] = normal(gen, (d, ff), d ** -0.5, torch.float32, dev)
        p["wu"][i] = normal(gen, (d, ff), d ** -0.5, torch.float32, dev)
        p["wd"][i] = normal(gen, (ff, d), ff ** -0.5, torch.float32, dev)
    gen = torch.Generator(dev).manual_seed(EP_SEED)
    p["router"] = normal(gen, (d, mo.n_experts), d ** -0.5, torch.float32,
                         dev)
    p["shared"] = mlp_params(gen, d, ff * mo.n_shared, "swiglu",
                             torch.float32, dev)
    h = torch.randn((EP_B, EP_S, d), generator=gen, device=dev)
    return p, h


def warm_collectives(group, device) -> None:
    """One small call of each collective on ``group``, so that the timed
    calls find the transport's connections made (NCCL builds a group's
    communicators, and one for each pair that sends, on first use)."""
    import torch

    from repro_torch.parallel import collectives as col

    n = group.size
    x = torch.zeros((n, 8), device=device)
    col.all_to_all(x, group)
    col.all_gather(x[0], group)
    col.psum(x, group)
    col.pmax(x, group)
    col.ppermute(x, group, [(i, (i + 1) % n) for i in range(n)])


def parallel_rank(device) -> dict:
    """Phase 21 on one of four ranks: (a) llama3.2-1b's 16 layers as 4
    pipeline stages through the flash kernel, (b) training through the
    pipeline, (c) ``compressed_psum_grads`` over llama3.2-1b's gradient
    shapes, (d) one deepseek-v3-671b MoE layer over 4 expert shards.
    Loads the flash library the parent built; returns what the parent
    checks and logs (NumPy arrays, rank 0 the outputs)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.models import build_model, layers, transformer
    from repro_torch.parallel import compression
    from repro_torch.parallel.collectives import pmax, psum
    from repro_torch.parallel.pipeline import (build_schedule,
                                               make_pipeline_loss,
                                               pipelined_forward)
    from repro_torch.tree import leaves, rebuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        lib = build.library_path("flash_attention")
        if not lib.is_file():
            raise RuntimeError(f"{lib.name} was not built by the parent")
        build.load("flash_attention")
    rank = dist.get_rank()
    res = {"transport": dist.get_backend(), "device": str(device),
           "t_in": time.time()}

    def sync():
        dist.barrier()
        torch.cuda.synchronize()

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # ------------- (a) llama3.2-1b, 16 layers as 4 stages of 4, flash
    cfg = get_config(LLAMA).replace(attn_impl="cuda")
    mesh = Mesh((PIPE_STAGES,), ("stage",), device=device)
    sched = build_schedule(PIPE_MICRO, PIPE_STAGES, PIPE_TILE)
    s = mesh.group("stage").index
    per = cfg.n_layers // PIPE_STAGES
    params = llama_stage_params(cfg, device, s * per, per)
    mbs = llama_microbatches(cfg, device)
    stage = llama_stage(cfg, per)
    warm_collectives(mesh.group("stage"), device)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), plain_refused(fa_mod, "flash_attention_hm_torch"):
        sync()
        flash_attention_hm.launches = 0
        out, t_pipe = timed(lambda: pipelined_forward(stage, params, mbs,
                                                      sched, mesh))
        launches = flash_attention_hm.launches
        sync()
        _, t_warm = timed(lambda: pipelined_forward(stage, params, mbs,
                                                    sched, mesh))
    res["a"] = {"launches": launches, "t": t_pipe, "t_warm": t_warm,
                "peak": torch.cuda.max_memory_allocated(),
                "finite": bool(torch.isfinite(out).all()),
                "shape": tuple(out.shape), "stage": s}
    if rank == 0:
        res["a"]["out"] = out.cpu().numpy()
    del params, mbs, out
    release()

    # ------------- (b) training through the pipeline, the example's size
    ex = example_inputs(device)
    p = {k: ex[k][s].clone().requires_grad_() for k in ("w1", "b1", "w2")}
    loss_fn = make_pipeline_loss(example_stage, sched, mesh)
    losses, first = [], None
    sync()
    t0 = time.perf_counter()
    for step in range(EXAMPLE_STEPS):
        loss = loss_fn(p, ex["mbs"], ex["targets"])
        grads = torch.autograd.grad(loss, list(p.values()))
        if first is None:
            first = {k: g.cpu().numpy() for k, g in zip(p, grads)}
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v -= EXAMPLE_LR * g
        losses.append(float(loss.detach()))
    sync()
    res["b"] = {"losses": losses, "grads": first,
                "t": time.perf_counter() - t0}

    # ------------- (c) int8 gradient exchange over llama3.2-1b's shapes
    dmesh = Mesh((PAR_RANKS,), ("data",), device=device)
    group = dmesh.group("data")
    warm_collectives(group, device)
    shapes = build_model(get_config(LLAMA)).init(torch.Generator(),
                                                 torch.float32, "meta")
    gen = torch.Generator(device).manual_seed(GRAD_SEED + rank)
    grads = rebuild(shapes, [torch.randn(t.shape, generator=gen,
                                         device=device)
                             for t in leaves(shapes)])
    n_values = sum(g.numel() for g in leaves(grads))
    torch.cuda.reset_peak_memory_stats()
    sync()
    got, t_int8 = timed(lambda: compression.compressed_psum_grads(grads,
                                                                 dmesh))
    sync()
    peak_c = torch.cuda.max_memory_allocated()
    t_f32, worst = 0.0, 0.0
    with torch.no_grad():
        for g, r in zip(leaves(grads), leaves(got)):
            mean, dt = timed(lambda: psum(g, group) / PAR_RANKS)
            t_f32 += dt
            bound = 2 * pmax(g.abs().max(), group) / 127 + 1e-6
            worst = max(worst, float((r - mean).abs().max() / bound))
            del mean
    sent, f32_sent = compression.wire_bytes(grads, PAR_RANKS)
    res["c"] = {"values": n_values, "leaves": len(leaves(grads)),
                "t_int8": t_int8, "t_f32": t_f32, "worst": worst,
                "sent": sent, "f32_sent": f32_sent, "peak": peak_c}
    del grads, got, shapes
    release()

    # ------------- (d) one deepseek-v3-671b MoE layer, 4 expert shards
    cfg = get_config(DEEPSEEK)
    emesh = make_debug_mesh(1, PAR_RANKS, device=device)
    ep = emesh.group(("data", "model"))
    for g in (ep, emesh.group("model")):
        warm_collectives(g, device)
    e_loc = cfg.moe.n_experts // ep.size
    pmoe, h = deepseek_moe(cfg, device,
                           range(ep.index * e_loc, (ep.index + 1) * e_loc))
    ctx = transformer.ParallelCtx(mesh=emesh, dp_spec="data")
    stats, a2a = {}, []
    orig_a2a, orig_ep = layers.all_to_all, transformer.moe_ep_apply

    def timed_a2a(x, group):
        out, dt = timed(lambda: orig_a2a(x, group))
        a2a.append(dt)
        return out

    def with_stats(*args, **kw):
        return orig_ep(*args, stats=stats, **kw)

    torch.cuda.reset_peak_memory_stats()
    sync()
    with torch.no_grad(), swapped(layers, "all_to_all", timed_a2a), \
            swapped(transformer, "moe_ep_apply", with_stats):
        out, t_ep = timed(lambda: transformer._moe_dispatch(cfg, pmoe, h,
                                                            ctx))
    peak_d = torch.cuda.max_memory_allocated()
    TK = EP_B * EP_S // PAR_RANKS * cfg.moe.top_k
    C = max(1, int(TK / ep.size * cfg.moe.capacity_factor))
    Ce = max(1, int(ep.size * C / e_loc * cfg.moe.capacity_factor))
    buf = torch.randn((e_loc, Ce, cfg.d_model), device=device)

    def gemms():
        hh = torch.nn.functional.silu(torch.einsum(
            "ecd,edf->ecf", buf, pmoe["wg"])) * torch.einsum(
            "ecd,edf->ecf", buf, pmoe["wu"])
        return torch.einsum("ecf,efd->ecd", hh, pmoe["wd"])

    with torch.no_grad():
        sync()
        gemm_ms = event_ms(gemms, reps=3, inner=1)
    res["d"] = {"dropped": stats["dropped"], "a2a_s": a2a, "t": t_ep,
                "gemm_ms": gemm_ms, "C": C, "Ce": Ce, "e_loc": e_loc,
                "peak": peak_d, "finite": bool(torch.isfinite(out).all())}
    if rank == 0:
        res["d"]["out"] = out.cpu().numpy()
    res["t_out"] = time.time()
    return res


def parallel_path(dev, card) -> dict:
    """Phase 21: parallelism on ``torch.distributed``, one ``run_ranks``
    call of four ranks (NCCL, each rank its own card, when the host has
    four; else gloo, the four sharing the card with CUDA tensors staged
    through the host), then the parent's checks: (a) the pipelined
    prefill against ``sequential_reference`` on one card, (b) the first
    step's gradients against autograd through ``sequential_reference``
    and the loss falling, (c) every gradient leaf within the reference
    test's bound of the exact mean, (d) the expert-parallel layer against
    the one-shard form.  Returns the flash launches of the pipelined run
    (the ranks') and of the sequential one."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.mesh import default_transport, run_ranks
    from repro_torch.models import transformer
    from repro_torch.parallel.pipeline import sequential_reference

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    transport = default_transport(PAR_RANKS, dev)
    how = ("each rank its own card" if transport == "nccl" else
           "the ranks share one device, CUDA tensors staged through the host"
           if dev.type == "cuda" else "CPU tensors")
    log(f"phase 21 transport: {transport} ({how}), {PAR_RANKS} ranks, "
        f"{cards} cards, {card}")
    t_call = time.time()
    ranks, t_ranks = timed(lambda: run_ranks(
        parallel_rank, PAR_RANKS, device=dev.type, backend=transport,
        timeout=600))
    if {r["transport"] for r in ranks} != {transport}:
        raise AssertionError(f"transports {[r['transport'] for r in ranks]}")

    # ---------------------------------------------------- (a) the parent
    cfg = get_config(LLAMA).replace(attn_impl="cuda")
    per = cfg.n_layers // PIPE_STAGES
    firsts = iter(range(0, cfg.n_layers, per))
    params = transformer.stacked(PIPE_STAGES, lambda: llama_stage_params(
        cfg, dev, next(firsts), per))
    mbs = llama_microbatches(cfg, dev)
    a = [r["a"] for r in ranks]
    pipelined = sum(x["launches"] for x in a)
    if [x["launches"] for x in a] != [
            (PIPE_MICRO // PIPE_TILE + PIPE_STAGES - 1) * per] * PAR_RANKS:
        raise AssertionError(f"flash launches a rank "
                             f"{[x['launches'] for x in a]}")
    with torch.no_grad(), plain_refused(fa_mod, "flash_attention_hm_torch"):
        flash_attention_hm.launches = 0
        want, t_seq = timed(lambda: sequential_reference(
            llama_stage(cfg, per), params, mbs))
        sequential = flash_attention_hm.launches
    if sequential != PIPE_MICRO // PIPE_TILE * cfg.n_layers:
        raise AssertionError(f"{sequential} flash launches in the sequential "
                             f"reference")
    got = torch.from_numpy(a[0]["out"]).to(dev)
    if not all(x["finite"] for x in a) or got.shape != want.shape:
        raise AssertionError(f"pipelined output {tuple(got.shape)}, finite "
                             f"{[x['finite'] for x in a]}")
    gap = float((got - want).abs().max())
    same = bool(torch.equal(got, want))
    torch.testing.assert_close(got, want, **MODEL_TOL, msg=lambda m: (
        f"{LLAMA} pipelined vs sequential_reference: {m}"))
    del got, want, params, mbs
    log(f"phase 21 (a) {LLAMA} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"f32) as {PIPE_STAGES} stages of {per} layers, "
        f"build_schedule({PIPE_MICRO}, {PIPE_STAGES}, tile_m={PIPE_TILE}): "
        f"{PIPE_MICRO // PIPE_TILE} tiles of B={PIPE_TILE}, S={PREFILL_S}, "
        f"{PIPE_MICRO // PIPE_TILE + PIPE_STAGES - 1} wavefronts; flash "
        f"launches {[x['launches'] for x in a]} ({pipelined} in all); "
        f"pipelined vs sequential_reference (one process, {sequential} "
        f"launches) max abs {gap:.3e}, bit-identical {same} (tol "
        f"{MODEL_TOL}); pipelined wall {max(x['t'] for x in a):.3f} s first "
        f"(counted), {max(x['t_warm'] for x in a):.3f} s warm (slowest "
        f"rank), sequential {t_seq:.3f} s; peak device memory a rank "
        f"{[x['peak'] for x in a]} bytes")

    # ---------------------------------------------------- (b) the parent
    ex = example_inputs(dev)
    p = {k: ex[k].clone().requires_grad_() for k in ("w1", "b1", "w2")}
    loss = torch.mean((sequential_reference(example_stage, p, ex["mbs"])
                       - ex["targets"]) ** 2)
    want = torch.autograd.grad(loss, list(p.values()))
    b = [r["b"] for r in ranks]
    worst = 0.0
    for k, w in zip(p, want):
        g = torch.from_numpy(np.stack([x["grads"][k] for x in b])).to(dev)
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    if not worst <= PIPE_GRAD_TOL:
        raise AssertionError(f"pipeline gradients {worst:.3e} of the largest "
                             f"from sequential_reference's")
    losses = b[0]["losses"]
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"pipeline training loss {losses[0]} -> "
                             f"{losses[-1]}")
    log(f"phase 21 (b) training through the pipeline (D {EXAMPLE_D}, "
        f"{PIPE_MICRO} microbatches in tiles of {PIPE_TILE}, "
        f"{EXAMPLE_STEPS} SGD steps at lr {EXAMPLE_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; first step's gradients vs "
        f"autograd through sequential_reference: {worst:.3e} of the largest "
        f"(tol {PIPE_GRAD_TOL}); {max(x['t'] for x in b):.3f} s")

    # ---------------------------------------------------- (c)
    c = [r["c"] for r in ranks]
    if c[0]["values"] != LLAMA_GRAD_VALUES:
        raise AssertionError(f"{c[0]['values']} gradient values a rank")
    worst_c = max(x["worst"] for x in c)
    if not worst_c <= 1.0:
        raise AssertionError(f"compressed mean off by {worst_c:.3f} of the "
                             f"bound 2 max|g|/127 + 1e-6")
    log(f"phase 21 (c) compressed_psum_grads over a {PAR_RANKS}-rank data "
        f"axis: {c[0]['values']} f32 values in {c[0]['leaves']} leaves a "
        f"rank ({4 * c[0]['values']} bytes); every leaf within "
        f"{worst_c:.3f} of the bound 2 max|g|/127 + 1e-6; wire bytes a rank "
        f"{c[0]['sent']} (int8 + f32 scales) vs {c[0]['f32_sent']} for an "
        f"f32 ring all-reduce ({c[0]['f32_sent'] / c[0]['sent']:.2f}x); "
        f"int8 exchange {max(x['t_int8'] for x in c):.3f} s, f32 "
        f"all-reduce {max(x['t_f32'] for x in c):.3f} s (slowest rank); "
        f"peak device memory a rank {[x['peak'] for x in c]} bytes")

    # ---------------------------------------------------- (d) the parent
    cfg = get_config(DEEPSEEK)
    d = [r["d"] for r in ranks]
    got = torch.from_numpy(d[0]["out"]).to(dev)
    pmoe, h = deepseek_moe(cfg, dev, range(cfg.moe.n_experts))
    stats = {}
    orig = transformer.moe_ep_apply
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), swapped(transformer, "moe_ep_apply",
                                  lambda *a, **kw: orig(*a, stats=stats,
                                                        **kw)):
        want, t_one = timed(lambda: transformer._moe_dispatch(cfg, pmoe, h))
    peak_one = torch.cuda.max_memory_allocated()
    del pmoe, h
    drops = [x["dropped"] for x in d]
    if not all(x["finite"] for x in d) or got.shape != want.shape:
        raise AssertionError(f"EP output {tuple(got.shape)}")
    gap_d = float((got - want).abs().max())
    none_dropped = stats["dropped"] == (0, 0) and all(
        x == (0, 0) for x in drops)
    if none_dropped:
        torch.testing.assert_close(got, want, **EP_TOL, msg=lambda m: (
            f"{DEEPSEEK} MoE layer, 4 expert shards vs one: {m}"))
    del got, want
    log(f"phase 21 (d) {DEEPSEEK} MoE layer ({cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, d {cfg.d_model}, FF {cfg.moe.d_ff_expert}, "
        f"f32) at B={EP_B} S={EP_S} on make_debug_mesh(1, {PAR_RANKS}): "
        f"ep_axis ('data', 'model'), {d[0]['e_loc']} experts and "
        f"{EP_B * EP_S // PAR_RANKS} tokens a rank, C {d[0]['C']}, Ce "
        f"{d[0]['Ce']}; dropped slots (send buffer, experts) a rank {drops}, "
        f"one shard {stats['dropped']}; 4 shards vs one max abs "
        f"{gap_d:.3e}" + (f" (tol {EP_TOL})" if none_dropped else
                          " (not compared: slots dropped)")
        + f"; _moe_dispatch {max(x['t'] for x in d):.3f} s a rank, its "
        f"{len(d[0]['a2a_s'])} all-to-alls "
        f"{max(sum(x['a2a_s']) for x in d):.3f} s "
        f"(slowest rank), the expert GEMMs at a rank's shapes "
        f"{max(x['gemm_ms'] for x in d):.3f} ms (CUDA events, median of 3); "
        f"one shard {t_one:.3f} s; peak device memory a rank "
        f"{[x['peak'] for x in d]} bytes, one shard {peak_one} bytes")
    log(f"phase 21 wall {time.perf_counter() - t_phase:.3f} s (run_ranks "
        f"{t_ranks:.3f} s: the ranks entered their function "
        f"{max(r['t_in'] for r in ranks) - t_call:.3f} s after the call "
        f"and left it {max(r['t_out'] for r in ranks) - t_call:.3f} s "
        f"after)")
    free_model("phase 21")
    return {"pipelined": pipelined, "sequential": sequential}


# ------------------------------------------------ phase 22: what a step costs
#: granite-moe-1b-a400m's decode step in phase 22: B, and the cache's
#: slots with the serve loop's prompt in it
COST_DECODE_B, COST_DECODE_SLOTS = SERVE_B, SERVE_LP + SERVE_G
COST_REPS = 3                           # timed runs of each step
#: cells of ``dryrun --all --single-pod`` phase 22 leaves out: those whose
#: walk on a CPU took over a minute (PERF.md): the two prefills'
#: attention runs the plain chunked loop on the card's route too
#: (deepseek-v3-671b's MLA head dims, zamba2-7b's sliding window);
#: rwkv6-1.6b's train step the plain WKV6 recurrence, a Python loop over
#: 4,096 steps a layer, forward, recomputed and backward; deepseek's train
#: step its 61 layers
DRYRUN_LEFT_OUT = {
    ("deepseek-v3-671b", "prefill_32k"): "721-758 s walk",
    ("zamba2-7b", "prefill_32k"): "190 s walk",
    ("rwkv6-1.6b", "train_4k"): "1,246 s walk",
    ("deepseek-v3-671b", "train_4k"): "57-68 s walk",
}
#: processes the dry run's cells walk on (spawned) beside phases 17-22,
#: which keeps the other cores
DRYRUN_WORKERS = 3
#: what the card's count and the meta walk must agree on
COUNTED = ("flops", "bytes_accessed", "launches", "kernels")


def dryrun_cell(cell) -> dict:
    """One ``dryrun --single-pod`` cell's record, walked on ``meta`` in a
    worker process of phase 22 (``repro_torch`` put on its path)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    return dryrun.run_cell(*cell, False, save=False)


def cost_steps():
    """Phase 22's steps: ``(label, build)``, where ``build(dev)`` returns
    ``(step, args)`` with f32 weights drawn from a seed (on ``meta``:
    their shapes), as phases 10-13, 17 and 18 run them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state

    def ints(shape, high, dev, gen):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.int64, device=dev)
        return torch.randint(0, high, shape, device=dev, generator=gen)

    def model_on(name, dev, **kw):
        cfg = get_config(name).replace(**kw)
        model = build_model(cfg)
        gen = torch.Generator(dev if dev.type != "meta" else "cpu")
        params = model.init(gen.manual_seed(0), torch.float32, dev)
        return cfg, model, gen, params

    def prefill(name):
        def build(dev):
            cfg, model, gen, params = model_on(name, dev, attn_impl="cuda")
            tokens = ints((PREFILL_B, PREFILL_S), cfg.vocab, dev, gen)
            return make_prefill_step(model), (params, {"tokens": tokens})
        return (f"{name} make_prefill_step B={PREFILL_B} S={PREFILL_S} "
                f"cuda", build)

    def train(dev):
        cfg, model, gen, params = model_on(LLAMA, dev)
        opt = AdamWConfig(lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
        tokens = ints((TRAIN_B, TRAIN_S), cfg.vocab, dev, gen)
        return make_train_step(model, opt), (
            params, init_state(opt, params),
            {"tokens": tokens, "labels": tokens})

    def decode(dev):
        cfg, model, gen, params = model_on(GRANITE, dev)
        caches = model.init_cache(COST_DECODE_B, COST_DECODE_SLOTS,
                                  torch.float32, dev)
        for group in caches.values():
            group["len"] = SERVE_LP
        batch = {"tokens1": ints((COST_DECODE_B, 1), cfg.vocab, dev, gen),
                 "pos": torch.full((), SERVE_LP, dtype=torch.int32,
                                   device=dev)}
        return make_decode_step(model), (params, caches, batch)

    return [prefill(LLAMA), prefill(RWKV), prefill(ZAMBA),
            (f"{LLAMA} make_train_step B={TRAIN_B} S={TRAIN_S} xla", train),
            (f"{GRANITE} make_decode_step B={COST_DECODE_B}, cache "
             f"{COST_DECODE_SLOTS} at {SERVE_LP}", decode)]


def cost_path(dev, card) -> None:
    """Phase 22, after phase 21: what a step costs.  (a) Each of five steps
    (llama3.2-1b's, rwkv6-1.6b's and zamba2-7b's ``make_prefill_step`` at
    B=2 S=4096 through flash, WKV6 and SSD; llama3.2-1b's full-width train
    step, phase 17's; granite-moe-1b-a400m's decode step) is counted once
    on the card under ``launch.op_cost`` and walked on ``meta`` at the
    same shapes: FLOPs, bytes, launches and kernel calls must be equal.
    (b) One line a step: its FLOPs and measured ms (timed apart from the
    counted run, which the dispatch mode slows), the achieved TFLOP/s
    against the f32 SIMT peak, bytes a second against 3.35 TB/s, the
    profiler's CUDA kernels beside the counted launches, and the walk's
    peak beside ``torch.cuda.max_memory_allocated()``.  (c), ``python -m
    repro_torch.launch.dryrun --all --single-pod``'s cells, is walked
    from phase 17 on (:func:`start_dryrun`, :func:`finish_dryrun`)."""
    import torch

    from repro_torch.launch.op_cost import op_cost

    t_phase = time.perf_counter()
    meta = torch.device("meta")
    for label, build in cost_steps():
        step, args = build(dev)
        step(*args)                                   # warm
        torch.cuda.synchronize()
        on_card = op_cost(step, *args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds = sorted(timed(lambda: step(*args))[1]
                         for _ in range(COST_REPS))
        max_alloc = torch.cuda.max_memory_allocated()
        _, _, kernels, _ = device_profile(lambda: step(*args))
        del step, args
        free_model(f"phase 22 {label}")
        step, args = build(meta)
        walked = op_cost(step, *args)
        del step, args
        if any(on_card[k] != walked[k] for k in COUNTED):
            card_ops = collections.Counter(on_card["ops"])
            meta_ops = collections.Counter(walked["ops"])
            raise AssertionError(
                f"phase 22 {label}: the card counts "
                f"{ {k: on_card[k] for k in COUNTED} }, the meta walk "
                f"{ {k: walked[k] for k in COUNTED} }; ops only on the card "
                f"{dict(card_ops - meta_ops)}, only on meta "
                f"{dict(meta_ops - card_ops)}")
        ms = statistics.median(seconds) * 1e3
        flops, nbytes = walked["flops"], walked["bytes_accessed"]
        rate, bps = flops / ms / 1e9, nbytes / ms / 1e9   # TFLOP/s, TB/s
        log(f"phase 22 {label}: card count = meta walk: {flops} flop, "
            f"{nbytes} bytes, {walked['launches']} launches, kernels "
            f"{walked['kernels']}; {ms:.3f} ms a step (median of "
            f"{COST_REPS}: {[round(t * 1e3, 3) for t in seconds]}): "
            f"{rate:.3f} TFLOP/s, {rate * 1e12 / F32_FLOP_PER_S:.1%} of the "
            f"f32 SIMT peak 67 TFLOP/s; {bps:.3f} TB/s, "
            f"{bps * 1e12 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; {kernels} "
            f"CUDA kernels profiled beside {walked['launches']} launches "
            f"counted; peak {walked['peak_bytes']} bytes walked "
            f"({walked['peak_bytes'] / 2**30:.2f} GiB) beside "
            f"max_memory_allocated {max_alloc} "
            f"({max_alloc / 2**30:.2f} GiB); {card}")

    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s on {card}, its "
        f"dry run walking since phase 17")


def start_dryrun():
    """Phase 22 (c), started: ``dryrun --all --single-pod``'s cells on
    ``meta``, less :data:`DRYRUN_LEFT_OUT`, walked on a pool of
    :data:`DRYRUN_WORKERS` spawned processes while phases 17-22 run on
    the card (the walks take the host's other cores, which phases 23's
    and 24's ranks then find free).  Returns what :func:`finish_dryrun`
    reads."""
    from repro_torch.configs import REGISTRY, SHAPES, get_config

    # the train cells, the longest walks, first, the deepest first among
    # them (a train walk's time grows with the layers), so that the
    # pool's last walks are short ones
    cells = sorted(((a, sh) for a in sorted(REGISTRY) for sh in SHAPES
                    if (a, sh) not in DRYRUN_LEFT_OUT),
                   key=lambda c: (SHAPES[c[1]].kind != "train",
                                  -get_config(c[0]).n_layers))
    workers = min(DRYRUN_WORKERS, os.cpu_count() or 1)
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(dryrun_cell, c) for c in cells]
    return pool, cells, futures, workers, time.perf_counter()


def finish_dryrun(started) -> None:
    """Phase 22 (c), read: a line a walked cell; none may fail."""
    pool, cells, futures, workers, t0 = started
    counts = collections.Counter()
    with pool:
        recs = [f.result() for f in futures]
    for (arch, shape), rec in zip(cells, recs):
        counts[rec["status"]] += 1
        if rec["status"] == "error":
            raise AssertionError(f"phase 22 dryrun {arch} {shape}: "
                                 f"{rec['traceback']}")
        if rec["status"] == "ok":
            oc = rec["op_cost"]
            log(f"phase 22 dryrun pod16x16 {arch} {shape}: "
                f"{oc['flops']} flop, {oc['launches']} launches, "
                f"kernels {oc['kernels']}, collectives "
                f"{oc['collective_total']} bytes ("
                f"{oc['collective_bytes']['all-reduce']} all-reduce), peak "
                f"{oc['peak_bytes'] / 2**30:.2f} GiB a rank, by_specs "
                f"{rec['memory']['by_specs']['total'] / 2**30:.2f} GiB, "
                f"walk {rec['walk_s']} s")
    log(f"phase 22 dryrun --all --single-pod on meta, less "
        f"{ {k: v for k, v in DRYRUN_LEFT_OUT.items()} }: "
        + " ".join(f"{k}={counts[k]}" for k in ("ok", "skipped",
                                                "not_ported", "error"))
        + f" in {time.perf_counter() - t0:.1f} s on {workers} processes "
        f"from phase 17 on (read after phase 24)")


# ------------------------------------- phase 23: the train step under a mesh
MESH_TRAIN_STEPS = 3                    # (a): llama3.2-1b, data-parallel
#: (b): granite-moe-1b-a400m expert-parallel, 4,096 tokens (its
#: ep_threshold); capacity E/k = 4.0 drops nothing in either form, the
#: config's 1.25 does
MESH_EP_B, MESH_EP_S, MESH_EP_STEPS = 8, 512, 2
MESH_EP_CF, MESH_EP_DROP_CF = 4.0, 1.25
MESH_EP_SHAPE = (2, 2)                  # 32 experts, 8 a rank
#: on one card, where the exchanges go through the host: (a) at 8 of
#: llama3.2-1b's 16 layers, (b) at 8 of granite's 24 (all with four cards)
MESH_DP_LAYERS_ONE_CARD = MESH_EP_LAYERS_ONE_CARD = 8
MESH_SEED = 2400
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_TOL = 1e-4                    # of each gradient leaf's largest


def mesh_train_setup(kind: str, dev, cf: float = MESH_EP_CF):
    """``(cfg, model, opt_cfg, params, batches)`` of phase 23's (a)
    (``kind`` "dp") or (b) ("ep"): f32 params from one seed on ``dev``
    (the same values on every card), global batches from another, each
    with ``-1`` labels on half of row 0 and all of the last row, so the
    data blocks count different labels."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    one_card = torch.cuda.device_count() < 4
    if kind == "dp":
        cfg = get_config(LLAMA).replace(attn_impl="xla")
        if one_card:
            cfg = cfg.replace(n_layers=MESH_DP_LAYERS_ONE_CARD)
        B, S, n = TRAIN_B, TRAIN_S, MESH_TRAIN_STEPS
    else:
        cfg = get_config(GRANITE)
        cfg = cfg.replace(attn_impl="xla", moe=dataclasses.replace(
            cfg.moe, impl="ep_a2a", capacity_factor=cf))
        if one_card:
            cfg = cfg.replace(n_layers=MESH_EP_LAYERS_ONE_CARD)
        B, S, n = MESH_EP_B, MESH_EP_S, MESH_EP_STEPS
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
    params = model.init(torch.Generator(dev).manual_seed(MESH_SEED),
                        torch.float32, dev)
    batches = []
    for i in range(n):
        gen = torch.Generator().manual_seed(MESH_SEED + 1 + i)
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
        labels = toks[:, 1:].clone()
        labels[0, :S // 2] = -1
        labels[-1] = -1
        batches.append({"tokens": toks[:, :-1].to(dev),
                        "labels": labels.to(dev)})
    return cfg, model, opt_cfg, params, batches


def one_rank_steps(kind: str, dev) -> dict:
    """The steps of (a) or (b) without a mesh, on the card: each step's
    loss and ms, the first step's gradient and the params after the
    steps (left on the card, which the ranks then share)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.optim import init_state
    from repro_torch.tree import leaves

    cfg, model, opt_cfg, params, batches = mesh_train_setup(kind, dev)
    state = init_state(opt_cfg, params)
    step = steps.make_train_step(model, opt_cfg)
    grads = []
    orig = steps.apply_updates

    def capturing(c, p, g, st, **kw):
        if not grads:
            grads.extend(x.clone() for x in leaves(g))
        return orig(c, p, g, st, **kw)

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    with swapped(steps, "apply_updates", capturing):
        for b in batches:
            (params, state, loss), dt = timed(lambda: step(params, state, b))
            losses.append(float(loss))
            ms.append(dt * 1e3)
    # kept on the card: the spawned ranks open them through CUDA IPC
    out = {"losses": losses, "ms": ms, "grads": grads,
           "params": leaves(params), "peak": torch.cuda.max_memory_allocated()}
    del params, state, step, batches, grads
    free_model(f"phase 23 {kind} one rank")
    return out


def mesh_train_rank(device, kind: str, shape, ref: dict) -> dict:
    """Phase 23 on one rank: the steps of (a) or (b) under a ``shape``
    (data, model) mesh from the same params and global batches as the
    parent's one-rank steps ``ref``, the rank holding its slice of each
    expert stack; the first step's gradient and the params after the
    steps against ``ref``'s, the step and exchange times, the exchanged
    bytes, the peak memory; for (b) one more step at capacity 1.25 with
    its dropped slots."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import ParallelCtx, transformer
    from repro_torch.optim import init_state
    from repro_torch.parallel.sharding import (dp_axes, local_shard,
                                               spec_for_param)
    from repro_torch.tree import leaves, rebuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh(shape, ("data", "model"), device=device)
    ctx = ParallelCtx(mesh=mesh, dp_spec="data")

    def sync():
        torch.cuda.synchronize(device)
        dist.barrier()

    def spec_for(path, p):
        return spec_for_param(path, tuple(p.shape), mesh)

    def held(params):
        """The params as the rank holds them: expert stacks cut."""
        return rebuild(params, [
            local_shard(p, spec_for(path, p), mesh).clone()
            if steps._EXPERTS.search(path) else p
            for path, p in zip(steps._paths(params), leaves(params))])

    def sliced(want, path, got):
        """``ref``'s leaf (on the parent's card) cut to this rank's slice
        where the rank holds one, on this rank's card."""
        if tuple(want.shape) != tuple(got.shape):
            want = local_shard(want, spec_for(path, want), mesh)
        return want.to(device)

    res = {"transport": dist.get_backend(), "rank": dist.get_rank(),
           "t_in": time.time()}
    cfg, model, opt_cfg, params, batches = mesh_train_setup(kind, device)
    params = held(params)
    paths = steps._paths(params)
    state = init_state(opt_cfg, params)
    step = steps.make_train_step(model, opt_cfg, ctx)
    grads, ex_s, ex_bytes = [], [], []
    orig_update, orig_exchange = steps.apply_updates, steps.exchange

    def capturing(c, p, g, st, **kw):
        if not grads:
            grads.extend(x.clone() for x in leaves(g))
        return orig_update(c, p, g, st, **kw)

    def timed_exchange(gl, specs, m):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = orig_exchange(gl, specs, m)
        torch.cuda.synchronize(device)
        ex_s.append(time.perf_counter() - t0)
        ex_bytes.append(sum(
            4 * g.numel() for g, sp in zip(gl, specs)
            if any(a not in steps._named(sp) and m.shape[a] > 1
                   for a in dp_axes(m))))
        return out

    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats(device)
    with swapped(steps, "apply_updates", capturing), \
            swapped(steps, "exchange", timed_exchange):
        for b in batches:
            sync()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, b)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    res.update(losses=losses, ms=ms, exchange_s=ex_s, exchange_bytes=ex_bytes,
               peak=torch.cuda.max_memory_allocated(device),
               t_steps=time.time())
    del state
    # the params the steps started from, drawn again from their seed
    start = leaves(held(mesh_train_setup(kind, device)[3]))
    worst_g = worst_u = worst_p = 0.0
    for path, g, w in zip(paths, grads, ref["grads"]):
        w = sliced(w, path, g)
        worst_g = max(worst_g, float((g - w).abs().max() / w.abs().max()))
    for path, p, p0, w in zip(paths, leaves(params), start, ref["params"]):
        w = sliced(w, path, p)
        upd = torch.linalg.vector_norm(w - p0)
        worst_u = max(worst_u, float(torch.linalg.vector_norm(p - w) / upd))
        worst_p = max(worst_p, float((p - w).abs().max() / w.abs().max()))
    res.update(grad_gap=worst_g, update_gap=worst_u, param_gap=worst_p,
               held_values=sum(p.numel() for p in leaves(params)),
               t_checked=time.time())
    del params, grads, step, start
    if kind == "ep":
        # one step at the config's capacity factor, which drops slots
        cfg, model, opt_cfg, params, batches = mesh_train_setup(
            kind, device, MESH_EP_DROP_CF)
        params = held(params)
        state = init_state(opt_cfg, params)
        drops = []
        orig_ep = transformer.moe_ep_apply

        def recording(*a, **kw):
            st = {}
            out = orig_ep(*a, stats=st, **kw)
            drops.append(st["dropped"])
            return out

        with swapped(transformer, "moe_ep_apply", recording):
            _, _, loss = steps.make_train_step(model, opt_cfg, ctx)(
                params, state, batches[0])
        # the forward's calls, one a layer (remat recomputes them)
        fwd = drops[:cfg.n_layers]
        res.update(drop_loss=float(loss), dropped=(
            sum(d[0] for d in fwd), sum(d[1] for d in fwd)),
            layers=cfg.n_layers, top_k=cfg.moe.top_k,
            tokens=batches[0]["tokens"].numel() // mesh.size)
    res["t_out"] = time.time()
    return res


def train_mesh_path(dev, card) -> None:
    """Phase 23, after phase 22: the train step under a mesh, through
    ``run_ranks``.  (a) llama3.2-1b at full width and depth (8 of its 16
    layers on one card, :data:`MESH_DP_LAYERS_ONE_CARD`),
    data-parallel: a (4, 1) mesh over NCCL with four cards, else (2, 1)
    over gloo on the one card (four ranks of f32 params, gradients and two
    moments would not fit it), phase 17's B=8 S=256 global batch, 3 steps.
    (b) granite-moe-1b-a400m at full width and depth (8 of its 24
    layers on one card, :data:`MESH_EP_LAYERS_ONE_CARD`) with
    ``impl="ep_a2a"`` on a (2, 2) mesh: the 32 experts over (data,
    model), 8 a rank, B=8 S=512, 2 steps at capacity 4.0, then one step
    at 1.25 with its dropped slots.  Each is held against the same steps
    without a mesh in this process first: every rank's loss within
    ``MESH_LOSS_RTOL``, the first step's gradient leaves within
    ``MESH_GRAD_TOL`` of their largest, the params after the steps within
    ``TRAIN_STATE_RTOL``'s update norm."""
    import torch

    from repro_torch.launch.mesh import default_transport, run_ranks

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    for kind in ("dp", "ep"):
        t0 = time.perf_counter()
        shape = ((4, 1) if kind == "dp" and cards >= 4 else
                 (2, 1) if kind == "dp" else MESH_EP_SHAPE)
        world = shape[0] * shape[1]
        transport = default_transport(world, dev)
        t_one = time.time()
        ref = one_rank_steps(kind, dev)
        t_call = time.time()
        ranks, t_ranks = timed(lambda: run_ranks(
            mesh_train_rank, world, kind, shape, ref, device=dev.type,
            backend=transport, timeout=600))
        label = (f"(a) {LLAMA} data-parallel" if kind == "dp" else
                 f"(b) {GRANITE} expert-parallel (ep_a2a)") + (
            "" if cards >= 4 else
            f" at {MESH_DP_LAYERS_ONE_CARD} of 16 layers (depth cut on one "
            f"card)" if kind == "dp" else
            f" at {MESH_EP_LAYERS_ONE_CARD} of 24 layers (depth cut on one "
            f"card)")
        for r in ranks:
            gaps = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                        ref["losses"])]
            if r["transport"] != transport or not max(gaps) <= \
                    MESH_LOSS_RTOL:
                raise AssertionError(f"phase 23 {label} rank {r['rank']} "
                                     f"over {r['transport']}: losses "
                                     f"{r['losses']}, one rank "
                                     f"{ref['losses']}")
            if not r["grad_gap"] <= MESH_GRAD_TOL:
                raise AssertionError(f"phase 23 {label} rank {r['rank']}: a "
                                     f"gradient leaf {r['grad_gap']:.3e} of "
                                     f"its largest from the one-rank step")
            if not r["update_gap"] <= TRAIN_STATE_RTOL[1]["updates"]:
                raise AssertionError(f"phase 23 {label} rank {r['rank']}: a "
                                     f"param leaf {r['update_gap']:.3e} of "
                                     f"its update from the one-rank step")
        slowest = [round(max(x), 3) for x in zip(*(r["ms"] for r in ranks))]
        log(f"phase 23 {label}: mesh {shape} (data, model) over "
            f"{transport}, {world} ranks, {cards} cards, {card}; "
            f"{len(ref['losses'])} steps; losses a rank "
            f"{[r['losses'] for r in ranks]}, one rank {ref['losses']}; "
            f"largest gaps to the one-rank step: gradient "
            f"{max(r['grad_gap'] for r in ranks):.3e} of a leaf's largest "
            f"(tol {MESH_GRAD_TOL}), params "
            f"{max(r['param_gap'] for r in ranks):.3e} of a leaf's largest, "
            f"{max(r['update_gap'] for r in ranks):.3e} of a leaf's update "
            f"norm (tol {TRAIN_STATE_RTOL[1]['updates']}); step ms a rank "
            f"(slowest) {slowest}, one rank "
            f"{[round(x, 3) for x in ref['ms']]}; exchange "
            f"{[round(x, 3) for x in ranks[0]['exchange_s']]} s a step on "
            f"rank 0, {ranks[0]['exchange_bytes'][0]} f32 bytes a rank a "
            f"step; values held a rank "
            f"{[r['held_values'] for r in ranks]}; peak device memory a "
            f"rank {[r['peak'] for r in ranks]} bytes, one rank "
            f"{ref['peak']}")
        if kind == "ep":
            drops = [r["dropped"] for r in ranks]
            if not any(d[0] + d[1] for d in drops) or not all(
                    np.isfinite(r["drop_loss"]) for r in ranks):
                raise AssertionError(f"phase 23 {label} at capacity "
                                     f"{MESH_EP_DROP_CF}: losses "
                                     f"{[r['drop_loss'] for r in ranks]}, "
                                     f"dropped {drops}")
            log(f"phase 23 {label} at capacity {MESH_EP_DROP_CF}: one step, "
                f"loss a rank {[r['drop_loss'] for r in ranks]}; dropped "
                f"slots (send buffer, experts) a rank over the "
                f"{ranks[0]['layers']} layers' forward {drops}, of "
                f"{ranks[0]['tokens']} tokens x top-{ranks[0]['top_k']} a "
                f"rank a layer")
        del ref

        def after(key):
            return max(r[key] for r in ranks) - t_call

        log(f"phase 23 {label}: {time.perf_counter() - t0:.1f} s; one rank "
            f"{t_call - t_one:.1f} s; run_ranks {t_ranks:.1f} s: the ranks "
            f"entered {after('t_in'):.1f} s after the call, ended their "
            f"steps at {after('t_steps'):.1f} s, their checks at "
            f"{after('t_checked'):.1f} s, left at {after('t_out'):.1f} s")
    log(f"phase 23 wall {time.perf_counter() - t_phase:.1f} s on {card}")


# ----------------------------------- phase 24: tensor-parallel serving
TP_RANKS = 4
TP_MESH = (1, 4)                        # (a), (b): internvl2-26b, 'model' 4
TP_LLAMA_MESH = (2, 2)                  # (c): llama3.2-1b
#: (a) internvl2-26b with every width as published cut to 8 layers: 17.03
#: GB of f32 weights whole, 7.67 GB a rank under param_specs on (1, 4),
#: held against the one-rank run of the same params
TP_VLM_DEPTH = 8
#: (b) all 48 layers (23.27 GB a rank) with four cards; on one card,
#: where the four ranks share its 80 GB, 12 (9.23 GB a rank)
TP_VLM_LAYERS, TP_VLM_DEPTH_ONE_CARD = 48, 12
TP_SEED = 2500


def tp_vlm_inputs(cfg, dev) -> dict:
    """(a)'s and (b)'s inputs, drawn on ``dev`` from ``TP_SEED + 1`` (the
    same values on every card): the prefill step's batch (B=2, 256
    patches and 3,840 text tokens, by ``configs.input_specs``) and the
    serve loop's prompts ``[4, 512]`` and patches."""
    import torch

    from repro_torch.configs import ShapeSpec, input_specs

    gen = torch.Generator(dev).manual_seed(TP_SEED + 1)
    spec = input_specs(cfg, ShapeSpec("prefill_step", PREFILL_S, PREFILL_B,
                                      "prefill"), torch.float32)
    P, d = cfg.frontend_seq, cfg.d_model

    def prefix(b):
        return FRAME_SCALE * torch.randn((b, P, d), generator=gen,
                                         device=dev)

    return {"prefill": {"tokens": torch.randint(
                0, cfg.vocab, tuple(spec["tokens"].shape), generator=gen,
                device=dev), "extra_embeds": prefix(PREFILL_B)},
            "prompts": torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LP),
                                     generator=gen, device=dev),
            "prefix": prefix(SERVE_B)}


def tp_llama_batch(cfg, dev) -> dict:
    """(c)'s global batch, drawn on ``dev`` from ``TP_SEED + 3``."""
    import torch

    gen = torch.Generator(dev).manual_seed(TP_SEED + 3)
    return {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                    generator=gen, device=dev)}


def tp_references(dev) -> dict:
    """Phase 24's one-rank runs in this process, each freed before the
    ranks start: (a) internvl2-26b at 8 layers, its prefill step and the
    serve loop (its tokens and each step's logits); (c) llama3.2-1b's
    prefill step.  NumPy, for the ranks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM).replace(n_layers=TP_VLM_DEPTH, attn_impl="cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(TP_SEED),
                        torch.float32, dev)
    inp = tp_vlm_inputs(cfg, dev)
    with torch.no_grad():
        prefill, t_prefill = timed(lambda: make_prefill_step(model)(
            params, inp["prefill"]))
        res = serve(cfg, gen=SERVE_G, device=dev, params=params,
                    prompts=inp["prompts"], extra_embeds=inp["prefix"])
    check_generated(res, cfg.vocab, f"phase 24 (a) {VLM} one rank")
    out = {"a_prefill": prefill.cpu().numpy(),
           "a_tokens": res.tokens.cpu().numpy(),
           "a_logits": torch.stack(res.logits, dim=1).cpu().numpy(),
           "a_ms": (t_prefill * 1e3, res.prefill_s * 1e3,
                    res.decode_s_per_step * 1e3),
           "a_peak": torch.cuda.max_memory_allocated()}
    del params, prefill, res, inp
    free_model(f"phase 24 (a) {VLM} at {TP_VLM_DEPTH} layers, one rank")
    cfg = get_config(LLAMA).replace(attn_impl="cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(TP_SEED + 2),
                        torch.float32, dev)
    with torch.no_grad():
        prefill, t_prefill = timed(lambda: make_prefill_step(model)(
            params, tp_llama_batch(cfg, dev)))
    out.update(c_prefill=prefill.cpu().numpy(), c_ms=t_prefill * 1e3)
    del params, prefill
    free_model(f"phase 24 (c) {LLAMA}, one rank")
    return out


def tp_rank(device, ref_path: str, vlm_layers: int) -> dict:
    """Phase 24 on one of four ranks: (a) internvl2-26b at 8 layers and
    (b) at ``vlm_layers`` on a (1, 4) mesh, (c) llama3.2-1b on (2, 2),
    each rank drawing its held params layer by layer from the seed of
    the parent's one-rank runs, whose results ``ref`` (the ``.npz`` at
    ``ref_path``) holds.  (a): the prefill step and the serve loop
    held against ``ref``'s, the decode teacher-forced on its tokens; (b)
    the same two, its decode held against the tensor-parallel forward
    over prefix, prompt and generated tokens; (c) the prefill step
    against ``ref``'s.  Each step through the flash kernel (counted, its
    plain version refused); the held bytes against ``param_specs``', the
    peak memory, the times, the all-reduces' count and bytes."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_hm
    from repro_torch.launch.dryrun import spec_bytes
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import (make_cache_prefill_step,
                                          make_decode_step, make_prefill_step)
    from repro_torch.models import ParallelCtx, build_model
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import cache_block, param_specs
    from repro_torch.tree import leaves

    res = {"transport": dist.get_backend(), "rank": dist.get_rank(),
           "device": str(device), "t_in": time.time()}
    with np.load(ref_path) as f:
        ref = dict(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        lib = build.library_path("flash_attention")
        if not lib.is_file():
            raise RuntimeError(f"{lib.name} was not built by the parent")
        build.load("flash_attention")
    meshes = {shape: Mesh(shape, ("data", "model"), device=device)
              for shape in (TP_MESH, TP_LLAMA_MESH)}
    res["t_meshes"] = time.time()
    nccl = dist.get_backend() == "nccl"
    reduced = collections.Counter()
    orig = collectives._all_reduce

    def counting(x, group, op):
        if group.pg is not None:
            reduced["count"] += 1
            reduced["bytes"] += x.numel() * x.element_size()
        return orig(x, group, op)

    def sync():
        torch.cuda.synchronize(device)
        dist.barrier()

    def close(got, want) -> tuple[float, bool]:
        want = torch.as_tensor(want).to(got.device)
        return (float((got - want).abs().max()),
                bool(torch.allclose(got, want, **MODEL_TOL)))

    def counted(fn):
        """``fn()`` with the flash launches and all-reduces it makes,
        counted from 0, and its seconds."""
        sync()
        flash_attention_hm.launches = 0
        reduced.clear()
        out, dt = timed(fn)
        return out, dt, flash_attention_hm.launches, dict(reduced)

    def held_model(cfg, mesh, seed):
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats(device)
        params = model.init(torch.Generator(device).manual_seed(seed),
                            torch.float32, device, mesh=mesh)
        meta = model.init(torch.Generator(), torch.float32, "meta")
        held = sum(t.numel() * t.element_size() for t in leaves(params))
        return model, params, {"held": held, "by_specs": spec_bytes(
            meta, param_specs(meta, mesh), mesh)}

    def vlm(layers: int) -> dict:
        mesh = meshes[TP_MESH]
        ctx = ParallelCtx(mesh=mesh, dp_spec="data")
        cfg = get_config(VLM).replace(n_layers=layers, attn_impl="cuda")
        model, params, out = held_model(cfg, mesh, TP_SEED)
        inp = tp_vlm_inputs(cfg, device)
        step = make_prefill_step(model, ctx)
        got, dt, out["launches"], out["prefill_reduced"] = counted(
            lambda: step(params, inp["prefill"]))
        out["prefill_ms"] = [dt * 1e3]
        if nccl:
            out["prefill_ms"].append(timed(lambda: step(
                params, inp["prefill"]))[1] * 1e3)
        out["prefill_shape"] = tuple(got.shape)
        out["finite"] = bool(torch.isfinite(got).all())
        if layers == TP_VLM_DEPTH:
            out["prefill_err"], out["prefill_ok"] = close(got, ref[
                "a_prefill"])
        del got
        reduced.clear()
        served = serve(cfg, gen=SERVE_G, device=device, params=params,
                       prompts=inp["prompts"], extra_embeds=inp["prefix"],
                       ctx=ctx)
        out["serve_ms"] = (served.prefill_s * 1e3,
                           served.decode_s_per_step * 1e3)
        out["serve_reduced"] = dict(reduced)
        out["tokens"] = served.tokens.cpu().numpy()
        P = cfg.frontend_seq
        if layers == TP_VLM_DEPTH:
            # teacher-forced on the one-rank tokens, step by step
            caches = cache_block(model, SERVE_B, P + SERVE_LP + SERVE_G + 1,
                                 torch.float32, device, mesh)
            logits, caches = make_cache_prefill_step(model, ctx)(
                params, caches, {"tokens": inp["prompts"],
                                 "extra_embeds": inp["prefix"]})
            errs = [close(logits, ref["a_logits"][:, 0])]
            decode = make_decode_step(model, ctx)
            tokens = torch.from_numpy(ref["a_tokens"]).to(device)
            for i in range(SERVE_G - 1):
                logits, caches = decode(params, caches, {
                    "tokens1": tokens[:, i:i + 1],
                    "pos": P + SERVE_LP + i})
                errs.append(close(logits, ref["a_logits"][:, i + 1]))
            out["decode_err"] = max(e for e, _ in errs)
            out["decode_ok"] = all(ok for _, ok in errs)
            out["cache_heads"] = caches["dense"]["k"].shape[3]
            del caches, logits
        else:
            # the tensor-parallel forward over prefix, prompt and the
            # generated tokens it was fed
            seq = torch.cat([inp["prompts"], served.tokens[:, :-1]], dim=1)
            full, _ = model.forward(params, seq, extra_embeds=inp["prefix"],
                                    ctx=ctx)
            out["decode_err"], out["decode_ok"] = close(
                torch.stack(served.logits, dim=1),
                full[:, P + SERVE_LP - 1:])
            del full
        out["peak"] = torch.cuda.max_memory_allocated(device)
        del params, served, inp
        return out

    def llama() -> dict:
        mesh = meshes[TP_LLAMA_MESH]
        ctx = ParallelCtx(mesh=mesh, dp_spec="data")
        cfg = get_config(LLAMA).replace(attn_impl="cuda")
        model, params, out = held_model(cfg, mesh, TP_SEED + 2)
        got, dt, out["launches"], out["prefill_reduced"] = counted(
            lambda: make_prefill_step(model, ctx)(
                params, tp_llama_batch(cfg, device)))
        out["prefill_ms"] = [dt * 1e3]
        out["prefill_shape"] = tuple(got.shape)
        out["finite"] = bool(torch.isfinite(got).all())
        out["prefill_err"], out["prefill_ok"] = close(got, ref["c_prefill"])
        out["peak"] = torch.cuda.max_memory_allocated(device)
        del params
        return out

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    with torch.no_grad(), plain_refused(fa_mod, "flash_attention_hm_torch"), \
            swapped(collectives, "_all_reduce", counting):
        for key, run in (("a", lambda: vlm(TP_VLM_DEPTH)),
                         ("b", lambda: vlm(vlm_layers)), ("c", llama)):
            t0 = time.perf_counter()
            res[key] = run()
            res[key]["s"] = time.perf_counter() - t0
            release()
            sync()
    res["t_out"] = time.time()
    return res


def tp_path(dev, card) -> dict:
    """Phase 24, after phase 23: tensor-parallel serving through
    ``run_ranks``, four ranks (NCCL with each its own card when the host
    has four, else gloo on the one card with every exchange staged
    through the host).  The one-rank runs of (a) and (c) first, in this
    process (:func:`tp_references`), then one call of :func:`tp_rank`,
    whose results are checked here: every rank's logits finite, of the
    global shape, within ``MODEL_TOL``, its held bytes equal to
    ``param_specs``', its flash launches one a layer.  Returns the flash
    launches of each prefill step, summed over the ranks, the flash
    kernel's record at internvl2-26b's per-rank shape and (b)'s layers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import default_transport, run_ranks

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    transport = default_transport(TP_RANKS, dev)
    layers = TP_VLM_LAYERS if transport == "nccl" else TP_VLM_DEPTH_ONE_CARD
    how = ("each rank its own card" if transport == "nccl" else
           "the ranks share one device, CUDA tensors staged through the host"
           if dev.type == "cuda" else "CPU tensors")
    log(f"phase 24 transport: {transport} ({how}), {TP_RANKS} ranks, "
        f"{cards} cards, {card}; (b) {VLM} at {layers} of "
        f"{TP_VLM_LAYERS} layers"
        + ("" if layers == TP_VLM_LAYERS else
           f" (depth cut: the four ranks share one card)"))
    ref, t_ref = timed(lambda: tp_references(dev))
    # to the ranks through a file: a spawned rank's arguments go down a
    # pipe that the parent fills one rank at a time, each as that rank
    # starts, so tens of MB of them serialise the ranks' start
    ref_path = ROOT / "build" / "phase24_reference.npz"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(ref_path, **ref)
    t_call = time.time()
    try:
        ranks, t_ranks = timed(lambda: run_ranks(
            tp_rank, TP_RANKS, str(ref_path), layers, device=dev.type,
            backend=transport, timeout=900))
    finally:
        ref_path.unlink()
    vcfg, lcfg = get_config(VLM), get_config(LLAMA)
    launches = {}
    for key, label, depth, B, V in (
            ("a", f"(a) {VLM} at {TP_VLM_DEPTH} layers on {TP_MESH}",
             TP_VLM_DEPTH, PREFILL_B, vcfg.vocab),
            ("b", f"(b) {VLM} at {layers} layers on {TP_MESH}", layers,
             PREFILL_B, vcfg.vocab),
            ("c", f"(c) {LLAMA} on {TP_LLAMA_MESH}", lcfg.n_layers,
             PREFILL_B, lcfg.vocab)):
        rs = [r[key] for r in ranks]
        for r, x in zip(ranks, rs):
            bad = [k for k in ("prefill_ok", "decode_ok") if k in x
                   and not x[k]]
            if r["transport"] != transport or x["launches"] != depth or bad \
                    or x["held"] != x["by_specs"] or not x["finite"] \
                    or x["prefill_shape"] != (B, V):
                raise AssertionError(
                    f"phase 24 {label} rank {r['rank']} over "
                    f"{r['transport']}: flash launches {x['launches']} for "
                    f"{depth} layers, held {x['held']} bytes against "
                    f"{x['by_specs']} by the specs, failed {bad}, "
                    + ", ".join(f"{k} {x[k]}" for k in (
                        "prefill_err", "decode_err", "prefill_shape",
                        "finite") if k in x))
        if key != "c":
            toks = [x["tokens"] for x in rs]
            if any(not np.array_equal(t, toks[0]) for t in toks):
                raise AssertionError(f"phase 24 {label}: the ranks' greedy "
                                     f"tokens differ")
        launches[key] = sum(x["launches"] for x in rs)
        line = (f"phase 24 {label} over {transport}, {cards} cards, {card}: "
                f"held param bytes a rank {[x['held'] for x in rs]} "
                f"({rs[0]['held'] / 1e9:.2f} GB; param_specs' "
                f"{rs[0]['by_specs']}); peak device memory a rank "
                f"{[x['peak'] for x in rs]} bytes; make_prefill_step "
                f"B={PREFILL_B} S={PREFILL_S} ms a rank "
                f"{[[round(t, 1) for t in x['prefill_ms']] for x in rs]} "
                f"(first call{', then warm' if transport == 'nccl' else ''})"
                f"; flash launches a rank {[x['launches'] for x in rs]}; "
                f"all-reduces a rank in the step "
                f"{[x['prefill_reduced'] for x in rs]}")
        if "prefill_err" in rs[0]:
            one = ref["a_ms"][0] if key == "a" else ref["c_ms"]
            line += (f"; last logits vs one rank max abs "
                     f"{max(x['prefill_err'] for x in rs):.3e} (tol "
                     f"{MODEL_TOL}; one rank {one:.1f} ms)")
        log(line)
        if key == "c":
            continue
        agree = int((rs[0]["tokens"] == ref["a_tokens"]).sum())
        log(f"phase 24 {label} serve B={SERVE_B}, {vcfg.frontend_seq} "
            f"patches + a {SERVE_LP}-token prompt, {SERVE_G} tokens: "
            f"prefill ms / decode ms a step a rank "
            f"{[tuple(round(t, 2) for t in x['serve_ms']) for x in rs]}; "
            f"all-reduces a rank over the loop "
            f"{[x['serve_reduced'] for x in rs]}; "
            + (f"decode teacher-forced on the one-rank tokens vs its logits "
               f"max abs {max(x['decode_err'] for x in rs):.3e}, cache "
               f"{rs[0]['cache_heads']} of {vcfg.n_kv_heads} kv heads a "
               f"rank; greedy tokens equal to one rank's {agree} of "
               f"{ref['a_tokens'].size} (one rank: prefill "
               f"{ref['a_ms'][1]:.1f} ms, decode {ref['a_ms'][2]:.2f} ms a "
               f"step, peak {ref['a_peak']} bytes)"
               if key == "a" else
               f"decode vs the tensor-parallel forward over prefix, prompt "
               f"and generated tokens max abs "
               f"{max(x['decode_err'] for x in rs):.3e}")
            + f" (tol {MODEL_TOL}); sample ids {rs[0]['tokens'][0, :8]}")

    def after(key):
        return max(r[key] for r in ranks) - t_call

    log(f"phase 24 wall {time.perf_counter() - t_phase:.1f} s on {card}: "
        f"one-rank runs {t_ref:.1f} s, run_ranks {t_ranks:.1f} s (the ranks "
        f"entered {after('t_in'):.1f} s after the call, had their meshes at "
        f"{after('t_meshes'):.1f} s, left at {after('t_out'):.1f} s; (a) "
        f"{max(r['a']['s'] for r in ranks):.1f} s, (b) "
        f"{max(r['b']['s'] for r in ranks):.1f} s, (c) "
        f"{max(r['c']['s'] for r in ranks):.1f} s)")
    free_model("phase 24")
    flash = flash_at(dev, vcfg.replace(
        head_dim=vcfg.hd(), n_heads=vcfg.n_heads // TP_MESH[1],
        n_kv_heads=max(1, vcfg.n_kv_heads // TP_MESH[1])),
        "phase 24 a rank's")
    return launches, flash, layers


def flash_record(dev, launches: int, path_err: dict, occupancy: dict) -> dict:
    """Phase 12 for flash attention: times and bounds at llama3.2-1b's
    prefill-step shape, in f32 as the path runs it (bf16 beside it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (cost,
                                                     flash_attention_hm,
                                                     flash_attention_hm_torch)

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
    del flush
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    fa["ms_bf16"] = event_ms(lambda: flash_attention_hm(qb, kb, vb), reps=7,
                             inner=5)
    fa["library_ms_bf16"] = event_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, enable_gqa=True), reps=7, inner=5)
    fa_q, fa_kv = q.shape, k.shape
    del q, k, v, qb, kb, vb
    work = cost(fa_q, fa_kv)                # causal QK^T and PV, f32
    flops, exps, nbytes = work["flops"], work["exps"], work["bytes"]
    # at f32 accuracy the products run at 3xTF32's rate; SIMT f32 beside it
    ops_s, bytes_s = flops / TF32X3_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    fa["bound_ms_simt"] = max(flops / F32_FLOP_PER_S, bytes_s) * 1e3
    # bf16: the products on the bf16 tensor cores and the exponentials on
    # the SFUs, each a bound, and half the bytes
    fa["bound_ms_bf16"] = max(
        flops / BF16_FLOP_PER_S, exps / SFU_EXP_PER_S,
        cost(fa_q, fa_kv, itemsize=2)["bytes"] / HBM_BYTES_PER_S) * 1e3
    fa["replaced_ms"] = REPLACED_MS["flash_attention_hm"]
    shape = f"q {list(fa_q)} k/v {list(fa_kv)} f32 causal"
    rec = {
        "name": "flash_attention_hm", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": launches, "matched": True,
        "max_abs_err": path_err["flash_attention_hm"],
        **fa, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "shape": shape, "flops": flops, "exps": exps, "bytes": nbytes,
        **occupancy["flash_attention_hm"]}
    log(f"phase 12 flash_attention_hm ({shape}): kernel {fa['ms']:.4f} ms "
        f"(cold L2 {fa['ms_cold_l2']:.4f} ms), plain {fa['plain_ms']:.4f} "
        f"ms, library {fa['library_ms']}, bound {rec['bound_ms']:.4f} ms "
        f"({flops} flop at 165 TFLOP/s (3xTF32): {ops_s * 1e3:.4f} ms; "
        f"{nbytes} bytes at 3.35 TB/s: {bytes_s * 1e3:.4f} ms)")
    log(f"phase 12 flash_attention_hm: SIMT f32 bound "
        f"{fa['bound_ms_simt']:.4f} ms; bf16 kernel {fa['ms_bf16']:.4f} ms, "
        f"scaled_dot_product_attention bf16 {fa['library_ms_bf16']:.4f} ms, "
        f"bf16 bound {fa['bound_ms_bf16']:.4f} ms ({exps} exponentials at "
        f"{SFU_EXP_PER_S:.4g}/s: {exps / SFU_EXP_PER_S * 1e3:.4f} ms; flop at "
        f"989 TFLOP/s: {flops / BF16_FLOP_PER_S * 1e3:.4f} ms); replaced "
        f"SIMT kernel {fa['replaced_ms']} ms")
    return rec


def wkv6_inputs(dev, gen, case):
    """f32 r, k, v, w, u and the state of a WKV6 path shape: a fresh serve
    cache's zero state where the path passes one, else None."""
    import torch

    B, S, H, D, with_state = case
    r, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, D), generator=gen, device=dev))
    u = 0.1 * torch.randn((H, D), generator=gen, device=dev)
    s0 = torch.zeros((B, H, D, D), device=dev) if with_state else None
    return r, k, v, w, u, s0


def wkv6_record(dev, launches: dict, path_err: dict, occupancy: dict) -> dict:
    """Phase 12 for WKV6: times and bounds at the serve prefill's shape
    (with the fresh cache's zero state) and at ``make_prefill_step``'s (no
    state), in f32 as the path runs them; the kernel must beat the one it
    replaced at both."""
    import torch

    from repro_torch.kernels.wkv6 import cost, wkv6, wkv6_torch

    gen = torch.Generator(dev).manual_seed(8)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    out = {}
    for key, case, plain_reps in (("serve", WKV_PATH, (5, 2)),
                                  ("prefill_step", WKV_PREFILL, (3, 1))):
        B, S, H, D, with_state = case
        args = wkv6_inputs(dev, gen, case)
        t = {
            "ms": event_ms(lambda: wkv6(*args), reps=15, inner=10),
            "ms_cold_l2": event_ms(lambda: wkv6(*args), flush=flush,
                                   reps=15, inner=10),
            "plain_ms": event_ms(lambda: wkv6_torch(*args),
                                 reps=plain_reps[0], inner=plain_reps[1]),
        }
        work = cost((B, S, H, D), with_state=with_state)     # f32
        flops, nbytes = work["flops"], work["bytes"]
        ops_s, bytes_s = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        t.update({
            "launches": launches[key], "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "replaced_ms": REPLACED_MS["wkv6"][key],
            "shape": f"r/k/v/w {[B, S, H, D]} f32, init_state {with_state}",
            "flops": flops, "bytes": nbytes,
            "max_abs_err": path_err["wkv6" if key == "serve"
                                    else f"wkv6 {key}"],
            "blocks": occupancy["wkv6"]["blocks"][key],
            "waves": occupancy["wkv6"]["waves"][key]})
        out[key] = t
        log(f"phase 12 wkv6 ({t['shape']}): kernel {t['ms']:.4f} ms (cold L2 "
            f"{t['ms_cold_l2']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"library None, bound {t['bound_ms']:.4f} ms ({flops} flop at "
            f"67 TFLOP/s: {ops_s * 1e3:.4f} ms; {nbytes} bytes at 3.35 TB/s: "
            f"{bytes_s * 1e3:.4f} ms), the bound {t['bound_ms'] / t['ms']:.1%}"
            f" of the kernel's time; replaced kernel {t['replaced_ms']} ms; "
            f"{launches[key]} launches in one {key.replace('_', ' ')}")
        if not t["ms"] < t["replaced_ms"]:
            raise AssertionError(f"wkv6 at the {key} shape: {t['ms']} ms, "
                                 f"the kernel it replaced "
                                 f"{t['replaced_ms']} ms")
        del args
    del flush
    occ = {k: v for k, v in occupancy["wkv6"].items()
           if k not in ("blocks", "waves")}
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:62", "matched": True,
            **out["serve"],
            "library_ms": None, "at_prefill_step": out["prefill_step"],
            **occ}


def ssd_record(dev, launches: dict, path_err: dict, occupancy: dict) -> dict:
    """Phase 12 for SSD: times and bounds at the serve prefill's shape
    (with the fresh cache's zero state, as a serve run passes it) and at
    ``make_prefill_step``'s (no state), in f32 as the path runs them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import cost, ssd, ssd_torch

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
        work = cost((B, S, H, P), N, with_state=with_state)  # f32
        flops, nbytes = work["flops"], work["bytes"]
        # at f32 accuracy the products run at 3xTF32's rate; SIMT f32 beside
        ops_s, bytes_s = flops / TF32X3_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        t.update({
            "launches": launches[key], "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bound_ms_simt": max(flops / F32_FLOP_PER_S, bytes_s) * 1e3,
            "replaced_ms": REPLACED_MS["ssd"][key],
            "shape": f"x {[B, S, H, P]} Bm/Cm {[B, S, N]} f32, chunk "
                     f"{chunk}, init_state {with_state}",
            "flops": flops, "bytes": nbytes})
        out[key] = t
        log(f"phase 12 ssd ({t['shape']}): kernel {t['ms']:.4f} ms (cold L2 "
            f"{t['ms_cold_l2']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"library None, bound {t['bound_ms']:.4f} ms ({flops} flop at "
            f"165 TFLOP/s (3xTF32): {ops_s * 1e3:.4f} ms; {nbytes} bytes at "
            f"3.35 TB/s: {bytes_s * 1e3:.4f} ms), SIMT f32 bound "
            f"{t['bound_ms_simt']:.4f} ms; replaced SIMT kernel "
            f"{t['replaced_ms']} ms; {launches[key]} launches in one "
            f"{key.replace('_', ' ')}")
        del x, dt, bm, cm, s0, args
    del flush
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:27", "matched": True,
            "max_abs_err": path_err["ssd"], **out["serve"],
            "library_ms": None, "at_prefill_step": out["prefill_step"],
            **occupancy["ssd"]}


def hmma_count(library: Path) -> int:
    """HMMA (tensor-core) instructions in a library's SASS, by cuobjdump."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def kernel_sass(library: Path, tag: str) -> list:
    """The SASS instructions (addresses and encodings dropped) of the
    kernel whose mangled name holds ``tag``, by cuobjdump."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                out[name].append(ins)
    found = [v for k, v in out.items() if tag in k]
    if len(found) != 1:
        raise AssertionError(f"{library.name}: {len(found)} kernels named "
                             f"*{tag}*")
    return found[0]


def occupancy_report(libraries: dict) -> dict:
    """Phase 2, continued: the HMMA count of every kernel's SASS (the
    tensor-core kernels must have some) and, for the serving kernels, what
    they occupy on the card at their path shapes (none may spill).
    Returns ``{record name: {...}}`` for phase 12."""
    import torch

    from repro_torch.kernels import flash_attention, ssd, wkv6

    counts = {n: hmma_count(p) for n, p in libraries.items()}
    log(f"phase 2 SASS (cuobjdump -sass | grep -c HMMA): {counts}")
    for name in TENSOR_CORE_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no HMMA instruction in its SASS")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    # grids: ssd a block per (b, h, 32 columns of P), flash a block per
    # (b, h, 64 query rows), wkv6 a block per (b, h, 32 state columns)
    wkv_blocks = WKV_PATH[3] // WKV_BLOCK_COLUMNS
    for rec, lib, occ, blocks in (
            ("ssd", "ssd", ssd.occupancy(torch.float32),
             {"serve": SSD_PATH[0] * SSD_PATH[2] * 2,
              "prefill_step": SSD_PREFILL[0] * SSD_PREFILL[2] * 2}),
            ("flash_attention_hm", "flash_attention",
             flash_attention.occupancy(torch.float32, 64),
             {"prefill_step": -(-FLASH_PATH[3] // 64) * FLASH_PATH[0]
              * FLASH_PATH[1]}),
            ("flash_attention_hm_d128", "flash_attention",
             flash_attention.occupancy(torch.float32, 128),
             {"prefill_step": -(-FLASH_INTERNVL[3] // 64)
              * FLASH_INTERNVL[0] * FLASH_INTERNVL[1]}),
            ("wkv6", "wkv6", wkv6.occupancy(torch.float32, torch.float32, 64),
             {"serve": WKV_PATH[0] * WKV_PATH[2] * wkv_blocks,
              "prefill_step": WKV_PREFILL[0] * WKV_PREFILL[2] * wkv_blocks})):
        waves = {k: round(v / (occ["blocks_per_sm"] * sms), 3)
                 for k, v in blocks.items()}
        out[rec] = {"hmma": counts[lib], **occ, "blocks": blocks,
                    "waves": waves}
        log(f"phase 2 {rec} f32: {occ['registers']} registers and "
            f"{occ['local_bytes']} spilled bytes a thread, "
            f"{occ['shared_bytes']} B of shared memory and "
            f"{occ['threads']} threads a block, {occ['blocks_per_sm']} "
            f"blocks an SM; grid {blocks} blocks on {sms} SMs: {waves} "
            f"waves")
    extra = {f"{torch.bfloat16} D={d}": flash_attention.occupancy(
        torch.bfloat16, d) for d in (64, 128)}
    extra["ssd bf16"] = ssd.occupancy(torch.bfloat16)
    for dt, wdt in ((torch.bfloat16, torch.bfloat16),
                    (torch.bfloat16, torch.float32)):
        for d in (64, 128):
            extra[f"wkv6 {dt} w {wdt} D={d}"] = wkv6.occupancy(dt, wdt, d)
    extra["wkv6 f32 D=128"] = wkv6.occupancy(torch.float32, torch.float32, 128)
    log(f"phase 2 other variants (registers, spills, shared bytes, blocks "
        f"an SM): " + "; ".join(
            f"{k}: {v['registers']}, {v['local_bytes']}, "
            f"{v['shared_bytes']}, {v['blocks_per_sm']}"
            for k, v in extra.items()))
    # the path's kernels must not spill; the other variants are logged
    for k, v in out.items():
        if v["local_bytes"]:
            raise AssertionError(f"{k}: {v['local_bytes']} bytes of local "
                                 f"memory a thread (spills)")
    return out


def ablation(dev, card, replaced: Path | None = None) -> dict:
    """``--ablation``: ``ssd`` (f32) and ``flash_attention_hm`` (f32 and
    bf16) at zamba2-7b's and llama3.2-1b's prefill-step shapes, and
    ``wkv6`` (f32) at rwkv6-1.6b's serve and prefill-step shapes, each
    built as it is and with each part of ``ABLATIONS`` that it reads
    (``ABLATED``) taken out, timed through their wrappers with CUDA
    events; flash also in f32 at internvl2-26b's shape (head dim 128).
    With ``--replaced DIR``, the ``wkv6`` and ``flash_attention`` kernels
    of the checkout at ``DIR`` are built too and timed beside these, in
    turns (replaced, this, this, replaced), and the head-dim-64 flash
    kernels of the two libraries compared in their SASS."""
    import ctypes
    import unittest.mock

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sd
    from repro_torch.kernels import wkv6 as wk

    modules = {"ssd": sd, "flash_attention": fa, "wkv6": wk}
    jobs = [(v, n) for v in ABLATIONS for n in ABLATED[v]]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: build.compile_library(j[1], ABLATIONS[j[0]]),
                    jobs))
    out = {"card": card, "ms": {}}
    old = {}
    if replaced is not None:
        # that checkout's source, and its headers on the include path
        csrc = replaced.resolve() / "src" / "repro_torch" / "csrc"
        flags = list(build.NVCC_FLAGS)
        flags[flags.index("-I") + 1] = str(csrc)
        with unittest.mock.patch.object(build, "CSRC", csrc), \
                unittest.mock.patch.object(build, "NVCC_FLAGS", tuple(flags)):
            paths = {n: build.compile_library(n)
                     for n in ("wkv6", "flash_attention")}
        old = {n: modules[n]._bind(ctypes.CDLL(str(p)))
               for n, p in paths.items()}
        same = {}
        for tag in ("IfLi64E", "I13__nv_bfloat16Li64E"):
            a, b = (kernel_sass(p, tag) for p in (
                paths["flash_attention"],
                build.library_path("flash_attention")))
            same[tag] = a == b
        out["flash_d64_sass_identical"] = same
        log(f"ablation flash_attention head dim 64 SASS identical to "
            f"{replaced}'s (f32, bf16): {same}")
    gen = torch.Generator(dev).manual_seed(9)
    B, S, H, P, N, chunk, _ = SSD_PREFILL
    ssd_args = (torch.randn((B, S, H, P), generator=gen, device=dev),
                F.softplus(torch.randn((B, S, H), generator=gen, device=dev)),
                -torch.ones(H, device=dev),
                *(torch.randn((B, S, N), generator=gen, device=dev)
                  for _ in range(2)))
    B, H, Hkv, Sq, Skv, D, causal = FLASH_PATH
    qkv = [torch.randn(shape, generator=gen, device=dev) for shape in
           ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    qkv_bf16 = [t.bfloat16() for t in qkv]
    B, H, Hkv, Sq, Skv, D, causal = FLASH_INTERNVL
    qkv_d128 = [torch.randn(shape, generator=gen, device=dev) for shape in
                ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    wkv_serve = wkv6_inputs(dev, gen, WKV_PATH)
    wkv_prefill = wkv6_inputs(dev, gen, WKV_PREFILL)
    cases = {
        "ssd float32": ("ssd", lambda: sd.ssd(*ssd_args, chunk=chunk)),
        "flash_attention_hm float32": (
            "flash_attention",
            lambda: fa.flash_attention_hm(*qkv, causal=causal)),
        "flash_attention_hm bfloat16": (
            "flash_attention",
            lambda: fa.flash_attention_hm(*qkv_bf16, causal=causal)),
        "flash_attention_hm float32 head dim 128": (
            "flash_attention",
            lambda: fa.flash_attention_hm(*qkv_d128, causal=causal)),
        "wkv6 float32 serve": ("wkv6", lambda: wk.wkv6(*wkv_serve)),
        "wkv6 float32 prefill_step": ("wkv6", lambda: wk.wkv6(*wkv_prefill)),
    }
    for key, (name, call) in cases.items():
        variants = [(v, modules[name]._lib(d)) for v, d in ABLATIONS.items()
                    if (v, name) in jobs]
        if name in old and key != "flash_attention_hm bfloat16":
            variants = [("replaced", old[name]), variants[0], variants[0],
                        ("replaced", old[name])] + variants[1:]
        for variant, lib in variants:
            with unittest.mock.patch.object(modules[name], "_lib",
                                            lambda: lib):
                ms = event_ms(call, reps=9, inner=5)
            out["ms"].setdefault(key, {}).setdefault(variant, []).append(ms)
            log(f"ablation {key} {variant}: {ms:.4f} ms on {card}")
    return out


def main() -> int:
    t_script = time.perf_counter()
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
    if sys.argv[1:2] == ["--ablation"]:
        args = sys.argv[2:]
        if args not in ([],) and not (len(args) == 2
                                     and args[0] == "--replaced"):
            print("usage: chip_smoke.py [--ablation [--replaced DIR]]",
                  file=sys.stderr)
            return 2
        log(json.dumps(ablation(dev, card,
                                Path(args[1]) if args else None)))
        return 0

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
    occupancy = occupancy_report({n: p for n, (p, _) in built.items()})

    slice_run, wavefront_record = edt_path(dev, card)
    records = [wavefront_record]
    atlas_path(dev, card, **slice_run)
    del slice_run
    path_err = check_kernels(dev)
    flash_launches = llama_path(dev)
    wkv6_launches = rwkv_path(dev)
    ssd_launches = zamba_path(dev)
    records.append(flash_record(dev, flash_launches, path_err, occupancy))
    records.append(wkv6_record(dev, wkv6_launches, path_err, occupancy))
    records.append(ssd_record(dev, ssd_launches, path_err, occupancy))
    for r in records:
        for ms, bound in (("ms", "bound_ms"), ("ms_bf16", "bound_ms_bf16")):
            if ms in r and not r[bound] <= r[ms]:
                raise AssertionError(f"{r['name']}: {ms} {r[ms]} is below "
                                     f"its bound {r[bound]}")
        step = r.get("at_prefill_step")
        if step and not step["bound_ms"] <= step["ms"]:
            raise AssertionError(f"{r['name']} at the prefill step: "
                                 f"{step['ms']} ms is below its bound "
                                 f"{step['bound_ms']}")
    walks = start_dryrun()
    train_path(dev, card)
    granite_launches, at_granite = moe_path(dev)
    fa = next(r for r in records if r["name"] == "flash_attention_hm")
    fa["launches_by_path"] = {f"{LLAMA} make_prefill_step": fa["launches"],
                              f"{GRANITE} make_prefill_step":
                                  granite_launches}
    fa["launches"] += granite_launches
    fa["at_granite"] = {
        **at_granite, "launches": granite_launches,
        "max_abs_err": path_err["flash_attention_hm_granite"]}
    if not at_granite["bound_ms"] <= at_granite["ms"]:
        raise AssertionError(f"flash_attention_hm at {GRANITE}'s shape: "
                             f"{at_granite['ms']} ms is below its bound "
                             f"{at_granite['bound_ms']}")
    whisper_launches, at_whisper = whisper_path(dev)
    fa["launches_by_path"][f"{WHISPER} make_prefill_step"] = whisper_launches
    fa["launches"] += whisper_launches
    fa["at_whisper"] = {
        **at_whisper, "launches": whisper_launches,
        "max_abs_err": path_err["flash_attention_hm_whisper"]}
    if not at_whisper["bound_ms"] <= at_whisper["ms"]:
        raise AssertionError(f"flash_attention_hm at {WHISPER}'s shape: "
                             f"{at_whisper['ms']} ms is below its bound "
                             f"{at_whisper['bound_ms']}")
    vlm_launches, at_internvl = vlm_path(dev)
    fa["launches_by_path"][f"{VLM} make_prefill_step"] = vlm_launches
    fa["launches"] += vlm_launches
    par = parallel_path(dev, card)
    fa["launches_by_path"][f"{LLAMA} pipelined_forward, {PAR_RANKS} ranks"
                           ] = par["pipelined"]
    fa["launches_by_path"][f"{LLAMA} sequential_reference"] = par[
        "sequential"]
    fa["launches"] += par["pipelined"] + par["sequential"]
    fa["at_internvl"] = {
        **at_internvl, "launches": vlm_launches,
        "max_abs_err": path_err["flash_attention_hm_internvl"],
        **occupancy["flash_attention_hm_d128"]}
    if not at_internvl["bound_ms"] <= at_internvl["ms"]:
        raise AssertionError(f"flash_attention_hm at {VLM}'s shape: "
                             f"{at_internvl['ms']} ms is below its bound "
                             f"{at_internvl['bound_ms']}")
    cost_path(dev, card)
    train_mesh_path(dev, card)
    tp, at_tp, tp_layers = tp_path(dev, card)
    for key, what in (("a", f"{VLM} at {TP_VLM_DEPTH} layers"),
                      ("b", f"{VLM} at {tp_layers} layers"),
                      ("c", f"{LLAMA} on {TP_LLAMA_MESH}")):
        fa["launches_by_path"][f"{what}, tensor-parallel make_prefill_step, "
                               f"{TP_RANKS} ranks"] = tp[key]
        fa["launches"] += tp[key]
    fa["at_internvl_tensor_parallel"] = {
        **at_tp, "launches": tp["a"] + tp["b"],
        "max_abs_err": path_err["flash_attention_hm_internvl_tp"]}
    fa["at_llama_tensor_parallel"] = {
        "shape": "q [1, 16, 4096, 64] k/v [1, 4, 4096, 64] f32 causal",
        "launches": tp["c"],
        "max_abs_err": path_err["flash_attention_hm_llama_tp"]}
    if not at_tp["bound_ms"] <= at_tp["ms"]:
        raise AssertionError(f"flash_attention_hm at {VLM}'s per-rank shape: "
                             f"{at_tp['ms']} ms is below its bound "
                             f"{at_tp['bound_ms']}")
    finish_dryrun(walks)
    log(f"kernel times on {card}")
    log(f"script wall {time.perf_counter() - t_script:.3f} s on {card}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
