"""Pipeline parallelism scheduled by the paper's polyhedral EDT machinery.

The port of the reference package's ``parallel/pipeline.py``.  The
(microbatch m, stage s) iteration space and its dependences
    (m, s) -> (m, s+1)    activation flow
    (m, s) -> (m+1, s)    stage occupancy
form a polyhedral program (``repro_torch.core.programs.pipeline``).  We:

  1. tile the microbatch axis with the §3 *compression* method (never
     projection) to get the tile-level task graph,
  2. synthesize the wavefront schedule t(mT, s) = mT + s from the graph
     (closed form exists because the distances are uniform; the materialized
     wavefronts are asserted equal — the EDT view *is* the schedule),
  3. run it on a 'stage' mesh axis, one rank a stage: one step per
     wavefront, ``ppermute`` for the (m,s)->(m,s+1) dependence.  The
     (m,s)->(m+1,s) dependence is satisfied by program order inside the
     loop — zero runtime synchronization objects (Table 2's limit point).

Training: differentiate straight through the pipelined forward — the
backward of ``ppermute`` is the reverse permute, so the backward pass is
the mirrored wavefront with no hand-written send/recv.  Every rank runs
the same operations on every step (the stage function on inactive steps
too, its output then zeroed, and the selections as tensor ``where``s),
so every rank's autograd graph has the same shape and each backward
``ppermute`` meets its partner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.edt import TiledTaskGraph, synthesize
from ..core.poly import Tiling
from ..core.programs import pipeline as pipeline_program
from ..tree import leaves, rebuild
from .collectives import ppermute, psum

PyTree = Any


@dataclass
class PipelineSchedule:
    n_stages: int
    n_tiles: int           # microbatch tiles (after tiling by tile_m)
    tile_m: int
    depth: int             # wavefront count = n_tiles + n_stages - 1
    levels: list           # [[(stmt, (mT, s)), ...], ...]

    def active(self, t: int, s: int) -> bool:
        return 0 <= t - s < self.n_tiles


def build_schedule(n_microbatches: int, n_stages: int,
                   tile_m: int = 1) -> PipelineSchedule:
    """Polyhedral construction: tile, compress, synthesize wavefronts."""
    assert n_microbatches % tile_m == 0
    prog = pipeline_program()
    graph = TiledTaskGraph(prog, {"S": Tiling((tile_m, 1))})
    params = {"M": n_microbatches, "S": n_stages}
    ws = synthesize(graph, params)
    n_tiles = n_microbatches // tile_m
    # closed-form check: the wavefront index of tile (mT, s) must be mT + s
    for lvl, tasks in enumerate(ws.levels):
        for _, (mT, s) in tasks:
            assert mT + s == lvl, (mT, s, lvl)
    assert ws.depth == n_tiles + n_stages - 1
    return PipelineSchedule(n_stages, n_tiles, tile_m, ws.depth, ws.levels)


def pipelined_forward(stage_fn: Callable, stage_params_local: PyTree,
                      microbatches: torch.Tensor, schedule: PipelineSchedule,
                      mesh, axis: str = "stage"):
    """Run the tiled pipeline, one rank a stage of ``axis``.

    stage_fn(params_one_stage, x) -> y          (same shape as x)
    stage_params_local: this rank's stage's params (the reference's
        ``[n_stages, ...]`` stack sharded over ``axis``, its leading dim
        dropped)
    microbatches: [n_tiles, B_tile, ...]        (already tiled by tile_m,
        the same on every rank)
    Returns [n_tiles, B_tile, ...] outputs of the final stage, on every
    rank.
    """
    group = mesh.group(axis)
    S = schedule.n_stages
    M = schedule.n_tiles
    T = schedule.depth
    if group.size != S:
        raise ValueError(f"{S} stages on an axis of {group.size} ranks")
    perm = [(i, i + 1) for i in range(S - 1)]
    s = group.index
    dev = microbatches.device

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=dev)

    x_buf = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(M)]
    for t in range(T):
        first_in = microbatches[min(max(t, 0), M - 1)]
        x_in = torch.where(flag(s == 0), first_in, x_buf)
        active = schedule.active(t, s)
        y = stage_fn(stage_params_local, x_in)
        y = torch.where(flag(active), y, torch.zeros_like(y))
        # dependence (m, s) -> (m, s+1): one wavefront step later
        x_buf = ppermute(y, group, perm)
        out_idx = min(max(t - (S - 1), 0), M - 1)
        outs[out_idx] = torch.where(flag(s == S - 1 and active), y,
                                    outs[out_idx])
    out = torch.stack(outs)
    # only the last stage holds real outputs; broadcast them
    out = torch.where(flag(s == S - 1), out, torch.zeros_like(out))
    return psum(out, group)


def sequential_reference(stage_fn: Callable, stage_params: PyTree,
                         microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: apply all stages to every microbatch sequentially
    (``stage_params`` stacked ``[n_stages, ...]``)."""
    flat = leaves(stage_params)
    n = flat[0].shape[0]
    stages = [rebuild(stage_params, [a[i] for a in flat]) for i in range(n)]

    def apply_all(x):
        for p in stages:
            x = stage_fn(p, x)
        return x

    return torch.stack([apply_all(mb) for mb in microbatches])


def make_pipeline_loss(stage_fn, schedule, mesh, axis="stage"):
    """Training through the pipeline: grad flows back through ppermute
    (reverse wavefront = the backward pipeline, synthesized for free).
    The loss is the same on every rank; each rank's gradients are those
    of its own stage's params."""

    def loss(stage_params_local, microbatches, targets):
        outs = pipelined_forward(stage_fn, stage_params_local, microbatches,
                                 schedule, mesh, axis)
        return torch.mean((outs - targets) ** 2)

    return loss
