"""Step functions (train / prefill / decode).

The port of the reference package's ``launch/steps.py``, with its
signatures.  A train step takes ``(params, opt_state, batch)`` and returns
``(params, opt_state, loss)`` as the reference's does; the params and the
optimizer state are updated in place and returned.  Every step maker
takes the reference's ``ParallelCtx``: the prefill step passes it to
every family's forward (the decoder family's MoE layers read its mesh;
elsewhere the reference reads it only for layout hints, not ported);
the decode step ignores it, as the reference's does.

A train step under a mesh of more than one rank computes what the
reference's sharded step computes, with one process a rank (see
:func:`value_and_grad`): data parallelism over the dp axes and, in MoE
layers that take it, expert parallelism.  Every leaf is held whole on
every rank except the expert stacks, which a rank holds as its
``[E/ep, ...]`` slice under their storage sharding (``param_specs``),
with the slice's optimizer state.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from ..models import Model
from ..models.transformer import ParallelCtx
from ..optim import AdamWConfig, apply_updates, init_state
from ..parallel.collectives import psum, psum_grads
from ..parallel.sharding import (P, _axes, _axis_size, batch_specs, dp_axes,
                                 local_shard, spec_for_param)
from ..tree import leaves, rebuild

_EXPERTS = re.compile(r"moe/w[gud]$")


def _meshed(ctx: ParallelCtx) -> bool:
    return ctx.mesh is not None and ctx.mesh.size > 1


def _paths(tree, prefix: str = "") -> list:
    """Each leaf's path (``a/b/c``), in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def held_specs(model: Model, params, mesh) -> list:
    """The spec of each leaf (in the order of :func:`leaves`) as this rank
    holds it: an expert stack held as a slice (``[L, E/ep, ...]``) has its
    storage spec, ``param_specs``' on the global ``[L, E, ...]``; every
    other leaf is held whole, ``P()``."""
    E = model.cfg.moe.n_experts if model.cfg.moe else 0
    out = []
    for path, t in zip(_paths(params), leaves(params)):
        if not (_EXPERTS.search(path) and t.shape[-3] != E):
            out.append(P())
            continue
        shape = tuple(t.shape[:-3]) + (E,) + tuple(t.shape[-2:])
        spec = spec_for_param(path, shape, mesh)
        n = _axis_size(mesh, spec[-3])
        if t.shape[-3] * n != E:
            raise ValueError(f"{path}: {t.shape[-3]} experts, neither {E} "
                             f"nor a slice under {spec} ({E // n})")
        out.append(spec)
    return out


def _named(spec: P) -> set:
    return {a for entry in spec for a in _axes(entry)}


def data_block(batch: dict, mesh) -> dict:
    """This rank's block of the global batch under ``batch_specs``: dim 0
    over the dp axes (a batch that the dp ranks do not divide is
    refused)."""
    dps = dp_axes(mesh)
    dp = dps if len(dps) > 1 else dps[0]
    specs = batch_specs(batch, mesh)
    out = {}
    for k, x in batch.items():
        if x.dim() and tuple(specs[k])[:1] != (dp,):
            raise ValueError(
                f"batch[{k!r}] {tuple(x.shape)}: dim 0 does not split over "
                f"the {_axis_size(mesh, dps)} data-parallel ranks {dps}")
        out[k] = local_shard(x, specs[k], mesh)
    return out


def exchange(grads: list, specs: list, mesh) -> list:
    """The data-parallel gradient exchange: each leaf summed over the dp
    axes that its held spec does not name (an expert slice sharded over
    ``("data", "model")`` takes none: the all-to-alls' backward brought
    every data block's cotangent to it), the leaves of one group of axes
    in flight together."""
    out = list(grads)
    groups: dict = {}
    for i, spec in enumerate(specs):
        axes = tuple(a for a in dp_axes(mesh)
                     if a not in _named(spec) and mesh.shape[a] > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        summed = psum_grads([grads[i] for i in idx], mesh.group(axes))
        for i, g in zip(idx, summed):
            out[i] = g
    return out


def global_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The norm of the whole gradient, as the reference's clip reads it:
    a sliced leaf's squares summed over the axes that shard it."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    by_axes: dict = {}
    for g, spec in zip(grads, specs):
        sq = torch.sum(torch.square(g.float()))
        axes = tuple(a for a in mesh.axis_names if a in _named(spec))
        if axes:
            by_axes[axes] = by_axes.get(axes, 0) + sq
        else:
            total = total + sq
    for axes, sq in by_axes.items():
        total = total + psum(sq, mesh.group(axes))
    return torch.sqrt(total)


def value_and_grad(model: Model, params, batch,
                   ctx: ParallelCtx = ParallelCtx()):
    """``(loss, grads)`` with ``grads`` a dict shaped like ``params``.

    Differentiates with respect to aliases of the leaves, so the caller's
    tensors keep ``requires_grad=False`` and serving them afterwards
    builds no autograd graph.  Under a mesh of more than one rank,
    ``batch`` is the global batch: the rank takes its block
    (:func:`data_block`), the loss is the global one and the gradients
    are exchanged (:func:`exchange`), which is what ``jax.value_and_grad``
    of the reference's loss under the mesh returns (for a sliced leaf,
    this rank's slice of it).
    """
    meshed = _meshed(ctx)
    if meshed:
        specs = held_specs(model, params, ctx.mesh)
        batch = data_block(batch, ctx.mesh)
        ctx = dataclasses.replace(ctx, dp_block=True)
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model.loss(rebuild(params, flat), batch, ctx)
    grads = list(torch.autograd.grad(loss, flat))
    if meshed:
        grads = exchange(grads, specs, ctx.mesh)
    return loss.detach(), rebuild(params, grads)


def _update(model, opt_cfg, ctx, params, grads, opt_state):
    gnorm = None
    if _meshed(ctx):
        gnorm = global_norm(leaves(grads),
                            held_specs(model, params, ctx.mesh), ctx.mesh)
    return apply_updates(opt_cfg, params, grads, opt_state, gnorm=gnorm)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    ctx: ParallelCtx = ParallelCtx(),
                    microbatches: int = 1):
    """Training step, optionally with gradient accumulation.

    microbatches > 1 splits the global batch along dim 0 (microbatch
    ``i`` is rows ``[i b/mb, (i+1) b/mb)``) and runs the forward+backward
    of each in turn, accumulating grads in bf16 and dividing in bf16, as
    the reference does; under a mesh each rank then takes its block of
    each microbatch, and each microbatch's gradient is exchanged before
    its bf16 cast.  The optimizer update runs once on the mean gradient,
    clipped by the whole gradient's norm.  ``ctx`` goes to the loss.
    """
    if microbatches == 1:
        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model, params, batch, ctx)
            params, opt_state = _update(model, opt_cfg, ctx, params, grads,
                                        opt_state)
            return params, opt_state, loss
        return train_step

    def train_step(params, opt_state, batch):
        def split(x):
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            return x.reshape((microbatches, b // microbatches)
                             + tuple(x.shape[1:]))

        mbs = {k: split(v) for k, v in batch.items()}
        acc = None
        losses = []
        for i in range(microbatches):
            loss, g = value_and_grad(model, params,
                                      {k: v[i] for k, v in mbs.items()},
                                      ctx)
            gl = [x.to(torch.bfloat16) for x in leaves(g)]
            acc = gl if acc is None else [a + x for a, x in zip(acc, gl)]
            losses.append(loss)
        grads = rebuild(params, [a / microbatches for a in acc])
        params, opt_state = _update(model, opt_cfg, ctx, params, grads,
                                    opt_state)
        return params, opt_state, torch.stack(losses).mean()
    return train_step


def make_prefill_step(model: Model, ctx: ParallelCtx = ParallelCtx()):
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch["tokens"],
                                  extra_embeds=batch.get("extra_embeds"),
                                  ctx=ctx)
        # serving returns the last-position logits (next-token distribution);
        # a copy, so the [B, S, V] logits are freed on return
        return logits[:, -1].clone()
    return prefill_step


def make_decode_step(model: Model, ctx: ParallelCtx = ParallelCtx()):
    """The decode step; ``ctx`` is ignored, as the reference's decode step
    ignores it."""
    del ctx
    cfg = model.cfg

    def decode_step(params, caches, batch):
        kw = {}
        if cfg.encdec:
            kw["enc_out"] = batch["enc_out"]
        return model.decode_step(params, batch["tokens1"], caches,
                                 batch["pos"], **kw)
    return decode_step


def init_all(model: Model, opt_cfg: AdamWConfig, gen: torch.Generator,
             dtype=torch.bfloat16, device=None):
    """Params drawn from ``gen`` and their zero optimizer state, on CUDA
    unless the caller passes ``device="cpu"``."""
    params = model.init(gen, dtype, device)
    return params, init_state(opt_cfg, params)
