"""Step functions (train / prefill / decode).

The port of the reference package's ``launch/steps.py``, with its
signatures.  A train step takes ``(params, opt_state, batch)`` and returns
``(params, opt_state, loss)`` as the reference's does; the params and the
optimizer state are updated in place and returned.  Every step maker
takes the reference's ``ParallelCtx`` and passes it to every family's
forward or decode step (the decoder family's MoE layers and held blocks
read its mesh; elsewhere the reference reads it only for layout hints,
not ported).

Under a mesh of more than one rank (one process a rank), a serving step
computes what the reference's jitted step computes under its argument
shardings (``param_specs``, ``batch_specs``, ``cache_specs_tree``), and
returns the global last-position logits on every rank, as its
``out_shardings=P()`` does.  It takes the global batch and computes on
the rank's block (:func:`serving_block`); the params are as the rank
holds them (``parallel.sharding.held_params``: the decoder family's
attention, MLP and vocabulary as their blocks over 'model', or whole),
and the decode caches are the rank's block (``sharding.cache_block``).

A train step under a mesh computes what the reference's sharded step
computes (see :func:`value_and_grad`): data parallelism over the dp axes
and, in MoE layers that take it, expert parallelism.  Every leaf is held
whole on every rank except the expert stacks, which a rank holds as its
``[E/ep, ...]`` slice under their storage sharding (``param_specs``),
with the slice's optimizer state; a leaf held as a tensor-parallel block
is refused, as its backward is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import Model
from ..models.transformer import ParallelCtx
from ..optim import AdamWConfig, apply_updates, init_state
from ..parallel.collectives import all_gather, psum, psum_grads
from ..parallel.sharding import (_EXPERTS, P, _axes, _axis_size, _paths,
                                 batch_specs, dp_axes, held_batch,
                                 held_specs, local_shard, param_shapes,
                                 tensor_parallel)
from ..tree import leaves, rebuild


def _meshed(ctx: ParallelCtx) -> bool:
    return ctx.mesh is not None and ctx.mesh.size > 1


def train_specs(model: Model, params, mesh, shapes: list) -> list:
    """:func:`~repro_torch.parallel.sharding.held_specs` of a train step's
    params (``shapes`` their global shapes, as there): an expert stack
    whole or as its slice, every other leaf whole.  A leaf held as a
    tensor-parallel block is refused, the error naming it: the train
    step's tensor-parallel backward is not ported."""
    specs = held_specs(model, params, mesh, shapes)
    for path, t, spec in zip(_paths(params), leaves(params), specs):
        if spec != P() and not _EXPERTS.search(path):
            raise ValueError(
                f"{path}: held as its tensor-parallel block "
                f"{tuple(t.shape)} ({spec}); a train step under a mesh "
                f"holds it whole (the tensor-parallel backward is not "
                f"ported)")
    return specs


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


def serving_block(batch: dict, mesh) -> tuple[dict, bool]:
    """``(block, cut)``: this serving rank's block of the global batch,
    dim 0 over the dp axes where they divide it (``batch_specs``; a
    batch they do not divide, such as ``long_500k``'s one row, is held
    whole on every rank, and ``cut`` is False), and whether it was cut.
    A host integer (the decode position) passes as it is."""
    dps = dp_axes(mesh)
    rows = [x.shape[0] for x in batch.values()
            if isinstance(x, torch.Tensor) and x.dim()]
    cut = bool(rows) and _axis_size(mesh, dps) > 1 and all(
        held_batch(n, mesh) != n for n in rows)
    if not cut:
        return dict(batch), False
    spec = P(dps if len(dps) > 1 else dps[0])
    return {k: local_shard(x, spec, mesh)
            if isinstance(x, torch.Tensor) and x.dim() else x
            for k, x in batch.items()}, True


def _rows_gathered(x: torch.Tensor, mesh, cut: bool) -> torch.Tensor:
    """The ranks' row blocks of ``x`` all-gathered over the dp axes (the
    global batch's rows, in order), or ``x`` where the batch was not
    cut."""
    if not cut:
        return x
    return torch.cat(all_gather(x, mesh.group(dp_axes(mesh))).unbind(0))


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
                   ctx: ParallelCtx = ParallelCtx(), specs=None):
    """``(loss, grads)`` with ``grads`` a dict shaped like ``params``.

    Differentiates with respect to aliases of the leaves, so the caller's
    tensors keep ``requires_grad=False`` and serving them afterwards
    builds no autograd graph.  Under a mesh of more than one rank,
    ``batch`` is the global batch: the rank takes its block
    (:func:`data_block`), the loss is the global one and the gradients
    are exchanged (:func:`exchange`), which is what ``jax.value_and_grad``
    of the reference's loss under the mesh returns (for a sliced leaf,
    this rank's slice of it).  ``specs``: the params' held specs
    (:func:`train_specs`), worked out here when not given.
    """
    meshed = _meshed(ctx)
    if meshed:
        if specs is None:
            specs = train_specs(model, params, ctx.mesh,
                                param_shapes(model))
        batch = data_block(batch, ctx.mesh)
        ctx = dataclasses.replace(ctx, dp_block=True, training=True)
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model.loss(rebuild(params, flat), batch, ctx)
    grads = list(torch.autograd.grad(loss, flat))
    if meshed:
        grads = exchange(grads, specs, ctx.mesh)
    return loss.detach(), rebuild(params, grads)


def _update(opt_cfg, ctx, params, grads, opt_state, specs):
    gnorm = None
    if _meshed(ctx):
        gnorm = global_norm(leaves(grads), specs, ctx.mesh)
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
    # the global param shapes, read once here rather than in every step
    shapes = param_shapes(model) if _meshed(ctx) else None

    def held(params):
        return train_specs(model, params, ctx.mesh, shapes) \
            if _meshed(ctx) else None

    if microbatches == 1:
        def train_step(params, opt_state, batch):
            specs = held(params)
            loss, grads = value_and_grad(model, params, batch, ctx, specs)
            params, opt_state = _update(opt_cfg, ctx, params, grads,
                                        opt_state, specs)
            return params, opt_state, loss
        return train_step

    def train_step(params, opt_state, batch):
        def split(x):
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            return x.reshape((microbatches, b // microbatches)
                             + tuple(x.shape[1:]))

        mbs = {k: split(v) for k, v in batch.items()}
        specs = held(params)
        acc = None
        losses = []
        for i in range(microbatches):
            loss, g = value_and_grad(model, params,
                                      {k: v[i] for k, v in mbs.items()},
                                      ctx, specs)
            gl = [x.to(torch.bfloat16) for x in leaves(g)]
            acc = gl if acc is None else [a + x for a, x in zip(acc, gl)]
            losses.append(loss)
        grads = rebuild(params, [a / microbatches for a in acc])
        params, opt_state = _update(opt_cfg, ctx, params, grads,
                                    opt_state, specs)
        return params, opt_state, torch.stack(losses).mean()
    return train_step


def _serving(model: Model, ctx: ParallelCtx, batch: dict):
    """``(block, cut, ctx, kw)`` of a serving step: the rank's batch
    block, whether it was cut, the ctx its forward takes (``dp_block``
    where it was cut) and, for the decoder family under a mesh, the
    forward's ``last_only``."""
    if not _meshed(ctx):
        return batch, False, ctx, {}
    block, cut = serving_block(batch, ctx.mesh)
    kw = {"last_only": True} if tensor_parallel(model.cfg) else {}
    return block, cut, dataclasses.replace(ctx, dp_block=cut), kw


def make_cache_prefill_step(model: Model, ctx: ParallelCtx = ParallelCtx()):
    """The serve loop's prefill: ``(params, caches, batch) -> (logits [B,
    V], caches)``, the prompt (behind its ``extra_embeds`` prefix) written
    into fresh caches from position 0 (none when ``caches`` is None) and
    the last-position logits.  Under a mesh the rank computes its batch
    block (:func:`serving_block`) with its held params into its cache
    block, and the logits are gathered over 'model' (a held vocabulary)
    and the dp axes, so every rank returns the global ones."""
    def prefill_step(params, caches, batch):
        block, cut, fctx, kw = _serving(model, ctx, batch)
        logits, caches = model.forward(
            params, block["tokens"], extra_embeds=block.get("extra_embeds"),
            caches=caches, pos_offset=0, ctx=fctx, **kw)
        # serving returns the last-position logits (next-token distribution);
        # a copy, so the [B, S, V] logits are freed on return
        return _rows_gathered(logits[:, -1].clone(), ctx.mesh, cut), caches
    return prefill_step


def make_prefill_step(model: Model, ctx: ParallelCtx = ParallelCtx()):
    """The prefill step: :func:`make_cache_prefill_step`'s logits, with no
    caches."""
    step = make_cache_prefill_step(model, ctx)

    def prefill_step(params, batch):
        return step(params, None, batch)[0]
    return prefill_step


def make_decode_step(model: Model, ctx: ParallelCtx = ParallelCtx()):
    """The decode step: ``(logits [B, V], caches)``.  The reference's
    decode step ignores ``ctx``, since GSPMD reads the layout from its
    arguments' shardings; the port reads it from ``ctx``: under a mesh
    the rank decodes its batch block into its cache block
    (``parallel.sharding.cache_block``) with its held params, and the
    logits are gathered as the prefill step's are."""
    cfg = model.cfg

    def decode_step(params, caches, batch):
        block, cut, fctx, _ = _serving(model, ctx, batch)
        kw = {"ctx": fctx} if _meshed(ctx) else {}
        if cfg.encdec:
            kw["enc_out"] = block["enc_out"]
        logits, caches = model.decode_step(params, block["tokens1"], caches,
                                           block["pos"], **kw)
        return _rows_gathered(logits, ctx.mesh, cut), caches
    return decode_step


def init_all(model: Model, opt_cfg: AdamWConfig, gen: torch.Generator,
             dtype=torch.bfloat16, device=None):
    """Params drawn from ``gen`` and their zero optimizer state, on CUDA
    unless the caller passes ``device="cpu"``."""
    params = model.init(gen, dtype, device)
    return params, init_state(opt_cfg, params)
