"""Step functions (train / prefill / decode).

The port of the reference package's ``launch/steps.py``, with its
signatures.  A train step takes ``(params, opt_state, batch)`` and returns
``(params, opt_state, loss)`` as the reference's does; the params and the
optimizer state are updated in place and returned.  Every step maker
takes the reference's ``ParallelCtx``: the prefill step passes it to
every family's forward (the decoder family's MoE layers read its mesh;
elsewhere the reference reads it only for layout hints, not ported);
the decode step ignores it, as the reference's does; a train step under
a mesh of more than one rank is not ported and refused.
"""
from __future__ import annotations

import torch

from ..models import Model
from ..models.transformer import ParallelCtx
from ..optim import AdamWConfig, apply_updates, init_state
from ..tree import leaves, rebuild


def value_and_grad(model: Model, params, batch,
                   ctx: ParallelCtx = ParallelCtx()):
    """``(loss, grads)`` with ``grads`` a dict shaped like ``params``.

    Differentiates with respect to aliases of the leaves, so the caller's
    tensors keep ``requires_grad=False`` and serving them afterwards
    builds no autograd graph.
    """
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model.loss(rebuild(params, flat), batch, ctx)
    return loss.detach(), rebuild(params, torch.autograd.grad(loss, flat))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    ctx: ParallelCtx = ParallelCtx(),
                    microbatches: int = 1):
    """Training step, optionally with gradient accumulation.

    microbatches > 1 splits the global batch along dim 0 and runs the
    forward+backward of each in turn, accumulating grads in bf16 and
    dividing in bf16, as the reference does.  The optimizer update runs
    once on the mean gradient.  ``ctx`` goes to the loss; a mesh of more
    than one rank raises ``NotImplementedError``: the data-parallel
    gradient exchange and the backward of the expert-parallel
    all-to-alls are not ported (ROADMAP.md, Queue 1), and the step must
    not run silently as one rank.
    """
    if ctx.mesh is not None and ctx.mesh.size > 1:
        raise NotImplementedError(
            f"a train step under a mesh of {ctx.mesh.size} ranks is not "
            f"ported (ROADMAP.md Queue 1, #9: the train step under a mesh; "
            f"data-parallel gradient exchange and the backward of the "
            f"expert-parallel all_to_all/all_gather)")
    if microbatches == 1:
        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model, params, batch, ctx)
            params, opt_state = apply_updates(opt_cfg, params, grads,
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
        params, opt_state = apply_updates(opt_cfg, params, grads, opt_state)
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
