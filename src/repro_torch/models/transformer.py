"""Decoder-only LM: the port of the reference package's
``models/transformer.py`` for the dense (GQA), MoE and MLA families.

Layers stay stacked (``[L, ...]`` leading dim) as in the reference, so its
parameter pytree carries across one to one: ``layers`` for the dense
layers and, in an MoE model, ``moe_layers`` for those after its
``n_dense_layers`` prefix, run in that order.  The port loops over them in
Python (one ``unbind`` a stacked leaf, so the backward stacks the layers'
gradients once).  When training (``cfg.remat``, grad mode on and params
that require grad) each block is rematerialised in the backward, as the
reference wraps its scanned body in ``jax.checkpoint``.  The unembedding
keeps the reference's custom VJP, which casts the cotangent to the
weight's dtype.  Decode caches (GQA's or MLA's, one group a stack) are
updated in place.  MoE layers take the reference's dispatch: without a
mesh in the :class:`ParallelCtx`, the grouped einsum or the one-shard
expert-parallel form; with one, the expert-parallel form over the ranks
(one process a rank).

Under a mesh, the route of each leaf follows how the rank holds it
(``parallel.sharding.tp_spec``): held as its block over 'model', GQA
attention and the dense MLP run column- then row-parallel with one
``psum`` each, the embedding looks up its vocab range and sums, and the
unembedding computes its vocab block (gathered) or its ``d`` block's
partial logits (summed); held whole, a leaf runs as on one card.  The MoE
region receives ``h`` replicated over 'model', as before.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..compat import default_device
from ..parallel.collectives import all_gather, psum, pvary
from ..parallel.sharding import (P, _axes, _axis_size, _fit_axis, dp_axes,
                                 gather_shards, held_params, local_shard)
from ..tree import leaves
from .config import ArchConfig
from .layers import (gqa_apply, gqa_params, mla_apply, mla_params,
                     mlp_apply, mlp_params, moe_einsum_apply, moe_ep_apply,
                     moe_params, normal, rmsnorm)

#: the reference's literal: without a mesh, an ``ep_a2a`` MoE layer takes
#: the expert-parallel form from this many tokens on (``MoEConfig``'s
#: ``ep_threshold`` is read only with a mesh)
EP_MIN_TOKENS = 8192


@dataclass
class ParallelCtx:
    """Parallel execution context for layers needing explicit collectives.

    None mesh => single-device semantics.  When a mesh (the port's
    :class:`~repro_torch.launch.mesh.Mesh`) is present, MoE layers with
    impl='ep_a2a' run the expert-parallel region: tokens sharded (batch
    over ``dp_spec`` x 'model' on sequence), experts sharded over
    ``ep_axis``, with explicit all-to-all dispatch (DeepSeek-style EP).
    """
    ep_axis: Optional[str] = None
    ep_size: int = 1
    mesh: Any = None
    dp_spec: Any = None      # partition spec entry for the batch dim
    #: set by a train step under a mesh (``launch.steps``): the batch a
    #: rank holds is its block of the global batch (dim 0 over the dp
    #: axes), so the MoE region cuts tokens over 'model' only and
    #: :func:`xent` divides by the global count of labels
    dp_block: bool = False
    #: set by a train step under a mesh: the step updates what a rank
    #: holds, so an expert stack must be the rank's slice
    training: bool = False


def stacked(n: int, draw: Callable[[], dict]) -> dict:
    """``n`` layers from ``draw()``, drawn in order and stacked along a new
    leading dim.  One layer is stacked as a view; more are copied into the
    stack one at a time, so at most one loose layer lives beside it."""
    def tmap(fn, *trees):
        return {k: tmap(fn, *(t[k] for t in trees)) if isinstance(v, dict)
                else fn(*(t[k] for t in trees)) for k, v in trees[0].items()}

    first = draw()
    if n == 1:
        return tmap(lambda t: t.unsqueeze(0), first)
    out = tmap(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        tmap(lambda o, t: o[i].copy_(t), out, first if i == 0 else draw())
    return out


def layer(tree, i: int):
    """Layer ``i`` of a stacked param or cache dict (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked param dict, one ``unbind`` a leaf
    (views; the backward stacks the layers' gradients in one op)."""
    def split(t):
        return (split_dict(t) if isinstance(t, dict) else torch.unbind(t))

    def split_dict(d):
        parts = {k: split(v) for k, v in d.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    return split_dict(tree)


def remat(cfg: ArchConfig, params) -> bool:
    """Whether to rematerialise blocks: ``cfg.remat`` while training
    (grad mode on and params that require grad), never when serving."""
    return cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params))


def rematerialised(fn, *args):
    """``fn(*args)``, recomputed in the backward (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def layer_cache(c: dict, i: int) -> dict:
    """Layer ``i``'s attention cache (views) with the shared host ``len``."""
    return {**layer({k: v for k, v in c.items() if k != "len"}, i),
            "len": c["len"]}


def attn_cache(cfg: ArchConfig, n: int, batch: int, max_len: int, dtype,
               device) -> dict:
    """``n`` stacked attention caches: a ring buffer of
    ``cfg.sliding_window`` slots when the window is shorter than
    ``max_len`` (``pos`` -1 marks an empty slot), else ``max_len`` flat
    slots.  ``len`` is a host integer."""
    ring = 0 < cfg.sliding_window < max_len
    slots = cfg.sliding_window if ring else max_len
    shape = (n, batch, slots, cfg.n_kv_heads, cfg.hd())
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "len": 0}
    if ring:
        c["pos"] = torch.full((n, slots), -1, dtype=torch.int32,
                              device=device)
    return c


def mla_cache(cfg: ArchConfig, n: int, batch: int, max_len: int, dtype,
              device) -> dict:
    """``n`` stacked MLA caches of ``max_len`` slots: the normalised
    latent ``c_kv`` and the roped ``k_rope``; ``len`` is a host integer."""
    m = cfg.mla
    return {"c_kv": torch.zeros((n, batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((n, batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "len": 0}


def stacks(cfg: ArchConfig) -> tuple[tuple[str, str, int, bool], ...]:
    """``(cache group, params key, layers, MoE)`` of each non-empty stack,
    in the order the forward runs them: the dense layers (an MoE model's
    ``n_dense_layers`` prefix), then the MoE layers."""
    n_moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else 0
    groups = (("dense", "layers", cfg.n_layers - n_moe, False),
              ("moe", "moe_layers", n_moe, True))
    return tuple(g for g in groups if g[2])


def _layer_params(gen, cfg: ArchConfig, dtype, device, moe_layer: bool):
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": (mla_params(gen, cfg, dtype, device) if cfg.mla
                 else gqa_params(gen, cfg, dtype, device)),
    }
    if moe_layer:
        p["moe"] = moe_params(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                              device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None, mesh=None):
    """Parameters drawn from ``gen`` (which must live on ``device``:
    CUDA unless the caller passes ``device="cpu"``).  With ``mesh``, this
    rank's held tree (``parallel.sharding.held_params``) from the same
    draws: each leaf is cut to its block as soon as it is drawn, so no
    more than one layer is whole at a time."""
    device = default_device(device)

    def held(tree, prefix=""):
        return tree if mesh is None else held_params(cfg, tree, mesh, prefix)

    s = 1.0 / math.sqrt(cfg.d_model)
    params: dict = held({
        "embed": normal(gen, (cfg.vocab, cfg.d_model), s, dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    })
    if not cfg.tie_embeddings:
        params.update(held({"unembed": normal(
            gen, (cfg.d_model, cfg.vocab), s, dtype, device)}))
    for _, key, n, moe in stacks(cfg):
        params[key] = stacked(n, lambda moe=moe, key=key: held(
            _layer_params(gen, cfg, dtype, device, moe), key))
    return params


def _model_group(ctx: Optional[ParallelCtx]):
    """The 'model' axis of ``ctx``'s mesh, which a held block needs."""
    if ctx is None or ctx.mesh is None:
        raise ValueError("a leaf held as a block over 'model' without a "
                         "mesh in the ParallelCtx")
    return ctx.mesh.group("model")


def _block(cfg: ArchConfig, p, x, positions, cache, moe_layer: bool,
           window: int = 0, ctx: Optional[ParallelCtx] = None):
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    if cfg.mla:
        a, new_cache = mla_apply(p["attn"], h, cfg, positions=positions,
                                 cache=cache)
    else:
        a, new_cache = gqa_apply(p["attn"], h, cfg, positions=positions,
                                 cache=cache, window=window,
                                 mesh=None if ctx is None else ctx.mesh)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    if moe_layer:
        f = _moe_dispatch(cfg, p["moe"], h, ctx)
    else:
        w_in = p["mlp"]["wg" if cfg.mlp == "swiglu" else "w1"]
        held = w_in.shape[-1] != cfg.d_ff
        f = mlp_apply(p["mlp"], h, cfg.mlp,
                      _model_group(ctx) if held else None)
    return x + f, new_cache


def ep_axis_for(cfg: ArchConfig, B: int, S: int, mesh):
    """The mesh axis (or axis tuple) an MoE layer's expert-parallel region
    spans at ``B x S`` tokens, or None where :func:`_moe_dispatch` takes
    another form: ``impl="ep_a2a"``, a mesh, ``cfg.moe.ep_threshold``
    tokens or more and a sequence the 'model' axis divides.  EP spans
    (data x model) when the expert count divides (DeepSeek: 256 experts
    over the whole 256-rank pod, one expert per rank); otherwise just the
    model axis; None when neither divides.  It must match the storage
    sharding of the experts."""
    if not (cfg.moe.impl == "ep_a2a" and mesh is not None
            and B * S >= cfg.moe.ep_threshold
            and S % mesh.shape["model"] == 0):
        return None
    return _fit_axis(("data", "model"), cfg.moe.n_experts, mesh)


def _moe_dispatch(cfg: ArchConfig, pmoe, h, ctx: Optional[ParallelCtx] = None):
    """Pick the MoE execution strategy, as the reference does.

    * no mesh: the grouped einsum dispatch, except that ``impl="ep_a2a"``
      at ``EP_MIN_TOKENS`` tokens or more takes the expert-parallel form
      at one shard;
    * impl='ep_a2a' + mesh, at ``cfg.moe.ep_threshold`` tokens or more of
      the global batch and a sequence the 'model' axis divides: expert
      parallelism over ``_fit_axis(("data", "model"), E)``.  This rank
      takes its token block (sequence over 'model', and batch over
      ``ctx.dp_spec`` unless ``ctx.dp_block`` says the rank holds its
      data block already) and its slice of the routed experts
      (``pmoe``'s global ``[E, ...]`` stacks sliced by ``local_shard``,
      or already this rank's ``[E/ep, ...]`` as the storage sharding
      holds them; a train step under a mesh, ``ctx.training``, takes
      only the latter), runs the routed experts only, and the block
      outputs are all-gathered back to the rank's ``[B, S, d]``
      (GSPMD's ``out_specs``).  The shared expert is added outside the
      region, on every rank.

    The backward is ``shard_map``'s transpose: the cuts and the gather
    transpose into each other, the all-to-alls into themselves, and a
    weight the region replicates over an axis its tokens are cut over
    (the router; an expert slice that axis does not shard) has its
    cotangent summed over that axis (``pvary``).
    """
    B, S, _ = h.shape
    mesh = None if ctx is None else ctx.mesh
    blocked = mesh is not None and ctx.dp_block
    E = cfg.moe.n_experts
    # the threshold reads the global token count, as the reference's does
    B_global = B * _axis_size(mesh, dp_axes(mesh)) if blocked else B
    ep_axis = ep_axis_for(cfg, B_global, S, mesh)
    if ep_axis is None:
        if blocked and pmoe["wg"].shape[0] != E:
            raise ValueError(f"moe/wg: {pmoe['wg'].shape[0]} of {E} experts "
                             f"where the einsum form needs them all")
        if cfg.moe.impl == "ep_a2a" and mesh is None \
                and B * S >= EP_MIN_TOKENS:
            # large token count without a mesh: still exercise the EP path
            return moe_ep_apply(pmoe, h, cfg)
        return moe_einsum_apply(pmoe, h, cfg)
    ep_size = _axis_size(mesh, ep_axis)
    tok_spec = P(None if blocked else ctx.dp_spec, "model", None)
    tok_axes = set(_axes(tok_spec[0])) | {"model"}
    w_spec = P(ep_axis, None, None)

    def entering(w, spec):
        axes = tuple(a for a in mesh.axis_names if a in tok_axes
                     and a not in _axes(spec[0]) and mesh.shape[a] > 1)
        return pvary(w, mesh.group(axes)) if axes else w

    routed = {"router": entering(pmoe["router"], P(None, None))}
    for name in ("wg", "wu", "wd"):
        w = pmoe[name]
        if w.shape[0] == E:
            # a train step holds and updates its slice; a serving rank may
            # take the global stack, cut here
            if ctx.training:
                raise ValueError(
                    f"moe/{name}: a global stack of {E} experts under a "
                    f"training mesh; a rank holds and updates its "
                    f"{E // ep_size}, as the storage sharding "
                    f"({w_spec}) holds them")
            w = local_shard(w, w_spec, mesh)
        elif w.shape[0] != E // ep_size:
            raise ValueError(f"moe/{name}: {w.shape[0]} experts, neither "
                             f"{E} nor this rank's {E // ep_size}")
        routed[name] = entering(w, w_spec)
    # routed experts only: the shared expert is added outside the region
    cfg_routed = cfg.replace(moe=dataclasses.replace(cfg.moe, n_shared=0))
    out = moe_ep_apply(routed, local_shard(h, tok_spec, mesh), cfg_routed,
                       ep_axis=mesh.group(ep_axis), ep_size=ep_size)
    out = gather_shards(out, tok_spec, mesh)
    if cfg.moe.n_shared:
        out = out + mlp_apply(pmoe["shared"], h, "swiglu")
    return out


def _embed(cfg: ArchConfig, params, tokens, extra_embeds=None,
           ctx: Optional[ParallelCtx] = None):
    """The token embeddings, behind the ``extra_embeds`` prefix.  An
    embedding held as its vocab block ``[V/m, d]`` (vocab-parallel) looks
    up the ids in its range, writes zeros elsewhere and sums over
    'model': one non-zero term an element, so the whole lookup bit for
    bit."""
    table = params["embed"]
    if table.shape[0] == cfg.vocab:
        x = table[tokens]
    else:
        group = _model_group(ctx)
        n = table.shape[0]
        local = tokens.long() - group.index * n
        mine = (local >= 0) & (local < n)
        x = psum(torch.where(mine[..., None], table[local.clamp(0, n - 1)],
                             0), group)
    if extra_embeds is not None:
        # VLM/audio stub: prefix precomputed embeddings
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


class _UnembedMM(torch.autograd.Function):
    """``x @ w`` (``w.T`` when ``transpose_w``) with the reference's custom
    VJP (``_unembed_bwd``): the cotangent is cast to ``w.dtype`` before
    both products.  In f32 this is plain autograd; in bf16 it is not.
    The reference's sharding constraint has no counterpart on one card."""

    @staticmethod
    def forward(ctx, x, w, transpose_w: bool):
        ctx.save_for_backward(x, w)
        ctx.transpose_w = transpose_w
        return x @ (w.T if transpose_w else w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(w.dtype)
        dx = (gb @ (w if ctx.transpose_w else w.T)).to(x.dtype)
        dw = x.reshape(-1, x.shape[-1]).to(w.dtype).T @ gb.reshape(
            -1, gb.shape[-1])                                  # [d, V]
        if ctx.transpose_w:
            dw = dw.T                                          # [V, d]
        return dx, dw, None


def unembed_mm(x, w, transpose_w: bool):
    return _UnembedMM.apply(x, w, transpose_w)


def _unembed(cfg: ArchConfig, params, x, ctx: Optional[ParallelCtx] = None):
    """The logits.  Tied to an embedding held as its vocab block, the rank
    computes its vocab block of the logits and the blocks are gathered
    over 'model'; untied and held as ``[d/m, V]`` (the unembedding's
    spec), it computes its ``d`` block's partial logits and they are
    summed over 'model'."""
    if cfg.tie_embeddings:
        w = params["embed"]
        y = unembed_mm(x, w, True)
        if w.shape[0] == cfg.vocab:
            return y
        return torch.cat(all_gather(y, _model_group(ctx)).unbind(0), dim=-1)
    w = params["unembed"]
    if w.shape[0] == cfg.d_model:
        return unembed_mm(x, w, False)
    group = _model_group(ctx)
    n = w.shape[0]
    return psum(unembed_mm(x.narrow(-1, group.index * n, n), w, False), group)


def forward(cfg: ArchConfig, params, tokens, *, extra_embeds=None,
            caches=None, pos_offset: int = 0, window: Optional[int] = None,
            ctx: Optional[ParallelCtx] = None, last_only: bool = False):
    """Full forward pass. tokens [B,S] -> (logits [B,S_total,V], caches).

    caches: the stacked cache dict of :func:`init_cache` (or a rank's
    block, ``parallel.sharding.cache_block``) for incremental decoding,
    written in place; pos_offset is the absolute position of tokens[:,0];
    ctx: the :class:`ParallelCtx` whose mesh its MoE layers dispatch on
    and its held blocks reduce over; ``last_only``: the logits of the
    last position only (``[B, 1, V]``), as a serving step under a mesh
    asks, so that ``[B, S, V]`` is never formed.
    """
    window = cfg.sliding_window if window is None else window
    x = _embed(cfg, params, tokens, extra_embeds, ctx)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + pos_offset
    on = caches is None and remat(cfg, params)
    new_caches = None if caches is None else {}
    for group, key, n, moe in stacks(cfg):
        c = None if caches is None else caches[group]
        block = functools.partial(_block, cfg, moe_layer=moe, window=window,
                                  ctx=ctx)
        for i, p in enumerate(unstack(params[key], n)):
            if on:
                x = rematerialised(lambda p, x, block=block: block(
                    p, x, positions, None)[0], p, x)
            else:
                x, _ = block(p, x, positions,
                             None if c is None else layer_cache(c, i))
        if c is not None:
            new_caches[group] = {**c, "len": c["len"] + S}
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["ln_f"], x, cfg.rms_eps)
    return _unembed(cfg, params, x, ctx), new_caches


def xent(logits, labels, ctx: ParallelCtx = ParallelCtx()):
    """Mean next-token cross entropy over the labels ``>= 0``.

    The reference contracts the logits with a ``[B,S,V]`` one-hot (a
    sharding device); here the gold logit is gathered, at an index
    clamped to 0 where the label is ``-1`` (whose one-hot row is all
    zeros), and the mask zeroes those terms.  The mean's denominator is
    floored at 1, as the reference's is.  Under a mesh the reference
    constrains the logits' layout (a GSPMD hint, not ported).  Where
    ``ctx.dp_block`` says the rank holds its data block of the batch, the
    denominator is the global count of labels (a sum over the dp axes)
    and the result is the global loss, the sum of the ranks' parts
    (``psum``, whose backward leaves each rank its own part's gradient)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    if ctx is None or ctx.mesh is None or not ctx.dp_block:
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    dp = ctx.mesh.group(dp_axes(ctx.mesh))
    count = psum(mask.sum(), dp)
    return psum(nll.sum() / torch.clamp(count, min=1.0), dp)


def loss_fn(cfg: ArchConfig, params, batch,
            ctx: ParallelCtx = ParallelCtx()):
    """Next-token cross-entropy; batch = {tokens, labels[, extra_embeds]};
    ``ctx`` goes to the forward's MoE layers."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        extra_embeds=batch.get("extra_embeds"), ctx=ctx)
    labels = batch["labels"]
    if batch.get("extra_embeds") is not None:
        # loss only on text positions: labels padded with -1 over the
        # modality prefix
        prefix = logits.shape[1] - labels.shape[1]
        labels = torch.cat([torch.full(labels.shape[:1] + (prefix,), -1,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    return xent(logits, labels, ctx)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer decode caches, one group a stack (``dense``,
    ``moe``): MLA's latent caches, or GQA's (a ring buffer under a sliding
    window shorter than ``max_len``); ``len`` is a host integer.  On CUDA
    unless the caller passes ``device="cpu"``."""
    device = default_device(device)
    make = mla_cache if cfg.mla else attn_cache
    return {group: make(cfg, n, batch, max_len, dtype, device)
            for group, _, n, _ in stacks(cfg)}


def decode_step(cfg: ArchConfig, params, tokens1, caches, pos: int,
                ctx: ParallelCtx = ParallelCtx()):
    """One incremental decode step: tokens1 [B,1] at absolute position pos
    (``ctx`` goes to the forward: its MoE layers and held blocks; under a
    mesh ``caches`` is the rank's block)."""
    logits, new_caches = forward(cfg, params, tokens1, caches=caches,
                                 pos_offset=pos, ctx=ctx)
    return logits[:, -1], new_caches
