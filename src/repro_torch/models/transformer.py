"""Decoder-only LM, dense path: the port of the reference package's
``models/transformer.py`` for the dense (GQA) family.

Layers stay stacked (``[L, ...]`` leading dim) as in the reference, so its
parameter pytree carries across one to one; the port loops over them in
Python (one ``unbind`` a stacked leaf, so the backward stacks the layers'
gradients once).  When training (``cfg.remat``, grad mode on and params
that require grad) each block is rematerialised in the backward, as the
reference wraps its scanned body in ``jax.checkpoint``.  The unembedding
keeps the reference's custom VJP, which casts the cotangent to the
weight's dtype.  Decode caches are updated in place.  MoE, MLA and the
sharded context wait for their ROADMAP items.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..compat import default_device
from ..tree import leaves
from .config import ArchConfig
from .layers import gqa_apply, gqa_params, mlp_apply, mlp_params, normal, rmsnorm


def stack(layers: list) -> dict:
    """Stack a list of equally shaped param dicts along a new leading dim."""
    first = layers[0]
    return {k: (stack([lp[k] for lp in layers]) if isinstance(v, dict)
                else torch.stack([lp[k] for lp in layers]))
            for k, v in first.items()}


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


def _layer_params(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": gqa_params(gen, cfg, dtype, device),
        "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None):
    """Parameters drawn from ``gen`` (which must live on ``device``:
    CUDA unless the caller passes ``device="cpu"``)."""
    device = default_device(device)
    s = 1.0 / math.sqrt(cfg.d_model)
    params: dict = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), s, dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(gen, (cfg.d_model, cfg.vocab), s, dtype,
                                   device)
    params["layers"] = stack([_layer_params(gen, cfg, dtype, device)
                              for _ in range(cfg.n_layers)])
    return params


def _block(cfg: ArchConfig, p, x, positions, cache, window: int = 0):
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    a, new_cache = gqa_apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, window=window)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp), new_cache


def _embed(cfg: ArchConfig, params, tokens, extra_embeds=None):
    x = params["embed"][tokens]
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


def _unembed(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return unembed_mm(x, params["embed"], True)
    return unembed_mm(x, params["unembed"], False)


def forward(cfg: ArchConfig, params, tokens, *, extra_embeds=None,
            caches=None, pos_offset: int = 0, window: Optional[int] = None):
    """Full forward pass. tokens [B,S] -> (logits [B,S_total,V], caches).

    caches: the stacked cache dict of :func:`init_cache` for incremental
    decoding, written in place; pos_offset is the absolute position of
    tokens[:,0].
    """
    window = cfg.sliding_window if window is None else window
    x = _embed(cfg, params, tokens, extra_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + pos_offset
    c = caches["dense"] if caches is not None else None
    on = c is None and remat(cfg, params)
    for i, p in enumerate(unstack(params["layers"], cfg.n_layers)):
        if on:
            x = rematerialised(lambda p, x: _block(
                cfg, p, x, positions, None, window)[0], p, x)
        else:
            x, _ = _block(cfg, p, x, positions,
                          None if c is None else layer_cache(c, i), window)
    new_caches = None
    if caches is not None:
        new_caches = {"dense": {**c, "len": c["len"] + S}}
    x = rmsnorm(params["ln_f"], x, cfg.rms_eps)
    return _unembed(cfg, params, x), new_caches


def xent(logits, labels):
    """Mean next-token cross entropy over the labels ``>= 0``.

    The reference contracts the logits with a ``[B,S,V]`` one-hot (a
    sharding device); here the gold logit is gathered, at an index
    clamped to 0 where the label is ``-1`` (whose one-hot row is all
    zeros), and the mask zeroes those terms.  The mean's denominator is
    floored at 1, as the reference's is."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token cross-entropy; batch = {tokens, labels[, extra_embeds]}."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        extra_embeds=batch.get("extra_embeds"))
    labels = batch["labels"]
    if batch.get("extra_embeds") is not None:
        # loss only on text positions: labels padded with -1 over the
        # modality prefix
        prefix = logits.shape[1] - labels.shape[1]
        labels = torch.cat([torch.full(labels.shape[:1] + (prefix,), -1,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    return xent(logits, labels)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer decode caches (``len`` is a host integer; a ring
    buffer under a sliding window shorter than ``max_len``), on CUDA
    unless the caller passes ``device="cpu"``."""
    device = default_device(device)
    return {"dense": attn_cache(cfg, cfg.n_layers, batch, max_len, dtype,
                                device)}


def decode_step(cfg: ArchConfig, params, tokens1, caches, pos: int):
    """One incremental decode step: tokens1 [B,1] at absolute position pos."""
    logits, new_caches = forward(cfg, params, tokens1, caches=caches,
                                 pos_offset=pos)
    return logits[:, -1], new_caches
