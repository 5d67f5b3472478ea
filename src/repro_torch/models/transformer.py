"""Decoder-only LM, dense path: the port of the reference package's
``models/transformer.py`` for the dense (GQA) family.

Layers stay stacked (``[L, ...]`` leading dim) as in the reference, so its
parameter pytree carries across one to one; the port loops over them in
Python, since ``scan``/``remat`` have no meaning for eager serving.  The
unembedding is the plain product (the reference's custom VJP serves
training).  Decode caches are updated in place.  MoE, MLA, the sharded
context and the loss wait for their ROADMAP items.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..compat import default_device
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


def _unembed(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


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
    for i in range(cfg.n_layers):
        x, _ = _block(cfg, layer(params["layers"], i), x, positions,
                      None if c is None else layer_cache(c, i), window)
    new_caches = None
    if caches is not None:
        new_caches = {"dense": {**c, "len": c["len"] + S}}
    x = rmsnorm(params["ln_f"], x, cfg.rms_eps)
    return _unembed(cfg, params, x), new_caches


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
