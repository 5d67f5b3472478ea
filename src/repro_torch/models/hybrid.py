"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block.

The port of the reference package's ``models/hybrid.py``.  The shared
transformer block (attention + MLP with its own weights) is applied every
``cfg.shared_attn_every`` layers, with the same weights each time; the
shared attention uses the config's sliding window, with a ring-buffer
cache once the window is shorter than the cache.  The reference's groups
of SSM layers scanned between attention applications become one Python
loop over the layers (the same order); ``seq_shard`` and ``ParallelCtx``
have no counterpart on one card.  Mamba2 layers stay stacked (``[n_ssm,
...]``) as in the reference; decode caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..compat import default_device
from .config import ArchConfig
from .layers import gqa_apply, gqa_params, mlp_apply, mlp_params, normal, rmsnorm
from .ssm import mamba2_apply, mamba2_params
from .transformer import attn_cache, layer, layer_cache


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None):
    """Parameters drawn from ``gen`` (which must live on ``device``:
    CUDA unless the caller passes ``device="cpu"``)."""
    device = default_device(device)
    s = 1.0 / math.sqrt(cfg.d_model)
    n = _n_ssm(cfg)

    def ones(*lead):
        return torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)

    params = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), s, dtype, device),
        "ln_f": ones(),
        "ssm_layers": {"ln": ones(n),
                       "mamba": mamba2_params(gen, cfg, dtype, device, n)},
        "shared_attn": {
            "ln1": ones(),
            "ln2": ones(),
            "attn": gqa_params(gen, cfg, dtype, device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                              device),
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(gen, (cfg.d_model, cfg.vocab), s, dtype,
                                   device)
    return params


def _is_attn_layer(cfg: ArchConfig, i: int) -> bool:
    k = cfg.shared_attn_every
    return k > 0 and (i + 1) % k == 0


def _n_ssm(cfg: ArchConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if not _is_attn_layer(cfg, i))


def _n_attn(cfg: ArchConfig) -> int:
    return cfg.n_layers - _n_ssm(cfg)


def forward(cfg: ArchConfig, params, tokens, *, caches=None, pos_offset=0,
            window: Optional[int] = None, extra_embeds=None):
    """tokens [B,S] -> (logits [B,S,V], caches).  ``caches`` (as
    :func:`init_cache` makes them) are written in place; pos_offset is the
    absolute position of tokens[:,0]."""
    del extra_embeds  # hybrid arch has no modality frontend
    window = cfg.sliding_window if window is None else window
    x = params["embed"][tokens]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + pos_offset
    ssm_i = attn_i = 0
    for i in range(cfg.n_layers):
        if _is_attn_layer(cfg, i):
            p = params["shared_attn"]
            c = None if caches is None else layer_cache(caches["attn"],
                                                        attn_i)
            h = rmsnorm(p["ln1"], x, cfg.rms_eps)
            a, _ = gqa_apply(p["attn"], h, cfg, positions=positions, cache=c,
                             window=window)
            x = x + a
            h = rmsnorm(p["ln2"], x, cfg.rms_eps)
            x = x + mlp_apply(p["mlp"], h, cfg.mlp)
            attn_i += 1
        else:
            p = layer(params["ssm_layers"], ssm_i)
            c = None if caches is None else layer(caches["ssm"], ssm_i)
            y, nc = mamba2_apply(p["mamba"], rmsnorm(p["ln"], x, cfg.rms_eps),
                                 cfg, cache=c)
            x = x + y
            if caches is not None:
                caches["ssm"]["conv"][ssm_i] = nc["conv"]
                caches["ssm"]["ssm"][ssm_i] = nc["ssm"]
            ssm_i += 1
    x = rmsnorm(params["ln_f"], x, cfg.rms_eps)
    logits = x @ (params["embed"].T if cfg.tie_embeddings
                  else params["unembed"])
    new_caches = None
    if caches is not None:
        new_caches = {"ssm": caches["ssm"],
                      "attn": {**caches["attn"],
                               "len": caches["attn"]["len"] + S}}
    return logits, new_caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer caches, on CUDA unless the caller passes
    ``device="cpu"``: each Mamba2 layer's conv history (in ``dtype``) and
    f32 state, and one attention cache per application of the shared
    block (a ring buffer when the window is shorter than ``max_len``)."""
    device = default_device(device)
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    n = _n_ssm(cfg)
    return {
        "ssm": {"conv": torch.zeros((n, batch, s.d_conv - 1,
                                     di + 2 * s.d_state), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((n, batch, nh, s.head_dim, s.d_state),
                                   dtype=torch.float32, device=device)},
        "attn": attn_cache(cfg, _n_attn(cfg), batch, max_len, dtype, device),
    }


def decode_step(cfg: ArchConfig, params, tokens1, caches, pos: int):
    """One incremental decode step: tokens1 [B,1] at absolute position pos."""
    logits, new_caches = forward(cfg, params, tokens1, caches=caches,
                                 pos_offset=pos)
    return logits[:, -1], new_caches
