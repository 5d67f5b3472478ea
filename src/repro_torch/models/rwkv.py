"""RWKV6 ("Finch") language model: attention-free, O(S) compute, O(1) state.

The port of the reference package's ``models/rwkv.py``.  Layers stay
stacked as in the reference and are looped over in Python, each
rematerialised in the backward when training (as the reference's scanned
body is); decode caches are updated in place.
"""
from __future__ import annotations

import math

import torch

from ..compat import default_device
from .config import ArchConfig
from .layers import normal
from .ssm import rwkv6_channel_mix, rwkv6_params, rwkv6_time_mix
from .transformer import layer, remat, rematerialised, stacked, unstack, xent


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None):
    """Parameters drawn from ``gen`` (which must live on ``device``:
    CUDA unless the caller passes ``device="cpu"``)."""
    device = default_device(device)
    s = 1.0 / math.sqrt(cfg.d_model)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=device)

    p = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), s, dtype, device),
        "ln_in": ones(),
        "ln_f": ones(),
        "layers": stacked(cfg.n_layers, lambda: {
            "ln1": ones(), "ln2": ones(),
            "mix": rwkv6_params(gen, cfg, dtype, device)}),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = normal(gen, (cfg.d_model, cfg.vocab), s, dtype, device)
    return p


def _ln(w, x, eps):
    xf = x.float()
    return (w * (xf * torch.rsqrt(
        torch.mean(xf * xf, -1, keepdim=True) + eps))).to(x.dtype)


def forward(cfg: ArchConfig, params, tokens, *, caches=None, pos_offset=0,
            window=None, extra_embeds=None):
    """tokens [B,S] -> (logits [B,S,V], caches).  ``caches`` (stacked, as
    :func:`init_cache` makes them) are written in place."""
    del pos_offset, window, extra_embeds   # no positions, no frontend
    x = _ln(params["ln_in"], params["embed"][tokens], cfg.rms_eps)
    use_kernel = cfg.attn_impl == "cuda"
    on = caches is None and remat(cfg, params)

    def body(p, x, c):
        a, tm_new = rwkv6_time_mix(p["mix"], _ln(p["ln1"], x, cfg.rms_eps),
                                   cfg, cache=None if c is None else c["tm"],
                                   use_kernel=use_kernel)
        x = x + a
        f, cm_new = rwkv6_channel_mix(p["mix"], _ln(p["ln2"], x, cfg.rms_eps),
                                      cache=None if c is None else c["cm"])
        return x + f, tm_new, cm_new

    for i, p in enumerate(unstack(params["layers"], cfg.n_layers)):
        if on:
            x = rematerialised(lambda p, x: body(p, x, None)[0], p, x)
            continue
        c = None if caches is None else layer(caches, i)
        x, tm_new, cm_new = body(p, x, c)
        if caches is not None:
            caches["tm"]["shift"][i] = tm_new["shift"]
            caches["tm"]["wkv"][i] = tm_new["wkv"]
            caches["cm"]["shift"][i] = cm_new["shift"]
    x = _ln(params["ln_f"], x, cfg.rms_eps)
    logits = x @ (params["embed"].T if cfg.tie_embeddings
                  else params["unembed"])
    return logits, caches


def loss_fn(cfg: ArchConfig, params, batch):
    logits, _ = forward(cfg, params, batch["tokens"])
    return xent(logits, batch["labels"])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Stacked per-layer states (their size does not grow with
    ``max_len``), on CUDA unless the caller passes ``device="cpu"``."""
    del max_len
    device = default_device(device)
    L, d = cfg.n_layers, cfg.d_model
    D = cfg.rwkv.head_dim
    H = d // D

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"tm": {"shift": zeros((L, batch, 1, d)),
                   "wkv": zeros((L, batch, H, D, D), torch.float32)},
            "cm": {"shift": zeros((L, batch, 1, d))}}


def decode_step(cfg: ArchConfig, params, tokens1, caches, pos: int):
    logits, new_caches = forward(cfg, params, tokens1, caches=caches,
                                 pos_offset=pos)
    return logits[:, -1], new_caches
