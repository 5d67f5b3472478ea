"""Whisper-backbone encoder-decoder (the conv frontend is a stub).

The port of the reference package's ``models/encdec.py``.  Inputs:
``frames`` [B, S_audio, d_model], precomputed frame embeddings (the stub
for the mel-spectrogram conv stem), and decoder ``tokens`` [B, S_text].
Encoder = bidirectional self-attention; decoder = causal self-attention +
cross-attention to the encoder output.

In the EDT view this is a two-statement polyhedral program whose cross-
attention dependences form a genuinely non-tree task graph (the paper's
diamond case): every decoder tile depends on every encoder tile.

The port keeps the reference's routes.  Only the decoder's causal
self-attention can reach the flash kernel (``attention_core`` takes it for
``Sq == Skv``, causal, no window, ``Sq % 128 == 0``): the encoder's
self-attention is bidirectional and the cross-attention passes no
``impl``, so both always run the plain algorithms.  ``decode`` recomputes
each layer's cross K/V from ``enc_out`` on every call, decode steps
included, as the reference does.  The loss covers only the decoder's
text logits, so its labels are not padded over the frames.  Layers stay
stacked (``[L, ...]``) as in the reference; when training (``cfg.remat``,
grad mode on and params that require grad) each block is rematerialised
in the backward, as the reference wraps its scanned bodies in
``jax.checkpoint``.  Decode caches are GQA caches written in place with a
host-integer ``len``.  ``forward``, ``loss_fn`` and ``decode_step`` take
the reference's ``ParallelCtx``, which the reference's encoder-decoder
reads nowhere (its ``xent`` reads it for a layout hint, not ported), so
``ctx`` changes nothing here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..compat import default_device
from .config import ArchConfig
from .layers import (attention_core, gqa_apply, gqa_params, mlp_apply,
                     mlp_params, normal, rmsnorm)
from .transformer import (ParallelCtx, layer_cache, remat, rematerialised,
                          stacked, unstack, xent)

#: rows of the learned encoder positions; longer inputs tile them
ENC_POS = 8192


def _xattn_params(gen, cfg: ArchConfig, dtype, device):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd()
    s = 1.0 / math.sqrt(d)
    return {"wq": normal(gen, (d, H * hd), s, dtype, device),
            "wk": normal(gen, (d, H * hd), s, dtype, device),
            "wv": normal(gen, (d, H * hd), s, dtype, device),
            "wo": normal(gen, (H * hd, d), s, dtype, device)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None):
    """Parameters drawn from ``gen`` (which must live on ``device``:
    CUDA unless the caller passes ``device="cpu"``)."""
    device = default_device(device)
    s = 1.0 / math.sqrt(cfg.d_model)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=device)

    def enc_layer():
        return {"ln1": ones(), "ln2": ones(),
                "attn": gqa_params(gen, cfg, dtype, device),
                "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                  device)}

    def dec_layer():
        return {"ln1": ones(), "ln_x": ones(), "ln2": ones(),
                "attn": gqa_params(gen, cfg, dtype, device),
                "xattn": _xattn_params(gen, cfg, dtype, device),
                "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                  device)}

    return {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), s, dtype, device),
        "enc_pos": normal(gen, (ENC_POS, cfg.d_model), 0.01, dtype, device),
        "ln_enc": ones(),
        "ln_f": ones(),
        "enc_layers": stacked(cfg.n_encoder_layers, enc_layer),
        "dec_layers": stacked(cfg.n_layers, dec_layer),
        "unembed": normal(gen, (cfg.d_model, cfg.vocab), s, dtype, device),
    }


def enc_block(cfg: ArchConfig, p, h, positions):
    """One encoder layer: bidirectional self-attention and the MLP."""
    a, _ = gqa_apply(p["attn"], rmsnorm(p["ln1"], h, cfg.rms_eps), cfg,
                     positions=positions, causal=False)
    h = h + a
    return h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, cfg.rms_eps), cfg.mlp)


def encode(cfg: ArchConfig, params, frames):
    """frames [B, S, d] -> encoder output [B, S, d].  ``frames`` plus the
    positions promote as in the reference (bf16 frames and f32 params give
    f32); past ``ENC_POS`` frames the positions repeat."""
    S = frames.shape[1]
    pe = params["enc_pos"]
    if S > pe.shape[0]:
        pe = pe.repeat(-(-S // pe.shape[0]), 1)
    x = frames + pe[None, :S]
    positions = torch.arange(S, device=x.device)
    on = remat(cfg, params)
    for p in unstack(params["enc_layers"], cfg.n_encoder_layers):
        if on:
            x = rematerialised(
                lambda p, x: enc_block(cfg, p, x, positions), p, x)
        else:
            x = enc_block(cfg, p, x, positions)
    return rmsnorm(params["ln_enc"], x, cfg.rms_eps)


def _cross_attend(p, x, enc_kv, cfg: ArchConfig):
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd()
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k, v = enc_kv
    Sk = k.shape[1]
    # no impl: the reference's cross-attention always takes the plain
    # algorithms
    out = attention_core(q, k, v, causal=False,
                         q_pos=torch.arange(S, device=x.device),
                         kv_pos=torch.arange(Sk, device=x.device))
    return out.reshape(B, S, H * hd) @ p["wo"]


def dec_block(cfg: ArchConfig, p, h, enc_out, positions, cache=None):
    """One decoder layer: causal self-attention (through ``cache`` when
    given), cross-attention to ``enc_out`` with K/V computed here from it,
    and the MLP.  Returns ``(h, new_cache)``."""
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.hd()
    a, nc = gqa_apply(p["attn"], rmsnorm(p["ln1"], h, cfg.rms_eps), cfg,
                      positions=positions, cache=cache)
    h = h + a
    k = (enc_out @ p["xattn"]["wk"]).reshape(B, -1, H, hd)
    v = (enc_out @ p["xattn"]["wv"]).reshape(B, -1, H, hd)
    h = h + _cross_attend(p["xattn"], rmsnorm(p["ln_x"], h, cfg.rms_eps),
                          (k, v), cfg)
    h = h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, cfg.rms_eps), cfg.mlp)
    return h, nc


def decode(cfg: ArchConfig, params, tokens, enc_out, *, caches=None,
           pos_offset: int = 0):
    """tokens [B, S] and enc_out [B, S_audio, d] -> (logits [B, S, V],
    caches).  ``caches`` (as :func:`init_cache` makes them) are written in
    place; ``pos_offset`` is the absolute position of tokens[:, 0]."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device) + pos_offset
    on = caches is None and remat(cfg, params)
    for i, p in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        if on:
            x = rematerialised(lambda p, x, e: dec_block(
                cfg, p, x, e, positions)[0], p, x, enc_out)
        else:
            x, _ = dec_block(cfg, p, x, enc_out, positions,
                             None if caches is None
                             else layer_cache(caches, i))
    new_caches = None if caches is None else {**caches,
                                              "len": caches["len"] + S}
    x = rmsnorm(params["ln_f"], x, cfg.rms_eps)
    return x @ params["unembed"], new_caches


def forward(cfg: ArchConfig, params, tokens, *, extra_embeds=None,
            caches=None, pos_offset: int = 0,
            ctx: ParallelCtx = ParallelCtx(), window: Optional[int] = None):
    """Encode ``extra_embeds`` (the frames, required), then decode
    ``tokens`` against them: (logits [B, S_text, V], caches)."""
    del window, ctx     # the reference's encdec takes and ignores both
    if extra_embeds is None:
        raise AssertionError("enc-dec needs frame embeddings")
    enc = encode(cfg, params, extra_embeds)
    return decode(cfg, params, tokens, enc, caches=caches,
                  pos_offset=pos_offset)


def loss_fn(cfg: ArchConfig, params, batch,
            ctx: ParallelCtx = ParallelCtx()):
    """Next-token cross-entropy over the text: batch = {tokens, labels,
    extra_embeds}.  The logits cover only the text, so the labels are not
    padded."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        extra_embeds=batch["extra_embeds"], ctx=ctx)
    return xent(logits, batch["labels"], ctx)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """The decoder's stacked self-attention caches, ``max_len`` flat slots
    a layer; ``len`` is a host integer.  On CUDA unless the caller passes
    ``device="cpu"``."""
    device = default_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def decode_step(cfg: ArchConfig, params, tokens1, caches, pos: int, *,
                enc_out, ctx: ParallelCtx = ParallelCtx()):
    """One incremental decode step: tokens1 [B, 1] at absolute position
    ``pos``, attending to ``enc_out`` (required, as in the reference)."""
    del ctx
    logits, new_caches = decode(cfg, params, tokens1, enc_out, caches=caches,
                                pos_offset=pos)
    return logits[:, -1], new_caches
