"""Core layers: RMSNorm, RoPE, chunked (flash-style) attention, GQA and the
SwiGLU/GELU MLPs, as torch functions over dicts of tensors.

The port of the reference package's ``models/layers.py`` (dense path).
Attention with ``attn_impl="cuda"`` goes through the hand-written flash
kernel where the reference took its Pallas kernel; otherwise it runs the
reference's plain algorithms as torch ops: an online-softmax chunked
loop, or direct softmax for decode and small sequences.  MLA and MoE are
not ported yet; the reference's sharding constraints have no counterpart
on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig

NEG_INF = -1e30
ATTN_IMPLS = ("xla", "cuda")


# ------------------------------------------------------------------- basics
def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (w * x).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embedding. x: [..., S, H, D], pos: [S] or [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[..., None] * freqs                     # [.., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [.., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# -------------------------------------------------- chunked flash attention
def _attn_chunked(q, k, v, *, causal: bool, q_pos, kv_pos,
                  window: int = 0, chunk: int = 1024, q_block: int = 512,
                  scale: float = None):
    """Online-softmax attention, blocked on BOTH q and kv (flash algorithm).

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D]; GQA by head grouping.  Every
    q block visits every kv chunk: the reference's static 4-group causal
    split only skips chunks that are fully masked for the whole block,
    and such a chunk adds exactly nothing (p = 0, correction 1) to a row
    that has met a visible key, as every causal row has in chunk 0.
    """
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))

    q_block = min(q_block, Sq)
    qpad = (-Sq) % q_block
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        q_pos = F.pad(q_pos, (0, qpad), value=2_000_000_000)
    nqb = (Sq + qpad) // q_block
    qg = q.reshape(B, nqb, q_block, Hkv, G, D)
    qp = q_pos.reshape(nqb, q_block)

    nchunk = (Skv + chunk - 1) // chunk
    pad = nchunk * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1_000_000_000)
    kc = k.reshape(B, nchunk, chunk, Hkv, D)
    vc = v.reshape(B, nchunk, chunk, Hkv, Dv)
    pc = kv_pos.reshape(nchunk, chunk)

    outs = []
    for i in range(nqb):
        qb, pb_q = qg[:, i].float(), qp[i]
        m = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q_block, Dv), dtype=torch.float32,
                          device=q.device)
        for c in range(nchunk):
            kb, vb, pb = kc[:, c], vc[:, c], pc[c]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.float()) * scale
            mask = pb[None, :] > -1_000_000_000 + 1           # kv padding
            if causal:
                mask = mask & (pb_q[:, None] >= pb[None, :])
            if window:
                mask = mask & (pb_q[:, None] - pb[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(lsum, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                  # [B,Hkv,G,q_block,Dv]
    out = torch.stack(outs, dim=1)                    # [B,nqb,Hkv,G,qb,Dv]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq + qpad, Hkv * G, Dv)
    return out[:, :Sq].to(q.dtype)


def _attn_direct(q, k, v, *, causal, q_pos, kv_pos, window=0, scale=None):
    """Direct attention (decode / small sequences)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = kv_pos[None, :] >= 0
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if window:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v)
    Dv = v.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def attention_core(q, k, v, *, causal=True, q_pos=None, kv_pos=None,
                   window=0, scale=None, impl="xla"):
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} is not one of {ATTN_IMPLS}")
    Sq, Skv = q.shape[1], k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=q.device)
    if impl == "cuda" and Sq == Skv and causal and window == 0 \
            and Sq % 128 == 0:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True)
    # shapes the kernel doesn't cover take the plain algorithms
    if Sq == 1 or Sq * Skv <= 1024 * 1024:
        return _attn_direct(q, k, v, causal=causal, q_pos=q_pos,
                            kv_pos=kv_pos, window=window, scale=scale)
    return _attn_chunked(q, k, v, causal=causal, q_pos=q_pos, kv_pos=kv_pos,
                         window=window, scale=scale)


# ---------------------------------------------------------------------- init
def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in f32 from ``gen``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------- GQA
def gqa_params(gen, cfg: ArchConfig, dtype, device):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(gen, (d, H * hd), s, dtype, device),
        "wk": normal(gen, (d, Hkv * hd), s, dtype, device),
        "wv": normal(gen, (d, Hkv * hd), s, dtype, device),
        "wo": normal(gen, (H * hd, d), s, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def gqa_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
              causal=True, window=0):
    """GQA attention.  cache: dict(k,v [B,Smax,Hkv,hd], len) for decode,
    or a ring buffer dict(k,v [B,W,Hkv,hd], pos [W], len) for windowed
    decode past W.

    The cache's ``k``/``v`` (and ``pos``) are written in place (the
    reference returns updated copies): at ``[len, len+S)``, or in the ring
    at ``len % W`` with the start clamped to ``W - S``, as the reference's
    ``dynamic_update_slice`` clamps it.  The returned cache carries the
    new length.
    """
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)
    new_cache = None
    if cache is not None:
        n = cache["len"]
        ck, cv = cache["k"], cache["v"]
        if "pos" in cache:                 # ring buffer of W slots
            W = ck.shape[1]
            if S > W:
                raise ValueError(f"{S} tokens do not fit a ring cache of "
                                 f"{W} slots")
            idx = min(n % W, W - S)
            kv_pos = cache["pos"]
            kv_pos[idx:idx + S] = positions
        else:
            idx = n
            kv_pos = torch.arange(ck.shape[1], device=x.device)
            kv_pos = torch.where(kv_pos < n + S, kv_pos, -1)
        ck[:, idx:idx + S] = k
        cv[:, idx:idx + S] = v
        new_cache = {**cache, "len": n + S}
        k, v = ck, cv
    else:
        kv_pos = positions
    out = attention_core(q, k, v, causal=causal, q_pos=positions,
                         kv_pos=kv_pos, window=window, impl=cfg.attn_impl)
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


# ---------------------------------------------------------------------- MLP
def mlp_params(gen, d: int, ff: int, kind: str, dtype, device):
    s = 1.0 / math.sqrt(d)
    if kind == "swiglu":
        return {"wg": normal(gen, (d, ff), s, dtype, device),
                "wu": normal(gen, (d, ff), s, dtype, device),
                "wd": normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype,
                             device)}
    return {"w1": normal(gen, (d, ff), s, dtype, device),
            "w2": normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype, device)}


def mlp_apply(p, x, kind: str):
    if kind == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]
