"""Core layers: RMSNorm, RoPE, chunked (flash-style) attention, GQA, MLA,
the SwiGLU/GELU MLPs and MoE, as torch functions over dicts of tensors.

The port of the reference package's ``models/layers.py``.  Attention
with ``attn_impl="cuda"`` goes through the hand-written flash kernel
where the reference took its Pallas kernel and the kernel covers the
shape; otherwise it runs the reference's plain algorithms as torch ops:
an online-softmax chunked loop, or direct softmax for decode and small
sequences.  MoE keeps the reference's grouped one-hot einsum dispatch and
its sort-based expert-parallel form, with its all-to-alls over a mesh
axis of ranks (``repro_torch.parallel``).  GQA attention and the dense
MLP run tensor-parallel over a mesh's 'model' axis where the rank holds
their blocks, in place of the reference's sharding constraints (GSPMD
layout hints), which are not ported.  Products of two dtypes
promote to the wider, as ``jnp.matmul`` does (:func:`mm`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import AxisGroup, all_gather, all_to_all, psum
from ..parallel.sharding import P, kv_heads_held
from .config import ArchConfig

NEG_INF = -1e30
ATTN_IMPLS = ("xla", "cuda")


# ------------------------------------------------------------------- basics
def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the reference's dtype promotion: operands of two
    dtypes (f32 frames into bf16 weights) meet in the wider one, as
    ``jnp.matmul`` promotes them; one dtype takes no copy."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


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
    # MLA's q/k head dim differs from its v head dim, which the kernel
    # does not take (the reference's kernel fails there): those shapes
    # take the plain algorithms, decided before any launch
    if impl == "cuda" and Sq == Skv and causal and window == 0 \
            and Sq % 128 == 0 and q.shape[-1] == k.shape[-1] == v.shape[-1]:
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


def _held_kv(x, p, name: str, cfg: ArchConfig, heads: range, group):
    """This rank's kv heads ``heads`` of ``x``'s keys or values (``name``
    ``"k"`` or ``"v"``), from ``w{name}`` (and ``b{name}``) as the rank
    holds it: whole (the heads taken from the whole projection), as its
    spec's block where that block is exactly those heads (``m`` divides
    ``Hkv``), or as its spec's block of columns within heads, whose
    projections are all-gathered over 'model' before the heads are
    taken."""
    hd, n = cfg.hd(), cfg.n_kv_heads * cfg.hd()
    y = mm(x, p["w" + name])
    if cfg.qkv_bias:
        y = y + p["b" + name]
    cols = y.shape[-1]
    if cols == n:
        return y[..., heads.start * hd:heads.stop * hd]
    if cols * group.size != n:
        raise ValueError(f"attn/w{name}: {cols} columns, neither {n} nor a "
                         f"block of {n // group.size} over 'model'")
    if cfg.n_kv_heads % group.size == 0:
        return y
    y = torch.cat(all_gather(y, group).unbind(0), dim=-1)
    return y[..., heads.start * hd:heads.stop * hd]


def gqa_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
              causal=True, window=0, mesh=None):
    """GQA attention.  cache: dict(k,v [B,Smax,Hkv,hd], len) for decode,
    or a ring buffer dict(k,v [B,W,Hkv,hd], pos [W], len) for windowed
    decode past W.

    The cache's ``k``/``v`` (and ``pos``) are written in place (the
    reference returns updated copies): at ``[len, len+S)``, or in the ring
    at ``len % W`` with the start clamped to ``W - S``, as the reference's
    ``dynamic_update_slice`` clamps it.  The returned cache carries the
    new length.

    Tensor-parallel where the rank holds ``wq`` as its ``[d, H·hd/m]``
    block over the ``m`` ranks of ``mesh``'s 'model' axis (its spec,
    ``parallel.sharding.tp_spec``): column-parallel ``wq``/``wk``/``wv``
    give its ``H/m`` query heads and the kv heads they read
    (``kv_heads_held``, through :func:`_held_kv`), RoPE, the cache (which
    holds those kv heads only) and the attention run on them, and the
    row-parallel ``wo`` block's output is summed over 'model' (``psum``).
    Held whole, every head is computed, as without a mesh.
    """
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    hq = p["wq"].shape[-1] // hd
    group = None
    if hq == H:
        heads = range(Hkv)
        q = mm(x, p["wq"])
        k = mm(x, p["wk"])
        v = mm(x, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    else:
        if mesh is None or hq * mesh.shape["model"] != H:
            raise ValueError(f"attn/wq: {hq} of {H} heads without a mesh "
                             f"whose 'model' axis splits them")
        group = mesh.group("model")
        heads = kv_heads_held(cfg, mesh)
        q = mm(x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        k = _held_kv(x, p, "k", cfg, heads, group)
        v = _held_kv(x, p, "v", cfg, heads, group)
    hkv = len(heads)
    q = rope(q.reshape(B, S, hq, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, hkv, hd)
    new_cache = None
    if cache is not None:
        n = cache["len"]
        ck, cv = cache["k"], cache["v"]
        if ck.shape[2] != hkv:
            raise ValueError(f"a cache of {ck.shape[2]} kv heads where this "
                             f"rank's attention reads {hkv}")
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
    out = mm(out.reshape(B, S, hq * hd), p["wo"])
    return (out if group is None else psum(out, group)), new_cache


# ---------------------------------------------------------------------- MLA
def mla_params(gen, cfg: ArchConfig, dtype, device):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    s = 1.0 / math.sqrt(d)
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    r_q, r_kv = 1.0 / math.sqrt(m.q_lora_rank), 1.0 / math.sqrt(m.kv_lora_rank)
    return {
        "wdq": normal(gen, (d, m.q_lora_rank), s, dtype, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "wuq": normal(gen, (m.q_lora_rank, H * qk_dim), r_q, dtype, device),
        "wdkv": normal(gen, (d, m.kv_lora_rank), s, dtype, device),
        "wkr": normal(gen, (d, m.qk_rope_head_dim), s, dtype, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        "wuk": normal(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim), r_kv,
                      dtype, device),
        "wuv": normal(gen, (m.kv_lora_rank, H * m.v_head_dim), r_kv, dtype,
                      device),
        "wo": normal(gen, (H * m.v_head_dim, d), s, dtype, device),
    }


def mla_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
              absorbed_decode: bool = True):
    """DeepSeek MLA.  The decode cache stores only (c_kv, k_rope) —
    (kv_lora_rank + rope_dim) per token instead of 2·H·hd: dict(c_kv
    [B,Smax,r], k_rope [B,Smax,rope], len), written in place at ``[len,
    len+S)``; the returned cache carries the new length.

    absorbed_decode: use the W_uk-absorption identity so decode attends
    directly against the compressed cache (never materializes K for the
    whole context), as the reference does by default; otherwise K and V
    are materialised from the cache for every head.
    """
    m, H = cfg.mla, cfg.n_heads
    B, S, d = x.shape
    nope, rdim, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    cq = rmsnorm(p["q_norm"], x @ p["wdq"], cfg.rms_eps)
    q = (cq @ p["wuq"]).reshape(B, S, H, nope + rdim)
    q_nope = q[..., :nope]
    q_rope = rope(q[..., nope:], positions, cfg.rope_theta)

    c_kv = x @ p["wdkv"]                                # [B,S,r]
    k_rope = rope((x @ p["wkr"])[:, :, None, :], positions, cfg.rope_theta)
    c_kv_n = rmsnorm(p["kv_norm"], c_kv, cfg.rms_eps)

    scale = 1.0 / math.sqrt(nope + rdim)
    if cache is not None:
        n = cache["len"]
        cc, cr = cache["c_kv"], cache["k_rope"]
        cc[:, n:n + S] = c_kv_n
        cr[:, n:n + S] = k_rope[:, :, 0, :]
        new_cache = {**cache, "len": n + S}
        Sk = cc.shape[1]
        kv_pos = torch.arange(Sk, device=x.device)
        kv_pos = torch.where(kv_pos < n + S, kv_pos, -1)
        if absorbed_decode:
            # q_c[h] = W_uk[h]^T q_nope[h]  -> score = q_c . c_kv + q_r . k_r
            wuk = p["wuk"].reshape(m.kv_lora_rank, H, nope)
            q_c = torch.einsum("bshn,rhn->bshr", q_nope, wuk)
            s1 = torch.einsum("bshr,bkr->bhsk", q_c.float(), cc.float())
            s2 = torch.einsum("bshr,bkr->bhsk", q_rope.float(), cr.float())
            sc = (s1 + s2) * scale
            mask = (positions[:, None] >= kv_pos[None, :]) & (kv_pos >= 0)
            sc = torch.where(mask, sc, NEG_INF)
            pr = torch.softmax(sc, dim=-1)
            # out[h] = (pr . c_kv) W_uv[h]
            ctx = torch.einsum("bhsk,bkr->bshr", pr.to(cc.dtype), cc)
            wuv = p["wuv"].reshape(m.kv_lora_rank, H, vdim)
            out = torch.einsum("bshr,rhv->bshv", ctx, wuv)
        else:
            k_nope = (cc @ p["wuk"]).reshape(B, Sk, H, nope)
            vfull = (cc @ p["wuv"]).reshape(B, Sk, H, vdim)
            kfull = torch.cat(
                [k_nope, cr[:, :, None, :].expand(B, Sk, H, rdim)], dim=-1)
            qfull = torch.cat([q_nope, q_rope], dim=-1)
            out = attention_core(qfull, kfull, vfull, causal=True,
                                 q_pos=positions, kv_pos=kv_pos, scale=scale)
        return out.reshape(B, S, H * vdim) @ p["wo"], new_cache

    k_nope = (c_kv_n @ p["wuk"]).reshape(B, S, H, nope)
    vfull = (c_kv_n @ p["wuv"]).reshape(B, S, H, vdim)
    kfull = torch.cat([k_nope, k_rope.expand(B, S, H, rdim)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_core(qfull, kfull, vfull, causal=True, q_pos=positions,
                         kv_pos=positions, scale=scale, impl=cfg.attn_impl)
    return out.reshape(B, S, H * vdim) @ p["wo"], None


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


def mlp_apply(p, x, kind: str, group: Optional[AxisGroup] = None):
    """The dense MLP.  With ``group`` (the 'model' axis), the rank holds
    column-parallel ``wg``/``wu`` (or ``w1``) and row-parallel ``wd`` (or
    ``w2``) blocks of the hidden dim, and its output is summed over the
    axis (``psum``)."""
    if kind == "swiglu":
        out = mm(F.silu(mm(x, p["wg"])) * mm(x, p["wu"]), p["wd"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        out = mm(F.gelu(mm(x, p["w1"]), approximate="tanh"), p["w2"])
    return out if group is None else psum(out, group)


# ---------------------------------------------------------------------- MoE
def moe_params(gen, cfg: ArchConfig, dtype, device):
    """Routed experts stacked ``[E, ...]``, an optional shared expert, and
    the router in f32 whatever ``dtype``."""
    mo, d = cfg.moe, cfg.d_model
    ff = mo.d_ff_expert
    s = 1.0 / math.sqrt(d)
    p = {
        "router": normal(gen, (d, mo.n_experts), s, torch.float32, device),
        "wg": normal(gen, (mo.n_experts, d, ff), s, dtype, device),
        "wu": normal(gen, (mo.n_experts, d, ff), s, dtype, device),
        "wd": normal(gen, (mo.n_experts, ff, d), 1.0 / math.sqrt(ff), dtype,
                     device),
    }
    if mo.n_shared:
        p["shared"] = mlp_params(gen, d, ff * mo.n_shared, "swiglu", dtype,
                                 device)
    return p


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in int64: the last dim marks ``idx``, and an
    index outside ``[0, n)`` gives a zero row.  A comparison with
    ``arange(n)``, the same ops on every device: ``F.one_hot`` refuses such
    an index and dispatches other ops on CUDA (a scatter) than on the CPU
    (its range checks) and on ``meta``, so the op counter's counts of a
    step on the card and on ``meta`` would differ."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest along the last dim, in descending
    order, ties to the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """``(gate, idx)``: each token's top-``k`` experts under the f32 router's
    softmax, the gates renormalised over the ``k`` with a 1e-9 floor."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, idx = top_k(probs, k)
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), idx


def moe_groups(cfg: ArchConfig, T: int) -> tuple[int, int, int]:
    """``(G, Tg, C)`` of :func:`moe_einsum_apply` at ``T`` tokens: its
    groups, their size (``group_size``, or one group when it does not
    divide ``T``) and each expert's capacity in a group."""
    mo = cfg.moe
    Tg = min(mo.group_size, T)
    if T % Tg:
        Tg = T
    return T // Tg, Tg, max(1, int(Tg * mo.top_k / mo.n_experts
                                   * mo.capacity_factor))


def moe_einsum_apply(p, x, cfg: ArchConfig, *, tokens: Optional[int] = None,
                     first_expert: int = 0):
    """Switch-style capacity dispatch with *grouped* one-hot einsums.

    Tokens are split into ``G`` groups of ``Tg`` (``group_size``, or one
    group when it does not divide); each expert takes at most ``C`` tokens
    of a group, in token order, and the rest are dropped.  The dispatch
    tensor is [G, Tg, E, C].  The combine weights are built in f32 and cast
    to x's dtype before the combine einsum, as the reference does.

    ``tokens``: the count :func:`moe_groups` forms ``Tg`` and ``C`` from,
    ``x``'s own by default; a rank whose ``x`` is a whole number of the
    global batch's groups passes the global count.  ``p``'s expert stacks
    may hold a range ``[first_expert, first_expert + E_loc)`` of the ``E``
    experts (a rank's slice): routing reads all ``E`` and each position is
    the cumsum of its own expert's one-hot column, so the range changes no
    position and no drop; the result is the range's part of the routed
    sum (plus the shared expert as ``p`` holds it), for the caller to sum
    over the ranks.
    """
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    k = mo.top_k
    _, Tg, C = moe_groups(cfg, T if tokens is None else tokens)
    if T % Tg:
        raise ValueError(f"{T} tokens are not whole groups of {Tg}")
    G, E = T // Tg, p["wg"].shape[0]
    xt = x.reshape(G, Tg, d)
    gate, idx = route(p["router"], xt, k)                   # [G,Tg,k]
    # [G,Tg,k,E]: an expert outside the range gives a zero row
    onehot = one_hot(idx - first_expert if first_expert else idx, E)
    pos_all = torch.cumsum(onehot.reshape(G, Tg * k, E), dim=1).reshape(
        G, Tg, k, E) - 1
    pos = (pos_all * onehot).sum(-1)                        # [G,Tg,k]
    # a zero row where pos >= C: the slot is dropped
    slot_oh = one_hot(pos, C).to(x.dtype)                   # [G,Tg,k,C]
    disp = torch.einsum("gtke,gtkc->gtec", onehot.to(x.dtype), slot_oh)
    comb = torch.einsum("gtke,gtk,gtkc->gtec", onehot.float(), gate.float(),
                        slot_oh.float())
    xe = torch.einsum("gtd,gtec->gecd", xt, disp)           # [G,E,C,d]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", xe, p["wu"])
    ye = torch.einsum("gecf,efd->gecd", h, p["wd"])
    yt = torch.einsum("gecd,gtec->gtd", ye, comb.to(x.dtype))
    out = yt.reshape(B, S, d)
    if mo.n_shared:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out


#: the reference's storage sharding of an MoE layer, in the port's specs
MOE_PARAM_SPECS = {
    "router": P(None, None),
    "wg": P("model", None, None),
    "wu": P("model", None, None),
    "wd": P("model", None, None),
    "shared": {"wg": P(None, "model"), "wu": P(None, "model"),
               "wd": P("model", None)},
}


def moe_ep_apply(p, x, cfg: ArchConfig, *, ep_axis=None, ep_size: int = 1,
                 mesh=None, stats: Optional[dict] = None):
    """Expert-parallel MoE with explicit all-to-all (DeepSeek-style EP).

    The reference's general form.  ``x`` is this rank's token block
    [B_loc, S_loc, d]; the expert weights arrive sliced [E_loc, ...] where
    E_loc = E / ep_size.  ``ep_axis`` is an :class:`AxisGroup` of
    ``ep_size`` ranks, or an axis name (or tuple) of ``mesh``; ``None``
    (and ``ep_size`` 1) runs one shard with no exchange.  Dispatch: local
    top-k -> stable sort by destination shard -> ``C = T·k/ep_size·cf``
    slots a destination (the rest dropped) -> all_to_all -> stable sort
    by local expert into ``Ce = N/E_loc·cf`` rows each (the rest dropped)
    -> expert GEMMs -> all_to_all back -> each kept slot's output,
    weighted by its gate, added in f32 at its token, in expert order (at
    one shard, the order of the expert buffer).

    At one shard the send buffer holds token indices, not rows: the
    expert buffer is gathered from ``x`` directly, as no exchange needs
    them.  ``stats``, when given, receives this shard's routing ``idx``
    [T, k], ``kept`` [T·k] (each token-major slot kept in the send buffer)
    and ``dropped`` (slots dropped at the send buffer, at this rank's
    experts).
    """
    mo = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, mo.n_experts, mo.top_k
    if E % ep_size:
        raise ValueError(f"{E} experts do not split over {ep_size} shards")
    if ep_axis is not None and not isinstance(ep_axis, AxisGroup):
        ep_axis = mesh.group(ep_axis)
    if (1 if ep_axis is None else ep_axis.size) != ep_size:
        raise ValueError(f"ep_size {ep_size} on an axis of "
                         f"{1 if ep_axis is None else ep_axis.size} ranks")
    group = ep_axis if ep_size > 1 else None
    e_loc = E // ep_size
    dev = x.device
    xt = x.reshape(T, d)
    gate, idx = route(p["router"], xt, k)                   # [T, k]

    TK = T * k
    flat_e = idx.reshape(TK)                                # expert per slot
    flat_dst = flat_e // e_loc                              # destination
    # capacity per destination shard
    C = max(1, int(TK / ep_size * mo.capacity_factor))
    order = torch.argsort(flat_dst, stable=True)        # as jnp.argsort
    d_sorted = flat_dst[order]
    pos = torch.arange(TK, device=dev) - torch.searchsorted(
        d_sorted, d_sorted, right=False)
    keep = pos < C
    n_send = ep_size * C
    slot = torch.where(keep, d_sorted * C + pos, n_send)    # overflow -> drop
    # each send slot's token-major slot and local expert (-1: empty)
    send_j = torch.zeros((n_send + 1,), dtype=torch.int64, device=dev)
    send_j[slot] = order             # index_put: only the dropped row twice
    send_e = torch.full((n_send + 1,), -1, dtype=torch.int64, device=dev)
    send_e[slot] = flat_e[order] % e_loc
    send_j, send_e = send_j[:-1], send_e[:-1]
    if group is None:
        recv_e = send_e
    else:
        recv_x = all_to_all(xt[send_j // k].reshape(ep_size, C, d), group
                            ).reshape(n_send, d)
        recv_e = all_to_all(send_e.reshape(ep_size, C), group
                            ).reshape(n_send)

    # local expert processing: sort received slots by local expert id
    N = n_send
    Ce = max(1, int(N / e_loc * mo.capacity_factor))
    ekey = torch.where(recv_e < 0, e_loc, recv_e)           # empty slots last
    order2 = torch.argsort(ekey, stable=True)
    ekey = ekey[order2]
    pos2 = torch.arange(N, device=dev) - torch.searchsorted(ekey, ekey,
                                                            right=False)
    keep2 = (pos2 < Ce) & (ekey < e_loc)
    row = torch.where(keep2, ekey * Ce + pos2, e_loc * Ce)  # overflow -> drop
    buf = x.new_zeros((e_loc * Ce + 1, d))
    if group is None:
        buf[row] = xt[send_j[order2] // k]
    else:
        buf[row] = recv_x[order2]
        del recv_x
    buf = buf[:-1].reshape(e_loc, Ce, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["wu"])
    del buf
    yb = torch.einsum("ecf,efd->ecd", h, p["wd"]).reshape(e_loc * Ce, d)
    del h
    y = torch.where(keep2[:, None], yb[torch.where(keep2, row, 0)], 0)
    del yb
    if stats is not None:
        kept = torch.zeros((TK,), dtype=torch.bool, device=dev)
        kept[order] = keep
        stats.update(idx=idx, kept=kept, dropped=(
            int((~keep).sum()), int(((ekey < e_loc) & ~keep2).sum())))

    if group is None:
        j, live = send_j[order2], keep2
    else:
        # un-sort back to recv slot order, then all_to_all back
        y_recv = torch.zeros_like(y)
        y_recv[order2] = y
        y = all_to_all(y_recv.reshape(ep_size, C, d), group).reshape(N, d)
        del y_recv
        # at origin, in expert order (empty slots last), as one shard adds
        eid = torch.where(send_e < 0, E, flat_e[send_j])
        corder = torch.argsort(eid, stable=True)
        y, j, live = y[corder], send_j[corder], send_e[corder] >= 0
    # combine at origin: slot -> (token, gate), in f32
    w = torch.where(live, gate.reshape(-1)[j], 0)
    yt = torch.zeros((T, d), dtype=torch.float32, device=dev).index_add_(
        0, j // k, y.float() * w[:, None])
    out = yt.to(x.dtype).reshape(B, S, d)
    if mo.n_shared:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out
