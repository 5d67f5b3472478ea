"""State-space blocks: Mamba2 (SSD, chunked) and RWKV6 (data-dependent decay).

The port of the reference package's ``models/ssm.py``.  Both mixers run
their recurrence through a hand-written kernel for every S > 1 when
asked to (``kernels.ops.ssd``, ``kernels.ops.wkv6``), and through the
plain chunked scan or recurrence otherwise; decode's S == 1 always takes
the plain step.  The reference's Mamba2 always runs its lax scan and
leaves its SSD Pallas kernel to the tests; the kernel computes the same
function, so the port routes ``attn_impl="cuda"`` through it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ssd as kssd
from ..kernels.wkv6 import wkv6_torch
from .config import ArchConfig
from .layers import normal


# =====================================================================
# Mamba2 (SSD — state space duality, chunked algorithm)
# =====================================================================
def mamba2_params(gen, cfg: ArchConfig, dtype, device, n: int):
    """``n`` Mamba2 mixers' parameters, stacked (each tensor's shape
    prefixed by ``n``) and drawn from ``gen`` in one call each, so a
    full-width stack is never held twice."""
    lead = (n,)
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    sc = 1.0 / math.sqrt(d)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        # fused in_proj -> [z, x, B, C, dt]
        "win": normal(gen, lead + (d, 2 * di + 2 * s.d_state + nh), sc,
                      dtype, device),
        "conv": normal(gen, lead + (s.d_conv, di + 2 * s.d_state), 0.1,
                       dtype, device),
        "A_log": full((nh,), 0.0, torch.float32),
        "D": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "norm": full((di,), 1.0),
        "wout": normal(gen, lead + (di, d), 1.0 / math.sqrt(di), dtype,
                       device),
    }


def mamba2_apply(p, x, cfg: ArchConfig, *, cache: Optional[dict] = None):
    """Mamba2 block.  cache = {'conv': [B,d_conv-1,Ci], 'ssm': [B,H,P,N]}
    enables O(1) decode steps; the new cache is returned, not written."""
    s = cfg.ssm
    B, S, d = x.shape
    di = s.expand * d
    nh = di // s.head_dim
    N = s.d_state
    K = s.d_conv
    proj = x @ p["win"]
    z, xin, Bm, Cm, dt = torch.split(proj, [di, di, N, N, nh], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)              # [B,S,di+2N]

    if cache is not None:
        hist = torch.cat([cache["conv"], conv_in], dim=1)
        conv_src = hist[:, -(S + K - 1):]
        new_conv = hist[:, -(K - 1):]
    else:
        conv_src = F.pad(conv_in, (0, 0, K - 1, 0))
        new_conv = conv_in[:, -(K - 1):]

    # causal depthwise conv1d, a tap at a time (no [B,S,K,C] window)
    w = p["conv"]
    conv = conv_src[:, 0:S] * w[0]
    for k in range(1, K):
        conv = conv + conv_src[:, k:k + S] * w[k]
    xin, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                               # [H], negative
    xh = xin.reshape(B, S, nh, s.head_dim)

    if S == 1:                                               # recurrent decode
        state = (cache["ssm"] if cache is not None
                 else torch.zeros((B, nh, s.head_dim, N), dtype=torch.float32,
                                  device=x.device))
        dA = torch.exp(dt[:, 0] * A[None, :])                # [B,H]
        st = state * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(), Bm[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), st)
        y = y.reshape(B, 1, nh, s.head_dim)
        new_state = st
    else:
        chunk = min(s.chunk, S)
        pad = (-S) % chunk
        init = cache["ssm"] if cache is not None else None
        xs, dts, Bs, Cs = xh, dt, Bm, Cm
        if pad:
            # dt=0 on padding => decay 1, contribution 0: state is unchanged
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dts = F.pad(dt, (0, 0, 0, pad))
            Bs = F.pad(Bm, (0, 0, 0, pad))
            Cs = F.pad(Cm, (0, 0, 0, pad))
        # the reference's lax scan over chunks is the plain version's loop
        scan = kops.ssd if cfg.attn_impl == "cuda" else kssd.ssd_torch
        y, new_state = scan(*(t.float().contiguous()
                              for t in (xs, dts, A, Bs, Cs)), init,
                            chunk=chunk)
        y = y[:, :S]

    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMSNorm (Mamba2 style)
    y = y * F.silu(z)
    yf = y.float()
    y = (p["norm"] * (yf * torch.rsqrt(
        torch.mean(yf * yf, -1, keepdim=True) + cfg.rms_eps))).to(y.dtype)
    out = y @ p["wout"]
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": new_state}
    return out, new_cache


# =====================================================================
# RWKV6 ("Finch"): token shift + data-dependent decay WKV
# =====================================================================


def rwkv6_params(gen, cfg: ArchConfig, dtype, device):
    r = cfg.rwkv
    d = cfg.d_model
    sc = 1.0 / math.sqrt(d)
    nh = d // r.head_dim

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "mix_rkvwg": full((5, d), 0.5),                 # token-shift mixes
        "wr": normal(gen, (d, d), sc, dtype, device),
        "wk": normal(gen, (d, d), sc, dtype, device),
        "wv": normal(gen, (d, d), sc, dtype, device),
        "wg": normal(gen, (d, d), sc, dtype, device),
        "w0": full((d,), -6.0, torch.float32),          # decay bias
        "w_lora_a": normal(gen, (d, r.decay_lora), sc, dtype, device),
        "w_lora_b": normal(gen, (r.decay_lora, d), 0.1, dtype, device),
        "u": normal(gen, (nh, r.head_dim), 0.1, torch.float32, device),
        "ln_x": full((d,), 1.0),
        "wo": normal(gen, (d, d), sc, dtype, device),
        # channel-mix
        "mix_cm": full((2, d), 0.5),
        "ck": normal(gen, (d, cfg.d_ff), sc, dtype, device),
        "cv": normal(gen, (cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff), dtype,
                     device),
        "cr": normal(gen, (d, d), sc, dtype, device),
    }


# The reference's plain WKV6 path.  It scans chunks of 64 steps only so
# that training rematerializes per chunk; its arithmetic is the
# step-by-step recurrence, which the kernel's plain version runs in the
# same order.
_wkv6_scan = wkv6_torch


def rwkv6_time_mix(p, x, cfg: ArchConfig, *, cache: Optional[dict] = None,
                   use_kernel: bool = False):
    r_cfg = cfg.rwkv
    B, S, d = x.shape
    H = d // r_cfg.head_dim
    D = r_cfg.head_dim
    last = (cache["shift"] if cache is not None
            else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    xs = torch.cat([last, x[:, :-1]], dim=1)                # token shift
    mixed = [x + (xs - x) * p["mix_rkvwg"][i] for i in range(5)]
    r = (mixed[0] @ p["wr"]).reshape(B, S, H, D)
    k = (mixed[1] @ p["wk"]).reshape(B, S, H, D)
    v = (mixed[2] @ p["wv"]).reshape(B, S, H, D)
    g = F.silu(mixed[4] @ p["wg"])
    wdec = p["w0"] + (torch.tanh(mixed[3] @ p["w_lora_a"]) @ p["w_lora_b"]
                      ).float()
    w = torch.exp(-torch.exp(wdec)).reshape(B, S, H, D)     # (0,1)

    init = cache["wkv"] if cache is not None else None
    if use_kernel and S > 1:
        out, state = kops.wkv6(r, k, v, w, p["u"], init_state=init)
    else:
        out, state = _wkv6_scan(r, k, v, w, p["u"], init_state=init)
    out = out.reshape(B, S, d)
    of = out.float()
    out = (p["ln_x"] * (of * torch.rsqrt(
        torch.mean(of * of, -1, keepdim=True) + cfg.rms_eps))).to(x.dtype)
    out = (out * g) @ p["wo"]
    new_cache = None
    if cache is not None:
        new_cache = {"shift": x[:, -1:], "wkv": state}
    return out, new_cache


def rwkv6_channel_mix(p, x, *, cache=None):
    B, S, d = x.shape
    last = (cache["shift"] if cache is not None
            else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    xs = torch.cat([last, x[:, :-1]], dim=1)
    xk = x + (xs - x) * p["mix_cm"][0]
    xr = x + (xs - x) * p["mix_cm"][1]
    kk = torch.square(torch.relu(xk @ p["ck"]))
    out = torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])
    return out, ({"shift": x[:, -1:]} if cache is not None else None)
