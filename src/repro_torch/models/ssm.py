"""RWKV6 ("Finch") layers: token shift and data-dependent decay WKV.

The port of the RWKV6 part of the reference package's ``models/ssm.py``.
The time mix runs the WKV recurrence through the hand-written kernel
(``kernels.ops.wkv6``) for every S > 1 when asked to, as the reference
runs its Pallas kernel, and through the plain recurrence otherwise
(decode's S == 1 always).  Mamba2 waits for the SSD kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6_torch
from .config import ArchConfig
from .layers import normal


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
        from ..kernels import ops as kops
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
