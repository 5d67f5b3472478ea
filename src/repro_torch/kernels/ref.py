"""Direct torch oracles for the hand-written kernels (the ``ref.py`` contract).

Copies of the reference package's ``kernels/ref.py`` in torch: naive,
direct implementations in the models' ``[B, S, H, D]`` layout, the
ground truth the kernels and their plain versions are checked against.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] (GQA by grouping). Direct softmax."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]
                                              ).to(q.dtype)


def wkv6_ref(r, k, v, w, u, init_state=None):
    """RWKV6 recurrence, step by step (the definition).

    r,k,v,w: [B,S,H,D]; u: [H,D]; state [B,H,D,D] (key-major outer products).
      out[t] = r_t . (state + u * (k_t ⊗ v_t));  state = w_t*state + k_t ⊗ v_t
    Returns (out [B,S,H,D], final_state).
    """
    B, S, H, D = r.shape
    state = (init_state if init_state is not None
             else torch.zeros((B, H, D, D), dtype=torch.float32,
                              device=r.device))
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                                 state + u[None, :, :, None] * kv))
        state = wf[:, t][..., None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def ssd_ref(x, dt, A, Bm, Cm, init_state=None):
    """Mamba2 SSD recurrence, step by step (the definition).

    x [B,S,H,P], dt [B,S,H] (>=0), A [H] (negative), Bm/Cm [B,S,N].
      state = exp(dt_t A) * state + dt_t * (x_t ⊗ B_t);   y_t = C_t . state
    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (init_state if init_state is not None
             else torch.zeros((B, H, P, N), dtype=torch.float32,
                              device=x.device))
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A[None, :])            # [B,H]
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
