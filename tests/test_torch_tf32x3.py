"""The tensor-core kernels' arithmetic (3xTF32) against the reference, on the CPU.

``csrc/ssd.cu`` and ``csrc/flash_attention.cu`` multiply f32 operands on
TF32 tensor cores in three terms (``csrc/mma_tf32x3.cuh``): each operand
``a`` is split into ``big`` = ``a`` rounded to TF32 (to nearest, ties away
from zero: ``cvt.rna.tf32.f32``'s rounding) and ``small`` = ``a - big``,
whose 13 low bits the tensor core drops, and ``a b ~= small_a big_b +
big_a small_b + big_a big_b``.  This file emulates that split on torch
f32 tensors, checks the rounding on hand-picked values, runs flash
attention and the SSD chunk walk in the kernels' order with every product
in three terms, and holds both against the reference's oracles
(``repro.kernels.ref``) at the f32 tolerance to which ``chip_smoke.py``
holds the kernels (2e-4).  Two more cases, one a kernel, show that a
single TF32 term fails that tolerance: the record of why three, and
that the tolerance would catch a kernel that dropped its small terms.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402

#: chip_smoke.KERNEL_TOL["float32"]
TOL = dict(rtol=2e-4, atol=2e-4)
NEG_INF = -1e30
TILE = 64            # the kernels' kv tile and SSD chunk


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(b):
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest,
    ties away from zero (add half a TF32 ulp to the magnitude, drop the
    13 low bits), as ``mma_tf32x3.cuh``'s ``tf32_rna``."""
    return _from_bits((_bits(x) + 0x1000) & 0xFFFFE000)


def tf32_trunc(x):
    """What the tensor core reads of an f32 register: its top 19 bits."""
    return _from_bits(_bits(x) & 0xFFFFE000)


def split(a):
    big = tf32_rna(a)
    return big, tf32_trunc(a - big)


def mm3(a, b):
    """a @ b in three TF32 terms, small terms first, in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a, b):
    """a @ b in one TF32 term (both operands rounded to TF32)."""
    return tf32_rna(a) @ tf32_rna(b)


def test_tf32_rna_on_ties_and_edges():
    ulp = 2.0 ** -10                   # TF32's ulp at 1
    cases = [
        (1.0, 1.0), (-1.0, -1.0), (0.0, 0.0),
        (1 + ulp / 2, 1 + ulp),                    # a tie: away from zero
        (-(1 + ulp / 2), -(1 + ulp)),
        (1 + 3 * ulp / 2, 1 + 2 * ulp),            # a tie above an odd ulp
        (1 + ulp / 2 - 2.0 ** -23, 1.0),           # just below the tie
        (1 + ulp / 2 + 2.0 ** -23, 1 + ulp),       # just above it
        (2 - ulp / 4, 2.0),                        # rounds up into the next binade
        (1.5 * 2.0 ** 127, 1.5 * 2.0 ** 127),      # large, exact in TF32
        (2.0 ** -149, 0.0),                        # the least subnormal
        (3 * 2.0 ** -137, 4 * 2.0 ** -137),        # a subnormal tie
        (float("inf"), float("inf")), (float("-inf"), float("-inf")),
    ]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want), (got - want)
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()
    # the largest finite f32 rounds past TF32's largest: infinity
    fmax = torch.tensor([torch.finfo(torch.float32).max])
    assert torch.isinf(tf32_rna(fmax)).all()
    # every result has 13 zero low bits; bf16 values are TF32 values
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    assert bool(((_bits(tf32_rna(r)) & 0x1FFF) == 0).all())
    rb = r.bfloat16().float()
    assert torch.equal(tf32_rna(rb), rb)
    # against round-half-away at 11 significant bits, computed in f64
    m, e = np.frexp(r.double().numpy())
    ref = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    assert np.array_equal(tf32_rna(r).double().numpy(), ref)
    # the split: big + small is a to within 2^-21 of |a|
    big, small = split(r)
    assert bool(((big.double() + small.double() - r.double()).abs()
                 <= 2.0 ** -21 * r.double().abs()).all())


def flash_kernel_order(q, k, v, causal, mm):
    """One (b, h) of flash attention as the kernel runs it: 64-key tiles,
    scores and P V through ``mm``, online softmax in f32."""
    Sq, D = q.shape
    Skv = k.shape[0]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((Sq,), NEG_INF)
    l = torch.zeros(Sq)
    o = torch.zeros(Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv if not causal else min(Skv, Sq), TILE):
        s = mm(q, k[k0:k0 + TILE].T) * scale
        kpos = torch.arange(k0, k0 + s.shape[1])[None, :]
        if causal:
            s = torch.where(kpos > qpos, torch.tensor(NEG_INF), s)
        mn = torch.maximum(m, s.max(1).values)
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn[:, None])
        l = l * corr + p.sum(1)
        m = mn
        o = o * corr[:, None] + mm(p, v[k0:k0 + TILE])
    return o / torch.clamp(l, min=1e-30)[:, None]


def _flash(mm, D, causal, seed):
    """The kernel-order flash at [B=1, H=2, Hkv=1, S=192, D] against the
    reference's oracle; returns (got, want) as f32 numpy."""
    rng = np.random.default_rng(seed)
    B, H, Hkv, S = 1, 2, 1, 192
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(rref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = np.stack([flash_kernel_order(tq[0, :, h], tk[0, :, 0], tv[0, :, 0],
                                       causal, mm).numpy()
                    for h in range(H)], axis=1)[None]
    return got, want


@pytest.mark.parametrize("D,causal", [(64, True), (128, True), (64, False)])
def test_flash_in_three_terms_meets_the_kernel_tolerance(D, causal):
    got, want = _flash(mm3, D, causal, seed=D + causal)
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_in_one_tf32_term_fails_the_kernel_tolerance():
    got, want = _flash(mm1, 64, True, seed=65)
    err = np.abs(got - want)
    worst = float((err / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())
    assert worst > 2.0, worst       # measured: about 2.9x the tolerance
    got3, _ = _flash(mm3, 64, True, seed=65)
    assert float(np.abs(got3 - want).max()) < float(err.max()) / 100


def ssd_kernel_order(x, dt, a, Bm, Cm, s0, mm):
    """One (b, h) of the SSD scan as the kernel walks it: chunks of 64,
    every product through ``mm``, the decay masked before the exponential.
    x [S, P], dt [S], Bm/Cm [S, N], s0 [P, N]."""
    S = x.shape[0]
    state = s0.clone()
    ys = []
    for t0 in range(0, S, TILE):
        xc, dc = x[t0:t0 + TILE], dt[t0:t0 + TILE]
        Bc, Cc = Bm[t0:t0 + TILE], Cm[t0:t0 + TILE]
        L = xc.shape[0]
        cum = torch.cumsum(dc * a, 0)
        g = mm(Cc, Bc.T)                                       # [t, s]
        inter = mm(Cc, state.T) * torch.exp(cum)[:, None]      # [t, p]
        below = torch.tril(torch.ones(L, L, dtype=torch.bool))
        rel = torch.where(below, cum[:, None] - cum[None, :],
                          torch.tensor(float("-inf")))
        M = g * torch.exp(rel) * dc[None, :]
        ys.append(inter + mm(M, xc))
        w = dc * torch.exp(cum[-1] - cum)
        state = state * torch.exp(cum[-1]) + mm((xc * w[:, None]).T, Bc)
    return torch.cat(ys), state


def _ssd(mm, dt_scale):
    """chip_smoke.py's phase 8 draws: dt = softplus(z) * dt_scale, A =
    -exp(0.2 z), at B=1, S=192, H=2, P=32, N=16 with an initial state,
    through the kernel-order walk with ``mm`` and the reference's oracle;
    returns (y, state, y_ref, state_ref) as f32 numpy."""
    rng = np.random.default_rng(int(dt_scale))
    B, S, H, P, N = 1, 192, 2, 32, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) * dt_scale
          ).astype(np.float32)
    A = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    y_ref, st_ref = (np.asarray(t) for t in rref.ssd_ref(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), jnp.asarray(s0)))
    tx, tdt, tB, tC, ts0 = (torch.from_numpy(t)
                            for t in (x, dt, Bm, Cm, s0))
    outs = [ssd_kernel_order(tx[0, :, h], tdt[0, :, h], float(A[h]), tB[0],
                             tC[0], ts0[0, h], mm) for h in range(H)]
    y = np.stack([o[0].numpy() for o in outs], axis=1)[None]
    st = np.stack([o[1].numpy() for o in outs])[None]
    return y, st, y_ref, st_ref


@pytest.mark.parametrize("dt_scale", [0.5, 40.0])
def test_ssd_in_three_terms_meets_the_kernel_tolerance(dt_scale):
    """At dt x40 (dt |A| about 28 a step, cum down to about -1,800 in a
    chunk) the chunked form carries cum's f32 rounding into each decay, so
    that case is held, as phase 8 holds it, to the tolerance times the
    largest output."""
    y, st, y_ref, st_ref = _ssd(mm3, dt_scale)
    assert np.isfinite(y).all()
    if dt_scale <= 1.0:
        np.testing.assert_allclose(y, y_ref, **TOL)
    else:
        scale = float(np.abs(y_ref).max())
        assert float(np.abs(y - y_ref).max()) <= TOL["rtol"] * scale, scale
    # chip_smoke.STATE_TOL
    np.testing.assert_allclose(st, st_ref, rtol=1e-3, atol=1e-3)


def test_ssd_in_one_tf32_term_fails_the_kernel_tolerance():
    y, _, y_ref, _ = _ssd(mm1, 0.5)
    err = np.abs(y - y_ref)
    worst = float((err / (TOL["atol"] + TOL["rtol"] * np.abs(y_ref))).max())
    assert worst > 2.0, worst       # measured: about 27x the tolerance
    y3, _, _, _ = _ssd(mm3, 0.5)
    assert float(np.abs(y3 - y_ref).max()) < float(err.max()) / 100
