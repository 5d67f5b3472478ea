"""The WKV6 kernel's arithmetic, in its own order, against the reference.

``csrc/wkv6.cu`` cannot run on the CPU, so this file walks the recurrence
in the kernel's order in torch f32, with each of the kernel's FMAs
rounded once (computed in f64, then rounded to f32):

* each key group's partial of ``r_t · S`` over its ``D/G`` rows, as two
  chains (even and odd rows) added at the end;
* the ``G`` partials summed in group order;
* the bonus ``Σ_d r u k`` as ``Q`` chains of ``D/Q`` rows summed in order,
  added last as ``fma(v, bonus, Σ partials)``;
* the decay ``S ← fma(w, S, k v)``.

It is held to the reference's f32 tolerances against
``repro.kernels.ref.wkv6_ref`` (the step-by-step definition) at S ≤ 128
and against ``repro.models.ssm._wkv6_scan`` (a ``lax.scan``) at S=4096,
on numpy-seeded inputs, at four decays: ``sigmoid(randn − 1)`` (what the
kernel tests draw), the RWKV6 layer's own ``exp(-exp(-6 + 0.1·randn))``,
channels with decays of exactly 0 and 1, and an initial state given.
The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.models.ssm import _wkv6_scan as ref_wkv6_scan  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
#: head dim -> (G key groups, Q bonus chains), as csrc/wkv6.cu's Split and
#: Layout set them
KERNEL_SPLIT = {8: (2, 2), 16: (4, 4), 32: (8, 4), 64: (16, 4), 128: (16, 4)}


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as the card's FMA rounds it."""
    return (a.double() * b.double() + c.double()).float()


def wkv6_kernel_order(r, k, v, w, u, init_state=None):
    """The recurrence in csrc/wkv6.cu's order of operations, in f32."""
    B, S, H, D = r.shape
    G, Q = KERNEL_SPLIT[D]
    R = D // G
    st = (torch.zeros((B, H, D, D)) if init_state is None
          else init_state.float().clone())
    out = torch.empty((B, S, H, D))
    for t in range(S):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        rg = rt.reshape(B, H, G, R, 1)
        sg = st.reshape(B, H, G, R, D)
        chains = [torch.zeros((B, H, G, D)), torch.zeros((B, H, G, D))]
        for i in range(R):
            chains[i % 2] = _fma(rg[:, :, :, i], sg[:, :, :, i], chains[i % 2])
        part = chains[0] + chains[1]                  # [B, H, G, D]
        o = part[:, :, 0]
        for g in range(1, G):
            o = o + part[:, :, g]
        ru = (rt * u.float()).reshape(B, H, Q, D // Q)
        kq = kt.reshape(B, H, Q, D // Q)
        acc = torch.zeros((B, H, Q))
        for j in range(D // Q):
            acc = _fma(ru[..., j], kq[..., j], acc)
        bonus = acc[..., 0]
        for q in range(1, Q):
            bonus = bonus + acc[..., q]
        out[:, t] = _fma(vt, bonus[..., None], o)
        st = _fma(wt[..., :, None], st, kt[..., :, None] * vt[..., None, :])
    return out, st


def _inputs(seed, B, S, H, D, decay):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    x = rng.standard_normal((B, S, H, D))
    if decay == "model":        # the RWKV6 layer's w0 = -6 bias
        w = np.exp(-np.exp(-6.0 + 0.1 * x))
    else:
        w = 1.0 / (1.0 + np.exp(1.0 - x))
    if decay == "w0_w1":        # channels that forget at once, and never
        w[..., 0::4], w[..., 1::4] = 0.0, 1.0
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)).astype(np.float32)
          if decay == "state" else None)
    return r, k, v, w.astype(np.float32), u, s0


def _run_both(ref_fn, arrays):
    r, k, v, w, u, s0 = arrays
    want, want_st = ref_fn(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                           None if s0 is None else jnp.asarray(s0))
    got, st = wkv6_kernel_order(
        *(torch.from_numpy(x) for x in (r, k, v, w, u)),
        None if s0 is None else torch.from_numpy(s0))
    return (got.numpy(), st.numpy()), (np.asarray(want), np.asarray(want_st))


@pytest.mark.parametrize("decay", ["sigmoid", "model", "w0_w1", "state"])
@pytest.mark.parametrize("B,S,H,D", [(1, 128, 2, 64), (2, 37, 3, 16),
                                     (1, 64, 1, 128)],
                         ids=["serve_head", "short_odd", "d128"])
def test_kernel_order_matches_reference(B, S, H, D, decay):
    (got, st), (want, want_st) = _run_both(
        rref.wkv6_ref, _inputs(S + D, B, S, H, D, decay))
    assert np.isfinite(got).all() and np.isfinite(st).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(st, want_st, **STATE_TOL)


def test_kernel_order_matches_reference_scan_at_4096_steps():
    """The prefill step's sequence length, at the model's own decay (the
    longest memory: about 400 steps), against the reference's lax scan."""
    arrays = _inputs(4096, 1, 4096, 2, 64, "model")
    (got, st), (want, want_st) = _run_both(
        lambda *a: ref_wkv6_scan(*a, chunk=64), arrays)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(st, want_st, **STATE_TOL)

