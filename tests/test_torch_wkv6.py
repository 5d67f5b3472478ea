"""``repro_torch.kernels.wkv6`` against the reference.

The port's WKV6 wrapper (on CPU tensors, its plain torch version) is held
against the reference's ``repro.kernels.ops.wkv6`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) and against both
packages' ``wkv6_ref`` oracles, on the same numpy-seeded inputs, at the
shapes and tolerances of ``tests/test_kernels.py``: outputs within
``TOL``, final states within 1e-3 (f32) / 5e-2 (bf16).  The CUDA kernel
itself is held against the plain version on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models.ssm import _wkv6_scan as ref_wkv6_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.models.ssm import _wkv6_scan  # noqa: E402

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = {"f32": dict(rtol=1e-3, atol=1e-3),
             "bf16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, D, dtype, wdtype=None, state=False):
    """r, k, v, w, u (and an initial state) for both packages from one
    numpy seed; decays in (0, 1) as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    jw, tw = DTYPES[wdtype or dtype]
    rkv = [rng.standard_normal((B, S, H, D)).astype(np.float32)
           for _ in range(3)]
    w = 1.0 / (1.0 + np.exp(1.0 - rng.standard_normal((B, S, H, D))))
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)).astype(np.float32)
          if state else None)
    jax_in = ([jnp.asarray(x).astype(jdt) for x in rkv]
              + [jnp.asarray(w.astype(np.float32)).astype(jw),
                 jnp.asarray(u), None if s0 is None else jnp.asarray(s0)])
    torch_in = ([torch.from_numpy(x).to(tdt) for x in rkv]
                + [torch.from_numpy(w.astype(np.float32)).to(tw),
                   torch.from_numpy(u),
                   None if s0 is None else torch.from_numpy(s0)])
    return jax_in, torch_in


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,D,chunk,state", [
    (1, 32, 1, 8, 8, False),
    (2, 64, 2, 16, 16, False),
    (1, 128, 2, 64, 64, False),
    (2, 64, 2, 16, 16, True),         # with an initial state
], ids=["tiny", "small", "real64", "init_state"])
def test_wkv6_matches_reference(B, S, H, D, chunk, state, dtype):
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = _inputs(
        S + D, B, S, H, D, dtype, state=state)
    want, want_st = rops.wkv6(jr, jk, jv, jw, ju, js, chunk=chunk)
    got, st = ops.wkv6(tr, tk, tv, tw, tu, ts, chunk=chunk)
    assert got.dtype == tr.dtype and st.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL[dtype])
    oracle, oracle_st = ref.wkv6_ref(tr, tk, tv, tw, tu, ts)
    rout, rst = rref.wkv6_ref(jr, jk, jv, jw, ju, js)
    np.testing.assert_allclose(_np(oracle), _np(rout), **TOL[dtype])
    np.testing.assert_allclose(_np(oracle_st), _np(rst), **STATE_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


def test_wkv6_bf16_streams_with_f32_decay_match_reference():
    """The RWKV6 layer hands the kernel bf16 r/k/v with an f32 decay."""
    (jr, jk, jv, jw, ju, _), (tr, tk, tv, tw, tu, _) = _inputs(
        5, 2, 64, 2, 16, "bf16", wdtype="f32")
    assert tw.dtype == torch.float32 and tr.dtype == torch.bfloat16
    want, want_st = rops.wkv6(jr, jk, jv, jw, ju, chunk=16)
    got, st = wkv6(tr, tk, tv, tw, tu, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bf16"])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL["bf16"])


def test_wkv6_state_handoff():
    """Two halves with the carried state == the whole, as in the
    reference (tests/test_kernels.py:63-78), and == the reference's run."""
    (jr, jk, jv, jw, ju, _), (r, k, v, w, u, _) = _inputs(3, 1, 64, 2, 16,
                                                          "f32")
    full, full_st = wkv6(r, k, v, w, u, chunk=16)
    h = 32
    first, st = wkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, chunk=16)
    second, st2 = wkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                       init_state=st, chunk=16)
    torch.testing.assert_close(torch.cat([first, second], 1), full,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st2, full_st, rtol=1e-4, atol=1e-4)
    want, _ = rops.wkv6(jr, jk, jv, jw, ju, chunk=16)
    np.testing.assert_allclose(_np(full), _np(want), **TOL["f32"])


@pytest.mark.parametrize("S,chunk", [(64, 64), (40, 64), (70, 16)],
                         ids=["even", "short", "padded"])
def test_model_scan_matches_reference_scan(S, chunk):
    """The model's plain recurrence (``_wkv6_scan``) == the reference's
    chunked lax scan, padding included."""
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, s0) = _inputs(
        S, 2, S, 2, 16, "f32", state=True)
    want, want_st = ref_wkv6_scan(jr, jk, jv, jw, ju, js, chunk=chunk)
    got, st = _wkv6_scan(r, k, v, w, u, s0)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["f32"])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL["f32"])


def test_refused_shapes_raise_where_the_reference_asserts():
    (jr, jk, jv, jw, ju, _), (r, k, v, w, u, _) = _inputs(9, 1, 40, 2, 16,
                                                          "f32")
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, k, v, w, u, chunk=16)               # 40 % 16
    with pytest.raises(AssertionError):
        rops.wkv6(jr, jk, jv, jw, ju, chunk=16)
    with pytest.raises(ValueError):
        wkv6(r, k, v[:, :, :1], w, u)               # v's heads
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u[:1])                     # u's heads
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u, torch.zeros(1, 2, 16, 8))   # state shape
