"""``repro_torch.kernels.ssd`` against the reference.

The port's SSD wrapper (on CPU tensors, its plain torch version) is held
against the reference's ``repro.kernels.ops.ssd`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) and against both
packages' ``ssd_ref`` oracles, on the same numpy-seeded inputs, at the
shapes and tolerances of ``tests/test_kernels.py``: y within 1e-3 (f32) /
3e-2 (bf16), final states within 2e-3 / 5e-2.  The model's chunked scan
equals the kernel equals the oracle, as ``tests/test_kernels.py:133-148``
pins it for the reference.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models.ssm import _ssd_chunk_scan as ref_chunk_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd import ssd, ssd_torch  # noqa: E402

#: tests/test_kernels.py:104-109
TOL = {"f32": dict(rtol=1e-3, atol=1e-3), "bf16": dict(rtol=3e-2, atol=3e-2)}
STATE_TOL = {"f32": dict(rtol=2e-3, atol=2e-3),
             "bf16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, P, N, dtype="f32", state=False, dt_scale=0.5):
    """x, dt, A, Bm, Cm (and an initial state) for both packages from one
    numpy seed, drawn as tests/test_kernels.py draws them: dt =
    softplus(z) * dt_scale, A = -exp(0.2 z)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) * dt_scale
          ).astype(np.float32)
    A = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if state else None)
    jax_in = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
              jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt),
              None if s0 is None else jnp.asarray(s0)]
    torch_in = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                torch.from_numpy(Cm).to(tdt),
                None if s0 is None else torch.from_numpy(s0)]
    return jax_in, torch_in


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 1, 16, 8, 8),
    (2, 64, 2, 32, 16, 16),
    (1, 128, 4, 64, 64, 32),
], ids=["tiny", "small", "real"])
def test_ssd_matches_reference(B, S, H, P, N, chunk, dtype):
    (jx, jdt, jA, jB, jC, _), (x, dt, A, Bm, Cm, _) = _inputs(
        4 + S, B, S, H, P, N, dtype)
    want, want_st = rops.ssd(jx, jdt, jA, jB, jC, chunk=chunk)
    got, st = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    assert got.dtype == x.dtype and st.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL[dtype])
    oracle, oracle_st = ref.ssd_ref(x, dt, A, Bm, Cm)
    rout, rst = rref.ssd_ref(jx, jdt, jA, jB, jC)
    np.testing.assert_allclose(_np(oracle), _np(rout), **TOL[dtype])
    np.testing.assert_allclose(_np(oracle_st), _np(rst), **STATE_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(st), _np(oracle_st), **STATE_TOL[dtype])
    assert ssd.launches == 0          # CPU tensors launch nothing


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_with_init_state_matches_reference(dtype):
    (jx, jdt, jA, jB, jC, js), (x, dt, A, Bm, Cm, s0) = _inputs(
        11, 2, 64, 2, 16, 8, dtype, state=True)
    want, want_st = rops.ssd(jx, jdt, jA, jB, jC, js, chunk=16)
    got, st = ssd(x, dt, A, Bm, Cm, s0, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL[dtype])
    oracle, oracle_st = ref.ssd_ref(x, dt, A, Bm, Cm, s0)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(st), _np(oracle_st), **STATE_TOL[dtype])


def test_ssd_state_handoff():
    """Two halves with the carried state == the whole, as in the
    reference (tests/test_kernels.py:113-130), and == the reference's run."""
    (jx, jdt, jA, jB, jC, _), (x, dt, A, Bm, Cm, _) = _inputs(
        5, 1, 64, 2, 16, 8)
    full, full_st = ssd(x, dt, A, Bm, Cm, chunk=16)
    h = 32
    y1, st = ssd(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], chunk=16)
    y2, st2 = ssd(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:],
                  init_state=st, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st2, full_st, rtol=1e-4, atol=1e-4)
    want, _ = rops.ssd(jx, jdt, jA, jB, jC, chunk=16)
    np.testing.assert_allclose(_np(full), _np(want), **TOL["f32"])


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunk16", "chunk64"])
def test_model_scan_matches_kernel_and_oracle(chunk):
    """The model's chunked scan (the plain version, which ``mamba2_apply``
    runs under ``attn_impl="xla"``) == the kernel's wrapper == the oracle
    (tests/test_kernels.py:133-148), and == the reference's lax scan."""
    (jx, jdt, jA, jB, jC, js), (x, dt, A, Bm, Cm, s0) = _inputs(
        6, 1, 64, 2, 16, 8, state=True)
    y_model, st_model = ssd_torch(x, dt, A, Bm, Cm, s0, chunk=chunk)
    y_kern, st_kern = ssd(x, dt, A, Bm, Cm, s0, chunk=chunk)
    y_ref, st_ref = ref.ssd_ref(x, dt, A, Bm, Cm, s0)
    for y, st in ((y_model, st_model), (y_kern, st_kern)):
        torch.testing.assert_close(y, y_ref, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)
    want, want_st = ref_chunk_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                                   init_state=js)
    np.testing.assert_allclose(_np(y_model), _np(want), **TOL["f32"])
    np.testing.assert_allclose(_np(st_model), _np(want_st),
                               **STATE_TOL["f32"])


def test_large_decay_stays_finite_and_matches_reference():
    """dt·|A| of 20-60 a step: above the diagonal cums[t] - cums[s] reaches
    thousands and exp overflows; the masked decay stays finite and equal
    to the reference's (Pallas kernel and lax scan), which select it away."""
    (jx, jdt, jA, jB, jC, _), (x, dt, A, Bm, Cm, _) = _inputs(
        13, 1, 64, 2, 16, 8, dt_scale=40.0)
    rel_max = float((torch.cumsum(dt * A.abs(), 1)[:, 15]
                     - torch.cumsum(dt * A.abs(), 1)[:, 0]).max())
    assert rel_max > 100.0                  # exp(rel_max) is inf in f32
    got, st = ssd(x, dt, A, Bm, Cm, chunk=16)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(st).all())
    want, want_st = rops.ssd(jx, jdt, jA, jB, jC, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["f32"])
    np.testing.assert_allclose(_np(st), _np(want_st), **STATE_TOL["f32"])
    lax_y, _ = ref_chunk_scan(jx, jdt, jA, jB, jC, chunk=16)
    np.testing.assert_allclose(_np(got), _np(lax_y), **TOL["f32"])
    oracle, _ = ref.ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(got, oracle, rtol=1e-3, atol=1e-3)


def test_refused_shapes_raise_where_the_reference_asserts():
    (jx, jdt, jA, jB, jC, _), (x, dt, A, Bm, Cm, _) = _inputs(
        9, 1, 40, 2, 16, 8)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=16)              # 40 % 16
    with pytest.raises(AssertionError):
        rops.ssd(jx, jdt, jA, jB, jC, chunk=16)
    y, _ = ssd(x, dt, A, Bm, Cm, chunk=64)           # min(64, 40) = 40
    want, _ = rops.ssd(jx, jdt, jA, jB, jC, chunk=64)
    np.testing.assert_allclose(_np(y), _np(want), **TOL["f32"])
    with pytest.raises(ValueError, match="dt"):
        ssd(x, dt[:, :, :1], A, Bm, Cm, chunk=8)     # dt's heads
    with pytest.raises(ValueError, match="A"):
        ssd(x, dt, A[:1], Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="Cm"):
        ssd(x, dt, A, Bm, Cm[..., :4], chunk=8)      # N differs
    with pytest.raises(ValueError, match="init_state"):
        ssd(x, dt, A, Bm, Cm, torch.zeros(1, 2, 8, 16), chunk=8)


def test_plain_version_is_the_pallas_body_at_every_chunk():
    """The plain version's chunk is a tiling of one function: chunks of
    8, 32 and the whole sequence agree with each other and the oracle."""
    _, (x, dt, A, Bm, Cm, s0) = _inputs(17, 2, 96, 3, 16, 8, state=True)
    want, want_st = ref.ssd_ref(x, dt, A, Bm, Cm, s0)
    for chunk in (8, 32, 96):
        y, st = ssd_torch(x, dt, A, Bm, Cm, s0, chunk=chunk)
        torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(st, want_st, rtol=1e-4, atol=1e-4)
