"""``repro_torch.kernels.flash_attention`` against the reference.

The port's flash wrapper (on CPU tensors, its plain torch version) and
its ``[B,S,H,D]`` adapter are held against the reference's
``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it) and against both packages'
``ref.py`` oracles, on the same numpy-seeded inputs, at the shapes and
tolerances of ``tests/test_kernels.py``.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: tests/test_kernels.py's TOL
TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shapes, dtype):
    """The same values for both packages: numpy f32, each side rounding to
    bf16 itself (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 64, True),     # MHA, single block
    (2, 256, 256, 4, 2, 64, True),     # GQA 2:1, multi-block
    (1, 384, 384, 3, 1, 128, True),    # GQA 3:1, D=128, odd block count
    (1, 128, 256, 2, 2, 64, False),    # non-causal, Sq != Skv
], ids=["mha128", "gqa256", "gqa384d128", "noncausal"])
def test_flash_attention_matches_reference(B, Sq, Skv, H, Hkv, D, causal,
                                           dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        Sq + H, [(B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)], dtype)
    want = _np(rops.flash_attention(jq, jk, jv, causal=causal))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, D)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    # the oracles agree with each other and with both implementations
    oracle = _np(ref.flash_attention_ref(tq, tk, tv, causal=causal))
    np.testing.assert_allclose(
        oracle, _np(rref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOL[dtype])
    np.testing.assert_allclose(_np(got), oracle, **TOL[dtype])


def test_head_major_wrapper_is_the_adapter_transposed():
    (_, _, _), (q, k, v) = _inputs(3, [(2, 128, 4, 64), (2, 128, 2, 64),
                                       (2, 128, 2, 64)], "f32")
    hm = fa.flash_attention_hm(*(x.transpose(1, 2).contiguous()
                                 for x in (q, k, v)))
    assert torch.equal(hm.transpose(1, 2), ops.flash_attention(q, k, v))
    assert torch.equal(hm, fa.flash_attention_hm_torch(
        *(x.transpose(1, 2) for x in (q, k, v))))


@pytest.mark.parametrize("q_shape,kv_shape,ref_asserts", [
    ((1, 2, 192, 64), (1, 2, 192, 64), True),      # Sq % 128
    ((1, 2, 128, 64), (1, 2, 192, 64), True),      # Skv % 128
    ((1, 2, 128, 64), (2, 2, 128, 64), False),     # k/v batch != q batch
    ((1, 3, 128, 64), (1, 2, 128, 64), False),     # H % Hkv
    ((1, 2, 128, 64), (1, 2, 128, 32), False),     # k/v D != q D
], ids=["sq-bq", "skv-bk", "batch", "heads", "headdim"])
def test_refused_shapes_raise_where_the_reference_asserts(q_shape, kv_shape,
                                                          ref_asserts):
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        fa.flash_attention_hm(q, k, k)
    if ref_asserts:
        # the reference refuses the same block shapes with an assert
        with pytest.raises(AssertionError):
            rops.flash_attention(*(jnp.zeros(s).transpose(0, 2, 1, 3)
                                   for s in (q_shape, kv_shape, kv_shape)))
