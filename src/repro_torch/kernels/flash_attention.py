"""Flash attention: the hand-written CUDA kernel, its wrapper and its plain version.

:func:`flash_attention_hm` replaces the reference package's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention_hm``).  On CUDA
tensors it launches ``csrc/flash_attention.cu`` (built on first use) or
raises; on CPU tensors it runs :func:`flash_attention_hm_torch`, the same
function as plain torch ops.  Layouts are head-major, as the reference's:
q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Skv, D]``, query head ``h`` reading kv
head ``h // (H // Hkv)``.  On ``meta`` tensors it checks the kernel's
conditions and returns the output's shape, launching nothing; on CUDA and
``meta`` tensors alike it records its :func:`cost` in the op counter
(``launch.op_cost``) when one is running.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..compat import refuse_autograd
from ..launch.op_cost import record_kernel

NEG_INF = -1e30
#: the reference's default block (flash_attention.py:76): Sq and Skv must be
#: multiples of min(BLOCK, length); the kernel itself tiles by 64
BLOCK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_hm_torch(q, k, v, *, causal: bool = True):
    """The plain torch version of :func:`flash_attention_hm`.

    Direct softmax in f32 (inputs widened, scores ``q kᵀ / √D``, causal
    mask ``qpos >= kpos`` with masked scores at ``NEG_INF``), output in
    q's dtype, on whatever device the tensors lie.
    """
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def cost(q_shape, kv_shape, causal: bool = True, itemsize: int = 4) -> dict:
    """The work of one call on q ``[B,H,Sq,D]`` and k/v ``[B,Hkv,Skv,D]``
    of ``itemsize`` bytes an element: ``flops`` of ``q kᵀ`` and ``P V`` over
    the visible scores (query ``i`` sees keys ``0..i`` when causal, the
    diagonal counted), ``exps`` one a visible score, and ``bytes`` q, k,
    v and the output once each."""
    B, H, Sq, D = q_shape
    Hkv, Skv = kv_shape[1], kv_shape[2]
    if causal:
        n = min(Sq, Skv)
        visible = n * (n + 1) // 2 + (Sq - n) * Skv
    else:
        visible = Sq * Skv
    return {"flops": 4 * B * H * D * visible, "exps": B * H * visible,
            "bytes": itemsize * (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D)}


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_hm takes 4-d q [B,H,Sq,D] and "
                         "k/v [B,Hkv,Skv,D]")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv "
                         f"heads")
    # the reference's block rule (flash_attention.py:82-84)
    bq, bk = min(BLOCK, Sq), min(BLOCK, Skv)
    if bq <= 0 or bk <= 0 or Sq % bq or Skv % bk:
        raise ValueError(f"Sq={Sq} is not a multiple of {bq} or Skv={Skv} "
                         f"of {bk}")


def _check_cuda(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {_HEAD_DIMS}, "
                         f"not {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("B * H must be at most 65535")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signature of its ``flash_attention_hm`` entry
    point."""
    # every pointer and the stream as c_void_p (ctypes cuts untyped ints)
    lib.flash_attention_hm.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.flash_attention_hm.restype = ctypes.c_int
    return lib


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    from .build import load

    return _bind(load("flash_attention", defines))


def flash_attention_hm(q, k, v, *, causal: bool = True):
    """Head-major flash attention: q [B,H,Sq,D], k/v [B,Hkv,Skv,D].

    The reference's block rule holds: ``Sq`` must be a multiple of
    ``min(BLOCK, Sq)`` and ``Skv`` of ``min(BLOCK, Skv)``, else
    ``ValueError``.  On CUDA tensors
    (float32 or bfloat16, contiguous, D 64 or 128) this launches the
    kernel on the current stream; on ``meta`` tensors it checks the
    same conditions and returns an empty output; on CPU tensors it runs
    the plain version.  With grad mode on, an input that requires grad is
    refused on every device.  ``flash_attention_hm.launches`` counts
    kernel launches.
    """
    _check_shapes(q, k, v)
    refuse_autograd("flash_attention_hm", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_hm_torch(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_hm runs on cuda or cpu tensors "
                         f"(meta for shapes), not {q.device}")
    _check_cuda(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    work = cost(q.shape, k.shape, causal, q.element_size())
    record_kernel("flash_attention_hm", work["flops"], work["bytes"])
    if q.is_meta:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv,
        Sq, Skv, D, int(causal), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_hm kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_hm.launches += 1
    return out


flash_attention_hm.launches = 0


def occupancy(dtype=torch.float32, head_dim: int = 64) -> dict:
    """Registers, spills, shared memory and blocks an SM of the kernel for
    ``dtype`` and ``head_dim`` on the current card (see
    :func:`.build.occupancy`)."""
    from .build import occupancy as query

    return query(_lib().flash_attention_occupancy, _DTYPES[dtype], head_dim)
