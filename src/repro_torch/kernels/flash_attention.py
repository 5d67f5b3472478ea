"""Flash attention: the hand-written CUDA kernel, its wrapper and its plain version.

:func:`flash_attention_hm` replaces the reference package's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention_hm``).  On CUDA
tensors it launches ``csrc/flash_attention.cu`` (built on first use) or
raises; on CPU tensors it runs :func:`flash_attention_hm_torch`, the same
function as plain torch ops.  Layouts are head-major, as the reference's:
q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Skv, D]``, query head ``h`` reading kv
head ``h // (H // Hkv)``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

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


@functools.cache
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("flash_attention")
    # every pointer and the stream as c_void_p (ctypes cuts untyped ints)
    lib.flash_attention_hm.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.flash_attention_hm.restype = ctypes.c_int
    return lib


def flash_attention_hm(q, k, v, *, causal: bool = True):
    """Head-major flash attention: q [B,H,Sq,D], k/v [B,Hkv,Skv,D].

    The reference's block rule holds: ``Sq`` must be a multiple of
    ``min(BLOCK, Sq)`` and ``Skv`` of ``min(BLOCK, Skv)``, else
    ``ValueError``.  On CUDA tensors
    (float32 or bfloat16, contiguous, D 64 or 128) this launches the
    kernel on the current stream; on CPU tensors it runs the plain
    version.  ``flash_attention_hm.launches`` counts kernel launches.
    """
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_hm_torch(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_hm runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check_cuda(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
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
