"""The RWKV6 recurrence: the hand-written CUDA kernel, its wrapper and its plain version.

:func:`wkv6` replaces the reference package's Pallas kernel
(``repro/kernels/wkv6.py::wkv6_pallas``).  On CUDA tensors it launches
``csrc/wkv6.cu`` (built on first use) or raises; on CPU tensors it runs
:func:`wkv6_torch`.  For each step t, with an f32 ``[D, D]`` state per
(batch, head)::

    out_t = r_t · (S + u ⊙ k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

The kernel splits each head's state over blocks and threads and sums
``r_t · S`` in another order than :func:`wkv6_torch` (its note says
which); its decay is one FMA, where the plain version rounds ``w S`` and
``k vᵀ`` before adding them.  On ``meta`` tensors :func:`wkv6` checks
the kernel's conditions and returns the outputs' shapes, launching
nothing; on CUDA and ``meta`` tensors alike it records its :func:`cost`
in the op counter (``launch.op_cost``) when one is running.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..compat import refuse_autograd
from ..launch.op_cost import record_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128)


def wkv6_torch(r, k, v, w, u, init_state=None):
    """The plain torch version of :func:`wkv6`: the recurrence step by
    step in f32 on whatever device the tensors lie.  Returns ``(out in
    r's dtype, final state f32)``."""
    B, S, H, D = r.shape
    state = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # [B,H,D,D]
        out[:, t] = torch.einsum("bhd,bhde->bhe", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return out.to(r.dtype), state


def cost(shape, itemsize: int = 4, w_itemsize: int = 4,
         with_state: bool = False) -> dict:
    """The work of one call on r, k, v, w of ``shape`` ``[B,S,H,D]`` (r, k,
    v and the output of ``itemsize`` bytes an element, w of
    ``w_itemsize``): ``flops``, for each (step, head) ``r · S``, ``k vᵀ``
    and the decay a (d, e) and ``r u k`` and ``v`` times the bonus a d;
    ``bytes`` every stream, u and the f32 states (the initial one when
    given) once each."""
    B, S, H, D = shape
    n = B * S * H * D
    return {"flops": 5 * n * (D + 1),
            "bytes": 4 * n * itemsize + n * w_itemsize
            + 4 * (H * D + (2 if with_state else 1) * B * H * D * D)}


def _check_args(r, k, v, w, u, init_state, chunk: int) -> None:
    if r.dim() != 4:
        raise ValueError("wkv6 takes r, k, v, w of shape [B,S,H,D]")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r "
                             f"{(B, S, H, D)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u has shape {tuple(u.shape)}, want {(H, D)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, D, D):
        raise ValueError(f"init_state has shape {tuple(init_state.shape)}, "
                         f"want {(B, H, D, D)}")
    # the reference's chunk rule (wkv6.py:66-67)
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")


def _check_cuda(r, k, v, w, u, init_state) -> None:
    streams = (("r", r), ("k", k), ("v", v), ("w", w))
    f32 = (("u", u),) + ((("init_state", init_state),)
                         if init_state is not None else ())
    for name, t in streams + f32:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or w.dtype not in (r.dtype, torch.float32):
        raise ValueError(f"the wkv6 kernel takes r, k, v all float32 or all "
                         f"bfloat16 and w in their type or float32, got "
                         f"{[str(t.dtype) for _, t in streams]}")
    for name, t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
    if r.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {_HEAD_DIMS}, "
                         f"not {r.shape[-1]}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signature of its ``wkv6`` entry point."""
    # every pointer and the stream as c_void_p (ctypes cuts untyped ints)
    lib.wkv6.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.wkv6.restype = ctypes.c_int
    return lib


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    from .build import load

    return _bind(load("wkv6", defines))


def wkv6(r, k, v, w, u, init_state=None, *, chunk: int = 64):
    """RWKV6 recurrence: r,k,v,w [B,S,H,D] (w in r's dtype or f32), u
    [H,D] f32, init_state [B,H,D,D] f32 or None (zeros) -> (out [B,S,H,D]
    in r's dtype, final state f32).

    ``chunk`` keeps the reference's rule: ``S`` must be a multiple of
    ``min(chunk, S)``, else ``ValueError``; the kernel stages time in its
    own stretches.  On CUDA tensors this launches the kernel on the
    current stream; on ``meta`` tensors it checks the same conditions and
    returns empty outputs; on CPU tensors it runs the plain version.  With grad
    mode on, an input that requires grad is refused on every device.
    ``wkv6.launches`` counts kernel launches.
    """
    _check_args(r, k, v, w, u, init_state, chunk)
    refuse_autograd("wkv6", r, k, v, w, u, init_state)
    if r.device.type == "cpu":
        return wkv6_torch(r, k, v, w, u, init_state)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6 runs on cuda or cpu tensors (meta for "
                         f"shapes), not {r.device}")
    _check_cuda(r, k, v, w, u, init_state)
    B, S, H, D = r.shape
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    work = cost(r.shape, r.element_size(), w.element_size(),
                init_state is not None)
    record_kernel("wkv6", work["flops"], work["bytes"])
    if r.is_meta:
        return out, state
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib().wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        out.data_ptr(), state.data_ptr(), B, S, H, D, _DTYPES[r.dtype],
        _DTYPES[w.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    wkv6.launches += 1
    return out, state


wkv6.launches = 0


def occupancy(dtype=torch.float32, wdtype=torch.float32,
              head_dim: int = 64) -> dict:
    """Registers, spills, shared memory and blocks an SM of the kernel for
    streams in ``dtype``, the decay in ``wdtype`` and ``head_dim`` on the
    current card (see :func:`.build.occupancy`)."""
    from .build import occupancy as query

    return query(_lib().wkv6_occupancy, _DTYPES[dtype], _DTYPES[wdtype],
                 head_dim)
