"""The Mamba2 SSD chunked scan: the hand-written CUDA kernel, its wrapper and its plain version.

:func:`ssd` replaces the reference package's Pallas kernel
(``repro/kernels/ssd.py::ssd_pallas``).  On CUDA tensors it launches
``csrc/ssd.cu`` (built on first use) or raises; on CPU tensors it runs
:func:`ssd_torch`.  Per (batch, head), with an f32 ``[P, N]`` state::

    state ← exp(dt_t A) state + dt_t x_t B_tᵀ;   y_t = state C_t

computed a chunk at a time: within a chunk the quadratic form
``((C Bᵀ) ⊙ decay)(dt ⊙ x) + seg ⊙ (C · state)``, across chunks the
state ``exp(cums[-1]) state + Σ_t w_t dt_t x_t B_tᵀ``.  On ``meta``
tensors :func:`ssd` checks the kernel's conditions and returns the
outputs' shapes, launching nothing; on CUDA and ``meta`` tensors alike it
records its :func:`cost` in the op counter (``launch.op_cost``) when one
is running.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..compat import refuse_autograd
from ..launch.op_cost import record_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel pads P and N to 64 in shared memory
MAX_DIM = 64
#: the kernel walks time in chunks of this many steps
KERNEL_CHUNK = 64


def ssd_torch(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    """The plain torch version of :func:`ssd`: the Pallas body's chunked
    form in f32, a loop over chunks of ``min(chunk, S)`` steps (``S`` a
    multiple of it), on whatever device the tensors lie.  Returns ``(y in
    x's dtype, final state f32)``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = S // L
    xc = x.float().reshape(B, nc, L, H, P)
    dtc = dt.float().reshape(B, nc, L, H)
    Bc = Bm.float().reshape(B, nc, L, N)
    Cc = Cm.float().reshape(B, nc, L, N)
    cums = torch.cumsum(dtc * A.float(), dim=2)          # [B,nc,L,H], <= 0
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    above = ~torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    y = torch.empty((B, nc, L, H, P), dtype=torch.float32, device=x.device)
    for c in range(nc):
        xb, dtb, Bb, Cb, cumb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], \
            cums[:, c]
        # the incoming state, decayed from the chunk's start to t
        y_state = (torch.einsum("bln,bhpn->blhp", Cb, state)
                   * torch.exp(cumb)[..., None])
        # decay from s to t at or below the diagonal; masked before the
        # exponential, which overflows above it for large dt·|A|
        rel = cumb[:, :, None, :] - cumb[:, None, :, :]  # [B,L(t),L(s),H]
        decay = torch.exp(rel.masked_fill(above, float("-inf")))
        scores = torch.einsum("bln,bmn->blm", Cb, Bb)[..., None] * decay
        y[:, c] = y_state + torch.einsum(
            "blmh,bmhp->blhp", scores * dtb[:, None], xb)
        # carry the state to the chunk's end
        w = torch.exp(cumb[:, -1:] - cumb) * dtb             # [B,L,H]
        state = (state * torch.exp(cumb[:, -1])[:, :, None, None]
                 + torch.einsum("blhp,bln->bhpn", w[..., None] * xb, Bb))
    return y.reshape(B, S, H, P).to(x.dtype), state


@functools.cache
def least_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """The least f32 operations SSD needs: the chunked form at its best
    chunk L.  A (step, head) costs 2 P N for C . state and 2 P N for the
    state update, P N / L for decaying the state once a chunk, and for
    each of its (L + 1) / 2 pairs at or below the diagonal 2 P for M x,
    2 for the decay and dt, and 2 N for C . B, which all H heads share."""
    per = min(4 * P * N + P * N / L + (L + 1) * (P + 1 + N / H)
              for L in range(1, S + 1))
    return round(B * S * H * per)


def cost(x_shape, N: int, itemsize: int = 4,
         with_state: bool = False) -> dict:
    """The work of one call on x of ``x_shape`` ``[B,S,H,P]`` and Bm/Cm
    ``[B,S,N]`` (x, Bm, Cm and y of ``itemsize`` bytes an element):
    ``flops`` by :func:`least_flops`, ``bytes`` every input, y and the f32
    states (the initial one when given) once each."""
    B, S, H, P = x_shape
    return {"flops": least_flops(B, S, H, P, N),
            "bytes": itemsize * (2 * B * S * H * P + 2 * B * S * N)
            + 4 * (B * S * H + H + (2 if with_state else 1) * B * H * P * N)}


def _check_args(x, dt, A, Bm, Cm, init_state, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError("ssd takes x of shape [B,S,H,P]")
    B, S, H, P = x.shape
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"Bm has shape {tuple(Bm.shape)}, want [{B},{S},N]")
    N = Bm.shape[-1]
    for name, t, want in (("dt", dt, (B, S, H)), ("A", A, (H,)),
                          ("Cm", Cm, (B, S, N))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"init_state has shape {tuple(init_state.shape)}, "
                         f"want {(B, H, P, N)}")
    # the reference's chunk rule (ssd.py:78-80)
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")


def _check_cuda(x, dt, A, Bm, Cm, init_state) -> None:
    streams = (("x", x), ("Bm", Bm), ("Cm", Cm))
    f32 = (("dt", dt), ("A", A)) + ((("init_state", init_state),)
                                    if init_state is not None else ())
    for name, t in streams + f32:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the ssd kernel takes x, Bm, Cm all float32 or all "
                         f"bfloat16, got "
                         f"{[str(t.dtype) for _, t in streams]}")
    for name, t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
    P, N = x.shape[-1], Bm.shape[-1]
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"the ssd kernel takes head dims and states of at "
                         f"most {MAX_DIM}, not P={P}, N={N}")


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    from .build import load

    lib = load("ssd", defines)
    # every pointer and the stream as c_void_p (ctypes cuts untyped ints)
    lib.ssd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd.restype = ctypes.c_int
    return lib


def ssd(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    """Mamba2 SSD: x [B,S,H,P] and Bm/Cm [B,S,N] (all f32 or all bf16), dt
    [B,S,H] f32 (>= 0), A [H] f32 (< 0), init_state [B,H,P,N] f32 or None
    (zeros) -> (y [B,S,H,P] in x's dtype, final state f32).

    ``chunk`` keeps the reference's rule: ``S`` must be a multiple of
    ``min(chunk, S)``, else ``ValueError``; the kernel walks time in its
    own chunks of 64, the same function up to rounding.  On CUDA tensors
    this launches the kernel on the current stream (two CUDA kernels: each
    chunk's ``C Bᵀ``, shared by the heads, then the scan); on ``meta``
    tensors it checks the same conditions and returns empty outputs; on
    CPU tensors it runs the plain version.  With grad mode on, an input that requires
    grad is refused on every device.  ``ssd.launches`` counts those
    launches, one a call.
    """
    _check_args(x, dt, A, Bm, Cm, init_state, chunk)
    refuse_autograd("ssd", x, dt, A, Bm, Cm, init_state)
    if x.device.type == "cpu":
        return ssd_torch(x, dt, A, Bm, Cm, init_state, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd runs on cuda or cpu tensors (meta for "
                         f"shapes), not {x.device}")
    _check_cuda(x, dt, A, Bm, Cm, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # scratch for each chunk's C Bᵀ, which all H heads share
    gram = torch.empty((B, -(-S // KERNEL_CHUNK), KERNEL_CHUNK, KERNEL_CHUNK),
                       dtype=torch.float32, device=x.device)
    work = cost(x.shape, N, x.element_size(), init_state is not None)
    record_kernel("ssd", work["flops"], work["bytes"])
    if x.is_meta:
        return y, state
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        gram.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, P, N,
        _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    ssd.launches += 1
    return y, state


ssd.launches = 0


def occupancy(dtype=torch.float32) -> dict:
    """Registers, spills, shared memory and blocks an SM of the kernel for
    ``dtype`` on the current card (see :func:`.build.occupancy`)."""
    from .build import occupancy as query

    return query(_lib().ssd_occupancy, _DTYPES[dtype])
