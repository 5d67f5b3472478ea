"""Device selection and the kernel build directory.

The port runs on the card: every entry point that takes ``device=`` uses
CUDA unless the caller asks for the CPU (``device="cpu"``), as the tests
do.  :func:`require_cuda` raises when CUDA is absent; nothing here ever
drops to the CPU on its own.  Torch has native float64, so the reference
package's x64 switch has no counterpart.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

#: Repository root (``src/repro_torch/compat.py`` -> ``.``).
REPO_ROOT = Path(__file__).resolve().parents[2]


def require_cuda() -> None:
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device=\"cpu\" to run "
            "the plain-torch versions of the kernels")


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device; CUDA is checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` requires grad.

    A hand-written kernel fills a fresh output that autograd cannot see,
    so its gradients would be silently missing; the reference's Pallas
    kernels define no VJP either, and its training runs the plain route.
    Checked on every device, before the dispatch, with no fallback."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the hand-written kernel has no backward (the "
            f"reference's Pallas kernels define no VJP); training runs on "
            f"attn_impl=\"xla\"")


def build_dir() -> Path:
    """Where hand-written kernels are compiled to (``build/repro_torch``)."""
    return REPO_ROOT / "build" / "repro_torch"
