"""Batched serving entry point: prefill + decode loop with caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --width full --batch 4 --prompt-len 512 --gen 32

The port of the reference package's ``launch/serve.py``: the same CLI,
the same prefill against a cache of ``prompt_len + gen + 1`` slots, the
same greedy decode loop and the same output line.  ``main`` runs on CUDA
with ``attn_impl="cuda"``, so the prefill goes through the hand-written
kernels where the reference's Pallas kernels would run; :func:`serve`
takes the config and a device, so other callers choose both.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..compat import default_device
from ..configs import get_config
from ..models import build_model
from ..models.config import ArchConfig


@dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, gen] generated ids
    logits: list                  # gen tensors [B, V]: prefill's last, then each step's
    prefill_s: float              # host clock, ends in a device sync
    decode_s_per_step: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, device=None, params=None,
          prompts: Optional[torch.Tensor] = None,
          seed: int = 0) -> ServeResult:
    """Prefill ``prompts`` [B, prompt_len] into fresh caches, then decode
    ``gen - 1`` greedy steps.  Without ``params``/``prompts`` they are drawn
    from ``seed`` (f32 params, as the reference's ``serve.py`` inits them).
    Runs on CUDA unless ``device="cpu"``."""
    device = default_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(seed),
                            torch.float32, device)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab, (batch, prompt_len), device=device,
            generator=torch.Generator(device).manual_seed(seed + 1))
    B, Lp, G = prompts.shape[0], prompts.shape[1], gen
    caches = model.init_cache(B, Lp + G + 1, torch.float32, device)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = model.forward(params, prompts, caches=caches,
                                   pos_offset=0)
    logits = logits[:, -1].clone()      # frees the [B, Lp, V] logits
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def pick(lg):
        return torch.argmax(lg, dim=-1)[:, None]

    tok = pick(logits)
    out, step_logits = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(G - 1):
        logits, caches = model.decode_step(params, tok, caches, Lp + i)
        tok = pick(logits)
        out.append(tok)
        step_logits.append(logits)
    _sync(device)
    dt = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), step_logits, t_prefill,
                       dt / max(G - 1, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--width", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted as the reference's CLI does; decoding "
                         "is greedy there and here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.width == "tiny":
        cfg = cfg.smoke_config().replace(remat=False)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as the reference
    res = serve(cfg.replace(attn_impl="cuda"), batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen)
    B, Lp, G = args.batch, args.prompt_len, args.gen
    print(f"arch={cfg.name} batch={B} prefill({Lp} tok)="
          f"{res.prefill_s*1e3:.0f}ms decode {G-1} steps @ "
          f"{res.decode_s_per_step*1e3:.1f} ms/step")
    print("sample token ids:", res.tokens[0, :16].tolist())
    if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise SystemExit("generated ids outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
