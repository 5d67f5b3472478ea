"""Batched serving entry point: prefill + decode loop with caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --width full --batch 4 --prompt-len 512 --gen 32

The port of the reference package's ``launch/serve.py``: the same CLI,
the same prefill against a cache of ``prompt_len + gen + 1`` slots, the
same greedy decode loop and the same output line.  ``main`` runs on CUDA
with ``attn_impl="cuda"``, so the prefill goes through the hand-written
kernels where the reference's Pallas kernels would run; :func:`serve`
takes the config and a device, so other callers choose both.  As the
reference's, the CLI drives text-only archs and refuses an arch with a
frontend before building it.  :func:`serve` also drives the frontend
archs from the model's own functions, as the reference's tests do.  The
encoder-decoder family: the frames encoded once, the prompt decoded into
the caches against them, then decode steps given ``enc_out``.  The
multimodal-prefix family: the ``extra_embeds`` prefix and the prompt
prefilled into the caches in one forward, then decode steps at positions
counted from the prefix's start.  Given a ``ParallelCtx`` with a mesh,
:func:`serve` runs on this rank's held params (the decoder family's
tensor-parallel blocks) and cache block through the serving steps of
``launch/steps.py``, every rank one process of ``launch.mesh.run_ranks``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..compat import default_device
from ..configs import get_config
from ..models import ParallelCtx, build_model, encdec
from ..models.config import ArchConfig
from ..parallel.sharding import cache_block, held_params
from .steps import make_cache_prefill_step, make_decode_step


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
          frames: Optional[torch.Tensor] = None,
          extra_embeds: Optional[torch.Tensor] = None,
          seed: int = 0,
          ctx: Optional[ParallelCtx] = None) -> ServeResult:
    """Prefill ``prompts`` [B, prompt_len] into fresh caches, then decode
    ``gen - 1`` greedy steps.  Without ``params``/``prompts`` they are drawn
    from ``seed`` (f32 params, as the reference's ``serve.py`` inits them).
    An encoder-decoder arch also takes ``frames`` [B, frontend_seq,
    d_model], and a multimodal-prefix arch ``extra_embeds`` of that shape
    (either drawn from ``seed`` when not given).  ``extra_embeds`` [B, P,
    d_model] goes in front of the prompt: the caches hold ``P + prompt_len
    + gen`` positions and decode step ``i`` runs at position ``P +
    prompt_len + i``.  The prefill time includes the encoder's or the
    prefix's.  Runs on CUDA unless ``device="cpu"``.

    With ``ctx`` and its mesh, every rank of the mesh calls this with the
    same global ``prompts`` (and prefix) and its held ``params``
    (``parallel.sharding.held_params``; drawn whole and cut when not
    given); the caches are its block, and the tokens and logits returned
    are the global ones.  The encoder-decoder family serves on one rank."""
    device = default_device(device)
    model = build_model(cfg)
    ctx = ParallelCtx() if ctx is None else ctx
    mesh = ctx.mesh if ctx.mesh is not None and ctx.mesh.size > 1 else None
    if mesh is not None and cfg.encdec:
        raise ValueError(f"{cfg.name}: the encoder-decoder family serves on "
                         f"one rank")
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(seed),
                            torch.float32, device)
        if mesh is not None:
            params = held_params(cfg, params, mesh)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab, (batch, prompt_len), device=device,
            generator=torch.Generator(device).manual_seed(seed + 1))
    B, Lp, G = prompts.shape[0], prompts.shape[1], gen

    def drawn_prefix():
        return 0.02 * torch.randn(
            (B, cfg.frontend_seq, cfg.d_model), device=device,
            generator=torch.Generator(device).manual_seed(seed + 2))

    if cfg.encdec:
        if extra_embeds is not None:
            raise ValueError(f"{cfg.name} takes frames, not extra_embeds")
        if frames is None:
            frames = drawn_prefix()
    elif cfg.frontend != "none" and extra_embeds is None:
        extra_embeds = drawn_prefix()
    P = 0 if extra_embeds is None else extra_embeds.shape[1]
    if mesh is None:
        caches = model.init_cache(B, P + Lp + G + 1, torch.float32, device)
    else:
        caches = cache_block(model, B, P + Lp + G + 1, torch.float32, device,
                             mesh)
    decode = make_decode_step(model, ctx)

    _sync(device)
    t0 = time.perf_counter()
    batch = {}
    if cfg.encdec:
        enc = batch["enc_out"] = encdec.encode(cfg, params, frames)
        logits, caches = encdec.decode(cfg, params, prompts, enc,
                                       caches=caches)
        logits = logits[:, -1].clone()  # frees the [B, Lp, V] logits
    else:
        prompt = {"tokens": prompts}
        if extra_embeds is not None:
            prompt["extra_embeds"] = extra_embeds
        logits, caches = make_cache_prefill_step(model, ctx)(params, caches,
                                                            prompt)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def pick(lg):
        return torch.argmax(lg, dim=-1)[:, None]

    tok = pick(logits)
    out, step_logits = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(G - 1):
        logits, caches = decode(params, caches,
                                {**batch, "tokens1": tok, "pos": P + Lp + i})
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
    if cfg.frontend != "none":
        raise SystemExit("serve.py drives text-only archs; "
                         "see examples/ for the multimodal path")
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
