"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 20 --batch 8 --seq 256 --width full

The port of the reference package's ``launch/train.py``: the same CLI and
output line, plus ``--device`` (CUDA unless ``cpu`` is named).
``--width tiny`` uses the reduced same-family config (CPU-runnable);
``--width full`` uses the assigned config.  The driver provides prefetch,
async checkpointing and restart; the optimizer is AdamW with a cosine
schedule.  Products run in full f32 (no TF32), as the reference's do.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..compat import default_device
from ..configs import get_config
from ..data import DataConfig
from ..models import build_model
from ..optim import AdamWConfig, init_state
from ..runtime import DriverConfig, TrainDriver
from .steps import make_train_step


def tiny_config(cfg):
    """The reference's ``--width tiny`` reduction of ``cfg``."""
    return cfg.smoke_config().replace(
        d_model=128, d_ff=384, n_layers=max(2, min(cfg.n_layers, 4)),
        vocab=2048, remat=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--width", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = get_config(args.arch)
    if args.width == "tiny":
        cfg = tiny_config(cfg)
    model = build_model(cfg)
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as the reference

    opt_cfg = AdamWConfig(lr=args.lr, warmup=20, total_steps=args.steps)

    def init_fn():
        params = model.init(torch.Generator(device).manual_seed(0), dtype,
                            device)
        return params, init_state(opt_cfg, params)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch,
                          frontend_seq=cfg.frontend_seq if cfg.frontend != "none" else 0,
                          d_model=cfg.d_model)
    drv_cfg = DriverConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir)
    driver = TrainDriver(drv_cfg, data_cfg, make_train_step(model, opt_cfg),
                         init_fn)

    t0 = time.time()
    hist = driver.run()
    dt = time.time() - t0
    first = hist[0].loss
    last = sum(h.loss for h in hist[-5:]) / min(5, len(hist))
    print(f"arch={cfg.name} steps={len(hist)} loss {first:.4f} -> {last:.4f} "
          f"({dt:.1f}s, {dt/max(1,len(hist))*1e3:.0f} ms/step, "
          f"restarts={driver.restarts})")
    assert last < first, "loss did not go down"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
