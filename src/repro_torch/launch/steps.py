"""Step functions (prefill / decode) for serving.

The port of the serving half of the reference package's
``launch/steps.py``; the training step waits for the optimizer (ROADMAP
Queue 1 #2).
"""
from __future__ import annotations

from ..models import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch["tokens"],
                                  extra_embeds=batch.get("extra_embeds"))
        # serving returns the last-position logits (next-token distribution);
        # a copy, so the [B, S, V] logits are freed on return
        return logits[:, -1].clone()
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, caches, batch):
        return model.decode_step(params, batch["tokens1"], caches,
                                 batch["pos"])
    return decode_step
