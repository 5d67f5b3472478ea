"""Data pipeline: sharded synthetic token streams with EDT-driven prefetch.

The port of the reference package's ``data/__init__.py``.  Each host
produces only its shard of the global batch (``host_slice``); batches are
staged ahead of the training step by the autodec runtime (the prefetch
task for step t+k depends on the consumption of step t — a counted
dependence, paper §2.2.4).  Every batch is drawn from the same
``SeedSequence([seed, step, host_id])`` as the reference's, so the two
streams are byte-identical; the tensors go to CUDA unless the caller
names another device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..compat import default_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_seq: int = 0      # >0: also emit stub modality embeddings
    d_model: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream (zipfian-ish token marginals).

    Deterministic in (seed, step, host) so checkpoint-restart resumes the
    exact stream — a fault-tolerance requirement, not a convenience.
    ``device`` (default CUDA) is where :meth:`batch_at` puts the batches.
    """

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 device=None):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.device = default_device(device)

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``: int32 ``tokens`` and ``labels`` [b, S]
        (and bf16 ``extra_embeds``), on the stream's device."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        # zipf-flavored marginals, cheap to generate
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = (cfg.vocab * u ** 3).astype(np.int32) % cfg.vocab
        out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(self.device),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(self.device)}
        if cfg.frontend_seq:
            emb = rng.standard_normal(
                (self.local_batch, cfg.frontend_seq, cfg.d_model),
                dtype=np.float32) * 0.02
            out["extra_embeds"] = torch.from_numpy(emb).to(
                torch.bfloat16).to(self.device)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchPipeline:
    """EDT-style prefetch: a bounded queue fed by autodec-scheduled tasks."""

    def __init__(self, source: SyntheticLM, depth: int = 2,
                 start_step: int = 0):
        from ..core.edt.threaded import ThreadedAutodec
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.depth = depth
        self._next_to_produce = start_step
        self._lock = threading.Lock()
        # each produce-task has exactly one input dependence: a free queue
        # slot; consuming a batch autodecs the producer of step+depth.
        self.rt = ThreadedAutodec(
            pred_count=lambda step: 1,
            successors=lambda step: [],
            body=self._produce,
            workers=1,
        )
        for s in range(start_step, start_step + depth):
            self.rt.autodec(s)   # initial slots are free

    def _produce(self, step: int) -> None:
        self.q.put((step, self.source.batch_at(step)))

    def get(self) -> tuple[int, dict]:
        step, batch = self.q.get()
        self.rt.autodec(step + self.depth)   # freed slot -> schedule producer
        return step, batch

    def close(self):
        self.rt.shutdown()
