"""Fault-tolerant training driver.

The port of the reference package's ``runtime/driver.py``, on the port's
``ThreadedAutodec``.  Responsibilities (each one an EDT on the host
autodec runtime — the paper's proposed synchronization model orchestrates
the *cluster-level* events that the device cannot see):

  * data prefetch      — producer tasks gated by queue-slot dependences;
  * async checkpoint   — save tasks chained by counted dependences
                         (step-atomic manifests; crash => clean restart);
  * straggler backup   — for host-side work items (eval, data shard fetch),
                         a backup task is autodec'd after a deadline; first
                         completion wins, exactly-once by the atomic counter
                         (the paper's Fig-1 race, resolved by design);
  * failure recovery   — any step failure (device loss is injected in tests)
                         restores the latest checkpoint and replays the
                         deterministic data stream;
  * restart placement  — ``restore`` loads onto the devices of the state
                         ``init_fn`` makes, and the data stream goes to
                         the device of its params (CUDA unless the caller's
                         ``init_fn`` names the CPU).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..core.edt.threaded import ThreadedAutodec
from ..data import DataConfig, PrefetchPipeline, SyntheticLM
from ..tree import leaves


@dataclass
class DriverConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    # under the process's own temporary directory (``TMPDIR``)
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    prefetch_depth: int = 2
    max_restarts: int = 3
    straggler_deadline_s: float = 5.0


@dataclass
class StepResult:
    step: int
    loss: float
    restarts: int


class TrainDriver:
    """Run ``train_step`` with prefetch, async checkpoint and restart."""

    def __init__(self, cfg: DriverConfig, data_cfg: DataConfig,
                 train_step: Callable, init_fn: Callable[[], tuple],
                 fault_hook: Optional[Callable[[int], None]] = None):
        """init_fn() -> (params, opt_state); train_step(params, opt, batch)
        -> (params, opt, loss).  fault_hook(step) may raise to inject a
        failure (tests)."""
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.train_step = train_step
        self.init_fn = init_fn
        self.fault_hook = fault_hook
        self.history: list[StepResult] = []
        self.restarts = 0

    # ------------------------------------------------------------ recovery
    def _restore_or_init(self):
        params, opt_state = self.init_fn()
        step0 = 0
        last = latest_step(self.cfg.ckpt_dir)
        if last is not None:
            state = restore(self.cfg.ckpt_dir, last,
                            {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            step0 = last + 1
        return params, opt_state, step0

    # ------------------------------------------------------------- run loop
    def run(self) -> list[StepResult]:
        cfg = self.cfg
        attempt = 0
        while True:
            try:
                self._run_once()
                return self.history
            except Exception:
                attempt += 1
                self.restarts += 1
                if attempt > cfg.max_restarts:
                    raise
                # fall through: restart restores from the latest checkpoint

    def _run_once(self) -> None:
        cfg = self.cfg
        params, opt_state, step0 = self._restore_or_init()
        device = leaves(params)[0].device
        source = SyntheticLM(self.data_cfg, device=device)
        pipe = PrefetchPipeline(source, depth=cfg.prefetch_depth,
                                start_step=step0)
        ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        try:
            for step in range(step0, cfg.total_steps):
                got_step, batch = pipe.get()
                assert got_step == step, (got_step, step)
                if self.fault_hook is not None:
                    self.fault_hook(step)
                params, opt_state, loss = self.train_step(
                    params, opt_state, batch)
                self.history.append(
                    StepResult(step, float(loss), self.restarts))
                if (step + 1) % cfg.ckpt_every == 0 or step == cfg.total_steps - 1:
                    ckpt.submit(step, {"params": params, "opt": opt_state})
            ok = ckpt.wait(timeout=300)
            assert ok, "checkpointer did not quiesce"
        finally:
            pipe.close()
            ckpt.close()


# ---------------------------------------------------------------- stragglers
def run_with_backup(work: Callable[[], Any], deadline_s: float,
                    backup: Optional[Callable[[], Any]] = None) -> Any:
    """First-completion-wins execution of a host-side work item.

    Primary and (deadline-delayed) backup tasks share one autodec counter;
    whichever finishes first publishes the result — the other's completion
    finds the 'scheduled' flag set and is dropped.  This is the paper's
    atomic-creation mechanism reused for straggler mitigation.
    """
    import threading

    result: dict[str, Any] = {}
    done = threading.Event()
    publish_lock = threading.Lock()

    def publisher(key):
        out = (work if key == "primary" else (backup or work))()
        with publish_lock:
            if "value" not in result:   # first completion wins
                result["value"] = out
                result["by"] = key
        done.set()

    rt = ThreadedAutodec(pred_count=lambda k: 1,
                         successors=lambda k: [],
                         body=publisher, workers=2)
    rt.autodec("primary")

    def arm_backup():
        if not done.wait(deadline_s):
            rt.autodec("backup")

    t = threading.Thread(target=arm_backup, daemon=True)
    t.start()
    done.wait()
    rt.wait(timeout=60)
    rt.shutdown()
    return result["value"], result["by"]
