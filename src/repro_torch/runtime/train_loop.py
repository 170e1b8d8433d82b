"""Fault-tolerant training loop: the port of the reference's
``runtime.train_loop``.

* auto-resume from the newest committed checkpoint (params + optimizer +
  data-pipeline state), making restart-after-kill bitwise reproducible;
  the checkpoint's arrays come back as tensors on the device the params
  live on (``checkpoint.restore_checkpoint(device=)``), AdamW's 0-d
  int32 ``count`` at its own dtype;
* periodic atomic checkpoints + GC;
* step-time watchdog: steps slower than ``watchdog_factor`` x the running
  median are logged as straggler events;
* optional failure injection for tests (``fail_at_step``).

A step's time is the host clock around ``step_fn``, which on the card
returns once its work is enqueued (as the reference's jitted step
returns before the device finishes).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..checkpoint import gc_checkpoints, restore_checkpoint, save_checkpoint
from ..optim import tree_leaves

log = logging.getLogger("repro.train")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    watchdog_factor: float = 3.0
    fail_at_step: Optional[int] = None   # test hook: simulated crash


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable,
                 params, opt_state, pipeline):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.step = 0
        self.straggler_events = []
        self._times = []
        if cfg.checkpoint_dir:
            self._maybe_resume()

    def _maybe_resume(self):
        got = restore_checkpoint(self.cfg.checkpoint_dir,
                                 {"params": self.params,
                                  "opt": self.opt_state},
                                 device=tree_leaves(self.params)[0].device)
        if got is not None:
            self.params = got["tree"]["params"]
            self.opt_state = got["tree"]["opt"]
            self.pipeline.restore(got["pipeline"])
            self.step = got["step"]
            log.info("resumed from step %d", self.step)

    def _checkpoint(self):
        if not self.cfg.checkpoint_dir:
            return
        save_checkpoint(self.cfg.checkpoint_dir, self.step,
                        {"params": self.params, "opt": self.opt_state},
                        pipeline_state=self.pipeline.state())
        gc_checkpoints(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)

    def run(self) -> Dict[str, Any]:
        metrics = {}
        while self.step < self.cfg.total_steps:
            if self.cfg.fail_at_step is not None \
                    and self.step == self.cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {self.step}")
            batch = self.pipeline.next_batch()
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            dt = time.monotonic() - t0
            self._times.append(dt)
            med = float(np.median(self._times[-50:]))
            if len(self._times) > 5 and dt > self.cfg.watchdog_factor * med:
                self.straggler_events.append((self.step, dt, med))
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            self.step, dt, med)
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0:
                self._checkpoint()
        self._checkpoint()
        return {"final_step": self.step, "metrics": metrics,
                "stragglers": self.straggler_events}
