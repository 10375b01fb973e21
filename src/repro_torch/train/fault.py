"""Fault tolerance: supervised stepping with checkpoint/replay and
straggler detection. The port of ``repro.train.fault``.

Policy (the reference's):
* every `ckpt_every` steps an async checkpoint is cut;
* a step raising a device/runtime error triggers restore-from-latest and
  replay (deterministic data keyed by step index makes replay exact);
* per-step wall time is tracked with an EMA; steps slower than
  `straggler_k` x EMA raise a StragglerEvent.
A step's time ends when its metrics reach the host, which waits for the
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ema: float


@dataclasses.dataclass
class FailureEvent:
    step: int
    error: str
    restored_step: int


class Supervisor:
    """Wraps a train step with checkpoint/replay + straggler watch; a
    restored state goes to `device` (the CPU by default)."""

    def __init__(self, step_fn: Callable, ckpt_dir: str, *,
                 ckpt_every: int = 50, straggler_k: float = 3.0,
                 ema_alpha: float = 0.2, device=None,
                 fail_injector: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.straggler_k = straggler_k
        self.ema_alpha = ema_alpha
        self.device = device
        self.fail_injector = fail_injector
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir)
        self.ema: Optional[float] = None
        self.events: List[Any] = []

    def run(self, state, make_batch: Callable[[int], Any], n_steps: int,
            start_step: int = 0):
        """state: (params, opt_state). make_batch(step) -> batch (replay-
        deterministic). Returns (state, metrics_history)."""
        history: List[Dict] = []
        step = start_step
        while step < n_steps:
            try:
                if self.fail_injector is not None:
                    self.fail_injector(step)
                t0 = time.time()
                batch = make_batch(step)
                params, opt_state, metrics = self.step_fn(*state, batch)
                values = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                state = (params, opt_state)
                self._watch_stragglers(step, dt)
                history.append(values)
                if (step + 1) % self.ckpt_every == 0:
                    self.checkpointer.save(step + 1, {"params": state[0],
                                                      "opt": state[1]})
                step += 1
            except (RuntimeError, ValueError, OSError) as e:
                restored = ckpt.latest_step(self.ckpt_dir)
                if restored is None:
                    raise  # nothing to restore from — fatal
                tree, _ = ckpt.restore_checkpoint(
                    self.ckpt_dir,
                    {"params": state[0], "opt": state[1]},
                    step=restored, device=self.device)
                state = (tree["params"], tree["opt"])
                self.events.append(FailureEvent(step, repr(e), restored))
                step = restored
        self.checkpointer.wait()
        return state, history

    def _watch_stragglers(self, step: int, dt: float):
        if self.ema is None:
            self.ema = dt
            return
        if dt > self.straggler_k * self.ema and step > 3:
            self.events.append(StragglerEvent(step, dt, self.ema))
        self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
