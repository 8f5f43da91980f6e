"""Fault-tolerant training-loop runner: torch port of
``repro.runtime.loop``.

Wraps a step function with:

* periodic atomic checkpoints of ``{params, opt}`` (``repro_torch.
  checkpoint``);
* crash recovery: when a step fails (an injected failure or a real one),
  the runner restores the latest checkpoint onto the devices the state
  lives on and REPLAYS the deterministic data stream from the checkpointed
  step. With deterministic steps (the port's kernels are, the embedding
  bag's backward included), a recovered run ends bitwise equal to one
  that never failed;
* a straggler hook: a step slower than ``step_deadline_s`` is logged.
  The runner waits on each step's loss where the reference calls
  ``block_until_ready``, so step times see the device's work.

One deliberate deviation (ROADMAP C8): every recovery counts against
``max_retries``, and when the retries run out the runner raises the
step's own error. The reference counts only retries made while no
checkpoint exists, so a step that fails every time (a kernel that cannot
launch) would be restored and retried forever.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.runtime")


class FailureInjector:
    """Deterministic failure schedule for tests: fail step k once."""

    def __init__(self, fail_at: tuple = ()):  # steps that fail once
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def _wait(x) -> None:
    """Wait until the device has computed ``x`` (a tensor on the card)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def tree_devices(tree):
    """``tree``'s structure with each leaf replaced by its device (the
    host for a leaf that is no tensor): the ``shardings`` that restores a
    checkpoint where the state lives."""
    return tree_map(lambda t: t.device if isinstance(t, torch.Tensor)
                    else torch.device("cpu"), tree)


@dataclasses.dataclass
class TrainLoopRunner:
    step_fn: Callable                      # (params, opt, batch) -> (params, opt, metrics)
    data_fn: Callable[[int], object]       # step -> batch (deterministic)
    ckpt_dir: str
    ckpt_every: int = 50
    step_deadline_s: Optional[float] = None
    failure_injector: Optional[FailureInjector] = None
    max_retries: int = 3

    def run(self, params, opt_state, n_steps: int, start_step: int = 0):
        step = start_step
        metrics = None
        while step < n_steps:
            try:
                batch = self.data_fn(step)
                t0 = time.time()
                if self.failure_injector:
                    self.failure_injector.maybe_fail(step)
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                _wait(metrics["loss"])
                dt = time.time() - t0
                if (self.step_deadline_s is not None
                        and dt > self.step_deadline_s):
                    log.warning("straggler: step %d took %.2fs (deadline %.2fs)"
                                " — flagged for replacement", step, dt,
                                self.step_deadline_s)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    save_checkpoint(self.ckpt_dir, step,
                                    dict(params=params, opt=opt_state))
            except Exception as e:  # noqa: BLE001 — recovery path
                if self.max_retries <= 0:
                    raise
                self.max_retries -= 1
                log.warning("step %d failed (%r); restoring last checkpoint",
                            step, e)
                restored = latest_step(self.ckpt_dir)
                if restored is None:
                    continue  # retry from the in-memory state
                state = dict(params=params, opt=opt_state)
                state, _ = restore_checkpoint(
                    self.ckpt_dir, restored, state,
                    shardings=tree_devices(state))
                params, opt_state = state["params"], state["opt"]
                step = restored  # deterministic data stream replays from here
        return params, opt_state, metrics
