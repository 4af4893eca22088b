"""The fault-tolerant training loop (the reference's ``train/loop.py``):
checkpoint and restart, resume from the latest checkpoint, and a straggler
count.

  * a crash mid-run (``fail_at_step``) followed by a restart resumes from the
    latest atomic checkpoint, at the step and data position it records;
  * each step's wall time (the step and the read-back of its loss) is held
    against the median of the last 50 once five exist; a step over
    ``straggler_factor`` times it counts as a straggler.

A run resumes only from a ``checkpoint_dir`` that the caller names; without
one it writes into a fresh directory under the temp dir.  The loop runs on
one device, the card unless the caller names another; the reference's mesh and shardings wait for ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.util import Device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.transformer import LM
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.train.steps import make_train_step


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None  # None: a fresh directory under the temp dir
    keep_checkpoints: int = 3
    lr: float = 3e-4
    warmup_steps: int = 10
    grad_clip: float = 1.0
    accum_steps: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None  # fault injection for tests
    async_checkpoints: bool = True


class Trainer:
    def __init__(self, cfg: ArchConfig, loop: TrainLoopConfig, data: TokenPipelineConfig, *,
                 device: Device = None):
        self.cfg = cfg
        self.loop = loop
        self.model = LM(cfg, device=device)
        self.device = self.model.device
        self.pipeline = TokenPipeline(data)
        lr = cosine_schedule(loop.lr, loop.warmup_steps, loop.total_steps)
        self.optimizer = make_optimizer(cfg.optimizer, lr)
        ckpt_dir = loop.checkpoint_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        self.ckpt = CheckpointManager(ckpt_dir, keep=loop.keep_checkpoints,
                                      async_writes=loop.async_checkpoints)
        self.train_step = make_train_step(cfg, self.optimizer, grad_clip=loop.grad_clip,
                                          accum_steps=loop.accum_steps)
        self.step_times: list[float] = []
        self.straggler_steps = 0

    # -- state
    def init_state(self, seed: int = 0):
        """(params, optimizer state, 0): the parameters drawn from a CPU
        ``torch.Generator`` seeded with ``seed``, so every device starts from
        the same values."""
        params = self.model.init(torch.Generator().manual_seed(seed))
        return params, self.optimizer.init(params), 0

    def restore_or_init(self, seed: int = 0):
        """The latest checkpoint's (params, optimizer state, next step), or a
        fresh :meth:`init_state`."""
        if self.ckpt.latest_step() is not None:
            params, opt_state, _ = self.init_state(seed)
            restored, extra, _ = self.ckpt.restore({"params": params, "opt": opt_state})
            return restored["params"], restored["opt"], int(extra["next_step"])
        return self.init_state(seed)

    # -- run
    def run(self, *, seed: int = 0) -> dict:
        params, opt_state, start_step = self.restore_or_init(seed)
        history = []
        t_med = None
        for step in range(start_step, self.loop.total_steps):
            if self.loop.fail_at_step is not None and step == self.loop.fail_at_step:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.pipeline.batch(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, step, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 5:
                t_med = float(np.median(self.step_times[-50:]))
                if dt > self.loop.straggler_factor * t_med:
                    self.straggler_steps += 1
            history.append(loss)
            if ((step + 1) % self.loop.checkpoint_every == 0
                    or step + 1 == self.loop.total_steps):
                self.ckpt.save({"params": params, "opt": opt_state}, step + 1,
                               extra={"next_step": step + 1,
                                      "data_state": self.pipeline.state(step + 1)})
            if (step + 1) % self.loop.log_every == 0:
                print(f"step {step + 1:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.1f} ms, stragglers {self.straggler_steps})")
        self.ckpt.wait()
        return {
            "final_loss": history[-1] if history else float("nan"),
            "history": history,
            "straggler_steps": self.straggler_steps,
            "median_step_time_s": t_med or (float(np.median(self.step_times))
                                            if self.step_times else None),
            "params": params,
            "opt_state": opt_state,
        }
