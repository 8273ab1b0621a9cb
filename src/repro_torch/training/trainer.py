"""Fault-tolerant training loop on one card.

The counterpart of the JAX package's `training/trainer.py`:
  * init-or-resume: restores the newest valid checkpoint (params, optimizer,
    data-pipeline cursor) — a restarted job continues where it stopped;
  * async checkpointing every `checkpoint_every` steps and at the end;
  * straggler watchdog: per-step wall time is tracked against a running
    median; slow steps are counted and surfaced in the result (tests
    exercise it with an injected delay, `step_delay_hook`);
  * failure injection for tests (`fail_at_step` raises mid-run).
The parameters are drawn from a `torch.Generator` seeded with
``tc.seed`` on the trainer's device (the JAX package draws from
`jax.random`, so the two start from other weights), in `param_dtype`:
f32, or bf16 beside a config whose ``dtype`` and ``param_dtype`` say
bf16 (bf16 training; the moments stay f32, and a checkpoint keeps each
leaf's type).  The step's time
ends in the host copy of its loss, which waits for the card.  It runs on
``device="cuda"`` unless asked for the CPU, and raises when CUDA is
absent; there is no mesh, so no elastic re-sharding.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_step,
                                                 restore_checkpoint)
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.plan import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.models.model import param_specs
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import init_opt_state
from repro_torch.training.train_step import make_train_step

__all__ = ["Trainer", "TrainerResult"]


@dataclasses.dataclass
class TrainerResult:
    step: int
    losses: list
    resumed_from: Optional[int]
    straggler_events: int


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainConfig,
        *,
        workdir: str | Path,
        batch: int,
        seq_len: int,
        param_dtype: torch.dtype = torch.float32,
        fail_at_step: Optional[int] = None,
        straggler_factor: float = 4.0,
        step_delay_hook: Optional[Callable[[int], None]] = None,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tc = tc
        self.workdir = Path(workdir)
        self.batch = batch
        self.seq_len = seq_len
        self.param_dtype = param_dtype
        self.fail_at_step = fail_at_step
        self.straggler_factor = straggler_factor
        self.step_delay_hook = step_delay_hook
        self.step_fn = make_train_step(cfg, tc)
        self.ckpt = AsyncCheckpointer(self.workdir / "ckpt")

    # ------------------------------------------------------------------

    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(param_specs(self.cfg), gen, self.param_dtype,
                             self.device)
        return params, init_opt_state(params)

    def run(self, num_steps: int) -> TrainerResult:
        stream = TokenStream(
            self.cfg.vocab_size, self.seq_len, self.batch, seed=self.tc.seed
        )
        params, opt_state = self._fresh_state()
        start = 0
        resumed_from = None
        last = latest_step(self.workdir / "ckpt")
        if last is not None:
            target = {"params": params, "opt": opt_state}
            restored, extra = restore_checkpoint(
                self.workdir / "ckpt", last, target
            )
            params, opt_state = restored["params"], restored["opt"]
            del target, restored
            stream.seek(extra["data_state"])
            start = last
            resumed_from = last

        losses = []
        step_times = []
        stragglers = 0
        for step in range(start, num_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = {"tokens": stream.next_batch()}
            t0 = time.perf_counter()
            if self.step_delay_hook is not None:
                # test hook: simulated slow host, inside the timed region
                self.step_delay_hook(step)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            # Straggler watchdog: compare against the running median.
            if len(step_times) >= 5:
                med = float(np.median(step_times[-20:]))
                if dt > self.straggler_factor * med:
                    stragglers += 1
            step_times.append(dt)
            losses.append(loss)
            done = step + 1
            if done % self.tc.checkpoint_every == 0 or done == num_steps:
                self.ckpt.save(
                    done,
                    {"params": params, "opt": opt_state},
                    extra={"data_state": stream.state(),
                           "straggler_events": stragglers},
                )
        self.ckpt.wait()
        return TrainerResult(
            step=num_steps,
            losses=losses,
            resumed_from=resumed_from,
            straggler_events=stragglers,
        )
