"""The step-driven GAN training loop (counterpart of
audiodec_tpu/train/trainer.py `GanTrainer` and `MetricsWriter`; ref
trainer/trainerGAN.py, bin/train.py).

The metric-only stage runs to the discriminator's start step, the
adversarial stage from there on, each from its own batch iterator; the
start is `discriminator_train_start_steps` (vocoder configs) or
`start_steps.discriminator` (autoencoder configs), and the stage switches
at `>=` that step with strict_start (the autoencoder) or `>` without (the
vocoder), as JAX's does.  Steps named {"train", "eval"} (denoising) have
one stage.  A batch is an array or a tuple of arrays (the denoiser's
(noisy, clean)), each moved to the device and passed as its own argument.
The JSONL log, eval, checkpoint and epoch bookkeeping follow the JAX
package's.  Step records stay on the device and are summed there; the
host reads them once per log interval.  A checkpoint is written at every
save interval and, on exit, `checkpoint-final.ckpt`; SIGTERM ends the run
at the next step boundary with that checkpoint.  In data-parallel training
every rank runs every step and every eval (their collectives need all of
them), and only the primary rank writes metrics and checkpoints: the state
is the same on every rank, so one copy is the truth (JAX's `primary`).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from audiodec_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


class MetricsWriter:
    """Scalars as JSON lines in <outdir>/metrics.jsonl."""

    def __init__(self, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": step}
        rec.update({prefix + k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class NullWriter:
    """The metrics sink of a rank that is not the primary one."""

    def write(self, step, scalars, prefix=""):
        pass

    def close(self):
        pass


def _as_input(array, device: torch.device) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _as_inputs(batch, device: torch.device) -> tuple:
    """A batch (an array or a tuple of arrays) -> the step's tensor
    arguments."""
    parts = batch if isinstance(batch, tuple) else (batch,)
    return tuple(_as_input(b, device) for b in parts)


class GanTrainer:
    """Drives the {metric, adv, eval} steps through the two-stage schedule,
    or the {train, eval} steps through one."""

    def __init__(self, steps_fns: Dict[str, Callable], state: dict,
                 config: dict, outdir: str, train_iter: Iterator,
                 eval_iter_fn: Callable[[], Iterator],
                 device: torch.device,
                 adv_train_iter: Optional[Iterator] = None,
                 strict_start: bool = True,
                 primary: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 adv_steps_per_epoch: Optional[int] = None):
        """primary: this rank writes metrics and checkpoints."""
        self.steps_fns = steps_fns
        self.state = state
        self.config = config
        self.outdir = outdir
        self.device = device
        self.train_iter = train_iter
        self.adv_train_iter = adv_train_iter or train_iter
        self.eval_iter_fn = eval_iter_fn
        self.steps = 0
        self.primary = primary
        self.writer = MetricsWriter(outdir) if primary else NullWriter()
        self.strict_start = strict_start
        self.discriminator_start = config.get(
            "discriminator_train_start_steps",
            config.get("start_steps", {}).get("discriminator", 200000))
        self.train_max_steps = config.get("train_max_steps", 200000)
        self.adv_train_max_steps = config.get("adv_train_max_steps",
                                              self.train_max_steps)
        self.save_interval = config.get("save_interval_steps", 100000)
        self.eval_interval = config.get("eval_interval_steps", 1000)
        self.log_interval = config.get("log_interval_steps", 100)
        self._log_accum: Dict[str, torch.Tensor] = {}
        self._log_count = 0
        self.epochs = 0
        self._epoch_progress = 0
        self.steps_per_epoch = steps_per_epoch
        self.adv_steps_per_epoch = adv_steps_per_epoch or steps_per_epoch

    def _adversarial(self) -> bool:
        if self.strict_start:
            return self.steps >= self.discriminator_start
        return self.steps > self.discriminator_start

    def _step_fn(self, adv: bool) -> Callable:
        if "metric" not in self.steps_fns:
            return self.steps_fns["train"]
        return self.steps_fns["adv" if adv else "metric"]

    def _ckpt_path(self, steps):
        return os.path.join(self.outdir, f"checkpoint-{steps}steps.ckpt")

    def save(self, path=None):
        if not self.primary:
            return
        save_checkpoint(path or self._ckpt_path(self.steps), self.state,
                        self.steps, extra={"epochs": self.epochs})
        logging.info("Saved checkpoint @ %d steps (%d epochs)", self.steps,
                     self.epochs)

    def resume(self, path: str):
        self.state, header = load_checkpoint(path, self.state)
        self.steps = header["steps"]
        self.epochs = int(header.get("epochs", 0))
        logging.info("Resumed from %s @ %d steps (%d epochs)", path,
                     self.steps, self.epochs)

    def _accumulate(self, metrics):
        for k, v in metrics.items():
            prev = self._log_accum.get(k)
            self._log_accum[k] = v if prev is None else prev + v
        self._log_count += 1

    def _flush_log(self):
        if self._log_count:
            avg = {k: float(v) / self._log_count
                   for k, v in self._log_accum.items()}
            self.writer.write(self.steps, avg, prefix="train/")
            top = {k: round(v, 4) for k, v in list(avg.items())[:6]}
            logging.info("step %d: %s", self.steps, top)
            self._log_accum, self._log_count = {}, 0

    def _eval(self):
        accum: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in self.eval_iter_fn():
            m = self.steps_fns["eval"](self.state,
                                       *_as_inputs(batch, self.device))
            for k, v in m.items():
                prev = accum.get(k)
                accum[k] = v if prev is None else prev + v
            n += 1
        if n:
            self.writer.write(self.steps, {k: float(v) / n for k, v in
                                           accum.items()}, prefix="eval/")

    def run(self):
        """Train to adv_train_max_steps, saving on exit; SIGTERM
        checkpoints and stops (resume with --resume)."""
        stop = {"flag": False}

        def _on_term(signum, frame):
            logging.warning("SIGTERM received: checkpointing and stopping")
            stop["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread
            prev_handler = None
        t0 = time.time()
        try:
            while self.steps < self.adv_train_max_steps and not stop["flag"]:
                adv = self._adversarial()
                batch = next(self.adv_train_iter if adv else self.train_iter)
                self.state, metrics = self._step_fn(adv)(
                    self.state, *_as_inputs(batch, self.device))
                self.steps += 1
                spe = (self.adv_steps_per_epoch if adv
                       else self.steps_per_epoch)
                if spe:
                    self._epoch_progress += 1
                    if self._epoch_progress >= spe:
                        self.epochs += 1
                        self._epoch_progress = 0
                self._accumulate(metrics)
                if self.steps % self.log_interval == 0:
                    self._flush_log()
                if self.steps % self.eval_interval == 0:
                    self._eval()
                if self.steps % self.save_interval == 0:
                    self.save()
        finally:
            # always a final checkpoint (ref: bin/train.py:119-123)
            self.save(os.path.join(self.outdir, "checkpoint-final.ckpt"))
            self.writer.close()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        logging.info("Finished %d steps in %.1fs", self.steps,
                     time.time() - t0)
