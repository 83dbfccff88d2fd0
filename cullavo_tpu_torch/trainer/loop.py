"""The training loop (counterpart of ``cullavo_tpu/trainer/loop.py``): epochs
of gradient steps over a batch iterable, host meters (loss, data and step
seconds), one host transfer of each step's metrics, the headline loss
(``loss_llm``, else ``loss_total``, else the sum of the ``loss*`` keys),
progress every ``log_every`` steps, checkpoints every ``updates_per_epoch //
PERIOD`` steps (re-derived from the real count after epoch 0, since a
mapper may drop records) and at each epoch's end, an optional profiler
window over chosen steps and optional wandb scalars.  Under several
processes every rank walks the same epochs and steps; only rank 0 logs and
runs wandb and the profiler window (the checkpoint writers write on rank 0
only).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from cullavo_tpu_torch.checkpoint.store import save_checkpoint
from cullavo_tpu_torch.parallel.mesh import process_index
from cullavo_tpu_torch.trainer.step import TrainState


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


@dataclasses.dataclass
class LoopConfig:
    max_epochs: int = 1
    checkpoint_period: int = 0      # checkpoints per epoch (PERIOD); 0 = epoch ends only
    log_every: int = 10
    save_dir: Optional[str] = None
    wandb: bool = False
    # torch.profiler window: steps [profile_start, profile_start + profile_steps),
    # exported as a chrome trace into profile_dir
    profile_steps: int = 0
    profile_start: int = 3          # after the warm-up steps
    profile_dir: Optional[str] = None


def _default_save(save_dir, global_step, state, epoch):
    save_checkpoint(save_dir, global_step, state)


def _headline(metrics: dict) -> float:
    if "loss_llm" in metrics:
        return metrics["loss_llm"]
    if "loss_total" in metrics:
        return metrics["loss_total"]
    return sum(v for k, v in metrics.items() if k.startswith("loss"))


def train_loop(state: TrainState, frozen_params: Any, step_fn: Callable,
               data_iter_fn: Callable[[int], Iterable[dict]], steps_per_epoch: int,
               cfg: LoopConfig, rng: Optional[torch.Generator],
               log_fn: Optional[Callable[[dict], None]] = None,
               save_fn: Optional[Callable] = None):
    """Runs the loop; returns the final state and the history (one record per
    step: epoch, step, loss and every metric as a float).

    ``step_fn(state, frozen_params, batch, rng) -> (state, metrics)``; ``rng``
    is the CPU generator of the LoRA dropout, advanced by each step.
    ``steps_per_epoch`` is an estimate (records // batch) that sets epoch 0's
    checkpoint cadence.  ``save_fn(save_dir, global_step, state, epoch)``
    replaces the default ``save_checkpoint`` at the same points.
    ``cfg.wandb`` imports wandb, which raises where it is not installed."""
    if cfg.profile_steps and not cfg.profile_dir:
        raise ValueError("LoopConfig.profile_steps needs a profile_dir")
    history = []
    loss_meter, data_time, step_time = AverageMeter(), AverageMeter(), AverageMeter()
    ckpt_every = steps_per_epoch // cfg.checkpoint_period if cfg.checkpoint_period else 0
    global_step = int(state.step)
    main = process_index() == 0
    logger = (log_fn if main else None) or (lambda d: None)
    save = save_fn or _default_save
    wandb_run = None
    if cfg.wandb and main:
        import wandb

        wandb_run = wandb.run or wandb.init(project="cullavo_tpu")

    prof, window_done = None, False
    for epoch in range(cfg.max_epochs):
        t_last = time.perf_counter()
        steps_this_epoch = 0
        for i, batch in enumerate(data_iter_fn(epoch)):
            steps_this_epoch = i + 1
            t_data = time.perf_counter()
            data_time.update(t_data - t_last)
            # >= so that a resume already past profile_start still gets a
            # window; one window only (JAX's loop opens a new one every step
            # after the first closes)
            if (cfg.profile_steps and main and not window_done
                    and global_step >= cfg.profile_start):
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
                prof_first, window_done = global_step, True
            state, metrics = step_fn(state, frozen_params, batch, rng)
            # ONE host transfer for every metric of the step
            names = list(metrics)
            values = torch.stack([torch.as_tensor(metrics[k]).float().reshape(())
                                  for k in names]).cpu().tolist()
            metrics = dict(zip(names, values))
            loss = float(_headline(metrics))
            t_step = time.perf_counter()
            step_time.update(t_step - t_data)
            t_last = t_step
            loss_meter.update(loss)
            global_step += 1
            if prof is not None and global_step >= prof_first + cfg.profile_steps:
                prof = _stop_profile(prof, cfg.profile_dir, prof_first, global_step)
            record = {"epoch": epoch, "step": global_step, "loss": loss, **metrics}
            history.append(record)
            if wandb_run is not None:
                wandb_run.log(record, step=global_step)
            if cfg.log_every and global_step % cfg.log_every == 0:
                logger({"epoch": epoch, "step": global_step, "loss_avg": loss_meter.avg,
                        "data_s": data_time.avg, "step_s": step_time.avg})
            if ckpt_every and cfg.save_dir and (i + 1) % ckpt_every == 0:
                save(cfg.save_dir, global_step, state, epoch)
        if cfg.save_dir:
            save(cfg.save_dir, global_step, state, epoch)
        if cfg.checkpoint_period and steps_this_epoch:
            ckpt_every = steps_this_epoch // cfg.checkpoint_period
    if prof is not None:
        # the loop ended inside the window: keep the trace
        _stop_profile(prof, cfg.profile_dir, prof_first, global_step)
    return state, history


def _stop_profile(prof, profile_dir: str, first: int, last: int):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_steps_{first}_{last}.json"))
    return None
