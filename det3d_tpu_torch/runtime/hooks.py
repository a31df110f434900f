"""Priority-ordered lifecycle hooks for the trainer.

Port of det3d_tpu/runtime/hooks.py. Parity: reference
det3d/torchie/trainer/hooks/ — Hook (hook.py:1-63), Priority
(priority.py:4). OptimizerHook/LrUpdaterHook are subsumed by the train step
(parallel/train.py: the optimizer and its schedules run on the card, inside
the captured step), but the observable hook surface (timing, logging,
checkpointing, profiling) is preserved so reference users find the same
extension points.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from enum import IntEnum
from typing import Optional

from det3d_tpu_torch.parallel.dist_utils import get_dist_info


class Priority(IntEnum):
    HIGHEST = 0
    VERY_HIGH = 10
    HIGH = 30
    NORMAL = 50
    LOW = 70
    VERY_LOW = 90
    LOWEST = 100


def get_priority(priority) -> int:
    if isinstance(priority, int):
        if not 0 <= priority <= 100:
            raise ValueError("priority must be in [0, 100]")
        return priority
    if isinstance(priority, Priority):
        return int(priority)
    if isinstance(priority, str):
        return int(Priority[priority.upper()])
    raise TypeError(f"bad priority {priority!r}")


class Hook:
    """Lifecycle callback. All sites mirror hooks/hook.py:1-63."""

    def before_run(self, trainer):
        pass

    def after_run(self, trainer):
        pass

    def before_epoch(self, trainer):
        pass

    def after_epoch(self, trainer):
        pass

    def before_iter(self, trainer):
        pass

    def after_iter(self, trainer):
        pass

    def before_train_epoch(self, trainer):
        self.before_epoch(trainer)

    def before_val_epoch(self, trainer):
        self.before_epoch(trainer)

    def after_train_epoch(self, trainer):
        self.after_epoch(trainer)

    def after_val_epoch(self, trainer):
        self.after_epoch(trainer)

    def before_train_iter(self, trainer):
        self.before_iter(trainer)

    def before_val_iter(self, trainer):
        self.before_iter(trainer)

    def after_train_iter(self, trainer):
        self.after_iter(trainer)

    def after_val_iter(self, trainer):
        self.after_iter(trainer)

    def every_n_epochs(self, trainer, n):
        return (trainer.epoch + 1) % n == 0 if n > 0 else False

    def every_n_inner_iters(self, trainer, n):
        return (trainer.inner_iter + 1) % n == 0 if n > 0 else False

    def every_n_iters(self, trainer, n):
        return (trainer.iter + 1) % n == 0 if n > 0 else False

    def end_of_epoch(self, trainer):
        return trainer.inner_iter + 1 == len(trainer.data_loader)


class IterTimerHook(Hook):
    """Per-iteration timing into the log buffer (hooks/iter_timer.py:6-24)."""

    def before_epoch(self, trainer):
        self.t = time.time()

    def before_iter(self, trainer):
        trainer.log_buffer.update({"data_time": time.time() - self.t})

    def after_iter(self, trainer):
        trainer.log_buffer.update({"time": time.time() - self.t})
        self.t = time.time()


class CheckpointHook(Hook):
    """Save a checkpoint (runtime/checkpoint.py) every `interval` epochs.
    Parity: hooks/checkpoint.py:5-22 + trainer.py:331-345."""

    def __init__(self, interval: int = 1, save_optimizer: bool = True,
                 out_dir: Optional[str] = None, **kwargs):
        self.interval = interval
        self.save_optimizer = save_optimizer
        self.out_dir = out_dir

    def after_train_epoch(self, trainer):
        if not self.every_n_epochs(trainer, self.interval):
            return
        trainer.save_checkpoint(self.out_dir or trainer.work_dir)


class TextLoggerHook(Hook):
    """Console + JSON-lines logging.
    Parity: hooks/logger/text.py (epoch/iter/lr/eta/time breakdown) and the
    `{timestamp}.log.json` file consumed by tools/analyze_logs.py."""

    def __init__(self, interval: int = 20, ignore_last: bool = True, **kwargs):
        self.interval = interval
        self.ignore_last = ignore_last
        self.json_path = None
        self.start_iter = 0
        self.t_start = None

    def before_run(self, trainer):
        self.start_iter = trainer.iter
        self.t_start = time.time()
        if trainer.work_dir and get_dist_info()[0] == 0:
            os.makedirs(trainer.work_dir, exist_ok=True)
            self.json_path = os.path.join(
                trainer.work_dir, f"{trainer.timestamp}.log.json")

    def _log(self, trainer):
        trainer.log_buffer.average(self.interval)
        out = dict(trainer.log_buffer.output)
        lr = trainer.current_lr()
        mode = trainer.mode
        log = dict(mode=mode, epoch=trainer.epoch + 1, iter=trainer.inner_iter + 1,
                   lr=float(lr) if lr is not None else None, **out)
        if mode == "train" and self.t_start is not None:
            done = trainer.iter - self.start_iter + 1
            total = trainer.max_iters or 0
            if done > 0 and total:
                eta = (time.time() - self.t_start) / done * (total - trainer.iter - 1)
                log["eta"] = str(datetime.timedelta(seconds=max(int(eta), 0)))
        items = ", ".join(
            f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in log.items() if k not in ("mode",))
        trainer.logger.info("%s\t%s", mode, items)
        if self.json_path:
            with open(self.json_path, "a") as f:
                f.write(json.dumps(log) + "\n")
        trainer.log_buffer.clear_output()

    def after_train_iter(self, trainer):
        if self.every_n_inner_iters(trainer, self.interval):
            self._log(trainer)
        elif self.end_of_epoch(trainer) and not self.ignore_last:
            self._log(trainer)

    def after_train_epoch(self, trainer):
        if trainer.log_buffer.val_history:
            self._log(trainer)
        trainer.log_buffer.clear()

    def after_val_epoch(self, trainer):
        if trainer.log_buffer.val_history:
            self._log(trainer)
        trainer.log_buffer.clear()


class TensorboardLoggerHook(Hook):
    """TensorBoard scalar logging (hooks/logger/tensorboard.py) via the
    package's own dependency-free event writer (utils/tfevents.py) — no
    tensorboard or tensorboardX import."""

    def __init__(self, log_dir: Optional[str] = None, interval: int = 20,
                 **kwargs):
        self.log_dir = log_dir
        self.interval = interval
        self.writer = None

    def before_run(self, trainer):
        from det3d_tpu_torch.utils.tfevents import TfEventWriter
        if get_dist_info()[0] != 0:
            return                      # rank 0 alone writes tfevents
        self.writer = TfEventWriter(
            self.log_dir or os.path.join(trainer.work_dir, "tf_logs"))

    def after_train_iter(self, trainer):
        if self.writer is None or not self.every_n_inner_iters(trainer, self.interval):
            return
        trainer.log_buffer.average(self.interval)
        for k, v in trainer.log_buffer.output.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f"train/{k}", v, trainer.iter)
        trainer.log_buffer.clear_output()

    def after_run(self, trainer):
        if self.writer is not None:
            self.writer.close()


class ProfilerHook(Hook):
    """Trace a window of train iterations with torch.profiler.

    Parity role: the reference's inline timing probes + tensorboard traces
    (SURVEY 5.1). Profiles iterations [start, start+steps) on the CPU and,
    where the model is on the card, the card; writes a Chrome trace
    (``trace_<iter>.json``, chrome://tracing or Perfetto) under
    ``log_dir`` (default ``work_dir/profile``) and keeps the profile as
    ``self.profile`` (``key_averages()``).

    It turns the port's tracing on for the whole run (utils/trace.py),
    not only for the profiled iterations: the trainer captures its step's
    graph at the first iteration, and only a graph captured with tracing
    on carries the layer markers. The trace then shows each replay's
    ``mark_begin_<segment>`` and ``mark_end_<segment>`` kernels around the
    layers' own (voxelize, targets, reader, backbone with plan and
    dense_tail, neck, bbox_head, loss, backward, optimizer), and the
    step's host spans (``step.*``: the staging wait and copies, the
    replay's launch, the outputs). Every step of the run pays for them:
    13.5-19.0 us of device time a call on an H100 80GB HBM3, and a few
    host ranges. After the run it writes ``trace_totals.json`` beside the
    trace: each span's and segment's calls and host seconds over the
    whole run, the warm-up and capture included (``spans``: name ->
    [calls, seconds]), and the markers launched (``marker_launches``).
    The switch is then set back as it was."""

    def __init__(self, start: int = 10, steps: int = 5,
                 log_dir: Optional[str] = None):
        self.start = start
        self.steps = steps
        self.log_dir = log_dir
        self.profile = None
        self._prof = None
        self._traced = False
        self._launches = 0

    def _dir(self, trainer) -> str:
        log_dir = self.log_dir or os.path.join(trainer.work_dir or ".",
                                               "profile")
        os.makedirs(log_dir, exist_ok=True)
        return log_dir

    def before_run(self, trainer):
        from det3d_tpu_torch.utils import trace
        self._traced = trace.enabled()
        self._launches = trace.segment.launches
        trace.reset()
        trace.enable()

    def after_run(self, trainer):
        from det3d_tpu_torch.utils import trace
        trace.enable(self._traced)
        path = os.path.join(self._dir(trainer), "trace_totals.json")
        with open(path, "w") as f:
            json.dump({"spans": trace.totals(),
                       "marker_launches":
                           trace.segment.launches - self._launches}, f,
                      indent=1, sort_keys=True)

    def before_train_iter(self, trainer):
        if trainer.iter != self.start or self._prof is not None:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        trainer.logger.info("profiler started at iter %d", trainer.iter)

    def after_train_iter(self, trainer):
        if self._prof is None or trainer.iter + 1 < self.start + self.steps:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.profile, self._prof = self._prof, None
        path = os.path.join(self._dir(trainer), f"trace_{self.start}.json")
        self.profile.export_chrome_trace(path)
        trainer.logger.info("profiler stopped -> %s", path)
