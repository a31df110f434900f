"""Epoch-workflow trainer with hook dispatch.

Port of det3d_tpu/runtime/trainer.py. Parity: reference
det3d/torchie/trainer/trainer.py:124-588 — ``run`` over a workflow like
[("train", 1)] or [("train", 5), ("val", 1)], hook lifecycle, resume/save,
LogBuffer-based logging. The per-iteration body is one train step
(parallel/train.py::make_train_step: on the card one CUDA graph, with
gradients, BN statistics and the optimizer's update); the state lives in
the step, ``train_step(batch) -> metrics``, and the trainer owns only
orchestration, timing and IO. The learning rate comes from the
optimizer's count on the card, so LrUpdaterHook becomes ``current_lr()``
introspection.

Under ranks (parallel/dist_utils.py) only rank 0 writes: the log file,
the checkpoints (then every rank waits at a barrier, so that none reads
a half-written file) and, in runtime/hooks.py, the JSON log and the
tfevents; the other ranks log at ERROR only
(det3d_tpu/runtime/trainer.py:36-43,126-127). ``resume`` reads the
checkpoint on every rank.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from det3d_tpu_torch.parallel.dist_utils import get_dist_info, synchronize
from det3d_tpu_torch.runtime.checkpoint import CheckpointManager
from det3d_tpu_torch.runtime.hooks import Hook, get_priority
from det3d_tpu_torch.runtime.log_buffer import LogBuffer


def _get_host_logger(work_dir: Optional[str], timestamp: str) -> logging.Logger:
    logger = logging.getLogger("det3d_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False          # root logger would double-print
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(sh)
    rank = get_dist_info()[0]
    if work_dir and rank == 0:
        os.makedirs(work_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(work_dir, f"{timestamp}.log"))
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(fh)
    if rank != 0:
        logger.setLevel(logging.ERROR)
    return logger


class Trainer:
    """Runs (train|val) epochs over data loaders with hooks.

    state: parallel/train.py::TrainState, which the steps advance in place
    train_step(batch) -> metrics-dict of 0-d tensors
    val_step(batch) -> metrics-dict (optional)
    lr_fn(step) -> lr (for logging only; the optimizer reads its schedule
    at its own count)
    """

    def __init__(self, state, train_step: Callable,
                 val_step: Optional[Callable] = None,
                 work_dir: Optional[str] = None,
                 lr_fn: Optional[Callable] = None,
                 logger: Optional[logging.Logger] = None,
                 max_to_keep: Optional[int] = None,
                 meta: Optional[Dict] = None):
        self.state = state
        self.train_step_fn = train_step
        self.val_step_fn = val_step
        self.work_dir = os.path.abspath(work_dir) if work_dir else None
        self.timestamp = time.strftime("%Y%m%d_%H%M%S")
        self.logger = logger or _get_host_logger(self.work_dir, self.timestamp)
        self.lr_fn = lr_fn
        self.meta = meta or {}

        self.log_buffer = LogBuffer()
        self._hooks: List[Tuple[int, Hook]] = []
        self.mode: Optional[str] = None
        self.data_loader = None
        self._epoch = 0
        self._iter = 0
        self._inner_iter = 0
        self._max_epochs = 0
        self._max_iters = 0
        self._ckpt = (CheckpointManager(os.path.join(self.work_dir, "ckpt"),
                                        max_to_keep)
                      if self.work_dir else None)

    # -- properties mirroring trainer.py:176-240 -------------------------
    @property
    def epoch(self):
        return self._epoch

    @property
    def iter(self):
        return self._iter

    @property
    def inner_iter(self):
        return self._inner_iter

    @property
    def max_epochs(self):
        return self._max_epochs

    @property
    def max_iters(self):
        return self._max_iters

    @property
    def hooks(self) -> List[Hook]:
        return [h for _, h in self._hooks]

    def current_lr(self) -> Optional[float]:
        if self.lr_fn is None:
            return None
        return float(self.lr_fn(torch.tensor(self._iter)))

    # -- hooks -----------------------------------------------------------
    def register_hook(self, hook: Hook, priority="NORMAL") -> None:
        p = get_priority(priority)
        idx = len([1 for q, _ in self._hooks if q <= p])
        self._hooks.insert(idx, (p, hook))

    def call_hook(self, fn_name: str) -> None:
        for _, hook in self._hooks:
            getattr(hook, fn_name)(self)

    # -- checkpoint ------------------------------------------------------
    def save_checkpoint(self, out_dir: Optional[str] = None) -> None:
        """Rank 0 writes the checkpoint; then every rank waits for it."""
        if get_dist_info()[0] == 0:
            mgr = self._ckpt if out_dir in (None, self.work_dir) else \
                CheckpointManager(os.path.join(out_dir, "ckpt"))
            meta = dict(self.meta, iter=self._iter,
                        timestamp=self.timestamp)
            mgr.save(self._epoch + 1, self.state, meta=meta)
            self.logger.info("saved checkpoint @ epoch %d", self._epoch + 1)
        synchronize()

    def resume(self, checkpoint_dir: Optional[str] = None) -> None:
        """Restore state + epoch/iter counters (trainer.py:475-488), the
        state written in place."""
        mgr = self._ckpt if checkpoint_dir is None else \
            CheckpointManager(os.path.join(checkpoint_dir, "ckpt"))
        _, epoch = mgr.restore(self.state)
        self._epoch = epoch
        meta = mgr.load_meta()
        if meta:
            self._iter = int(meta.get("iter", 0))
        self.logger.info("resumed from epoch %d, iter %d", epoch, self._iter)

    # -- epochs ----------------------------------------------------------
    def train(self, data_loader) -> None:
        self.mode = "train"
        self.data_loader = data_loader
        if hasattr(data_loader, "set_epoch"):
            data_loader.set_epoch(self._epoch)
        self.call_hook("before_train_epoch")
        for i, batch in enumerate(data_loader):
            self._inner_iter = i
            self.call_hook("before_train_iter")
            metrics = self.train_step_fn(batch)
            self._log_metrics(metrics)
            self.call_hook("after_train_iter")
            self._iter += 1
        self.call_hook("after_train_epoch")
        self._epoch += 1

    def val(self, data_loader) -> None:
        if self.val_step_fn is None:
            return
        self.mode = "val"
        self.data_loader = data_loader
        self.call_hook("before_val_epoch")
        for i, batch in enumerate(data_loader):
            self._inner_iter = i
            self.call_hook("before_val_iter")
            metrics = self.val_step_fn(batch)
            self._log_metrics(metrics)
            self.call_hook("after_val_iter")
        self.call_hook("after_val_epoch")

    def _log_metrics(self, metrics: Dict[str, Any]) -> None:
        # keep metrics as device tensors; LogBuffer reads them back at
        # logging time, so the loop never waits for the card (a .item()
        # here would sync on every captured step)
        self.log_buffer.update(dict(metrics))

    def run(self, data_loaders: Sequence, workflow: Sequence[Tuple[str, int]],
            max_epochs: int) -> None:
        """Parity: trainer.py:490-564. data_loaders align with workflow."""
        assert len(data_loaders) == len(workflow)
        self._max_epochs = max_epochs
        train_idx = [i for i, (m, _) in enumerate(workflow) if m == "train"]
        if train_idx:
            epochs_per_cycle = sum(e for m, e in workflow if m == "train")
            self._max_iters = int(
                max_epochs / max(epochs_per_cycle, 1)
                * sum(len(data_loaders[i]) for i in train_idx))
        self.logger.info("workflow: %s, max: %d epochs", workflow, max_epochs)
        self.call_hook("before_run")
        while self._epoch < max_epochs:
            for i, (mode, epochs) in enumerate(workflow):
                for _ in range(epochs):
                    if mode == "train" and self._epoch >= max_epochs:
                        break
                    getattr(self, mode)(data_loaders[i])
        self.call_hook("after_run")
