"""Checkpoints of the train state, with the JAX package's metadata.

Port of det3d_tpu/runtime/checkpoint.py, orbax replaced by ``torch.save``.
Parity surface: reference det3d/torchie/trainer/checkpoint.py:121-215
(save_checkpoint with meta {epoch, iter, config text, CLASSES}, latest
pointer, weights-only load).

A checkpoint is ``<directory>/epoch_<n>.pt``: the model's ``state_dict``
(parameters and BatchNorm statistics) and the optimizer's state (its
moments and its step count), written under a temporary name and moved
into place with one rename; ``det3d_tpu_meta.json`` beside it holds the
last save's metadata. A restore writes into the state's existing tensors
(``copy_``), never rebinding one: a captured train step
(parallel/graph.py::CapturedStep) replays on their addresses, so a
rebound tensor would leave its graph training memory nobody reads.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

_CKPT = re.compile(r"epoch_(\d+)\.pt$")


def _meta_path(directory: str) -> str:
    return os.path.join(directory, "det3d_tpu_meta.json")


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every tensor a TrainState (parallel/train.py)
    holds: ``model/<state_dict key>``, ``tx/count``, ``tx/<mu|nu|trace>/
    <parameter name>``."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for key, val in state.tx.state_dict().items():
        if isinstance(val, dict):
            out.update({f"tx/{key}/{n}": t for n, t in val.items()})
        else:
            out[f"tx/{key}"] = val
    return out


@torch.no_grad()
def copy_into(targets: Dict[str, torch.Tensor],
              values: Dict[str, Any], what: str) -> None:
    """``targets[k].copy_(values[k])`` for every key; the key sets must
    agree."""
    missing = sorted(set(targets) - set(values))
    extra = sorted(set(values) - set(targets))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected "
                       f"{extra[:5]}")
    for k, t in targets.items():
        v = torch.as_tensor(values[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, the "
                             f"state {tuple(t.shape)}")
        t.copy_(v)


class CheckpointManager:
    """Epoch-indexed checkpoint manager over a directory."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self):
        """The saved epochs, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _CKPT.search, os.listdir(self.directory)) if m)

    def save(self, epoch: int, state: Any,
             meta: Optional[Dict] = None) -> None:
        """Save state under the epoch index; meta mirrors the reference's
        checkpoint meta dict (tools/train.py:127-132)."""
        blob = {k: v.detach().cpu() for k, v in state_tensors(state).items()}
        tmp = self.path(epoch) + ".part"
        torch.save(blob, tmp)
        os.replace(tmp, self.path(epoch))
        if self.max_to_keep:
            for old in self.epochs()[:-self.max_to_keep]:
                os.unlink(self.path(old))
        if meta is not None:
            with open(_meta_path(self.directory), "w") as f:
                json.dump({**meta, "epoch": epoch}, f)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state: Any, epoch: Optional[int] = None):
        """Write the checkpoint into ``state``'s tensors in place; returns
        (state, epoch)."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        blob = torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)
        copy_into(state_tensors(state), blob, self.path(epoch))
        return state, epoch

    def load_meta(self) -> Optional[Dict]:
        p = _meta_path(self.directory)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None


def _nest(flat: Dict[str, np.ndarray], section: str) -> Dict:
    """'/'-joined keys of one section of a weights file -> nested dicts."""
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[0] != section:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_weights(state, src: str, epoch: Optional[int] = None):
    """Weights-only load for finetune (reference cfg.load_from semantics,
    apis/train.py:320-323): the model's parameters and BatchNorm
    statistics, written in place; the optimizer's state untouched.

    ``src``:
      * a ``.npz`` written by the JAX package's ``save_weights_npz``
        (params + batch_stats under '/'-joined flax paths), carried over
        by utils/convert.py::from_jax;
      * a checkpoint directory of this package's ``CheckpointManager``
        (the latest epoch, or ``epoch``).

    Loading from a URL (the JAX package's ``_fetch_url``) waits for
    ROADMAP queue 1, item 8."""
    if os.path.isfile(src):
        from det3d_tpu_torch.utils.convert import from_jax
        with np.load(src) as z:
            flat = {k: z[k] for k in z.files}
        values = from_jax(_nest(flat, "params"), _nest(flat, "batch_stats"))
    else:
        mgr = CheckpointManager(src)
        epoch = epoch if epoch is not None else mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {src}")
        blob = torch.load(mgr.path(epoch), map_location="cpu",
                          weights_only=True)
        values = {k[6:]: v for k, v in blob.items()
                  if k.startswith("model/")}
    copy_into(dict(state.model.state_dict()), values, src)
    return state
