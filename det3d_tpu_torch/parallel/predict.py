"""The serving step: points -> voxels -> network -> detections.

Port of det3d_tpu/parallel/train.py::build_example (``with_targets=False``)
and ``make_predict_step``, with double-flip TTA and without the mesh. The
JAX step takes its weights in a train state; here the model holds them.
A batch's ``plan_*`` keys (apis/train.py::host_plan_fn) go to the model as
its sparse middle's plan; a batch without them has the middle build its
plan on the device.

On the card the step runs as CUDA graphs (``CapturedStep``), the
counterpart of the JAX package's ``jax.jit(step_fn)``: every shape of the
step is fixed by the batch's shapes (the voxel and plan caps, K and
``max_per_img``), and no operation of the step reads a device value on
the host, so one captured graph replays the whole step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from det3d_tpu_torch.core.target import TargetAssigner
from det3d_tpu_torch.core.voxelize import VoxelGenerator


def build_example(batch: Dict[str, Any], voxel_generator: VoxelGenerator,
                  assigners: Sequence[TargetAssigner],
                  with_targets: bool = False) -> Dict[str, Any]:
    """Voxelize the batch (unless it already carries ``voxels``, the host
    voxelized serving input) and attach each task's anchors, broadcast over
    the batch. All tensors must be on one device."""
    if with_targets:
        raise NotImplementedError("target assignment is not ported yet")
    if "voxels" in batch:
        vox = {"voxels": batch["voxels"], "coords": batch["coordinates"],
               "num_points_per_voxel": batch["num_points_per_voxel"],
               "num_voxels": batch["num_voxels"]}
    else:
        vox = voxel_generator.generate_batch(batch["points"],
                                             batch["num_points"])
    points = batch["points"]
    b = points.shape[0]
    anchors = [a.anchors_on(points.device) for a in assigners]
    return {
        "voxels": vox["voxels"],
        "coordinates": vox["coords"],
        "num_points_per_voxel": vox["num_points_per_voxel"],
        "num_voxels": vox["num_voxels"],
        "anchors": [a[None].expand(b, *a.shape) for a in anchors],
    }


class _Graph:
    """One batch signature's graph: its static device inputs, the pinned
    host buffers they are copied from, its static outputs, and an event
    after the last copy out of the pinned buffers."""

    def __init__(self, tensors, device):
        self.static = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                       for k, t in tensors.items()}
        self.pinned = {k: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                       for k, t in tensors.items()}
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.out: Dict[str, torch.Tensor] = {}

    def stage(self, tensors):
        """Copy the batch into the static inputs on the current stream:
        host arrays through the pinned buffers, non-blocking; device
        tensors directly."""
        self.copied.synchronize()       # the pinned buffers are free again
        for k, t in tensors.items():
            if t.is_cuda:
                self.static[k].copy_(t)
            else:
                self.pinned[k].copy_(t)
                self.static[k].copy_(self.pinned[k], non_blocking=True)
        self.copied.record()


class CapturedStep:
    """A step ``run(tensors on the card) -> {name: tensor}`` as CUDA graphs,
    one per batch signature (sorted keys, shapes and dtypes), as
    ``jax.jit`` traces one program per signature.

    ``step(batch)`` takes numpy arrays or tensors. It copies them into the
    signature's static device inputs (``_Graph.stage``: outside the graph,
    on the current stream), replays the graph on the current stream and
    returns clones of its outputs, which no later call overwrites. A new
    signature is first warmed up, then captured; a capture that fails
    raises.

    ``eager(batch)`` runs the same step eagerly, each operation launched
    from Python. ``warm_up(batch)`` runs it eagerly once on the capture
    stream, so that what the step sets up at its first call (the kernels'
    libraries and attributes, cuDNN's and cuBLAS's handles and workspaces,
    the anchors' device copy) is set up outside any capture.
    ``capture(batch)`` captures the batch's signature (after a warm-up) and
    returns its ``_Graph``; ``graphs`` maps signatures to them. The
    kernels' Python launch counters move while a graph is captured, once
    per launch, and not when it replays."""

    def __init__(self, run: Callable, device: torch.device):
        self._run = run
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[tuple, _Graph] = {}

    @staticmethod
    def tensors(batch) -> Dict[str, torch.Tensor]:
        """The batch as tensors, host arrays as CPU tensors sharing their
        memory."""
        return {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}

    @staticmethod
    def signature(tensors) -> tuple:
        return tuple(sorted((k, tuple(t.shape), t.dtype)
                            for k, t in tensors.items()))

    def eager(self, batch):
        return self._run({k: v.to(self.device) for k, v in
                          self.tensors(batch).items()})

    def warm_up(self, batch):
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.eager(batch)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def capture(self, batch) -> _Graph:
        tensors = self.tensors(batch)
        entry = _Graph(tensors, self.device)
        entry.stage(tensors)
        with torch.cuda.graph(entry.graph, stream=self.stream):
            entry.out = self._run(entry.static)
        self.graphs[self.signature(tensors)] = entry
        return entry

    def __call__(self, batch):
        tensors = self.tensors(batch)
        entry = self.graphs.get(self.signature(tensors))
        if entry is None:
            self.warm_up(tensors)
            entry = self.capture(tensors)
        entry.stage(tensors)
        entry.graph.replay()
        return {k: v.clone() for k, v in entry.out.items()}


def double_flip_batch(batch):
    """The 4B-scan batch of double-flip TTA, [identity, y-flip, x-flip,
    xy-flip], from a batch's ``points`` and ``num_points``; every other key
    (host voxels, a plan) is dropped, since the flips rewrite the points.
    Port of the batch parallel/train.py::make_predict_step stacks."""
    pts = batch["points"]
    x, y, rest = pts[..., :1], pts[..., 1:2], pts[..., 2:]
    return {"points": torch.cat([pts,
                                 torch.cat([x, -y, rest], dim=-1),
                                 torch.cat([-x, y, rest], dim=-1),
                                 torch.cat([-x, -y, rest], dim=-1)], dim=0),
            "num_points": batch["num_points"].repeat(4)}


def make_predict_step(model, voxel_generator: VoxelGenerator,
                      assigners: Sequence[TargetAssigner],
                      class_ids_per_task: Sequence[Sequence[int]],
                      test_cfg) -> Callable:
    """Returns ``predict_step(batch) -> padded detections dict``.

    ``batch`` holds ``points`` (B, P, C) and ``num_points`` (B,), as tensors
    or numpy arrays, and may hold the host voxels and, for a sparse-middle
    model, the host plan of ``host_plan_fn(..., voxelize=True)``;
    everything is moved to the model's device. Without host voxels the
    device voxelizes; without a plan the middle builds it on the device.
    With ``test_cfg["double_flip"]`` the step runs the 4B flipped scans of
    ``double_flip_batch`` (from the points alone) and merges them with the
    head's ``predict_tta``. Output: the head's ``predict`` dict
    (box3d_lidar, scores, label_preds, valid).

    On a CUDA model the step is a ``CapturedStep``: each batch signature is
    captured once as a CUDA graph and replayed. On a CPU model (the caller
    asked for the CPU) it runs eagerly. Either way ``predict_step.eager``
    is the step run eagerly."""
    double_flip = bool(test_cfg.get("double_flip", False))
    device = next(model.parameters()).device

    @torch.no_grad()
    def run(batch):
        if double_flip:
            batch = double_flip_batch(batch)
        plan = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
        example = build_example(batch, voxel_generator, assigners)
        kw = {"plan": plan} if plan else {}
        preds = model(example["voxels"], example["num_points_per_voxel"],
                      example["coordinates"], **kw)
        if double_flip:
            return model.predict_tta(example, preds, test_cfg)
        return model.predict(example, preds, test_cfg)

    if device.type == "cuda":
        return CapturedStep(run, device)

    def predict_step(batch):
        return run({k: torch.as_tensor(v, device=device)
                    for k, v in batch.items()})

    predict_step.eager = predict_step
    return predict_step
