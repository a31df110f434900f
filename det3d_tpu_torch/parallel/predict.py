"""The serving step: points -> voxels -> network -> detections.

Port of det3d_tpu/parallel/train.py::make_predict_step, with double-flip
TTA and without the mesh. The JAX step takes its weights in a train
state; here the model holds them. The example comes from
parallel/train.py::build_example.
A batch's ``plan_*`` keys (apis/train.py::host_plan_fn) go to the model as
its sparse middle's plan; a batch without them has the middle build its
plan on the device.

On the card the step runs as CUDA graphs (parallel/graph.py::
``CapturedStep``), the counterpart of the JAX package's
``jax.jit(step_fn)``: every shape of the step is fixed by the batch's
shapes (the voxel and plan caps, K and ``max_per_img``), and no operation
of the step reads a device value on the host, so one captured graph
replays the whole step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from det3d_tpu_torch.core.target import TargetAssigner
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.parallel.graph import stepper
from det3d_tpu_torch.parallel.train import build_example
from det3d_tpu_torch.utils import trace


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
    is the step run eagerly. While tracing is on (utils/trace.py) the step
    enters the segments voxelize, reader, backbone (plan and dense_tail
    inside it), neck, bbox_head and decode+nms."""
    double_flip = bool(test_cfg.get("double_flip", False))
    device = next(model.parameters()).device
    trace.stage_hooks(model)

    @torch.no_grad()
    def run(batch):
        if double_flip:
            batch = double_flip_batch(batch)
        plan = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
        example = build_example(batch, voxel_generator, assigners)
        kw = {"plan": plan} if plan else {}
        preds = model(example["voxels"], example["num_points_per_voxel"],
                      example["coordinates"], **kw)
        with trace.segment("decode+nms"):
            if double_flip:
                return model.predict_tta(example, preds, test_cfg)
            return model.predict(example, preds, test_cfg)

    return stepper(run, device)
