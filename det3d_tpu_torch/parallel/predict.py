"""The serving step: points -> voxels -> network -> detections.

Port of det3d_tpu/parallel/train.py::build_example (``with_targets=False``)
and ``make_predict_step``, without the mesh and without double-flip TTA.
The JAX step takes its weights in a train state; here the model holds
them, and the step runs eagerly on the model's device. A batch's
``plan_*`` keys (apis/train.py::host_plan_fn) go to the model as its
sparse middle's plan.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

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


def make_predict_step(model, voxel_generator: VoxelGenerator,
                      assigners: Sequence[TargetAssigner],
                      class_ids_per_task: Sequence[Sequence[int]],
                      test_cfg) -> Callable:
    """Returns ``predict_step(batch) -> padded detections dict``.

    ``batch`` holds ``points`` (B, P, C) and ``num_points`` (B,), as tensors
    or numpy arrays, and for a sparse-middle model the host plan and voxels
    of ``host_plan_fn(..., voxelize=True)``; everything is moved to the
    model's device. Output: the head's ``predict`` dict (box3d_lidar,
    scores, label_preds, valid)."""
    if test_cfg.get("double_flip", False):
        raise NotImplementedError("double-flip TTA is not ported yet")
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict_step(batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        plan = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
        example = build_example(batch, voxel_generator, assigners)
        kw = {"plan": plan} if plan else {}
        preds = model(example["voxels"], example["num_points_per_voxel"],
                      example["coordinates"], **kw)
        return model.predict(example, preds, test_cfg)

    return predict_step
