"""Build the serving stack from a config, PointPillars subset.

Port of det3d_tpu/apis/train.py::build_stack: the same reference-schema
config (``voxel_generator``, ``model``, ``assigner``, ``tasks``,
``test_cfg``) builds the voxelizer, the detector, the per-task anchor sets
and the class ids. Training and evaluation entry points wait for later
ports.
"""

from __future__ import annotations

from typing import List

import torch

from det3d_tpu_torch.core.anchors import build_box_coder
from det3d_tpu_torch.core.target import build_target_assigners
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models.builder import build_detector


def build_stack(cfg, device="cpu"):
    """Build (model, voxel_gen, assigners, class_ids_per_task, test_cfg).

    The model is in eval mode on ``device`` with the modules' default
    initial weights; load a state dict (``utils/convert.py::from_jax``) or
    call ``models/builder.py::init_weights`` before serving. A reader or
    neck with ``precision="bf16"`` raises NotImplementedError (fp32 only).
    """
    vg_cfg = cfg["voxel_generator"]
    voxel_gen = VoxelGenerator(
        voxel_size=vg_cfg["voxel_size"],
        point_cloud_range=vg_cfg["range"],
        max_num_points=vg_cfg.get("max_points_in_voxel", 100),
        max_voxels=vg_cfg.get("max_voxel_num", 20000),
        order=vg_cfg.get("order", "appearance"),
        fuse_mean=bool(vg_cfg.get("fuse_mean", False)))
    grid = voxel_gen.grid_size

    model = build_detector(cfg["model"], train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), grid_size=grid)
    model = model.to(torch.device(device)).eval()

    assigner_cfg = cfg["assigner"]
    box_coder = build_box_coder(assigner_cfg["box_coder"])
    tasks = cfg["tasks"]
    assigners = build_target_assigners(assigner_cfg["target_assigner"],
                                       box_coder, tasks)
    osf = int(assigner_cfg["out_size_factor"])
    fm = [1, grid[1] // osf, grid[0] // osf]
    for a in assigners:
        a.generate_anchors(fm)

    # global 1-based class ids per task, numbered over the flattened
    # class_names list
    flat: List[str] = []
    for t in tasks:
        flat += list(t["class_names"])
    class_ids_per_task = [[flat.index(n) + 1 for n in t["class_names"]]
                          for t in tasks]
    return model, voxel_gen, assigners, class_ids_per_task, \
        cfg.get("test_cfg")
