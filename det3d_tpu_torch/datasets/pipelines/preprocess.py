"""Train-time augmentation stages + fixed-shape Reformat.

Port of det3d_tpu/datasets/pipelines/preprocess.py: the same stages and the
same draws in the same order (GT-AUG, per-object noise, flip, rotation,
scaling, translation, shuffle). Parity: reference
det3d/datasets/pipelines/preprocess.py ``Preprocess`` (:28-256): DontCare
filtering, min-points filter, GT-AUG paste (core/sampler/sample_ops.py),
per-object noise, random flip (double flip for nuScenes), global
rotation/scaling, point shuffle, class-name -> id mapping.

The reference's ``Voxelization`` and ``AssignTarget`` stages run on the
card here (parallel/train.py::build_example); their pipeline entries are
accepted for config compatibility and recorded as no-op config carriers.
``Reformat`` (pipelines/formating.py:13 there) here pads to the fixed
shapes the captured step consumes (one CUDA graph a batch signature).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from det3d_tpu_torch.core import augment
from det3d_tpu_torch.core.db_sampler import build_dbsampler
from det3d_tpu_torch.datasets.registry import PIPELINES


def _dict_select(d, mask_or_idx):
    for k, v in list(d.items()):
        if isinstance(v, np.ndarray) and len(v) > 0:
            d[k] = v[mask_or_idx]


@PIPELINES.register_module
class Preprocess:
    def __init__(self, cfg=None, **kwargs):
        cfg = cfg or {}
        get = cfg.get if isinstance(cfg, dict) else (
            lambda k, d=None: getattr(cfg, k, d))
        self.shuffle_points = get("shuffle_points", False)
        self.remove_unknown = get("remove_unknown_examples", False)
        self.min_points_in_gt = get("min_points_in_gt", -1)
        self.mode = get("mode", "val")
        if self.mode == "train":
            self.gt_rotation_noise = list(get("gt_rot_noise", [0.0, 0.0]))
            self.gt_loc_noise_std = list(get("gt_loc_noise", [0.0, 0.0, 0.0]))
            self.global_rotation_noise = list(
                get("global_rot_noise", [0.0, 0.0]))
            self.global_scaling_noise = list(
                get("global_scale_noise", [1.0, 1.0]))
            self.global_translate_std = get("global_trans_noise", 0.0)
            self.class_names = list(get("class_names", []))
            db_cfg = get("db_sampler", None)
            self.db_sampler = build_dbsampler(db_cfg) if db_cfg else None

    def __call__(self, res, info):
        res["mode"] = self.mode
        if res["type"] == "KittiDataset":
            points = res["lidar"]["points"]
        else:
            # multi-sweep datasets carry the time-lag channel in "combined"
            points = res["lidar"].get("combined", res["lidar"]["points"])

        if self.mode != "train":
            if self.shuffle_points:
                np.random.shuffle(points)
            res["lidar"]["points"] = points
            return res, info

        anno = res["lidar"]["annotations"]
        gt_dict = {
            "gt_boxes": np.asarray(anno["boxes"], np.float64).copy(),
            "gt_names": np.asarray(anno["names"]).reshape(-1),
        }
        if anno.get("difficulty") is not None:
            gt_dict["difficulty"] = np.asarray(anno["difficulty"])
        if anno.get("velocities") is not None and \
                gt_dict["gt_boxes"].shape[1] == 7:
            # nuScenes 9-dim boxes: [x y z w l h vx vy r]
            vel = np.asarray(anno["velocities"], np.float64)[:, :2]
            gt_dict["gt_boxes"] = np.concatenate(
                [gt_dict["gt_boxes"][:, :6], vel,
                 gt_dict["gt_boxes"][:, 6:7]], axis=1)

        # drop DontCare/ignore
        keep = np.array([n not in ("DontCare", "ignore")
                         for n in gt_dict["gt_names"]], bool)
        _dict_select(gt_dict, keep)
        if self.remove_unknown and "difficulty" in gt_dict:
            _dict_select(gt_dict, gt_dict["difficulty"] != -1)
        gt_dict.pop("difficulty", None)

        if self.min_points_in_gt > 0:
            counts = augment.points_in_rbbox(
                points, gt_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5, -1]]
            ).sum(0)
            _dict_select(gt_dict, counts >= self.min_points_in_gt)

        gt_boxes_mask = np.array(
            [n in self.class_names for n in gt_dict["gt_names"]], bool)

        if self.db_sampler is not None:
            sampled = self.db_sampler.sample_all(
                res["metadata"]["image_prefix"],
                gt_dict["gt_boxes"], gt_dict["gt_names"],
                res["metadata"]["num_point_features"])
            if sampled is not None:
                gt_dict["gt_names"] = np.concatenate(
                    [gt_dict["gt_names"], sampled["gt_names"]])
                gt_dict["gt_boxes"] = np.concatenate(
                    [gt_dict["gt_boxes"], sampled["gt_boxes"]])
                gt_boxes_mask = np.concatenate(
                    [gt_boxes_mask, sampled["gt_masks"]])
                points = np.concatenate([sampled["points"], points], axis=0)

        if np.any(np.asarray(self.gt_rotation_noise)) or \
                np.any(np.asarray(self.gt_loc_noise_std)):
            box7 = gt_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5, -1]]
            augment.noise_per_object(
                box7, points, gt_boxes_mask,
                rotation_perturb=self.gt_rotation_noise,
                center_noise_std=self.gt_loc_noise_std)
            gt_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5]] = box7[:, :6]
            gt_dict["gt_boxes"][:, -1] = box7[:, -1]

        _dict_select(gt_dict, gt_boxes_mask)
        gt_dict["gt_classes"] = np.array(
            [self.class_names.index(n) + 1 for n in gt_dict["gt_names"]],
            np.int32)

        # nuScenes gets the double flip (reference preprocess.py:202-206)
        flip = (augment.random_flip_both if res["type"] == "NuScenesDataset"
                else augment.random_flip)
        gt_dict["gt_boxes"], points = flip(gt_dict["gt_boxes"], points)
        gt_dict["gt_boxes"], points = augment.global_rotation(
            gt_dict["gt_boxes"], points, rotation=self.global_rotation_noise)
        gt_dict["gt_boxes"], points = augment.global_scaling(
            gt_dict["gt_boxes"], points, *self.global_scaling_noise)
        if np.any(np.asarray(self.global_translate_std)):
            gt_dict["gt_boxes"], points = augment.global_translate(
                gt_dict["gt_boxes"], points, self.global_translate_std)

        if self.shuffle_points:
            np.random.shuffle(points)

        res["lidar"]["points"] = points
        res["lidar"]["annotations"] = gt_dict
        return res, info


@PIPELINES.register_module
class Voxelization:
    """Accepted for reference-config compatibility; voxelization runs on
    device (core/voxelize.py). Records its cfg for the device pipeline."""

    def __init__(self, cfg=None, **kwargs):
        self.cfg = cfg

    def __call__(self, res, info):
        res.setdefault("device_pipeline", {})["voxelization"] = self.cfg
        return res, info


@PIPELINES.register_module
class AssignTarget:
    """Same: anchors/targets are produced on device (core/target.py)."""

    def __init__(self, cfg=None, **kwargs):
        self.cfg = cfg

    def __call__(self, res, info):
        res.setdefault("device_pipeline", {})["assign_target"] = self.cfg
        return res, info


@PIPELINES.register_module
class Reformat:
    """Pad to the fixed shapes the captured train/eval step consumes.

    Output example dict:
      points (P, C) f32 + num_points (), gt_boxes (G, nd) f32,
      gt_classes (G,) i32, gt_valid (G,) bool, metadata.
    Parity role: pipelines/formating.py:13-59 (shape discipline was done by
    collate_kitti padding there; here it is explicit and static).
    """

    def __init__(self, max_points: int = 70000, max_gt: int = 128,
                 box_dim: Optional[int] = None, **kwargs):
        self.max_points = int(max_points)
        self.max_gt = int(max_gt)
        self.box_dim = box_dim

    def __call__(self, res, info):
        points = res["lidar"]["points"]
        n = min(len(points), self.max_points)
        c = points.shape[1]
        pts = np.zeros((self.max_points, c), np.float32)
        pts[:n] = points[:n]

        example = {
            "points": pts,
            "num_points": np.int32(n),
            "metadata": res.get("metadata", {}),
        }
        if res["mode"] == "train" and "annotations" in res["lidar"]:
            anno = res["lidar"]["annotations"]
            boxes = np.asarray(anno["gt_boxes"], np.float32)
            nd = self.box_dim or (boxes.shape[1] if boxes.size else 7)
            g = min(len(boxes), self.max_gt)
            gt = np.zeros((self.max_gt, nd), np.float32)
            cls = np.zeros((self.max_gt,), np.int32)
            valid = np.zeros((self.max_gt,), bool)
            if g:
                gt[:g] = boxes[:g, :nd]
                cls[:g] = anno["gt_classes"][:g]
                valid[:g] = True
            example.update(gt_boxes=gt, gt_classes=cls, gt_valid=valid)
        return example, info
