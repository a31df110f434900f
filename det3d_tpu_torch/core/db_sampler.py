"""GT-database paste augmentation (GT-AUG).

Port of det3d_tpu/core/db_sampler.py: the same draws from the same
generator in the same order, so one seed pastes the same objects
(tests/test_torch_augment_db.py). Parity: reference
det3d/core/sampler/sample_ops.py:13-372 ``DataBaseSamplerV2`` + the
``BatchSampler`` epoch-shuffled queue (core/sampler/preprocess.py:19-63) +
db filters (:66-95). Pastes pre-cropped ground-truth point clusters from an
offline database pickle into scenes so rare classes appear in every batch;
candidates colliding (BEV) with existing boxes or each other are rejected.

Database format (same as the reference's ``dbinfos_train.pkl``):
  {class_name: [ {path, name, box3d_lidar, num_points_in_gt, difficulty,
                  group_id, image_idx}, ... ]}
with per-object point files at ``root_path/path`` storing float32
(N, num_point_features) clusters relative to the box center.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from det3d_tpu_torch.core import augment


class BatchSampler:
    """Epoch-shuffled sliding window over one class's db infos.

    Parity: core/sampler/preprocess.py:19-63."""

    def __init__(self, sampled_list, name=None, shuffle=True, rng=None):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._rng = rng or np.random
        self._shuffle = shuffle
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0
        self._name = name

    def _sample(self, num):
        if self._idx + num >= len(self._sampled_list):
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx:self._idx + num]
            self._idx += num
        return ret

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num):
        return [self._sampled_list[i] for i in self._sample(num)]


def filter_by_difficulty(db_infos, removed_difficulties):
    """Parity: preprocess.py:66-78."""
    return {
        k: [info for info in v
            if info.get("difficulty", 0) not in removed_difficulties]
        for k, v in db_infos.items()
    }


def filter_by_min_num_points(db_infos, min_gt_points_dict):
    """Parity: preprocess.py:82-95."""
    for name, min_num in min_gt_points_dict.items():
        if min_num > 0 and name in db_infos:
            db_infos[name] = [
                info for info in db_infos[name]
                if info["num_points_in_gt"] >= min_num]
    return db_infos


class DataBaseSampler:
    """Parity: sample_ops.py:13-372 DataBaseSamplerV2 (no group sampling —
    unused by the shipped configs)."""

    def __init__(self, db_infos, groups: Sequence[Dict[str, int]],
                 db_prepor=None, rate=1.0, rng=None):
        self._rng = rng or np.random
        if isinstance(db_infos, (str, pathlib.Path)):
            with open(db_infos, "rb") as f:
                db_infos = pickle.load(f)
        if db_prepor is not None:
            db_infos = db_prepor(db_infos)
        self.db_infos = db_infos
        self._rate = rate
        self._sample_classes: List[str] = []
        self._sample_max_nums: List[int] = []
        for group in groups:
            self._sample_classes += list(group.keys())
            self._sample_max_nums += list(group.values())
        self._sampler_dict = {
            k: BatchSampler(v, k, rng=self._rng)
            for k, v in db_infos.items()
        }

    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features,
                   rng=None):
        """Returns None or dict(gt_names, gt_boxes, points, gt_masks,
        difficulty). Parity: sample_ops.py:97-239."""
        rng = rng or self._rng
        sample_num_per_class = []
        for class_name, max_num in zip(self._sample_classes,
                                       self._sample_max_nums):
            n = int(max_num - np.sum([name == class_name
                                      for name in gt_names]))
            sample_num_per_class.append(
                int(np.round(self._rate * n)) if n > 0 else 0)

        sampled: List[dict] = []
        sampled_gt_boxes = []
        avoid = gt_boxes
        for class_name, n in zip(self._sample_classes, sample_num_per_class):
            if n <= 0 or class_name not in self._sampler_dict:
                continue
            cls_sampled = self._sample_class(class_name, n, avoid)
            sampled += cls_sampled
            if cls_sampled:
                boxes = np.stack(
                    [s["box3d_lidar"] for s in cls_sampled], axis=0)
                sampled_gt_boxes.append(boxes)
                avoid = np.concatenate([avoid, boxes], axis=0)

        if not sampled:
            return None
        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)
        pts_list = []
        keep = []
        for i, info in enumerate(sampled):
            path = pathlib.Path(root_path) / info["path"]
            try:
                pts = np.fromfile(str(path), dtype=np.float32).reshape(
                    -1, num_point_features)
            except (FileNotFoundError, ValueError):
                continue                    # swallow-and-continue like ref
            pts = pts.copy()
            pts[:, :3] += info["box3d_lidar"][:3]
            pts_list.append(pts)
            keep.append(i)
        if not pts_list:
            return None
        sampled = [sampled[i] for i in keep]
        sampled_gt_boxes = sampled_gt_boxes[keep]
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array(
                [s.get("difficulty", 0) for s in sampled]),
            "gt_boxes": sampled_gt_boxes,
            "points": np.concatenate(pts_list, axis=0),
            "gt_masks": np.ones((len(sampled),), dtype=bool),
        }

    def _sample_class(self, name, num, gt_boxes):
        """Collision-rejected candidates. Parity: sample_class_v2 (:247)."""
        sampled = self._sampler_dict[name].sample(num)
        if not sampled:
            return []
        num_gt = gt_boxes.shape[0]
        gt_corners = augment.corners_bev(gt_boxes[:, [0, 1, 3, 4, -1]])
        sp_boxes = np.stack([s["box3d_lidar"] for s in sampled], axis=0)
        sp_corners = augment.corners_bev(sp_boxes[:, [0, 1, 3, 4, -1]])

        all_corners = np.concatenate([gt_corners, sp_corners], axis=0)
        coll = augment.box_collision_test(all_corners, all_corners)
        np.fill_diagonal(coll, False)
        valid = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(sampled[i - num_gt])
        return valid


def build_dbsampler(cfg: dict, rng=None) -> Optional[DataBaseSampler]:
    """Config-driven builder. Parity: det3d/builder.py:378-397.

    cfg: dict(type="GT-AUG", enable=..., db_info_path=...,
              sample_groups=[dict(Car=15), ...],
              db_prep_steps=[dict(filter_by_min_num_points=dict(Car=5)),
                             dict(filter_by_difficulty=[-1])],
              rate=1.0)
    """
    if cfg is None or not cfg.get("enable", True):
        return None

    preps = []
    for step in cfg.get("db_prep_steps", []):
        if "filter_by_min_num_points" in step:
            arg = step["filter_by_min_num_points"]
            preps.append(lambda d, a=arg: filter_by_min_num_points(d, a))
        if "filter_by_difficulty" in step:
            arg = step["filter_by_difficulty"]
            preps.append(lambda d, a=arg: filter_by_difficulty(d, a))

    def prepor(db_infos):
        for fn in preps:
            db_infos = fn(db_infos)
        return db_infos

    groups = [{k: int(v) for k, v in g.items()}
              for g in cfg["sample_groups"]]
    return DataBaseSampler(cfg["db_info_path"], groups, db_prepor=prepor,
                           rate=cfg.get("rate", 1.0), rng=rng)
