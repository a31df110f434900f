"""KITTI dataset; port of det3d_tpu/datasets/kitti/kitti.py. Parity:
reference det3d/datasets/kitti/kitti.py:16-242.

Loads ``kitti_infos_*.pkl``, yields pipeline seed dicts, converts the
predict step's detections back to KITTI camera-frame annos (incl.
projected 2D bboxes), and evaluates with the official AP kernels (eval.py
here)."""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.core import box_np
from det3d_tpu_torch.datasets.custom import PointCloudDataset
from det3d_tpu_torch.datasets.kitti import kitti_common
from det3d_tpu_torch.datasets.kitti.eval import (
    get_coco_eval_result, get_official_eval_result)
from det3d_tpu_torch.datasets.registry import DATASETS


@DATASETS.register_module
class KittiDataset(PointCloudDataset):
    NumPointFeatures = 4

    def __init__(self, root_path, info_path, cfg=None, pipeline=None,
                 class_names=None, test_mode=False, **kwargs):
        super().__init__(root_path, info_path, pipeline,
                         test_mode=test_mode, class_names=class_names)
        with open(self._info_path, "rb") as f:
            self._kitti_infos = pickle.load(f)
        self._num_point_features = self.NumPointFeatures
        self._class_names = class_names

    def __len__(self):
        return len(self._kitti_infos)

    @property
    def num_point_features(self):
        return self._num_point_features

    @property
    def ground_truth_annotations(self):
        if "annos" not in self._kitti_infos[0]:
            return None
        return [info["annos"] for info in self._kitti_infos]

    def get_sensor_data(self, idx):
        info = self._kitti_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None, "annotations": None},
            "metadata": {
                "image_prefix": str(self._root_path),
                "num_point_features": self._num_point_features,
                "image_idx": info["image"]["image_idx"],
                "image_shape": info["image"]["image_shape"],
                "token": str(info["image"]["image_idx"]),
            },
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
        }
        return res, info

    def convert_detection_to_kitti_annos(self, detection):
        """detection: {token: {box3d_lidar, scores, label_preds}} (numpy,
        already unpadded). Parity: kitti.py:78-158."""
        class_names = self._class_names
        annos = []
        empty_det = {"box3d_lidar": np.zeros((0, 7), np.float32),
                     "scores": np.zeros((0,), np.float32),
                     "label_preds": np.zeros((0,), np.int64)}
        missing = [str(info["image"]["image_idx"])
                   for info in self._kitti_infos
                   if str(info["image"]["image_idx"]) not in detection]
        if missing:
            # a token with no detection entry means the predict loop never
            # saw that example — almost certainly an eval-pipeline bug, not
            # a scan with zero objects (those yield an empty but PRESENT
            # entry). Evaluate anyway (as the reference does), but loudly.
            logging.getLogger("det3d").warning(
                "convert_detection_to_kitti_annos: %d/%d val tokens have no "
                "detection entry (first few: %s) — treating them as empty. "
                "This usually indicates a broken eval loop, not empty scans.",
                len(missing), len(self._kitti_infos), missing[:5])
        for info in self._kitti_infos:
            token = str(info["image"]["image_idx"])
            det = detection.get(token, empty_det)
            calib = info["calib"]
            rect = calib["R0_rect"]
            Trv2c = calib["Tr_velo_to_cam"]
            P2 = calib["P2"]
            final_box_preds = np.asarray(det["box3d_lidar"], np.float64)
            label_preds = np.asarray(det["label_preds"]).astype(np.int64)
            scores = np.asarray(det["scores"], np.float64)

            anno = kitti_common.get_start_result_anno()
            num_example = 0
            if final_box_preds.shape[0] != 0:
                final_box_preds = final_box_preds.copy()
                final_box_preds[:, -1] = box_np.limit_period(
                    final_box_preds[:, -1], offset=0.5, period=np.pi * 2)
                final_box_preds[:, 2] -= final_box_preds[:, 5] / 2
                box3d_camera = box_np.box_lidar_to_camera(
                    final_box_preds, rect, Trv2c)
                corners = box_np.center_to_corner_box3d(
                    box3d_camera[:, :3], box3d_camera[:, 3:6],
                    box3d_camera[:, 6], origin=[0.5, 1.0, 0.5], axis=1)
                corners_img = box_np.project_to_image(corners, P2)
                minxy = corners_img.min(axis=1)
                maxxy = corners_img.max(axis=1)
                bbox = np.concatenate([minxy, maxxy], axis=1)
                image_shape = info["image"]["image_shape"]
                for j in range(box3d_camera.shape[0]):
                    if bbox[j, 0] > image_shape[1] \
                            or bbox[j, 1] > image_shape[0]:
                        continue
                    if bbox[j, 2] < 0 or bbox[j, 3] < 0:
                        continue
                    bbox[j, 2:] = np.minimum(
                        bbox[j, 2:], image_shape[::-1])
                    bbox[j, :2] = np.maximum(bbox[j, :2], [0, 0])
                    anno["bbox"].append(bbox[j])
                    anno["alpha"].append(
                        -np.arctan2(-final_box_preds[j, 1],
                                    final_box_preds[j, 0])
                        + box3d_camera[j, 6])
                    anno["dimensions"].append(box3d_camera[j, 3:6])
                    anno["location"].append(box3d_camera[j, :3])
                    anno["rotation_y"].append(box3d_camera[j, 6])
                    anno["name"].append(class_names[int(label_preds[j])])
                    anno["truncated"].append(0.0)
                    anno["occluded"].append(0)
                    anno["score"].append(scores[j])
                    num_example += 1
            if num_example != 0:
                anno = {k: np.stack(v) for k, v in anno.items()}
            else:
                anno = kitti_common.empty_result_anno()
            anno["metadata"] = {"token": token}
            annos.append(anno)
        return annos

    def evaluation(self, detections, output_dir=None):
        """Parity: kitti.py:160-194 — official 11-pt AP + COCO-style AP."""
        gt_annos = self.ground_truth_annotations
        dt_annos = self.convert_detection_to_kitti_annos(detections)
        result_str, result_dict = get_official_eval_result(
            gt_annos, dt_annos, self._class_names)
        coco_str, coco_dict = get_coco_eval_result(
            gt_annos, dt_annos, self._class_names)
        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / "kitti_eval.txt").write_text(result_str + "\n" + coco_str)
        return {
            "results": {"official": result_str, "coco": coco_str},
            "detail": {"eval.kitti": {"official": result_dict,
                                      "coco": coco_dict}},
        }, dt_annos
