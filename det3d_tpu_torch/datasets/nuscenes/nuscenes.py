"""nuScenes dataset with CBGS class-balanced resampling and native eval.

The port's copy of det3d_tpu/datasets/nuscenes/nuscenes.py, kept line for
line (host code in both packages, no torch), so that both give the same
results.

Parity: reference det3d/datasets/nuscenes/nuscenes.py:29-319 —
10-sweep loading (via pipelines/loading.py here), CBGS resampling at
info-load time (:72-102, duplicates scene infos so each of the 10 classes
is ~1/10 of the epoch), velocity + attribute assignment heuristics
(:223-259), evaluation via the official devkit there / the native
re-implementation in nusc_eval.py here (same published algorithm).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.datasets.custom import PointCloudDataset
from det3d_tpu_torch.datasets.nuscenes import nusc_eval
from det3d_tpu_torch.datasets.registry import DATASETS

# velocity-threshold attribute heuristic + per-class priors
# (reference nuscenes.py:223-259 + cls_attr_dist argmax)
DEFAULT_ATTR = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "trailer": "vehicle.parked", "bus": "vehicle.stopped",
    "construction_vehicle": "vehicle.parked",
    "pedestrian": "pedestrian.standing",
    "motorcycle": "cycle.without_rider", "bicycle": "cycle.without_rider",
    "traffic_cone": "", "barrier": "",
}
MOVING_ATTR = {
    "car": "vehicle.moving", "truck": "vehicle.moving",
    "trailer": "vehicle.moving", "bus": "vehicle.moving",
    "construction_vehicle": "vehicle.moving",
    "pedestrian": "pedestrian.moving",
    "motorcycle": "cycle.with_rider", "bicycle": "cycle.with_rider",
}


@DATASETS.register_module
class NuScenesDataset(PointCloudDataset):
    # the .bin's columns read (xyz, intensity, ring index); the examples
    # append the time lag: 6 in all (pipelines/loading.py)
    NumPointFeatures = 5

    def __init__(self, root_path, info_path, pipeline=None,
                 class_names=None, test_mode=False, nsweeps=10,
                 balanced_resample=None, **kwargs):
        super().__init__(root_path, info_path, pipeline,
                         test_mode=test_mode, class_names=class_names)
        self.nsweeps = int(nsweeps)
        with open(info_path, "rb") as f:
            infos_all = pickle.load(f)
        if balanced_resample is None:
            balanced_resample = not test_mode
        if balanced_resample and class_names:
            self._nusc_infos = self._balance(infos_all, class_names)
        else:
            self._nusc_infos = infos_all
        self._num_point_features = self.NumPointFeatures

    def _balance(self, infos, class_names):
        """CBGS resampling (reference nuscenes.py:72-102)."""
        cls_infos = {name: [] for name in class_names}
        for info in infos:
            for name in set(info["gt_names"].tolist()):
                if name in class_names:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(class_names)
        out = []
        rng = np.random.RandomState(0)
        for name, v in cls_infos.items():
            if not v:
                continue
            ratio = frac / (len(v) / duplicated)
            picks = rng.choice(len(v), int(len(v) * ratio))
            out += [v[i] for i in picks]
        return out

    def __len__(self):
        return len(self._nusc_infos)

    @property
    def num_point_features(self):
        return self._num_point_features

    def get_sensor_data(self, idx):
        info = self._nusc_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None, "nsweeps": self.nsweeps,
                      "annotations": None},
            "metadata": {
                "image_prefix": str(self._root_path),
                "num_point_features": self._num_point_features,
                "token": info["token"],
            },
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
        }
        return res, info

    # -- evaluation --------------------------------------------------------
    def _gt_eval_boxes(self):
        gt = {}
        for info in self._nusc_infos:
            boxes = []
            for i, b in enumerate(np.asarray(info["gt_boxes"])):
                name = str(info["gt_names"][i])
                if name == "ignore":
                    continue
                boxes.append({
                    "translation": b[:3].tolist(),
                    "size": b[3:6].tolist(),
                    "yaw": float(-b[-1] - np.pi / 2),
                    "velocity": np.asarray(
                        info["gt_boxes_velocity"][i][:2]).tolist(),
                    "name": name,
                    "attribute_name": (str(info["gt_attributes"][i])
                                       if "gt_attributes" in info else ""),
                    "num_pts": int(info["gt_num_pts"][i])
                    if "gt_num_pts" in info else 1,
                })
            gt[info["token"]] = boxes
        return gt

    @staticmethod
    def _attr_for(name, velocity):
        speed = float(np.hypot(velocity[0], velocity[1]))
        if speed > 0.2 and name in MOVING_ATTR:
            return MOVING_ATTR[name]
        return DEFAULT_ATTR.get(name, "")

    def _det_eval_boxes(self, detections):
        preds = {}
        for info in self._nusc_infos:
            token = info["token"]
            det = detections.get(token)
            boxes = []
            if det is not None:
                box3d = np.asarray(det["box3d_lidar"])
                scores = np.asarray(det["scores"])
                labels = np.asarray(det["label_preds"]).astype(int)
                for i in range(box3d.shape[0]):
                    name = self._class_names[labels[i]]
                    vel = (box3d[i, 6:8].tolist()
                           if box3d.shape[1] > 7 else [0.0, 0.0])
                    boxes.append({
                        "translation": box3d[i, :3].tolist(),
                        "size": box3d[i, 3:6].tolist(),
                        "yaw": float(-box3d[i, -1] - np.pi / 2),
                        "velocity": vel,
                        "detection_name": name,
                        "detection_score": float(scores[i]),
                        "attribute_name": self._attr_for(name, vel),
                    })
            preds[token] = boxes
        return preds

    def evaluation(self, detections, output_dir=None):
        gt = self._gt_eval_boxes()
        preds = self._det_eval_boxes(detections)
        metrics = nusc_eval.evaluate(gt, preds, self._class_names)

        lines = [
            f"mAP: {metrics['mean_ap']:.4f}",
            f"mATE: {metrics['tp_errors']['trans_err']:.4f}",
            f"mASE: {metrics['tp_errors']['scale_err']:.4f}",
            f"mAOE: {metrics['tp_errors']['orient_err']:.4f}",
            f"mAVE: {metrics['tp_errors']['vel_err']:.4f}",
            f"mAAE: {metrics['tp_errors']['attr_err']:.4f}",
            f"NDS: {metrics['nd_score']:.4f}",
        ]
        for cls, aps in metrics["label_aps"].items():
            lines.append(
                f"{cls}: " + " ".join(f"AP@{d}={v:.3f}"
                                      for d, v in aps.items()))
        result_str = "\n".join(lines)
        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / "metrics_summary.json").write_text(
                json.dumps(metrics, default=float, indent=2))
        return {
            "results": {"nusc": result_str},
            "detail": {"eval.nusc": metrics},
        }, None
