"""Minimal devkit-free reader for the nuScenes relational tables.

The port's copy of det3d_tpu/datasets/nuscenes/tables.py, kept line for
line (host code in both packages, no torch), so that both give the same
results.

The reference depends on the external ``nuscenes-devkit``
(det3d/datasets/nuscenes/nusc_common.py imports NuScenes/Quaternion); this
module reads the raw JSON tables directly and provides the few accessors the
info-creation path needs (token lookup, transform matrices, box velocity).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

TABLE_NAMES = [
    "category", "attribute", "sensor", "calibrated_sensor", "ego_pose",
    "scene", "sample", "sample_data", "sample_annotation", "instance",
]


def quat_to_rotmat(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)]])


def quaternion_yaw(q) -> float:
    """Yaw of a z-up box quaternion (parity: nusc_common.py:545-559)."""
    v = quat_to_rotmat(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def yaw_to_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def transform_matrix(translation, rotation_quat, inverse=False) -> np.ndarray:
    """4x4 homogeneous transform (devkit geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    rot = quat_to_rotmat(rotation_quat)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation, np.float64)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = np.asarray(translation, np.float64)
    return tm


class NuScenesTables:
    """Token-indexed access over the raw JSON tables of one version dir."""

    def __init__(self, root_path, version="v1.0-trainval"):
        self.root_path = Path(root_path)
        self.version = version
        table_dir = self.root_path / version
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in TABLE_NAMES:
            path = table_dir / f"{name}.json"
            recs = json.loads(path.read_text()) if path.exists() else []
            self._tables[name] = recs
            self._index[name] = {r["token"]: r for r in recs}
        self._build_reverse_index()

    def _build_reverse_index(self):
        """Derive sample['data'][channel] and sample['anns'] like the devkit
        (the raw sample.json does not carry them)."""
        for sample in self._tables["sample"]:
            sample.setdefault("data", {})
            sample.setdefault("anns", [])
        for sd in self._tables["sample_data"]:
            if not sd.get("is_key_frame", False):
                continue
            cs = self._index["calibrated_sensor"][
                sd["calibrated_sensor_token"]]
            channel = self._index["sensor"][cs["sensor_token"]]["channel"]
            sample = self._index["sample"][sd["sample_token"]]
            sample["data"].setdefault(channel, sd["token"])
        for ann in self._tables["sample_annotation"]:
            self._index["sample"][ann["sample_token"]]["anns"].append(
                ann["token"])

    def table(self, name) -> List[dict]:
        return self._tables[name]

    def get(self, name, token) -> dict:
        return self._index[name][token]

    # -- derived accessors -------------------------------------------------
    def box_name(self, ann: dict) -> str:
        if "category_name" in ann:
            return ann["category_name"]
        inst = self.get("instance", ann["instance_token"])
        return self.get("category", inst["category_token"])["name"]

    def data_path(self, sample_data_token) -> str:
        return str(self.root_path
                   / self.get("sample_data", sample_data_token)["filename"])

    def box_velocity(self, ann_token, max_time_diff=1.5) -> np.ndarray:
        """Global-frame velocity by annotation finite difference (devkit
        NuScenes.box_velocity): uses prev/next of the same instance, nan if
        neither neighbor is within max_time_diff."""
        current = self.get("sample_annotation", ann_token)
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = (self.get("sample_annotation", current["prev"])
                 if has_prev else current)
        last = (self.get("sample_annotation", current["next"])
                if has_next else current)
        pos_first = np.asarray(first["translation"], np.float64)
        pos_last = np.asarray(last["translation"], np.float64)
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt

    def boxes_in_sensor_frame(self, sample_data_token):
        """Keyframe annotations transformed into the sensor frame.

        Returns list of dicts {center, wlh, yaw, velocity, name, token}
        (devkit get_sample_data equivalent)."""
        sd = self.get("sample_data", sample_data_token)
        sample = self.get("sample", sd["sample_token"])
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = self.get("ego_pose", sd["ego_pose_token"])
        r_sensor = quat_to_rotmat(cs["rotation"])
        t_sensor = np.asarray(cs["translation"], np.float64)
        r_ego = quat_to_rotmat(pose["rotation"])
        t_ego = np.asarray(pose["translation"], np.float64)

        out = []
        for ann_token in sample["anns"]:
            ann = self.get("sample_annotation", ann_token)
            center = np.asarray(ann["translation"], np.float64)
            rot = quat_to_rotmat(ann["rotation"])
            vel = self.box_velocity(ann_token)
            # global -> ego -> sensor
            center = r_ego.T @ (center - t_ego)
            center = r_sensor.T @ (center - t_sensor)
            rot = r_sensor.T @ r_ego.T @ rot
            vel3 = r_sensor.T @ (r_ego.T @ vel)
            yaw = float(np.arctan2(rot[1, 0], rot[0, 0]))
            out.append({
                "center": center,
                "wlh": np.asarray(ann["size"], np.float64),
                "yaw": yaw,
                "velocity": vel3,
                "name": self.box_name(ann),
                "token": ann_token,
                "num_lidar_pts": ann.get("num_lidar_pts", -1),
                "num_radar_pts": ann.get("num_radar_pts", 0),
                "attribute_tokens": ann.get("attribute_tokens", []),
            })
        return out
