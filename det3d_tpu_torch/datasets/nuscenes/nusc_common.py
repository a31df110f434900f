"""nuScenes info-pkl creation and name mapping (devkit-free).

The port's copy of det3d_tpu/datasets/nuscenes/nusc_common.py, kept line
for line (host code in both packages, no torch), so that both give the same
results.

Parity: reference det3d/datasets/nuscenes/nusc_common.py —
``general_to_detection`` (:20), ``create_nuscenes_infos`` (:625),
``_fill_trainval_infos`` (:372: per-keyframe lidar path, (nsweeps-1) past
sweeps with composed ref_from_car @ car_from_global @ global_from_car @
car_from_current transforms + time lags, gt boxes in the lidar frame as
[x y z w l h vx vy  -yaw - pi/2], zero-point filtering).

Scene splits: the official trainval split lives in the devkit
(nuscenes.utils.splits). If the devkit is importable we use it; otherwise
pass ``splits`` = {"train": [scene names...], "val": [...]} or drop a
``splits.json`` with those keys in the dataset root. v1.0-mini falls back to
the embedded mini split.
"""

from __future__ import annotations

import json
import pickle
from functools import reduce
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from det3d_tpu_torch.datasets.nuscenes.tables import (
    NuScenesTables, transform_matrix)

general_to_detection = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

MINI_TRAIN = ["scene-0061", "scene-0553", "scene-0655", "scene-0757",
              "scene-0796", "scene-1077", "scene-1094", "scene-1100"]
MINI_VAL = ["scene-0103", "scene-0916"]


def _resolve_splits(root_path, version, splits: Optional[Dict] = None):
    if splits is not None:
        return splits
    sp_file = Path(root_path) / "splits.json"
    if sp_file.exists():
        return json.loads(sp_file.read_text())
    if "mini" in version:
        return {"train": MINI_TRAIN, "val": MINI_VAL}
    try:
        from nuscenes.utils import splits as nusc_splits
        return {"train": nusc_splits.train, "val": nusc_splits.val}
    except ImportError:
        raise RuntimeError(
            "No nuscenes-devkit and no splits given: pass splits= or put a "
            "splits.json with {'train': [...scene names], 'val': [...]} in "
            "the dataset root.")


def _fill_infos(nusc: NuScenesTables, train_scene_tokens, test=False,
                nsweeps=10, name_map=None):
    if name_map is None:
        name_map = general_to_detection
    train_infos, val_infos = [], []
    for sample in nusc.table("sample"):
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd = nusc.get("sample_data", ref_sd_token)
        ref_cs = nusc.get("calibrated_sensor",
                          ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_lidar_path = nusc.data_path(ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs["translation"], ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(
            ref_pose["translation"], ref_pose["rotation"], inverse=True)

        info = {
            "lidar_path": ref_lidar_path,
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        curr_sd = ref_sd
        sweeps = []
        while len(sweeps) < nsweeps - 1:
            if curr_sd["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": ref_lidar_path,
                        "sample_data_token": curr_sd["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd = nusc.get("sample_data", curr_sd["prev"])
                curr_pose = nusc.get("ego_pose", curr_sd["ego_pose_token"])
                global_from_car = transform_matrix(
                    curr_pose["translation"], curr_pose["rotation"],
                    inverse=False)
                curr_cs = nusc.get("calibrated_sensor",
                                   curr_sd["calibrated_sensor_token"])
                car_from_current = transform_matrix(
                    curr_cs["translation"], curr_cs["rotation"],
                    inverse=False)
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": nusc.data_path(curr_sd["token"]),
                    "sample_data_token": curr_sd["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr_sd["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            boxes = nusc.boxes_in_sensor_frame(ref_sd_token)
            anns = [nusc.get("sample_annotation", t)
                    for t in sample["anns"]]
            mask = np.array(
                [(a.get("num_lidar_pts", 1) + a.get("num_radar_pts", 0)) > 0
                 for a in anns], bool).reshape(-1)
            locs = np.array([b["center"] for b in boxes]).reshape(-1, 3)
            dims = np.array([b["wlh"] for b in boxes]).reshape(-1, 3)
            velocity = np.array([b["velocity"] for b in boxes]).reshape(-1, 3)
            velocity = np.nan_to_num(velocity)
            rots = np.array([b["yaw"] for b in boxes]).reshape(-1, 1)
            names = np.array([b["name"] for b in boxes])
            tokens = np.array([b["token"] for b in boxes])
            gt_boxes = np.concatenate(
                [locs, dims, velocity[:, :2], -rots - np.pi / 2], axis=1)
            attrs = []
            for b in boxes:
                toks = b.get("attribute_tokens") or []
                attrs.append(
                    nusc.get("attribute", toks[0])["name"] if toks else "")
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = np.array(
                [name_map.get(n, n) for n in names])[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["gt_attributes"] = np.array(attrs)[mask]
            info["gt_num_pts"] = np.array(
                [a.get("num_lidar_pts", 1) + a.get("num_radar_pts", 0)
                 for a in anns])[mask]

        if sample["scene_token"] in train_scene_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(root_path, version="v1.0-trainval", nsweeps=10,
                          splits: Optional[Dict] = None):
    """Parity: nusc_common.create_nuscenes_infos (:625)."""
    nusc = NuScenesTables(root_path, version)
    split_names = _resolve_splits(root_path, version, splits)
    scene_by_name = {s["name"]: s["token"] for s in nusc.table("scene")}
    train_scene_tokens = {scene_by_name[n] for n in split_names["train"]
                          if n in scene_by_name}
    test = "test" in version
    train_infos, val_infos = _fill_infos(nusc, train_scene_tokens,
                                         test=test, nsweeps=nsweeps)
    root = Path(root_path)
    if test:
        with open(root / f"infos_test_{nsweeps:02d}sweeps_withvelo.pkl",
                  "wb") as f:
            pickle.dump(train_infos + val_infos, f)
        print(f"test infos: {len(train_infos) + len(val_infos)}")
    else:
        with open(root / f"infos_train_{nsweeps:02d}sweeps_withvelo.pkl",
                  "wb") as f:
            pickle.dump(train_infos, f)
        with open(root / f"infos_val_{nsweeps:02d}sweeps_withvelo.pkl",
                  "wb") as f:
            pickle.dump(val_infos, f)
        print(f"train infos: {len(train_infos)}, val: {len(val_infos)}")


def second_box_to_global(info, boxes9, names=None):
    """Lidar-frame [x y z w l h vx vy r] detections -> global-frame dicts.

    Parity: _second_det_to_nusc_box (:222) + _lidar_nusc_box_to_global
    (:243), using the info's stored ref_from_car/car_from_global inverses.
    """
    ref_from_car = info["ref_from_car"]
    car_from_global = info["car_from_global"]
    car_from_ref = np.linalg.inv(ref_from_car)
    global_from_car = np.linalg.inv(car_from_global)
    g_from_ref = global_from_car @ car_from_ref
    rot = g_from_ref[:3, :3]
    trans = g_from_ref[:3, 3]

    out = []
    for i in range(boxes9.shape[0]):
        yaw_nusc = -float(boxes9[i, -1]) - np.pi / 2
        center = rot @ boxes9[i, :3] + trans
        # compose yaw with the frame rotation's yaw (z-up boxes)
        frame_yaw = float(np.arctan2(rot[1, 0], rot[0, 0]))
        vel = rot @ np.array([boxes9[i, 6], boxes9[i, 7], 0.0])
        out.append({
            "translation": center.tolist(),
            "size": boxes9[i, 3:6].tolist(),
            "yaw": yaw_nusc + frame_yaw,
            "velocity": vel[:2].tolist(),
        })
    return out
