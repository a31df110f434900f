"""Point-cloud / annotation loading stages.

Port of det3d_tpu/datasets/pipelines/loading.py. Parity: reference
det3d/datasets/pipelines/loading.py — ``LoadPointCloudFromFile`` (:66,
KITTI velodyne_reduced preference, nuScenes multi-sweep concat with
per-point time-lag channel), ``LoadPointCloudAnnotations`` (:167, KITTI
camera->lidar box conversion with bottom-center -> true-center shift).

nuScenes and Lyft examples carry 6 columns a point, as the JAX package's
do: the 5 of the ``.bin`` that ``read_file`` keeps (xyz, intensity, the
ring index) and the time lag. The reference reads 4 plus the time lag
(ROADMAP queue 3). The past sweeps are drawn with ``np.random.choice`` on
the global stream, the same draw in the same order as the JAX package's,
so that a seeded run picks the same sweeps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from det3d_tpu_torch.core import box_np
from det3d_tpu_torch.datasets.registry import PIPELINES


def read_file(path, num_features=5, painted=False):
    """nuScenes .bin reader: (N, 5) xyzit, intensity kept, retries once.
    Parity: loading.py:17-31."""
    for _ in range(2):
        try:
            pts = np.fromfile(path, dtype=np.float32)
            return pts.reshape(-1, 5)[:, :num_features]
        except Exception:
            continue
    return None


def read_sweep(sweep):
    """Load one past sweep and transform into the keyframe. loading.py:34-48."""
    points_sweep = read_file(str(sweep["lidar_path"]))
    if points_sweep is None:
        return None, None
    nbr = points_sweep.shape[0]
    if sweep["transform_matrix"] is not None:
        pts = np.concatenate(
            [points_sweep[:, :3], np.ones((nbr, 1))], axis=1)
        points_sweep[:, :3] = (pts @ sweep["transform_matrix"].T)[:, :3]
    times = sweep["time_lag"] * np.ones((nbr, 1), np.float32)
    return points_sweep, times


@PIPELINES.register_module
class LoadPointCloudFromFile:
    def __init__(self, dataset="KittiDataset", **kwargs):
        self.type = dataset

    def __call__(self, res, info):
        res["type"] = self.type

        if self.type == "KittiDataset":
            pc_info = info["point_cloud"]
            velo_path = Path(pc_info["velodyne_path"])
            if not velo_path.is_absolute():
                velo_path = Path(
                    res["metadata"]["image_prefix"]) / pc_info["velodyne_path"]
            reduced = (velo_path.parent.parent
                       / (velo_path.parent.stem + "_reduced") / velo_path.name)
            if reduced.exists():
                velo_path = reduced
            points = np.fromfile(
                str(velo_path), dtype=np.float32).reshape(
                    -1, res["metadata"]["num_point_features"])
            res["lidar"]["points"] = points

        elif self.type in ("NuScenesDataset", "LyftDataset"):
            nsweeps = res["lidar"]["nsweeps"]
            points = read_file(str(info["lidar_path"]))
            sweep_points = [points]
            sweep_times = [np.zeros((points.shape[0], 1), np.float32)]
            if nsweeps > 1:
                assert (nsweeps - 1) <= len(info["sweeps"]), (
                    f"nsweeps {nsweeps} > available {len(info['sweeps'])}")
                rng = np.random
                for i in rng.choice(len(info["sweeps"]), nsweeps - 1,
                                    replace=False):
                    pts_s, times_s = read_sweep(info["sweeps"][i])
                    if pts_s is not None:
                        sweep_points.append(pts_s)
                        sweep_times.append(times_s)
            points = np.concatenate(sweep_points, axis=0)
            times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
            res["lidar"]["points"] = points
            res["lidar"]["times"] = times
            res["lidar"]["combined"] = np.hstack([points, times])
        else:
            raise NotImplementedError(self.type)
        return res, info


@PIPELINES.register_module
class LoadPointCloudAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        pass

    def __call__(self, res, info):
        if res["type"] in ("NuScenesDataset", "LyftDataset") \
                and "gt_boxes" in info:
            res["lidar"]["annotations"] = {
                "boxes": info["gt_boxes"].astype(np.float32),
                "names": info["gt_names"],
                "tokens": info.get("gt_boxes_token"),
                "velocities": info.get("gt_boxes_velocity"),
            }
        elif res["type"] == "KittiDataset":
            calib = info["calib"]
            res["calib"] = {
                "rect": calib["R0_rect"],
                "Trv2c": calib["Tr_velo_to_cam"],
                "P2": calib["P2"],
            }
            if "annos" in info:
                annos = _remove_dontcare(info["annos"])
                locs = annos["location"]
                dims = annos["dimensions"]
                rots = annos["rotation_y"]
                gt_boxes = np.concatenate(
                    [locs, dims, rots[..., None]], axis=1).astype(np.float32)
                gt_boxes = box_np.box_camera_to_lidar(
                    gt_boxes, calib["R0_rect"], calib["Tr_velo_to_cam"])
                # KITTI [0.5, 0.5, 0] bottom-center -> true center
                box_np.change_box3d_center_(
                    gt_boxes, [0.5, 0.5, 0], [0.5, 0.5, 0.5])
                res["lidar"]["annotations"] = {
                    "boxes": gt_boxes,
                    "names": annos["name"],
                    "difficulty": annos.get("difficulty"),
                }
                res["cam"]["annotations"] = {
                    "boxes": annos["bbox"], "names": annos["name"]}
        return res, info


def _remove_dontcare(annos):
    keep = [i for i, n in enumerate(annos["name"]) if n != "DontCare"]
    out = {}
    for k, v in annos.items():
        if isinstance(v, np.ndarray) and v.shape[:1] == annos["name"].shape:
            out[k] = v[keep]
        else:
            out[k] = v
    return out
