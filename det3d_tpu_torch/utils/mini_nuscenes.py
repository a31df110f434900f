"""Synthetic mini-nuScenes raw tree (JSON tables + lidar bins).

The port's copy of the JAX package's tests/mini_nuscenes.py, on the port's
``yaw_to_quat``, so that chip_smoke.py and the port's tests write the same
tree without the JAX package. At its defaults ``make_tree`` writes the
same files byte for byte; ``clutter`` sets the clutter points a sweep
(1500 there), so that a 10-sweep scan can reach nuScenes' scan size:

    from det3d_tpu_torch.utils import mini_nuscenes as mn
    mn.make_tree(root, n_scenes=10, sweeps_between=9, clutter=29800)
    # then the infos and the gt database:
    # python -m det3d_tpu_torch.cli create_data nuscenes_data_prep \
    #     --root_path ROOT --version v1.0-mini-synth

``lyft_categories(root)`` renames the tree's two categories to Lyft's
names (``car``, ``pedestrian``), which Lyft's tables use and its
shipped config's tasks name.
"""

import json
from pathlib import Path

import numpy as np

from det3d_tpu_torch.datasets.nuscenes.tables import yaw_to_quat

VERSION = "v1.0-mini-synth"
LIDAR_T = [0.9, 0.0, 1.8]

# per scene: (name, class, start_xy_global, yaw, velocity_xy, size_wlh)
OBJECTS = [
    ("car_a", "vehicle.car", (10.0, 2.0), 0.3, (2.0, 0.0),
     (1.95, 4.6, 1.72)),
    ("car_b", "vehicle.car", (15.0, -4.0), -0.5, (0.0, 0.0),
     (1.90, 4.4, 1.70)),
    ("ped_a", "human.pedestrian.adult", (6.0, -2.0), 1.0, (0.5, 0.5),
     (0.66, 0.72, 1.75)),
]


def _tok(*parts):
    return "_".join(str(p) for p in parts)


def make_tree(root, n_scenes=2, keyframes=4, sweeps_between=2, seed=0,
              clutter=1500):
    """Returns {sample_token: [gt dicts in sensor frame]} for checking."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / VERSION).mkdir(parents=True, exist_ok=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)

    sensor = [{"token": "sensor_lidar", "channel": "LIDAR_TOP",
               "modality": "lidar"}]
    calibrated = [{"token": "cs_lidar", "sensor_token": "sensor_lidar",
                   "translation": LIDAR_T, "rotation": [1, 0, 0, 0],
                   "camera_intrinsic": []}]
    categories = [
        {"token": "cat_car", "name": "vehicle.car"},
        {"token": "cat_ped", "name": "human.pedestrian.adult"},
    ]
    cat_by_name = {c["name"]: c["token"] for c in categories}
    attributes = [
        {"token": "attr_moving", "name": "vehicle.moving"},
        {"token": "attr_parked", "name": "vehicle.parked"},
        {"token": "attr_ped_moving", "name": "pedestrian.moving"},
    ]
    scenes, samples, sample_datas, annotations, instances = [], [], [], [], []
    ego_poses = []
    gt_truth = {}

    t0 = 1_000_000_000_000_000  # microseconds
    dt_key = 500_000            # 0.5 s between keyframes
    dt_sweep = dt_key // (sweeps_between + 1)

    for s in range(n_scenes):
        scene_tok = _tok("scene", s)
        scenes.append({"token": scene_tok, "name": f"scene-{s:04d}",
                       "nbr_samples": keyframes,
                       "first_sample_token": _tok("sample", s, 0),
                       "last_sample_token": _tok("sample", s, keyframes - 1)})
        for name, cat, _, _, _, _ in OBJECTS:
            instances.append({
                "token": _tok("inst", s, name),
                "category_token": cat_by_name[cat],
                "nbr_annotations": keyframes,
                "first_annotation_token": _tok("ann", s, 0, name),
                "last_annotation_token": _tok("ann", s, keyframes - 1, name),
            })

        prev_sd = ""
        for k in range(keyframes):
            t_key = t0 + s * 100 * dt_key + k * dt_key
            sample_tok = _tok("sample", s, k)
            samples.append({
                "token": sample_tok,
                "timestamp": t_key,
                "scene_token": scene_tok,
                "prev": _tok("sample", s, k - 1) if k else "",
                "next": _tok("sample", s, k + 1) if k < keyframes - 1 else "",
            })

            # intermediate (non-key) sweeps preceding this keyframe
            frames = []
            if k > 0:
                for j in range(sweeps_between):
                    frames.append(
                        (t_key - (sweeps_between - j) * dt_sweep, False, j))
            frames.append((t_key, True, sweeps_between))

            for t_frame, is_key, j in frames:
                sd_tok = _tok("sd", s, k, j)
                ego_x = 2.0 * (t_frame - t0) * 1e-6    # ego moves +x at 2m/s
                pose_tok = _tok("pose", s, k, j)
                folder = "samples" if is_key else "sweeps"
                fname = f"{folder}/LIDAR_TOP/{sd_tok}.bin"
                sample_datas.append({
                    "token": sd_tok,
                    "sample_token": sample_tok,
                    "ego_pose_token": pose_tok,
                    "calibrated_sensor_token": "cs_lidar",
                    "timestamp": t_frame,
                    "fileformat": "bin",
                    "is_key_frame": is_key,
                    "filename": fname,
                    "prev": prev_sd,
                    "next": "",
                })
                prev_sd = sd_tok
                # ego_pose table rows share the sample_data token space
                sample_datas_pose = {
                    "token": pose_tok,
                    "translation": [ego_x, 0.0, 0.0],
                    "rotation": [1, 0, 0, 0],
                    "timestamp": t_frame,
                }
                ego_poses.append(sample_datas_pose)

                # write the lidar bin (sensor frame)
                pts = _scene_points(rng, s, t_frame, t0, ego_x, clutter)
                pts.astype(np.float32).tofile(root / fname)

            # keyframe annotations
            gt_truth[sample_tok] = []
            for name, cat, (x0, y0), yaw, (vx, vy), wlh in OBJECTS:
                t_rel = (t_key - t0) * 1e-6 - s * 50.0
                gx = x0 + vx * t_rel + s * 100.0   # scenes far apart
                gy = y0 + vy * t_rel
                ego_x = 2.0 * (t_key - t0) * 1e-6
                annotations.append({
                    "token": _tok("ann", s, k, name),
                    "sample_token": sample_tok,
                    "instance_token": _tok("inst", s, name),
                    "translation": [gx, gy, wlh[2] / 2],
                    "size": list(wlh),
                    "rotation": yaw_to_quat(yaw),
                    "num_lidar_pts": 50,
                    "num_radar_pts": 0,
                    "attribute_tokens": ["attr_moving"]
                    if (vx, vy) != (0.0, 0.0) and cat == "vehicle.car"
                    else (["attr_parked"] if cat == "vehicle.car"
                          else ["attr_ped_moving"]),
                    "visibility_token": "4",
                    "prev": _tok("ann", s, k - 1, name) if k else "",
                    "next": _tok("ann", s, k + 1, name)
                    if k < keyframes - 1 else "",
                })
                # sensor-frame truth for assertions
                sx = gx - ego_x - LIDAR_T[0]
                sy = gy - LIDAR_T[1]
                sz = wlh[2] / 2 - LIDAR_T[2]
                gt_truth[sample_tok].append({
                    "center": (sx, sy, sz), "wlh": wlh, "yaw": yaw,
                    "velocity": (vx, vy), "name": cat,
                })

    tables = {
        "sensor": sensor, "calibrated_sensor": calibrated,
        "category": categories, "attribute": attributes,
        "ego_pose": ego_poses, "scene": scenes, "sample": samples,
        "sample_data": sample_datas, "sample_annotation": annotations,
        "instance": instances,
    }
    for name, recs in tables.items():
        (root / VERSION / f"{name}.json").write_text(json.dumps(recs))
    (root / "splits.json").write_text(json.dumps(
        {"train": [f"scene-{i:04d}" for i in range(n_scenes // 2)],
         "val": [f"scene-{i:04d}" for i in range(n_scenes // 2, n_scenes)]}))
    return gt_truth


def _scene_points(rng, scene_idx, t_frame, t0, ego_x, clutter=1500):
    """Points in the sensor frame: object clusters + clutter, 5 channels."""
    pts = []
    t_rel = (t_frame - t0) * 1e-6 - scene_idx * 50.0
    for name, cat, (x0, y0), yaw, (vx, vy), wlh in OBJECTS:
        gx = x0 + vx * t_rel + scene_idx * 100.0
        gy = y0 + vy * t_rel
        k = 60
        local = rng.uniform(-0.45, 0.45, (k, 3)) * [wlh[0], wlh[1], wlh[2]]
        c, s = np.cos(yaw), np.sin(yaw)
        x = local[:, 1] * c - local[:, 0] * s + gx - ego_x - LIDAR_T[0]
        y = local[:, 1] * s + local[:, 0] * c + gy - LIDAR_T[1]
        z = local[:, 2] + wlh[2] / 2 - LIDAR_T[2]
        pts.append(np.stack(
            [x, y, z, rng.uniform(0, 100, k), np.zeros(k)], -1))
    n = clutter
    clutter = np.stack([
        rng.uniform(-30, 30, n), rng.uniform(-30, 30, n),
        rng.uniform(-2.0, 0.5, n), rng.uniform(0, 100, n),
        np.zeros(n)], -1)
    return np.concatenate(pts + [clutter])


def lyft_categories(root):
    """Rename the tree's categories to Lyft's (``car``, ``pedestrian``):
    Lyft's infos keep the tables' names as they are."""
    path = Path(root) / VERSION / "category.json"
    cats = json.loads(path.read_text())
    lyft = {"vehicle.car": "car", "human.pedestrian.adult": "pedestrian"}
    path.write_text(json.dumps([dict(c, name=lyft[c["name"]])
                                for c in cats]))
