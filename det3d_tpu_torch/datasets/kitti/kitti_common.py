"""KITTI label/calib parsing and info-pkl creation; port of
det3d_tpu/datasets/kitti/kitti_common.py (the same files and infos).

Parity: reference det3d/datasets/kitti/kitti_common.py (label parsing
:parse lines, ``get_kitti_image_info``, difficulty assignment
``add_difficulty_to_annos``) and datasets/utils/create_gt_database.py.
Re-written host-side numpy; file formats identical so existing KITTI trees
and pickles interoperate.
"""

from __future__ import annotations

import pickle
from concurrent import futures
from pathlib import Path
from typing import List

import numpy as np

from det3d_tpu_torch.core import augment, box_np


def get_image_index_str(img_idx):
    return "{:06d}".format(img_idx)


def area(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


# ---------------------------------------------------------------------------
# label files
# ---------------------------------------------------------------------------

def get_label_anno(label_path):
    """Parse one KITTI label txt into the standard annos dict."""
    annotations = {k: [] for k in
                   ("name", "truncated", "occluded", "alpha", "bbox",
                    "dimensions", "location", "rotation_y")}
    with open(label_path, "r") as f:
        lines = [line.strip().split(" ") for line in f if line.strip()]
    for x in lines:
        annotations["name"].append(x[0])
        annotations["truncated"].append(float(x[1]))
        annotations["occluded"].append(int(float(x[2])))
        annotations["alpha"].append(float(x[3]))
        annotations["bbox"].append([float(v) for v in x[4:8]])
        # KITTI stores h, w, l; standard anno layout is l, h, w
        annotations["dimensions"].append(
            [float(x[10]), float(x[8]), float(x[9])])
        annotations["location"].append([float(v) for v in x[11:14]])
        annotations["rotation_y"].append(float(x[14]))
    n = len(lines)
    annos = {
        "name": np.array(annotations["name"]),
        "truncated": np.array(annotations["truncated"]),
        "occluded": np.array(annotations["occluded"]),
        "alpha": np.array(annotations["alpha"]),
        "bbox": np.array(annotations["bbox"]).reshape(-1, 4),
        "dimensions": np.array(annotations["dimensions"]).reshape(-1, 3),
        "location": np.array(annotations["location"]).reshape(-1, 3),
        "rotation_y": np.array(annotations["rotation_y"]),
    }
    num_obj = int((annos["name"] != "DontCare").sum())
    annos["score"] = np.zeros((n,))
    annos["index"] = np.concatenate(
        [np.arange(num_obj, dtype=np.int32),
         -np.ones((n - num_obj,), np.int32)])
    annos["group_ids"] = np.arange(n, dtype=np.int32)
    return annos


def get_start_result_anno():
    return {k: [] for k in ("name", "truncated", "occluded", "alpha", "bbox",
                            "dimensions", "location", "rotation_y", "score")}


def empty_result_anno():
    return {
        "name": np.zeros((0,), dtype="<U32"),
        "truncated": np.zeros((0,)),
        "occluded": np.zeros((0,)),
        "alpha": np.zeros((0,)),
        "bbox": np.zeros((0, 4)),
        "dimensions": np.zeros((0, 3)),
        "location": np.zeros((0, 3)),
        "rotation_y": np.zeros((0,)),
        "score": np.zeros((0,)),
    }


# ---------------------------------------------------------------------------
# calib files
# ---------------------------------------------------------------------------

def _extend_matrix(mat):
    return np.concatenate(
        [mat, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def get_calib(calib_path, extend_matrix=True):
    with open(calib_path, "r") as f:
        lines = f.readlines()

    def mat(line, shape):
        return np.array(
            [float(v) for v in line.split(" ")[1:1 + shape[0] * shape[1]]]
        ).reshape(shape)

    P0 = mat(lines[0], (3, 4))
    P1 = mat(lines[1], (3, 4))
    P2 = mat(lines[2], (3, 4))
    P3 = mat(lines[3], (3, 4))
    R0 = mat(lines[4], (3, 3))
    Tr_velo_to_cam = mat(lines[5], (3, 4))
    if extend_matrix:
        P0, P1, P2, P3 = (_extend_matrix(p) for p in (P0, P1, P2, P3))
        Tr_velo_to_cam = _extend_matrix(Tr_velo_to_cam)
        rect_4x4 = np.eye(4)
        rect_4x4[:3, :3] = R0
        R0 = rect_4x4
    return {"P0": P0, "P1": P1, "P2": P2, "P3": P3, "R0_rect": R0,
            "Tr_velo_to_cam": Tr_velo_to_cam}


# ---------------------------------------------------------------------------
# difficulty (official easy/moderate/hard)
# ---------------------------------------------------------------------------

def add_difficulty_to_annos(info):
    """Parity: kitti_common.add_difficulty_to_annos — assigns the EASIEST
    difficulty bucket each object satisfies, -1 if none."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    annos = info["annos"]
    height = annos["bbox"][:, 3] - annos["bbox"][:, 1]
    occlusion = annos["occluded"]
    truncation = annos["truncated"]
    diff = []
    for h, o, t in zip(height, occlusion, truncation):
        if h >= min_height[0] and o <= max_occlusion[0] and t <= max_trunc[0]:
            diff.append(0)
        elif h >= min_height[1] and o <= max_occlusion[1] \
                and t <= max_trunc[1]:
            diff.append(1)
        elif h >= min_height[2] and o <= max_occlusion[2] \
                and t <= max_trunc[2]:
            diff.append(2)
        else:
            diff.append(-1)
    annos["difficulty"] = np.array(diff, np.int32)
    return annos["difficulty"]


# ---------------------------------------------------------------------------
# info creation
# ---------------------------------------------------------------------------

def _read_imageset(path) -> List[int]:
    with open(path, "r") as f:
        return [int(line) for line in f if line.strip()]


def get_kitti_image_info(path, image_ids, training=True, label_info=True,
                         velodyne=True, calib=True, num_workers=8,
                         relative_path=True):
    """Build the per-sample info dicts (image/point_cloud/calib/annos)."""
    root = Path(path)

    def build(idx):
        folder = "training" if training else "testing"
        info = {
            "image": {
                "image_idx": idx,
                "image_path": f"{folder}/image_2/{get_image_index_str(idx)}.png",
                "image_shape": None,
            },
            "point_cloud": {
                "num_features": 4,
                "velodyne_path":
                    f"{folder}/velodyne/{get_image_index_str(idx)}.bin",
            },
        }
        img = root / info["image"]["image_path"]
        if img.exists():
            try:
                import cv2
                shape = cv2.imread(str(img)).shape[:2]
                info["image"]["image_shape"] = np.array(shape, np.int32)
            except Exception:
                pass
        if info["image"]["image_shape"] is None:
            info["image"]["image_shape"] = np.array([375, 1242], np.int32)
        if calib:
            info["calib"] = get_calib(
                root / folder / "calib" / f"{get_image_index_str(idx)}.txt")
        if label_info and training:
            label_path = (root / folder / "label_2"
                          / f"{get_image_index_str(idx)}.txt")
            info["annos"] = get_label_anno(label_path)
            add_difficulty_to_annos(info)
        return info

    with futures.ThreadPoolExecutor(num_workers) as ex:
        infos = list(ex.map(build, image_ids))
    return infos


def _add_num_points_in_gt(root, infos, relative_path=True):
    for info in infos:
        if "annos" not in info:
            continue
        velo = Path(root) / info["point_cloud"]["velodyne_path"]
        points = np.fromfile(str(velo), np.float32).reshape(-1, 4)
        annos = info["annos"]
        num_obj = int((annos["name"] != "DontCare").sum())
        calib = info["calib"]
        loc = annos["location"][:num_obj]
        dims = annos["dimensions"][:num_obj]
        rots = annos["rotation_y"][:num_obj]
        boxes_cam = np.concatenate([loc, dims, rots[..., None]], axis=1)
        boxes_lidar = box_np.box_camera_to_lidar(
            boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
        box_np.change_box3d_center_(boxes_lidar, [0.5, 0.5, 0],
                                    [0.5, 0.5, 0.5])
        counts = augment.points_in_rbbox(points, boxes_lidar).sum(0)
        annos["num_points_in_gt"] = np.concatenate(
            [counts, -np.ones((len(annos["name"]) - num_obj,))]
        ).astype(np.int32)


def create_kitti_info_file(data_path, save_path=None):
    """Parity: tools/create_data.py kitti path. Writes
    kitti_infos_{train,val,trainval,test}.pkl."""
    imageset_dir = Path(data_path) / "ImageSets"
    save_path = Path(save_path or data_path)
    splits = {}
    for split in ("train", "val", "test"):
        f = imageset_dir / f"{split}.txt"
        if f.exists():
            splits[split] = _read_imageset(f)
    for split, ids in splits.items():
        training = split != "test"
        infos = get_kitti_image_info(
            data_path, ids, training=training, label_info=training)
        if training:
            _add_num_points_in_gt(data_path, infos)
        out = save_path / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"kitti infos [{split}]: {len(infos)} -> {out}")
    if "train" in splits and "val" in splits:
        with open(save_path / "kitti_infos_train.pkl", "rb") as f:
            tr = pickle.load(f)
        with open(save_path / "kitti_infos_val.pkl", "rb") as f:
            va = pickle.load(f)
        with open(save_path / "kitti_infos_trainval.pkl", "wb") as f:
            pickle.dump(tr + va, f)


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """Keep lidar points whose projection lands inside the image.

    Parity: box_np_ops.remove_outside_points (:941-952) — the reference
    clips by the camera frustum polytope; projecting and bounds-checking
    (with a positive-depth gate) selects the same set for pinhole P2.
    """
    pts_cam = box_np.lidar_to_camera(points[:, :3], rect, Trv2c)
    depth = pts_cam[:, 2]
    uv = box_np.project_to_image(pts_cam, P2)
    h, w = int(image_shape[0]), int(image_shape[1])
    keep = ((depth > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    return points[keep]


def create_reduced_point_cloud(data_path, info_path, save_path=None):
    """Write ``velodyne_reduced/*.bin`` crops of the camera frustum.

    Parity: kitti_common.create_reduced_point_cloud — the loader prefers
    the reduced clouds when present (pipelines/loading.py:85-91 there,
    datasets/pipelines/loading.py here).
    """
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    root = Path(data_path)
    for info in infos:
        velo = root / info["point_cloud"]["velodyne_path"]
        out_dir = Path(save_path) if save_path else (
            velo.parent.parent / (velo.parent.stem + "_reduced"))
        out_dir.mkdir(parents=True, exist_ok=True)
        points = np.fromfile(str(velo), np.float32).reshape(
            -1, info["point_cloud"].get("num_features", 4))
        calib = info["calib"]
        reduced = remove_outside_points(
            points, calib["R0_rect"], calib["Tr_velo_to_cam"], calib["P2"],
            info["image"]["image_shape"])
        reduced.astype(np.float32).tofile(out_dir / velo.name)
