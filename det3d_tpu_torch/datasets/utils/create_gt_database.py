"""Offline GT-database creation for paste augmentation; port of
det3d_tpu/datasets/utils/create_gt_database.py.

Parity: reference det3d/datasets/utils/create_gt_database.py:18-160 — run
the load pipeline over the train split, crop each GT's points
(points_in_rbbox), store center-relative clusters as ``gt_database/*.bin``
plus a ``dbinfos_train.pkl`` index keyed by class name.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.core import augment
from det3d_tpu_torch.datasets.builder import build_dataset


def create_groundtruth_database(dataset_class_name, data_path, info_path,
                                db_path=None, dbinfo_path=None,
                                used_classes=None, nsweeps=10):
    pipeline = [
        dict(type="LoadPointCloudFromFile", dataset=dataset_class_name),
        dict(type="LoadPointCloudAnnotations", with_bbox=True),
    ]
    if dataset_class_name in ("NuScenesDataset",):
        ds_cfg = dict(type=dataset_class_name, root_path=data_path,
                      info_path=info_path, pipeline=pipeline,
                      test_mode=True, nsweeps=nsweeps)
    else:
        ds_cfg = dict(type=dataset_class_name, root_path=data_path,
                      info_path=info_path, pipeline=pipeline, test_mode=True)
    dataset = build_dataset(ds_cfg)

    root = Path(data_path)
    db_path = Path(db_path or root / "gt_database")
    dbinfo_path = Path(dbinfo_path or root / "dbinfos_train.pkl")
    db_path.mkdir(parents=True, exist_ok=True)

    all_db_infos = {}
    group_counter = 0
    for idx in range(len(dataset)):
        res = dataset[idx]
        token = res["metadata"].get("token", str(idx))
        if res["type"] == "NuScenesDataset":
            points = res["lidar"]["combined"]
        else:
            points = res["lidar"]["points"]
        anno = res["lidar"]["annotations"]
        if anno is None:
            continue
        gt_boxes = np.asarray(anno["boxes"])
        names = np.asarray(anno["names"])
        difficulty = anno.get("difficulty")
        if difficulty is None:
            difficulty = np.zeros((len(names),), np.int32)
        if len(gt_boxes) == 0:
            continue

        box7 = gt_boxes[:, [0, 1, 2, 3, 4, 5, -1]]
        masks = augment.points_in_rbbox(points, box7)       # (P, N)
        for i in range(len(gt_boxes)):
            if used_classes is not None and names[i] not in used_classes:
                continue
            filename = f"{token}_{names[i]}_{i}.bin"
            gt_points = points[masks[:, i]].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.astype(np.float32).tofile(db_path / filename)
            db_info = {
                "name": names[i],
                "path": str(Path(db_path.name) / filename),
                "image_idx": token,
                "gt_idx": i,
                "box3d_lidar": gt_boxes[i],
                "num_points_in_gt": int(masks[:, i].sum()),
                "difficulty": int(difficulty[i]) if i < len(difficulty)
                else 0,
                "group_id": group_counter,
            }
            group_counter += 1
            all_db_infos.setdefault(names[i], []).append(db_info)

    for k, v in all_db_infos.items():
        print(f"db: {len(v)} {k} instances")
    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
