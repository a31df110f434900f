"""Lyft Level-5 dataset (nuScenes-schema tables) + kaggle mAP eval.

The port's copy of det3d_tpu/datasets/lyft/lyft.py, kept line for line
(host code in both packages, no torch), so that both give the same results.

Parity: reference det3d/datasets/lyft/lyft.py:13-200 (lyft SDK there; the
Lyft release ships nuScenes-format JSON tables, so the devkit-free table
reader is shared with NuScenesDataset). Evaluation is the kaggle-style
3D-IoU-threshold mAP (lyft/eval.py here, reference lyft/eval.py:43).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.datasets.nuscenes.nuscenes import NuScenesDataset
from det3d_tpu_torch.datasets.lyft.eval import get_lyft_eval_result
from det3d_tpu_torch.datasets.registry import DATASETS

LYFT_CLASSES = ["car", "pedestrian", "motorcycle", "bicycle",
                "other_vehicle", "bus", "truck", "emergency_vehicle",
                "animal"]


def create_lyft_infos(root_path, version="v1.0-trainval", nsweeps=10,
                      splits=None):
    """Lyft infos: identical machinery, identity category mapping."""
    from det3d_tpu_torch.datasets.nuscenes.nusc_common import (
        _fill_infos, _resolve_splits)
    from det3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables

    nusc = NuScenesTables(root_path, version)
    split_names = _resolve_splits(root_path, version, splits)
    scene_by_name = {s["name"]: s["token"] for s in nusc.table("scene")}
    train_scene_tokens = {scene_by_name[n] for n in split_names["train"]
                          if n in scene_by_name}
    train_infos, val_infos = _fill_infos(
        nusc, train_scene_tokens, test="test" in version, nsweeps=nsweeps,
        name_map={})
    root = Path(root_path)
    with open(root / f"lyft_infos_train_{nsweeps:02d}sweeps.pkl", "wb") as f:
        pickle.dump(train_infos, f)
    with open(root / f"lyft_infos_val_{nsweeps:02d}sweeps.pkl", "wb") as f:
        pickle.dump(val_infos, f)
    print(f"lyft train infos: {len(train_infos)}, val: {len(val_infos)}")


@DATASETS.register_module
class LyftDataset(NuScenesDataset):
    NumPointFeatures = 5

    def __init__(self, root_path, info_path, pipeline=None,
                 class_names=None, test_mode=False, nsweeps=10, **kwargs):
        super().__init__(root_path, info_path, pipeline=pipeline,
                         class_names=class_names or LYFT_CLASSES,
                         test_mode=test_mode, nsweeps=nsweeps, **kwargs)

    def evaluation(self, detections, output_dir=None):
        gt_by_token, det_by_token = {}, {}
        for info in self._nusc_infos:
            token = info["token"]
            boxes9 = np.asarray(info["gt_boxes"], np.float64)
            gt_by_token[token] = {
                "boxes": boxes9[:, [0, 1, 2, 3, 4, 5, -1]]
                if boxes9.size else np.zeros((0, 7)),
                "names": np.asarray(info["gt_names"]),
            }
            det = detections.get(token)
            if det is None:
                det_by_token[token] = {
                    "boxes": np.zeros((0, 7)), "names": np.zeros((0,), "<U32"),
                    "scores": np.zeros((0,))}
                continue
            box3d = np.asarray(det["box3d_lidar"], np.float64)
            labels = np.asarray(det["label_preds"]).astype(int)
            det_by_token[token] = {
                "boxes": box3d[:, [0, 1, 2, 3, 4, 5, -1]]
                if box3d.size else np.zeros((0, 7)),
                "names": np.asarray(
                    [self._class_names[i] for i in labels], dtype="<U32"),
                "scores": np.asarray(det["scores"], np.float64),
            }
        result_str, detail = get_lyft_eval_result(
            gt_by_token, det_by_token, list(self._class_names))
        if output_dir is not None:
            Path(output_dir).mkdir(parents=True, exist_ok=True)
            (Path(output_dir) / "lyft_eval.txt").write_text(result_str)
        return {
            "results": {"lyft": result_str},
            "detail": {"eval.lyft": detail},
        }, None
