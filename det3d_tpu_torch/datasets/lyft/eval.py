"""Lyft (kaggle-style) 3D-IoU mAP evaluation, native numpy.

The port's copy of det3d_tpu/datasets/lyft/eval.py, kept line for line
(host code in both packages, no torch), so that both give the same results.

Parity: reference det3d/datasets/lyft/eval.py ``get_lyft_eval_result``
(:43): per class, match detections to ground truth at 3D rotated-IoU
thresholds 0.5, 0.55, ..., 0.95 in the LIDAR frame (z axis 2, z center
0.5); report AP per threshold and the mean over thresholds and classes.
The reference reuses its KITTI statistics kernels; here matching is a
score-ordered greedy assignment with 101-point interpolated AP.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from det3d_tpu_torch.core import augment

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def d3_iou_lidar(boxes, qboxes):
    """(N, 7) x (K, 7) lidar boxes [x y z w l h r] -> (N, K) 3D IoU."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    ca = augment.corners_bev(boxes[:, [0, 1, 3, 4, 6]])
    cb = augment.corners_bev(qboxes[:, [0, 1, 3, 4, 6]])
    rinc = augment.intersection_area_corners(
        np.broadcast_to(ca[:, None], (n, k, 4, 2)),
        np.broadcast_to(cb[None, :], (n, k, 4, 2)))
    zmin = np.maximum(boxes[:, None, 2] - boxes[:, None, 5] / 2,
                      qboxes[None, :, 2] - qboxes[None, :, 5] / 2)
    zmax = np.minimum(boxes[:, None, 2] + boxes[:, None, 5] / 2,
                      qboxes[None, :, 2] + qboxes[None, :, 5] / 2)
    inc = rinc * np.clip(zmax - zmin, 0, None)
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    union = vol_a + vol_b - inc
    return np.where(union > 0, inc / np.maximum(union, 1e-12), 0.0)


def _ap_for_class_threshold(gt_by_token, det_by_token, cls, iou_matrix,
                            threshold):
    npos = sum(int((g["names"] == cls).sum()) for g in gt_by_token.values())
    if npos == 0:
        return np.nan
    entries = []
    for token, det in det_by_token.items():
        sel = np.nonzero(det["names"] == cls)[0]
        for j in sel:
            entries.append((float(det["scores"][j]), token, j))
    entries.sort(key=lambda e: -e[0])

    matched = set()
    tp, fp = [], []
    for score, token, j in entries:
        gt = gt_by_token.get(token)
        ious = iou_matrix[token]                 # (num_det, num_gt)
        best, best_i = 0.0, -1
        if gt is not None:
            for i in np.nonzero(gt["names"] == cls)[0]:
                if (token, i) in matched:
                    continue
                if ious[j, i] > best:
                    best, best_i = ious[j, i], i
        if best >= threshold:
            matched.add((token, best_i))
            tp.append(1)
            fp.append(0)
        else:
            tp.append(0)
            fp.append(1)
    if not entries:
        return 0.0
    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    rec = tp / npos
    prec = tp / (tp + fp)
    rec_interp = np.linspace(0, 1, 101)
    prec_interp = np.interp(rec_interp, rec, prec, right=0)
    # standard PR-AUC with backward max smoothing
    prec_interp = np.maximum.accumulate(prec_interp[::-1])[::-1]
    return float(prec_interp.mean())


def get_lyft_eval_result(gt_by_token: Dict[str, dict],
                         det_by_token: Dict[str, dict],
                         classes: List[str]):
    """gt/det entries: {boxes (N,7) lidar, names (N,), scores (dets only)}.

    Returns (result_str, {"mAPs": per class/threshold, "mAP": scalar}).
    """
    iou_matrix = {}
    for token, det in det_by_token.items():
        gt = gt_by_token.get(token, {"boxes": np.zeros((0, 7))})
        iou_matrix[token] = d3_iou_lidar(np.asarray(det["boxes"], np.float64),
                                         np.asarray(gt["boxes"], np.float64))

    aps = np.full((len(classes), len(IOU_THRESHOLDS)), np.nan)
    for c, cls in enumerate(classes):
        for t, th in enumerate(IOU_THRESHOLDS):
            aps[c, t] = _ap_for_class_threshold(
                gt_by_token, det_by_token, cls, iou_matrix, th)
    class_map = {cls: float(np.nanmean(aps[c]))
                 for c, cls in enumerate(classes)}
    valid = ~np.isnan(aps)
    mean_ap = float(aps[valid].mean()) if valid.any() else 0.0
    lines = [f"Lyft mAP@0.5:0.95: {mean_ap:.4f}"]
    for cls, v in class_map.items():
        lines.append(f"  {cls}: {v:.4f}")
    return "\n".join(lines), {"mAPs": class_map, "mAP": mean_ap,
                              "aps": aps.tolist()}
