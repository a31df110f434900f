"""2D detection eval utilities (VOC-style mAP / recall), numpy.

The port's copy of det3d_tpu/core/eval2d.py, kept line for line (host code
in both packages, no torch), so that both give the same results.

Parity: det3d/core/evaluation/{bbox_overlaps.py, mean_ap.py:9-334,
recall.py:7-128, class_names.py} — the reference's image-domain legacy
eval helpers. Independent implementation of the published VOC protocol:
greedy score-ordered matching per image, AP by area-under-PR or 11-point
interpolation. Host-side numpy (this is offline metric code, not a device
path); everything is vectorized over detections — there is no per-box
python loop except the greedy match, which is order-dependent by
definition.

Boxes are (x1, y1, x2, y2) with inclusive +1 extents off (plain
width = x2 - x1), scores appended as a 5th column on detections.
"""

from __future__ import annotations

import numpy as np


def bbox_overlaps(bboxes1: np.ndarray, bboxes2: np.ndarray,
                  mode: str = "iou") -> np.ndarray:
    """(N, 4) x (K, 4) -> (N, K) IoU, or intersection-over-first ("iof")."""
    assert mode in ("iou", "iof")
    n, k = bboxes1.shape[0], bboxes2.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    lt = np.maximum(bboxes1[:, None, :2], bboxes2[None, :, :2])
    rb = np.minimum(bboxes1[:, None, 2:4], bboxes2[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = ((bboxes1[:, 2] - bboxes1[:, 0])
             * (bboxes1[:, 3] - bboxes1[:, 1]))
    if mode == "iof":
        union = area1[:, None]
    else:
        area2 = ((bboxes2[:, 2] - bboxes2[:, 0])
                 * (bboxes2[:, 3] - bboxes2[:, 1]))
        union = area1[:, None] + area2[None, :] - inter
    return (inter / np.maximum(union, np.finfo(np.float32).eps)
            ).astype(np.float32)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from monotonic PR samples; supports batched (S, R) input.

    mode "area": area under the monotonized PR curve (the VOC2010+ /
    mean_ap.py:9 "area" branch). mode "11points": mean of max precision
    at recall {0, 0.1, ..., 1.0}.
    """
    single = recalls.ndim == 1
    if single:
        recalls, precisions = recalls[None], precisions[None]
    s = recalls.shape[0]
    ap = np.zeros(s, np.float64)
    if mode == "area":
        zeros, ones = np.zeros((s, 1)), np.ones((s, 1))
        mrec = np.hstack([zeros, recalls, ones])
        mpre = np.hstack([zeros, precisions, zeros])
        mpre = np.maximum.accumulate(mpre[:, ::-1], axis=1)[:, ::-1]
        for i in range(s):
            idx = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, idx + 1] - mrec[i, idx])
                           * mpre[i, idx + 1])
    elif mode == "11points":
        for t in np.arange(0, 1.01, 0.1):
            prec = np.where(recalls >= t, precisions, 0.0).max(axis=1,
                                                               initial=0.0)
            ap += prec
        ap /= 11.0
    else:
        raise ValueError(f"unknown AP mode {mode}")
    return ap[0] if single else ap


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_ignore: np.ndarray | None = None,
                 iou_thr: float = 0.5):
    """Greedy match one image's detections (N, 5 incl. score) against GTs.

    Returns (tp, fp) each (N,) in SCORE ORDER (descending). Ignored GTs
    absorb detections without counting either way (mean_ap.py:133-197
    semantics).
    """
    nd = det_bboxes.shape[0]
    tp = np.zeros(nd, np.float32)
    fp = np.zeros(nd, np.float32)
    ng = gt_bboxes.shape[0]
    if gt_ignore is None:
        gt_ignore = np.zeros(ng, bool)
    order = np.argsort(-det_bboxes[:, 4])
    if ng == 0:
        fp[:] = 1.0
        return tp, fp
    ious = bbox_overlaps(det_bboxes[order, :4], gt_bboxes)
    taken = np.zeros(ng, bool)
    for r in range(nd):
        j = int(np.argmax(ious[r]))
        if ious[r, j] >= iou_thr:
            if gt_ignore[j]:
                continue                      # matches an ignored GT: skip
            if not taken[j]:
                taken[j] = True
                tp[r] = 1.0
            else:
                fp[r] = 1.0
        else:
            fp[r] = 1.0
    return tp, fp


def eval_map(det_results, gt_bboxes, gt_labels, gt_ignore=None,
             iou_thr: float = 0.5, mode: str = "area",
             print_summary: bool = False):
    """VOC mAP over a dataset (mean_ap.py:217-333 surface).

    det_results: list (per image) of lists (per class) of (n, 5) arrays.
    gt_bboxes/gt_labels: per-image arrays; labels are 1-based class ids.
    Returns (mean_ap, per-class list of dicts with recall/precision/ap).
    """
    n_img = len(det_results)
    n_cls = len(det_results[0]) if n_img else 0
    results = []
    for c in range(n_cls):
        cls_dets, cls_tp, cls_fp = [], [], []
        n_gt = 0
        for i in range(n_img):
            dets = np.asarray(det_results[i][c]).reshape(-1, 5)
            sel = gt_labels[i] == (c + 1)
            gts = np.asarray(gt_bboxes[i]).reshape(-1, 4)[sel]
            ign = (np.asarray(gt_ignore[i])[sel]
                   if gt_ignore is not None else None)
            n_gt += int(gts.shape[0]
                        - (ign.sum() if ign is not None else 0))
            tp, fp = tpfp_default(dets, gts, ign, iou_thr)
            order = np.argsort(-dets[:, 4])
            cls_dets.append(dets[order, 4])
            cls_tp.append(tp)
            cls_fp.append(fp)
        scores = np.concatenate(cls_dets) if cls_dets else np.zeros(0)
        tp = np.concatenate(cls_tp) if cls_tp else np.zeros(0)
        fp = np.concatenate(cls_fp) if cls_fp else np.zeros(0)
        order = np.argsort(-scores)
        tp_cum = np.cumsum(tp[order])
        fp_cum = np.cumsum(fp[order])
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(n_gt, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap = (average_precision(recalls, precisions, mode)
              if n_gt > 0 and recalls.size else 0.0)
        results.append(dict(num_gts=n_gt, num_dets=int(scores.size),
                            recall=recalls, precision=precisions,
                            ap=float(ap)))
    aps = [r["ap"] for r in results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    if print_summary:
        for c, r in enumerate(results):
            print(f"class {c + 1}: gts={r['num_gts']} dets={r['num_dets']} "
                  f"ap={r['ap']:.4f}")
        print(f"mAP: {mean_ap:.4f}")
    return mean_ap, results


def eval_recalls(gts, proposals, proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,), print_summary: bool = False):
    """Proposal recall matrix (recall.py:62-99): fraction of GTs whose best
    proposal IoU (among the top-k by score, or first k) clears each
    threshold. Returns (len(proposal_nums), len(iou_thrs))."""
    proposal_nums = np.asarray(proposal_nums, int)
    iou_thrs = np.asarray(iou_thrs, float)
    best_ious = []
    for gt, prop in zip(gts, proposals):
        prop = np.asarray(prop)
        if prop.shape[1] == 5:
            prop = prop[np.argsort(-prop[:, 4])][:, :4]
        gt = np.asarray(gt).reshape(-1, 4)
        img_best = np.zeros((len(proposal_nums), gt.shape[0]), np.float32)
        if gt.shape[0] and prop.shape[0]:
            ious = bbox_overlaps(gt, prop)            # (G, P)
            for k, num in enumerate(proposal_nums):
                img_best[k] = ious[:, :num].max(axis=1, initial=0.0)
        best_ious.append(img_best)
    all_best = np.concatenate(best_ious, axis=1)      # (K, total_gts)
    recalls = np.stack([(all_best >= t).mean(axis=1) if all_best.size
                        else np.zeros(len(proposal_nums))
                        for t in iou_thrs], axis=1)
    if print_summary:
        print(recalls)
    return recalls


# class-name registries (class_names.py surface, lidar-relevant sets)
def kitti_classes():
    return ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting"]


def nuscenes_classes():
    return ["car", "truck", "construction_vehicle", "bus", "trailer",
            "barrier", "motorcycle", "bicycle", "pedestrian",
            "traffic_cone"]


def get_classes(dataset: str):
    alias = {"kitti": kitti_classes, "nuscenes": nuscenes_classes}
    if dataset not in alias:
        raise KeyError(f"unknown dataset {dataset}")
    return alias[dataset]()
