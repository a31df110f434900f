"""Native nuScenes detection metrics (mAP over center-distance thresholds,

The port's copy of det3d_tpu/datasets/nuscenes/nusc_eval.py, kept line for
line (host code in both packages, no torch), so that both give the same
results.
ATE/ASE/AOE/AVE/AAE, NDS) — devkit-free.

The reference shells out to the official ``nuscenes-devkit`` evaluator
(reference det3d/datasets/nuscenes/nuscenes.py:180 ``evaluation`` ->
nusc_common.eval_main :699). That package is not importable here, so this
module re-implements the published algorithm (the devkit's
``detection/algo.py`` accumulate/calc_ap/calc_tp): greedy score-ordered
matching by 2D center distance, 101-point interpolated precision with the
(p-0.1)/0.9 normalization, cumulative-mean TP errors interpolated over the
recall axis, NDS = (5*mAP + sum over 5 TP scores of max(1-err, 0)) / 10.

Boxes may be given in any per-sample-consistent frame (center distance,
sizes, yaw differences and velocity differences are invariant under a rigid
transform applied to both gt and predictions of a sample); range filtering
uses distance from the frame origin (the lidar), a ~1 m approximation of
the devkit's ego-distance filter.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

DETECTION_NAMES = ["car", "truck", "bus", "trailer", "construction_vehicle",
                   "pedestrian", "motorcycle", "bicycle", "traffic_cone",
                   "barrier"]
DIST_THS = [0.5, 1.0, 2.0, 4.0]
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
TP_METRICS = ["trans_err", "scale_err", "orient_err", "vel_err", "attr_err"]
# classes where some TP metrics are undefined (devkit detection/constants)
ATTR_FREE = {"traffic_cone", "barrier"}
VEL_FREE = {"traffic_cone", "barrier", "construction_vehicle"}


def _center_dist(a, b):
    return float(np.hypot(a["translation"][0] - b["translation"][0],
                          a["translation"][1] - b["translation"][1]))


def _scale_err(a, b):
    """1 - aligned 3D IoU of the size boxes (devkit scale_iou)."""
    sa = np.asarray(a["size"], np.float64)
    sb = np.asarray(b["size"], np.float64)
    mins = np.minimum(sa, sb)
    inter = mins.prod()
    union = sa.prod() + sb.prod() - inter
    return 1.0 - inter / union


def _angle_diff(a, b, period):
    d = (a - b + period / 2) % period - period / 2
    return abs(d)


def filter_boxes(boxes_by_token: Dict[str, List[dict]]):
    out = {}
    for token, boxes in boxes_by_token.items():
        kept = []
        for b in boxes:
            name = b["detection_name"] if "detection_name" in b else b["name"]
            if name not in CLASS_RANGE:
                continue
            dist = np.hypot(b["translation"][0], b["translation"][1])
            if dist > CLASS_RANGE[name]:
                continue
            if b.get("num_pts", 1) == 0:
                continue
            kept.append(b)
        out[token] = kept[:MAX_BOXES_PER_SAMPLE]
    return out


def accumulate(gt_all, pred_all, class_name, dist_th):
    """Devkit algo.accumulate: returns 101-point md dict or None (no gt)."""
    npos = sum(1 for boxes in gt_all.values() for b in boxes
               if (b.get("detection_name") or b["name"]) == class_name)
    if npos == 0:
        return None

    preds = []
    for token, boxes in pred_all.items():
        for b in boxes:
            if (b.get("detection_name") or b["name"]) == class_name:
                preds.append((float(b["detection_score"]
                                    if "detection_score" in b
                                    else b["score"]), token, b))
    preds.sort(key=lambda x: -x[0])

    taken = set()
    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_data["conf"] = []
    for score, token, pred in preds:
        best_dist = np.inf
        best_idx = None
        for i, gt in enumerate(gt_all.get(token, [])):
            if (gt.get("detection_name") or gt["name"]) != class_name:
                continue
            if (token, i) in taken:
                continue
            d = _center_dist(gt, pred)
            if d < best_dist:
                best_dist = d
                best_idx = i
        is_match = best_dist < dist_th
        if is_match:
            taken.add((token, best_idx))
            gt = gt_all[token][best_idx]
            tp.append(1)
            fp.append(0)
            conf.append(score)
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match_data["trans_err"].append(best_dist)
            match_data["scale_err"].append(_scale_err(gt, pred))
            match_data["orient_err"].append(
                0.0 if class_name == "traffic_cone"
                else _angle_diff(float(gt["yaw"]), float(pred["yaw"]),
                                 period))
            if class_name in VEL_FREE:
                match_data["vel_err"].append(0.0)
            else:
                gv = np.asarray(gt.get("velocity", (0, 0))[:2], np.float64)
                pv = np.asarray(pred.get("velocity", (0, 0))[:2], np.float64)
                match_data["vel_err"].append(float(np.linalg.norm(gv - pv)))
            if class_name in ATTR_FREE or not gt.get("attribute_name"):
                match_data["attr_err"].append(0.0)
            else:
                match_data["attr_err"].append(
                    1.0 - float(gt.get("attribute_name")
                                == pred.get("attribute_name")))
            match_data["conf"].append(score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    if len(match_data["trans_err"]) == 0:
        return {"recall": np.zeros(101), "precision": np.zeros(101),
                "confidence": np.zeros(101), "npos": npos,
                **{k: np.ones(101) for k in TP_METRICS}}

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / (fp + tp)
    rec = tp / npos
    rec_interp = np.linspace(0, 1, 101)
    precision = np.interp(rec_interp, rec, prec, right=0)
    confidence = np.interp(rec_interp, rec, conf, right=0)

    out = {"recall": rec_interp, "precision": precision,
           "confidence": confidence, "npos": npos}
    for key in TP_METRICS:
        # cumulative mean over TPs, then resample onto the recall grid via
        # the (monotone decreasing) confidence axis (devkit algo.py)
        tmp = _cummean(np.asarray(match_data[key], np.float64))
        out[key] = np.interp(confidence[::-1],
                             np.asarray(match_data["conf"])[::-1],
                             tmp[::-1])[::-1]
    return out


def _cummean(x):
    return np.cumsum(x) / (np.arange(len(x)) + 1)


def calc_ap(md, min_recall=MIN_RECALL, min_precision=MIN_PRECISION):
    prec = md["precision"].copy()
    prec = prec - min_precision
    prec[prec < 0] = 0
    prec = prec[round(100 * min_recall) + 1:]
    return float(prec.sum() / len(prec) / (1.0 - min_precision))


def calc_tp(md, metric, min_recall=MIN_RECALL):
    first_ind = round(100 * min_recall) + 1
    # devkit: last operating point = max achieved recall
    nonzero = np.nonzero(md["confidence"])[0]
    if len(nonzero) == 0:
        return 1.0
    last_ind = int(nonzero[-1])
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric][first_ind:last_ind + 1]))


def evaluate(gt_by_token: Dict[str, List[dict]],
             pred_by_token: Dict[str, List[dict]],
             classes=None) -> Dict[str, Any]:
    """Full metric computation. Returns a metrics_summary-like dict."""
    classes = classes or DETECTION_NAMES
    gt_by_token = filter_boxes(gt_by_token)
    pred_by_token = filter_boxes(pred_by_token)

    mds = {}
    for cls in classes:
        for dist_th in DIST_THS:
            mds[(cls, dist_th)] = accumulate(gt_by_token, pred_by_token,
                                             cls, dist_th)

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp_errors: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        label_aps[cls] = {}
        for dist_th in DIST_THS:
            md = mds[(cls, dist_th)]
            label_aps[cls][dist_th] = calc_ap(md) if md is not None else \
                float("nan")
        md_tp = mds[(cls, DIST_TH_TP)]
        label_tp_errors[cls] = {
            m: (calc_tp(md_tp, m) if md_tp is not None else float("nan"))
            for m in TP_METRICS}

    ap_values = [v for c in label_aps.values() for v in c.values()
                 if not np.isnan(v)]
    mean_ap = float(np.mean(ap_values)) if ap_values else 0.0
    tp_errors = {}
    for m in TP_METRICS:
        vals = [label_tp_errors[c][m] for c in classes
                if not np.isnan(label_tp_errors[c][m])]
        tp_errors[m] = float(np.mean(vals)) if vals else 1.0
    tp_scores = {m: max(1.0 - tp_errors[m], 0.0) for m in TP_METRICS}
    nd_score = (5.0 * mean_ap + sum(tp_scores.values())) / 10.0

    return {
        "label_aps": label_aps,
        "label_tp_errors": label_tp_errors,
        "mean_dist_aps": {c: float(np.nanmean(list(v.values())))
                          for c, v in label_aps.items()},
        "mean_ap": mean_ap,
        "tp_errors": tp_errors,
        "tp_scores": tp_scores,
        "nd_score": nd_score,
    }
