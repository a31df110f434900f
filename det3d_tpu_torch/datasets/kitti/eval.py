"""Official KITTI AP evaluation (bbox / bev / 3d / aos, easy/mod/hard).

The port's copy of det3d_tpu/datasets/kitti/eval.py, kept line for line
(host numpy in both packages), so that both compute the same AP to the
bit (tests/test_torch_kitti_data.py).

Parity: reference det3d/datasets/utils/kitti_object_eval_python/eval.py —
``get_thresholds`` (:8), ``clean_data`` (:29), ``image_box_overlap`` (:90),
``bev_box_overlap``/``d3_box_overlap`` (:129,:149 — rotated IoU via the
numba.cuda ``rotate_iou_gpu_eval``, here via the same Liang-Barsky numpy
kernel the framework uses everywhere), ``compute_statistics_jit`` (:160),
``eval_class_v3``, ``get_official_eval_result`` (:460). AP is the 11-point
interpolated metric (prec at recalls 0, 0.1, ..., 1.0 -> prec[::4] of 41
samples) matching the README model-zoo numbers.

Derivation note: ``get_thresholds``, ``clean_data`` and the sequential
``compute_statistics`` are deliberate transcriptions of the official KITTI
benchmark protocol (as published in the KITTI devkit and mirrored by the
reference's kitti_object_eval_python) — the matching rules admit exactly one
shape and any deviation changes the metric, so they are kept structurally
identical as the parity oracle. Everything around them is rewritten: the
IoU kernels are the framework's vectorized Liang-Barsky (not numba.cuda
polygon clipping), and the hot accumulation path is
``compute_statistics_thresholds``, which fuses all 41 score thresholds into
one masked matrix pass per image (the sequential twin is retained only as
the golden oracle in tests).
"""

from __future__ import annotations

import io
from typing import List

import numpy as np

from det3d_tpu_torch.core import augment

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting",
               "car", "tractor", "trailer"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=41):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" \
                and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(num_dt):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name \
            else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes, 0) if dc_bboxes
          else np.zeros((0, 4), np.float64))
    return num_valid_gt, ignored_gt, ignored_dt, dc


def image_box_overlap(boxes, query_boxes, criterion=-1):
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _rotate_overlap(boxes, qboxes, criterion=-1):
    """Pairwise rotated overlap of (N,5)/(K,5) [x,y,w,l,r] boxes."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    ca = augment.corners_bev(boxes)
    cb = augment.corners_bev(qboxes)
    inter = augment.intersection_area_corners(
        np.broadcast_to(ca[:, None], (n, k, 4, 2)),
        np.broadcast_to(cb[None, :], (n, k, 4, 2)))
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        return inter                      # raw intersection area
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """boxes: (N, 5) camera-BEV [x, z, l, w, ry] like the reference."""
    return _rotate_overlap(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """boxes: (N, 7) camera [x, y, z, l, h, w, ry]; y is box bottom."""
    rinc = _rotate_overlap(boxes[:, [0, 2, 3, 5, 6]],
                           qboxes[:, [0, 2, 3, 5, 6]], criterion=2)
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.clip(iw, 0, None) * rinc
    if criterion == -1:
        denom = vol_a + vol_b - inc
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inc.shape)
    else:
        denom = np.broadcast_to(vol_b, inc.shape)
    out = np.where((iw > 0) & (denom > 0), inc / np.maximum(denom, 1e-12),
                   0.0)
    return out


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """One image. overlaps: (num_dt, num_gt). Parity: eval.py:160-299."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned = [False] * det_size
    ignored_threshold = [dt_scores[j] < thresh if compute_fp else False
                         for j in range(det_size)]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds: List[float] = []
    delta: List[float] = []

    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap \
                    and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif compute_fp and overlap > min_overlap \
                    and (overlap > max_overlap or assigned_ignored_det) \
                    and ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap \
                    and valid_detection == NO_DETECTION \
                    and ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc_bboxes, 0)
            for i in range(dc_bboxes.shape[0]):
                for j in range(det_size):
                    if assigned[j] or ignored_det[j] in (-1, 1) \
                            or ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def compute_statistics_thresholds(overlaps, gt_datas, dt_datas, ignored_gt,
                                  ignored_det, dc_bboxes, metric, min_overlap,
                                  thresholds, compute_aos=False):
    """All-thresholds fused twin of ``compute_statistics(compute_fp=True)``.

    Replays the official sequential gt->det assignment once with the
    threshold axis vectorized: per-gt candidate selection and the assigned
    bookkeeping are (T, num_dt) masked numpy ops instead of T independent
    scalar passes. Bit-identical to looping ``compute_statistics`` over
    ``thresholds`` (asserted in tests/test_kitti_dataset.py); the reference
    needed numba + a per-threshold re-run (kitti_object_eval_python/
    eval.py:389-460 ``fused_compute_statistics``), this needs neither.

    Returns pr: (T, 4) float64 of [tp, fp, fn, similarity] per threshold
    (similarity is the raw sum; -1 handling follows the sequential twin).
    """
    thresholds = np.asarray(thresholds, np.float64)
    T = thresholds.shape[0]
    det_size = dt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]
    ignored_gt = np.asarray(ignored_gt, np.int64)
    ignored_det = np.asarray(ignored_det, np.int64)

    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T, np.float64)

    # score_ok[t, j]: det j survives threshold t (ignored_threshold is
    # ``dt_scores[j] < thresh``)
    score_ok = dt_scores[None, :] >= thresholds[:, None]
    assigned = np.zeros((T, det_size), bool)
    t_idx = np.arange(T)

    if det_size > 0:
        base_not_skip = ignored_det != -1
        base0 = (ignored_det == 0)[None, :]
        base1 = (ignored_det == 1)[None, :]
        for i in range(gt_datas.shape[0]):
            if ignored_gt[i] == -1:
                continue
            ov_hit = (overlaps[:, i] > min_overlap) & base_not_skip
            usable = ov_hit[None, :] & score_ok & ~assigned
            avail0 = usable & base0
            avail1 = usable & base1
            has0 = avail0.any(1)
            has1 = avail1.any(1)
            # preferred: max-overlap non-ignored det (first max in j order,
            # like the sequential strict-> running max); fallback: FIRST
            # ignored det in j order (only reachable when nothing was
            # selected before it — see the valid_detection==NO_DETECTION
            # guard in the sequential twin)
            det0 = np.where(avail0, overlaps[:, i][None, :],
                            -np.inf).argmax(1)
            det1 = avail1.argmax(1)
            chosen = np.where(has0, det0, det1)
            has = has0 | has1
            if ignored_gt[i] == 0:
                fn += ~has
                is_tp = has0  # chosen is non-ignored exactly when has0
                tp += is_tp
                if compute_aos:
                    delta = gt_alphas[i] - dt_alphas[chosen]
                    sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
            assigned[t_idx[has], chosen[has]] = True

    # fp: unassigned, non-ignored, above-threshold dets
    fp_mask = (~assigned) & (ignored_det == 0)[None, :] & score_ok
    fp = fp_mask.sum(1)
    if metric == 0 and len(dc_bboxes) > 0 and det_size > 0:
        overlaps_dt_dc = image_box_overlap(dt_bboxes, dc_bboxes, 0)
        in_dc = (overlaps_dt_dc > min_overlap).any(1)[None, :]
        fp = fp - (fp_mask & in_dc).sum(1)

    pr = np.zeros((T, 4), np.float64)
    pr[:, 0] = tp
    pr[:, 1] = fp
    pr[:, 2] = fn
    if compute_aos:
        pr[:, 3] = np.where((tp > 0) | (fp > 0), sim, 0.0)
    return pr


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas, dt_datas, ignored_gts, ignored_dets, dontcares = \
        [], [], [], [], []
    total_dc_num = []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc = clean_data(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        total_num_valid_gt += num_valid_gt
        dontcares.append(dc)
        total_dc_num.append(dc.shape[0])
        gt_datas.append(np.concatenate(
            [gt["bbox"], gt["alpha"][..., None]], 1))
        dt_datas.append(np.concatenate(
            [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1))
    return (gt_datas, dt_datas, ignored_gts, ignored_dets, dontcares,
            total_dc_num, total_num_valid_gt)


def _bev_rects(anno):
    """(N, 5) camera-BEV [x, z, l, w, ry] rectangles of one anno."""
    return np.concatenate(
        [anno["location"][:, [0, 2]], anno["dimensions"][:, [0, 2]],
         anno["rotation_y"][..., None]], 1)


def calculate_iou_partly(gt_annos, dt_annos, metric, cache=None):
    """Per-image (num_dt, num_gt) overlap matrices.

    The BEV and 3D metrics share the same rotated-rectangle intersection
    (d3_box_overlap's rinc IS the BEV intersection); pass one ``cache``
    dict across metric calls to compute it once per image.
    """
    if metric == 0:
        return [image_box_overlap(dt["bbox"], gt["bbox"]).astype(np.float64)
                for gt, dt in zip(gt_annos, dt_annos)]
    if metric not in (1, 2):
        raise ValueError("unknown metric")

    if cache is None:
        cache = {}
    if "rinc" not in cache:
        cache["rinc"] = [
            _rotate_overlap(_bev_rects(dt), _bev_rects(gt), criterion=2)
            for gt, dt in zip(gt_annos, dt_annos)]

    overlaps = []
    for gt, dt, rinc in zip(gt_annos, dt_annos, cache["rinc"]):
        dt_rect, gt_rect = _bev_rects(dt), _bev_rects(gt)
        if metric == 1:
            area_a = (dt_rect[:, 2] * dt_rect[:, 3])[:, None]
            area_b = (gt_rect[:, 2] * gt_rect[:, 3])[None, :]
            denom = area_a + area_b - rinc
            ov = np.where(denom > 0, rinc / np.maximum(denom, 1e-12), 0.0)
        else:
            boxes, qboxes = dt["location"], gt["location"]
            dims, qdims = dt["dimensions"], gt["dimensions"]
            iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
                  - np.maximum(boxes[:, None, 1] - dims[:, None, 1],
                               qboxes[None, :, 1] - qdims[None, :, 1]))
            vol_a = dims.prod(-1)[:, None]
            vol_b = qdims.prod(-1)[None, :]
            inc = np.clip(iw, 0, None) * rinc
            denom = vol_a + vol_b - inc
            ov = np.where((iw > 0) & (denom > 0),
                          inc / np.maximum(denom, 1e-12), 0.0)
        overlaps.append(ov.astype(np.float64))
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_sample_pts=41,
               iou_cache=None, prep_cache=None):
    """Parity: eval.py eval_class_v3. Returns dict with precision
    (num_class, num_diff, num_minoverlap, num_sample_pts) and aos.

    ``iou_cache``/``prep_cache`` (optional dicts) share the per-image
    rotated intersections and the (class, difficulty)-keyed cleaned data
    across the three metric passes of ``do_eval``."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou_partly(gt_annos, dt_annos, metric, iou_cache)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros(
        [num_class, num_difficulty, num_minoverlap, num_sample_pts])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            if prep_cache is not None:
                if (current_class, difficulty) not in prep_cache:
                    prep_cache[(current_class, difficulty)] = _prepare_data(
                        gt_annos, dt_annos, current_class, difficulty)
                prepared = prep_cache[(current_class, difficulty)]
            else:
                prepared = _prepare_data(
                    gt_annos, dt_annos, current_class, difficulty)
            (gt_datas, dt_datas, ignored_gts, ignored_dets, dontcares,
             total_dc_num, total_num_valid_gt) = prepared
            for k, min_overlap in enumerate(
                    min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    tp, fp, fn, sim, th = compute_statistics(
                        overlaps[i], gt_datas[i], dt_datas[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, 0.0, False, False)
                    thresholdss.append(th)
                thresholdss = np.concatenate(thresholdss)
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(thresholdss, total_num_valid_gt,
                                            num_sample_pts)
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    pr += compute_statistics_thresholds(
                        overlaps[i], gt_datas[i], dt_datas[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, thresholds, compute_aos)
                for t in range(len(thresholds)):
                    recall[m, l, k, t] = pr[t, 0] / max(
                        pr[t, 0] + pr[t, 2], 1e-12)
                    precision[m, l, k, t] = pr[t, 0] / max(
                        pr[t, 0] + pr[t, 1], 1e-12)
                    if compute_aos:
                        aos[m, l, k, t] = pr[t, 3] / max(
                            pr[t, 0] + pr[t, 1], 1e-12)
                for t in range(num_sample_pts):
                    precision[m, l, k, t] = np.max(
                        precision[m, l, k, t:], axis=-1)
                    recall[m, l, k, t] = np.max(recall[m, l, k, t:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, t] = np.max(aos[m, l, k, t:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    """11-point interpolated AP x100 (eval.py:600-604)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False):
    difficultys = [0, 1, 2]
    iou_cache, prep_cache = {}, {}
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, iou_cache=iou_cache,
                     prep_cache=prep_cache)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_aos = get_mAP(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, iou_cache=iou_cache,
                     prep_cache=prep_cache)
    mAP_bev = get_mAP(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, iou_cache=iou_cache,
                     prep_cache=prep_cache)
    mAP_3d = get_mAP(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """Parity: eval.py:460-560. Returns (result_str, result_dict)."""
    overlap_0_7 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7]])
    overlap_0_5 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)

    # earlier (canonical) entries win over lowercase aliases
    name_to_class = {}
    for i, n in enumerate(CLASS_NAMES):
        name_to_class.setdefault(n.lower(), i)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c.lower()] if isinstance(c, str) else int(c)
        for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = any(
        anno["alpha"].shape[0] > 0 and anno["alpha"][0] != -10
        for anno in dt_annos)

    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)

    out = io.StringIO()
    result_dict = {}
    for j, curcls in enumerate(current_classes):
        name = CLASS_NAMES[curcls]
        for i in range(min_overlaps.shape[0]):
            ov = min_overlaps[i, :, j]
            print(f"{name} AP@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:",
                  file=out)
            print("bbox AP:{:.2f}, {:.2f}, {:.2f}".format(
                *mAP_bbox[j, :, i]), file=out)
            print("bev  AP:{:.2f}, {:.2f}, {:.2f}".format(
                *mAP_bev[j, :, i]), file=out)
            print("3d   AP:{:.2f}, {:.2f}, {:.2f}".format(
                *mAP_3d[j, :, i]), file=out)
            if compute_aos:
                print("aos  AP:{:.2f}, {:.2f}, {:.2f}".format(
                    *mAP_aos[j, :, i]), file=out)
            tag = "" if i == 0 else "_loose"
            for d, dn in enumerate(("easy", "moderate", "hard")):
                result_dict[f"{name}_bbox_{dn}{tag}"] = mAP_bbox[j, d, i]
                result_dict[f"{name}_bev_{dn}{tag}"] = mAP_bev[j, d, i]
                result_dict[f"{name}_3d_{dn}{tag}"] = mAP_3d[j, d, i]
                if compute_aos:
                    result_dict[f"{name}_aos_{dn}{tag}"] = mAP_aos[j, d, i]
    return out.getvalue(), result_dict


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style AP averaged over an overlap range (eval.py:754-828):
    Car/Van over IoU 0.5:0.05:0.95, Pedestrian/Cyclist 0.25:0.05:0.70,
    reported for bbox/bev/3d (+aos) at easy/moderate/hard."""
    class_to_range = {
        "car": [0.5, 0.95, 10], "pedestrian": [0.25, 0.7, 10],
        "cyclist": [0.25, 0.7, 10], "van": [0.5, 0.95, 10],
        "person_sitting": [0.25, 0.7, 10],
    }
    name_to_class = {}
    for i, n in enumerate(CLASS_NAMES):
        name_to_class.setdefault(n.lower(), i)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c.lower()] if isinstance(c, str) else int(c)
        for c in current_classes]

    # (num_overlap, metric, class) threshold grid
    n_cls = len(current_classes)
    thresholds = np.zeros([10, 3, n_cls])
    for i, curcls in enumerate(current_classes):
        lo, hi, n = class_to_range.get(
            CLASS_NAMES[curcls].lower(), [0.5, 0.95, 10])
        t = np.linspace(lo, hi, int(n))
        thresholds[:, :, i] = t[:, None]

    compute_aos = any(
        anno["alpha"].shape[0] > 0 and anno["alpha"][0] != -10
        for anno in dt_annos)
    difficultys = [0, 1, 2]
    maps = {}
    iou_cache, prep_cache = {}, {}
    for metric, key in ((0, "bbox"), (1, "bev"), (2, "3d")):
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys,
                         metric, thresholds,
                         compute_aos=(compute_aos and metric == 0),
                         iou_cache=iou_cache, prep_cache=prep_cache)
        # mean over the overlap-range axis then 11-pt AP
        maps[key] = get_mAP(ret["precision"]).mean(axis=-1)
        if metric == 0 and compute_aos:
            maps["aos"] = get_mAP(ret["orientation"]).mean(axis=-1)

    out = io.StringIO()
    result_dict = {}
    for j, curcls in enumerate(current_classes):
        name = CLASS_NAMES[curcls]
        lo, hi, _ = class_to_range.get(name.lower(), [0.5, 0.95, 10])
        print(f"{name} coco AP@{lo:.2f}:0.05:{hi:.2f}:", file=out)
        for key in ("bbox", "bev", "3d"):
            print("{} AP:{:.2f}, {:.2f}, {:.2f}".format(
                key, *maps[key][j]), file=out)
            for d, dn in enumerate(("easy", "moderate", "hard")):
                result_dict[f"{name}_{key}_coco_{dn}"] = maps[key][j, d]
        if "aos" in maps:
            print("aos AP:{:.2f}, {:.2f}, {:.2f}".format(
                *maps["aos"][j]), file=out)
    return out.getvalue(), result_dict
