"""What decides ``correct``: the numbers compared with the plain reference.

Serving, per checked request:

- ``head_gap``: the widest gap between the program's head outputs (the
  tensors the captured step's head writes, read after the request's
  replay) and the reference's own forward from the same points and
  weights, each tensor's gap over its largest reference value. It covers
  the voxelizer, the device plans, the middle, the dense tail, the RPN
  and the head.
- ``nms_mismatch``: the detections the program returned against a greedy
  NMS that the reference replays in float64 over the candidates it
  decodes from the program's own head outputs (score threshold, top
  ``nms_pre_max_size``, IoU above the threshold suppresses,
  ``nms_post_max_size``, direction fix, centre range, ``max_per_img``):
  each returned detection matched to its candidate by label, score and
  box, then every decision the replay sees clearly (each IoU with a kept
  box farther from the threshold than fp32 resolves, ``tie_margin``)
  that differs, and every
  returned detection that is no candidate. At a near tie fp32 and
  float64 may decide either way, and the replay follows the program.
- ``det_gap``: the widest gap of a matched detection's box and score.

Training, from the program's state after its first three steps (each
cell's limits file names the ones it compares; the others are reported):

- ``loss_gap``: the widest relative gap of a step's loss; ``loss1_gap``
  the first step's.
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment over (1 - b1)), each leaf's norm against the reference's, the
  gap over the larger of that leaf's norm and the median leaf's, at the
  worst leaf (``grad_gap``) and the median leaf (``grad_gap_median``).
- ``update_gap``, ``update_gap_median``: the change of each leaf over the
  three steps, the same way, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (the rest move under Adam by
  round-off alone).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

MARGIN = 1e-4
F32_EPS = 2.0 ** -23


def tie_margin(b5):
    """(m, m) margins of an IoU near-tie between rotated boxes [x, y, w, l,
    r]: MARGIN plus what fp32 can resolve, 32 ulps of the pair's farthest
    coordinate over its smallest side (an fp32 corner is off by an ulp of
    its coordinate; the intersection's error over the area grows as the
    box shrinks: 0.4-m traffic cones 47 m out reach ~5e-4)."""
    reach = torch.maximum(b5[:, 0].abs(), b5[:, 1].abs()) + 0.5 * torch.sqrt(
        b5[:, 2] ** 2 + b5[:, 3] ** 2)
    side = torch.clamp(torch.minimum(b5[:, 2], b5[:, 3]), min=1e-6)
    far = torch.maximum(reach[:, None], reach[None, :])
    small = torch.minimum(side[:, None], side[None, :])
    return (MARGIN + 32 * F32_EPS * far / small).cpu().numpy()


def head_gap(prog: List[Dict[str, torch.Tensor]],
             ref: List[Dict[str, torch.Tensor]]) -> float:
    gap = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            pv = p[k].to(rv.device).float()
            scale = max(float(rv.abs().max()), 1e-30)
            gap = max(gap, float((pv - rv).abs().max()) / scale)
    return gap


def _candidates(R, arch, heads_t, anchors, t, b):
    """(boxes (A, nd), scores (A,), labels (A,), dir labels (A,) or
    None) of task t, sample b, decoded from the head outputs in fp32."""
    nc = arch.num_classes[t]
    box = heads_t["box_preds"][b].reshape(-1, arch.code).float()
    cls = heads_t["cls_preds"][b].reshape(-1, nc).float()
    boxes = R.decode(arch, box, anchors)
    sc = torch.sigmoid(cls)
    if nc == 1:
        scores, labels = sc[:, 0], torch.zeros(sc.shape[0], dtype=torch.long,
                                               device=sc.device)
    else:
        scores, labels = torch.max(sc, -1)
    dirs = None
    if "dir_cls_preds" in heads_t:
        dirs = torch.argmax(heads_t["dir_cls_preds"][b].reshape(-1, 2)
                            .float(), -1)
    return boxes, scores, labels, dirs


def _iou_rows(R, b5, near):
    """Dense (m, m) float64 IoU of the candidate boxes over the pairs
    ``near`` marks (upper triangle), zero elsewhere."""
    m = b5.shape[0]
    ii, jj = torch.nonzero(near, as_tuple=True)
    iou = torch.zeros(m, m, dtype=torch.float64, device=b5.device)
    for s in range(0, ii.numel(), 200_000):
        a, c = ii[s:s + 200_000], jj[s:s + 200_000]
        iou[a, c] = R.rotated_iou(b5[a], b5[c])
    return iou.cpu().numpy(), int(ii.numel())


def _task_check(R, arch, heads_t, anchors, t, b, test_cfg, prog,
                floor=-math.inf):
    """One sample's task: the program's detections of it ``prog`` [(label,
    score, box)] against the greedy NMS replayed over the candidates
    decoded from the head outputs. Returns (mismatches, near ties, gap,
    (valid candidates, near pairs, slots), unmatched program detections).

    The replay follows the program's decision wherever it can see one (a
    candidate inside the centre range is kept exactly when it is among
    the program's detections) and counts a mismatch only where the
    decision was clear: every IoU with a kept box at least ``MARGIN`` from
    the threshold. A candidate outside the range, which the program drops
    after its NMS, takes the replay's decision; one at or under ``floor``
    (the lowest score returned, where ``max_per_img`` was reached) may
    have been cut by it."""
    nms = test_cfg["nms"]
    thr = float(test_cfg["score_threshold"])
    pre, post = int(nms["nms_pre_max_size"]), int(nms["nms_post_max_size"])
    iou_thr = float(nms["nms_iou_threshold"])
    boxes, scores, labels, dirs = _candidates(R, arch, heads_t, anchors, t,
                                              b)
    nms_scores = torch.where(scores >= thr, scores, -1.0)
    srt, idx = torch.sort(nms_scores, descending=True, stable=True)
    k = min(pre, idx.numel())
    order = idx[:k][srt[:k] > 0]
    m = int(order.numel())
    bx = boxes[order].clone()
    if dirs is not None:
        off_d = float(arch.head.get("direction_offset", 0.0))
        opp = ((bx[:, -1] - off_d) > 0) ^ dirs[order].bool()
        bx[:, -1] = bx[:, -1] + torch.where(opp, math.pi, 0.0)
    pcr = test_cfg.get("post_center_limit_range")
    inside = np.ones(m, bool)
    if pcr:
        lo = torch.tensor(pcr[:3], device=bx.device)
        hi = torch.tensor(pcr[3:], device=bx.device)
        inside = ((bx[:, :3] >= lo).all(1) & (bx[:, :3] <= hi).all(1)
                  ).cpu().numpy()
    cbox = bx.cpu().numpy().astype(np.float64)
    csc = scores[order].cpu().numpy().astype(np.float64)
    clab = labels[order].cpu().numpy()
    # the program's detections, each matched to its candidate
    in_prog = np.zeros(m, bool)
    gap, unmatched = 0.0, 0
    for lab, sc, box in prog:
        best, best_gap = None, None
        cand = np.nonzero((clab == lab) & ~in_prog)[0]
        if cand.size:
            g = np.maximum(np.abs(csc[cand] - sc), np.max(
                np.abs(cbox[cand] - np.asarray(box, np.float64))
                / (1 + np.abs(cbox[cand])), 1))
            i = int(np.argmin(g))
            best, best_gap = int(cand[i]), float(g[i])
        if best is not None and best_gap < 1e-3:
            in_prog[best] = True
            gap = max(gap, best_gap)
        else:
            unmatched += 1
            print(f"nms mismatch: task {t} sample {b}: a returned "
                  f"detection (label {lab}, score {sc!r}) is no candidate "
                  f"(nearest gap {best_gap!r})", file=sys.stderr)
    if m == 0:
        return unmatched, 0, gap, (0, 0, k), unmatched
    b5 = torch.cat([bx[:, 0:2], bx[:, 3:5], boxes[order][:, -1:]],
                   -1).double()
    rad = 0.5 * torch.sqrt(b5[:, 2] ** 2 + b5[:, 3] ** 2)
    d2 = ((b5[:, None, :2] - b5[None, :, :2]) ** 2).sum(-1)
    near = (d2 <= (rad[:, None] + rad[None, :]) ** 2 * (1 + 1e-6)) & \
        torch.triu(torch.ones(m, m, dtype=torch.bool, device=b5.device), 1)
    iou, n_near = _iou_rows(R, b5, near)
    margin = tie_margin(b5)
    keep = np.zeros(m, bool)
    mism, ties, n_kept = unmatched, 0, 0
    for j in range(m):
        over = iou[:j, j][keep[:j]]
        clear = not (over.size and (np.abs(over - iou_thr)
                                    < margin[:j, j][keep[:j]]).any())
        ties += not clear
        ref = n_kept < post and not (over > iou_thr).any()
        if inside[j]:
            if clear and ref != in_prog[j] and not (
                    ref and csc[j] <= floor):
                mism += 1
                print(f"nms mismatch: task {t} sample {b} rank {j} of {m} "
                      f"score {csc[j]!r} program keeps {bool(in_prog[j])} "
                      f"replay keeps {bool(ref)} kept before {n_kept} "
                      f"max IoU with a kept box "
                      f"{float(over.max()) if over.size else 0.0!r} "
                      f"box {cbox[j].tolist()}", file=sys.stderr)
            keep[j] = in_prog[j]
        else:
            keep[j] = ref
        n_kept += keep[j]
    return mism, ties, gap, (m, n_near, k), unmatched


def nms_check(R, arch, heads, dets, anchors_t, test_cfg):
    """(mismatches, near ties, det_gap, NMS work list) over the samples of
    one request. ``dets``: the program's numpy detections dict, its
    labels numbered over the tasks' classes in order."""
    mism, ties, gap, work = 0, 0, 0.0, []
    mpi = int(test_cfg.get("max_per_img", 0) or 0)
    for b in range(dets["scores"].shape[0]):
        v = dets["valid"][b]
        labs = dets["label_preds"][b][v]
        scs = dets["scores"][b][v]
        bxs = dets["box3d_lidar"][b][v]
        floor = float(scs.min()) if mpi and int(v.sum()) >= mpi \
            else -math.inf
        off = 0
        for t, heads_t in enumerate(heads):
            nc = arch.num_classes[t]
            sel = (labs >= off) & (labs < off + nc)
            prog = [(int(l) - off, float(s), x) for l, s, x in
                    zip(labs[sel], scs[sel], bxs[sel])]
            mi, ti, g, w, _ = _task_check(R, arch, heads_t, anchors_t[t][0],
                                          t, b, test_cfg, prog, floor)
            mism, ties, gap = mism + mi, ties + ti, max(gap, g)
            work.append(w)
            off += nc
    return mism, ties, gap, work


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def leaf_gaps(prog: Sequence[float], ref: Sequence[float]) -> np.ndarray:
    """Each leaf's |prog - ref| over max(ref leaf, median ref leaf)."""
    r = np.asarray(ref, np.float64)
    p = np.asarray(prog, np.float64)
    med = float(np.median(r)) if r.size else 0.0
    return np.abs(p - r) / np.maximum(np.maximum(r, med), 1e-30)


def train_numbers(prog: dict, ref: dict, names=None) -> Dict[str, float]:
    """``prog`` / ``ref``: {"loss": [3 floats], "grad": [leaf norms],
    "update": [leaf norms]}. The update gap leaves out the leaves whose
    reference gradient is under a thousandth of the median leaf's."""
    lp, lr = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    print("train losses program " + " ".join(repr(float(v)) for v in lp)
          + " reference " + " ".join(repr(float(v)) for v in lr),
          file=sys.stderr)
    g = np.asarray(ref["grad"], np.float64)
    moving = g >= 1e-3 * float(np.median(g))
    gg = leaf_gaps(prog["grad"], ref["grad"])
    ug = leaf_gaps(np.asarray(prog["update"])[moving],
                   np.asarray(ref["update"])[moving])
    if names is not None and gg.size and ug.size:
        mv = [n for n, k in zip(names, moving) if k]
        i, j = int(np.argmax(gg)), int(np.argmax(ug))
        print(f"worst gradient leaf {names[i]} {prog['grad'][i]!r} vs "
              f"{ref['grad'][i]!r}; worst update leaf {mv[j]} "
              f"{np.asarray(prog['update'])[moving][j]!r} vs "
              f"{np.asarray(ref['update'])[moving][j]!r}; "
              f"{int((~moving).sum())} leaves left out", file=sys.stderr)
    lg = np.abs(lp - lr) / np.abs(lr)
    return {"loss_gap": float(lg.max()),
            "loss1_gap": float(lg[0]),
            "grad_gap": float(gg.max()) if gg.size else 0.0,
            "grad_gap_median": float(np.median(gg)) if gg.size else 0.0,
            "update_gap": float(ug.max()) if ug.size else 0.0,
            "update_gap_median": float(np.median(ug)) if ug.size else 0.0}
