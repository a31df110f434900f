"""Fixed-size greedy NMS (rotated and axis-aligned), batched over samples.

Port of det3d_tpu/ops/nms.py: top-k by score to ``pre_max_size``, the keep
mask, then compaction of the kept entries in score order to
``post_max_size`` slots. Every function takes a leading sample dimension N
(the reference vmaps over it). Rotated NMS goes through
``ops/nms_cuda.py::rotated_nms_keep``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from det3d_tpu_torch.core import box_ops
from det3d_tpu_torch.core.geometry import _ccw, box_to_corners, polygon_area
from det3d_tpu_torch.ops.nms_cuda import greedy_suppress, rotated_nms_keep


def sort_desc(scores, dim=-1):
    """Stable descending sort: ties keep the lower index first, as
    ``jax.lax.top_k`` does. Returns (values, indices)."""
    return torch.sort(scores, dim=dim, descending=True, stable=True)


def nms(boxes_for_nms, scores, *, pre_max_size: int, post_max_size: int,
        iou_threshold: float, rotated: bool = True):
    """Greedy NMS with fixed output size, per sample.

    boxes_for_nms: (N, A, 5) rotated BEV boxes [x, y, w, l, r] when
      ``rotated``, else (N, A, 4) standup [x1, y1, x2, y2].
    scores: (N, A); entries at or below 0 are invalid (the caller masks
      sub-threshold scores to a negative value).

    Returns (indices, valid): (N, P) int64 indices into A and a bool mask,
    P = min(post_max_size, pre_max_size, A), in score-descending order.
    """
    n, a = scores.shape
    k = min(pre_max_size, a)
    top_scores, top_idx = sort_desc(scores)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    valid = top_scores > 0.0
    boxes = torch.gather(
        boxes_for_nms, 1,
        top_idx[..., None].expand(-1, -1, boxes_for_nms.shape[-1]))

    if rotated:
        corners = _ccw(box_to_corners(boxes))                 # (N, k, 4, 2)
        area = polygon_area(corners)
        keep = rotated_nms_keep(corners.reshape(n, k, 8).contiguous(),
                                area.contiguous(), valid.contiguous(),
                                iou_threshold)
    else:
        keep = greedy_suppress(box_ops.iou_matrix(boxes, boxes), valid,
                               iou_threshold)

    # compact the kept entries (already in score order) to post_max_size
    pos = torch.arange(k, device=scores.device).expand(n, k)
    rank_key = torch.where(keep, pos, k + 1)
    order = torch.sort(rank_key, dim=1, stable=True).indices[:, :post_max_size]
    out_valid = torch.gather(keep, 1, order)
    out_idx = torch.where(out_valid, torch.gather(top_idx, 1, order), 0)
    return out_idx, out_valid


def rotate_nms(boxes_bev, scores, pre_max_size, post_max_size, iou_threshold):
    """Rotated NMS over (N, A, 5) boxes."""
    return nms(boxes_bev, scores, pre_max_size=pre_max_size,
               post_max_size=post_max_size, iou_threshold=iou_threshold,
               rotated=True)


def standup_nms(boxes_standup, scores, pre_max_size, post_max_size,
                iou_threshold):
    """Axis-aligned NMS over (N, A, 4) standup boxes."""
    return nms(boxes_standup, scores, pre_max_size=pre_max_size,
               post_max_size=post_max_size, iou_threshold=iou_threshold,
               rotated=False)
