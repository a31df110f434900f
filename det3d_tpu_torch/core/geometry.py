"""Rotated-box intersection geometry on torch tensors.

Port of det3d_tpu/core/geometry.py: sort-free Liang-Barsky edge clipping.
The boundary of A∩B is (∂A∩B) ∪ (∂B∩A), and the shoelace integral is
additive over directed segments, so each edge's clipped contribution is
summed directly. The arithmetic is written in the same order as the
reference, and ``csrc/rotated_nms.cu`` repeats it operation for operation
without fused multiply-adds, so the CUDA kernel and this module round
alike. (Compiled XLA may fuse products into FMAs, so the JAX package can
differ in the last bit.)

Boxes are BEV rotated rectangles ``[cx, cy, w, l, angle]``.
"""

from __future__ import annotations

import torch

from det3d_tpu_torch.core import box_ops

_EPS = 1e-8


def box_to_corners(boxes):
    """(..., 5) rotated boxes -> (..., 4, 2) BEV corners."""
    flat = boxes.reshape(-1, 5)
    corners = box_ops.center_to_corner_box2d(flat[:, :2], flat[:, 2:4],
                                             flat[:, 4])
    return corners.reshape(*boxes.shape[:-1], 4, 2)


def _cross2(o, a, b):
    """z of cross((a-o), (b-o)): positive when o->a->b turns counterclockwise."""
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])


def _ccw(corners):
    """Force counterclockwise winding. (..., 4, 2) -> (..., 4, 2)."""
    area2 = (
        _cross2(corners[..., 0, :], corners[..., 1, :], corners[..., 2, :])
        + _cross2(corners[..., 0, :], corners[..., 2, :], corners[..., 3, :]))
    return torch.where((area2 >= 0)[..., None, None], corners,
                       corners.flip(-2))


def _clip_contrib(px, py, qx, qy, open_side):
    """Shoelace contribution of quad-P edges Liang-Barsky-clipped to quad Q.

    px/py/qx/qy: length-4 lists of same-shaped (or broadcastable) coordinate
    tensors, CCW. ``open_side`` clips against the open interior of Q, so a
    boundary run shared by both quads is counted once, not twice.
    """
    total = 0.0
    for i in range(4):
        x1, y1 = px[i], py[i]
        x2, y2 = px[(i + 1) % 4], py[(i + 1) % 4]
        dx, dy = x2 - x1, y2 - y1
        t_lo = torch.zeros_like(x1)
        t_hi = torch.ones_like(x1)
        ok = None
        for j in range(4):
            ex = qx[(j + 1) % 4] - qx[j]
            ey = qy[(j + 1) % 4] - qy[j]
            # inside(t): cross(e, p(t) - q_j) = a + t*b >= 0
            a = ex * (y1 - qy[j]) - ey * (x1 - qx[j])
            b = ex * dy - ey * dx
            moving = torch.abs(b) > _EPS
            b_safe = torch.where(moving, b, 1.0)
            tj = -a / b_safe
            t_lo = torch.where(moving & (b > 0), torch.maximum(t_lo, tj), t_lo)
            t_hi = torch.where(moving & (b < 0), torch.minimum(t_hi, tj), t_hi)
            # parallel edge: the whole segment is in or out of this half-plane
            border_ok = (a > _EPS) if open_side else (a >= -_EPS)
            step = moving | border_ok
            ok = step if ok is None else ok & step
        valid = ok & (t_lo < t_hi)
        sx1 = x1 + t_lo * dx
        sy1 = y1 + t_lo * dy
        sx2 = x1 + t_hi * dx
        sy2 = y1 + t_hi * dy
        total = total + torch.where(valid, sx1 * sy2 - sx2 * sy1, 0.0)
    return total


def rotated_intersection_area(corners_a, corners_b):
    """Intersection area of two convex quads. (..., 4, 2) x2 -> (...,)."""
    A = _ccw(corners_a)
    B = _ccw(corners_b)
    ax = [A[..., i, 0] for i in range(4)]
    ay = [A[..., i, 1] for i in range(4)]
    bx = [B[..., i, 0] for i in range(4)]
    by = [B[..., i, 1] for i in range(4)]
    total = (_clip_contrib(ax, ay, bx, by, open_side=False)
             + _clip_contrib(bx, by, ax, ay, open_side=True))
    return torch.clamp(0.5 * total, min=0.0)


def polygon_area(corners):
    """Shoelace area of (..., 4, 2) corners, as the reference NMS computes it
    (ops/nms.py::_pairwise_rotated_iou_from_corners)."""
    nxt = torch.roll(corners, -1, dims=-2)
    terms = corners[..., 0] * nxt[..., 1] - nxt[..., 0] * corners[..., 1]
    total = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]
    return 0.5 * torch.abs(total)


def rotated_iou_matrix(boxes, qboxes, criterion=-1):
    """Pairwise rotated IoU / overlap of BEV boxes over broadcast leading
    dimensions: (..., N, 5) x (..., K, 5) -> (..., N, K). ``criterion``
    -1: intersection over union; 0: over the area of ``boxes``; 1: over
    the area of ``qboxes``. Port of geometry.rotated_iou_matrix."""
    ca = box_to_corners(boxes)[..., :, None, :, :]       # (..., N, 1, 4, 2)
    cb = box_to_corners(qboxes)[..., None, :, :, :]      # (..., 1, K, 4, 2)
    shape = torch.broadcast_shapes(ca.shape, cb.shape)
    inter = rotated_intersection_area(ca.expand(shape), cb.expand(shape))
    area_a = (boxes[..., 2] * boxes[..., 3])[..., :, None]
    area_b = (qboxes[..., 2] * qboxes[..., 3])[..., None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = area_a.expand(inter.shape)
    elif criterion == 1:
        denom = area_b.expand(inter.shape)
    else:
        raise ValueError("criterion must be -1, 0 or 1")
    return torch.where(denom > 0,
                       inter / torch.where(denom > 0, denom, 1.0), 0.0)
