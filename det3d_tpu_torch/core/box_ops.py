"""3D box math on torch tensors: encode and decode, corners, rotation,
period wrap, standup IoU.

Port of det3d_tpu/core/box_ops.py (the functions serving and training
need).
The reference switches between numpy and jax per call; here every function
takes and returns torch tensors and keeps the reference's arithmetic order,
so results agree with it to rounding.

Box layout (lidar frame, z-center): ``[x, y, z, w, l, h, (vx, vy,) theta]``.
"""

from __future__ import annotations

import numpy as np
import torch

from det3d_tpu_torch.core.voxelize import filled


def second_box_encode(boxes, anchors, encode_angle_to_vector=False,
                      smooth_dim=False, norm_velo=False):
    """SECOND's box encoding of ``boxes`` against ``anchors``: center
    offsets over the anchor's BEV diagonal, z over its height, dims as log
    ratios (ratio - 1 with ``smooth_dim``), the angle as a residual or a
    (cos, sin) difference, 9-dim boxes with velocity residuals. Port of
    box_ops.second_box_encode; ``second_box_decode`` inverts it."""
    ndim = anchors.shape[-1]
    xa, ya, za = anchors[..., 0:1], anchors[..., 1:2], anchors[..., 2:3]
    wa, la, ha = anchors[..., 3:4], anchors[..., 4:5], anchors[..., 5:6]
    ra = anchors[..., ndim - 1:ndim]
    xg, yg, zg = boxes[..., 0:1], boxes[..., 1:2], boxes[..., 2:3]
    wg, lg, hg = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
    rg = boxes[..., ndim - 1:ndim]

    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    zt = (zg - za) / ha
    if smooth_dim:
        lt = lg / la - 1.0
        wt = wg / wa - 1.0
        ht = hg / ha - 1.0
    else:
        lt = torch.log(lg / la)
        wt = torch.log(wg / wa)
        ht = torch.log(hg / ha)
    parts = [xt, yt, zt, wt, lt, ht]

    if ndim > 7:
        vxa, vya = anchors[..., 6:7], anchors[..., 7:8]
        vxg, vyg = boxes[..., 6:7], boxes[..., 7:8]
        if norm_velo:
            parts.extend([(vxg - vxa) / diagonal, (vyg - vya) / diagonal])
        else:
            parts.extend([vxg - vxa, vyg - vya])

    if encode_angle_to_vector:
        parts.extend([torch.cos(rg) - torch.cos(ra),
                      torch.sin(rg) - torch.sin(ra)])
    else:
        parts.append(rg - ra)
    return torch.cat(parts, dim=-1)


def second_box_decode(box_encodings, anchors, encode_angle_to_vector=False,
                      smooth_dim=False, norm_velo=False):
    """Inverse of SECOND's box encoding. Port of box_ops.second_box_decode."""
    ndim = anchors.shape[-1]
    xa, ya, za = anchors[..., 0:1], anchors[..., 1:2], anchors[..., 2:3]
    wa, la, ha = anchors[..., 3:4], anchors[..., 4:5], anchors[..., 5:6]
    ra = anchors[..., ndim - 1:ndim]
    xt, yt, zt = (box_encodings[..., 0:1], box_encodings[..., 1:2],
                  box_encodings[..., 2:3])
    wt, lt, ht = (box_encodings[..., 3:4], box_encodings[..., 4:5],
                  box_encodings[..., 5:6])

    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    if smooth_dim:
        lg = (lt + 1.0) * la
        wg = (wt + 1.0) * wa
        hg = (ht + 1.0) * ha
    else:
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
    parts = [xg, yg, zg, wg, lg, hg]

    off = 6
    if ndim > 7:
        vxa, vya = anchors[..., 6:7], anchors[..., 7:8]
        vxt, vyt = box_encodings[..., 6:7], box_encodings[..., 7:8]
        if norm_velo:
            parts.extend([vxt * diagonal + vxa, vyt * diagonal + vya])
        else:
            parts.extend([vxt + vxa, vyt + vya])
        off = 8

    if encode_angle_to_vector:
        rtx = box_encodings[..., off:off + 1]
        rty = box_encodings[..., off + 1:off + 2]
        rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
    else:
        rg = box_encodings[..., off:off + 1] + ra
    parts.append(rg)
    return torch.cat(parts, dim=-1)


def corners_nd(dims, origin=0.5):
    """(N, ndim) dims -> (N, 2**ndim, ndim) corner offsets around ``origin``,
    in the reference's convex traversal order. Port of box_ops.corners_nd."""
    ndim = int(dims.shape[-1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(np.float32)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.asarray(origin, dtype=np.float32)
    norm = filled(corners_norm.ravel().tolist(), dims)
    return dims.reshape(-1, 1, ndim) * norm.reshape(1, 2 ** ndim, ndim)


def rotation_2d(points, angles):
    """Rotate (N, P, 2) points by per-box angles (N,), counterclockwise for a
    positive angle: ``out = p @ [[c, -s], [s, c]]``. Port of
    box_ops.rotation_2d, written out per component instead of an einsum."""
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c + y * s, x * (-s) + y * c], dim=-1)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """(N, 2) centers + (N, 2) dims + (N,) angles -> (N, 4, 2) BEV corners.
    Port of box_ops.center_to_corner_box2d."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def corner_to_standup_nd(corners):
    """(N, C, ndim) corners -> (N, 2*ndim) axis-aligned [min..., max...]."""
    return torch.cat([corners.amin(dim=1), corners.amax(dim=1)], dim=-1)


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap val into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def iou_matrix(boxes, qboxes, eps=0.0):
    """Pairwise IoU of axis-aligned [x1, y1, x2, y2] boxes over broadcast
    leading dimensions: (..., K, 4) x (..., M, 4) -> (..., K, M). ``eps``
    is added to every extent (box_np_ops.iou_jit's pixel convention; 0.0
    for metric boxes). The JAX package's operations in its order."""
    lt = torch.maximum(boxes[..., :, None, :2], qboxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:4], qboxes[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + eps, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((boxes[..., 2] - boxes[..., 0] + eps)
              * (boxes[..., 3] - boxes[..., 1] + eps))
    area_b = ((qboxes[..., 2] - qboxes[..., 0] + eps)
              * (qboxes[..., 3] - qboxes[..., 1] + eps))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0,
                       inter / torch.where(union > 0, union, 1.0), 0.0)


def rbbox2d_to_near_bbox(rbboxes):
    """Rotated BEV boxes [x, y, w, l, r] -> their nearest axis-aligned
    boxes [x1, y1, x2, y2]: w and l swap where the period-limited rotation
    is nearer pi/2. Port of box_ops.rbbox2d_to_near_bbox."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = torch.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., None]
    dims_swapped = torch.cat([rbboxes[..., 0:2], rbboxes[..., 3:4],
                              rbboxes[..., 2:3]], dim=-1)
    bboxes_center = torch.where(cond, dims_swapped, rbboxes[..., :4])
    centers, dims = bboxes_center[..., :2], bboxes_center[..., 2:]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)
