"""3D box math on torch tensors: decode, corners, rotation, period wrap.

Port of det3d_tpu/core/box_ops.py (the functions the serving path needs).
The reference switches between numpy and jax per call; here every function
takes and returns torch tensors and keeps the reference's arithmetic order,
so results agree with it to rounding.

Box layout (lidar frame, z-center): ``[x, y, z, w, l, h, (vx, vy,) theta]``.
"""

from __future__ import annotations

import numpy as np
import torch

from det3d_tpu_torch.core.voxelize import filled


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


def iou_matrix(boxes, qboxes):
    """Pairwise IoU of axis-aligned [x1, y1, x2, y2] boxes over a leading
    batch dimension: (N, K, 4) x (N, M, 4) -> (N, K, M)."""
    lt = torch.maximum(boxes[:, :, None, :2], qboxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:4], qboxes[:, None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    area_b = (qboxes[..., 2] - qboxes[..., 0]) * (qboxes[..., 3]
                                                  - qboxes[..., 1])
    union = area_a[:, :, None] + area_b[:, None, :] - inter
    return torch.where(union > 0,
                       inter / torch.where(union > 0, union, 1.0), 0.0)
