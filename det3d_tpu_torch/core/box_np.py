"""Host-side numpy box utilities: camera<->lidar transforms, corners, 2D.

The port's own copy of det3d_tpu/core/box_np.py (the port imports nothing
of the JAX package; tests/test_torch_augment_db.py holds it equal).
Parity: reference det3d/core/bbox/box_np_ops.py — ``limit_period`` (:572),
``project_to_image`` (:900), ``camera_to_lidar``/``lidar_to_camera``
(:909,:917), ``box_camera_to_lidar``/``box_lidar_to_camera`` (:925,:933),
``center_to_corner_box3d`` (:496), ``change_box3d_center_`` (:1331),
``corner_to_standup_nd`` (:781), ``iou_jit`` (:1056 — axis-aligned 2D IoU).
These run in the data pipeline and evaluation (host), so they stay numpy.
"""

from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotation_3d_in_axis(points, angles, axis=2):
    """(N, P, 3) points, (N,) angles — reference rot_mat_T convention
    (out = p @ M, 'clockwise when positive'). box_np_ops.py:358-391."""
    c, s = np.cos(angles), np.sin(angles)
    ones, zeros = np.ones_like(c), np.zeros_like(c)
    if axis == 2 or axis == -1:
        rot = np.stack([
            np.stack([c, -s, zeros], -1),
            np.stack([s, c, zeros], -1),
            np.stack([zeros, zeros, ones], -1)], axis=-2)
    elif axis == 1:
        rot = np.stack([
            np.stack([c, zeros, -s], -1),
            np.stack([zeros, ones, zeros], -1),
            np.stack([s, zeros, c], -1)], axis=-2)
    elif axis == 0:
        rot = np.stack([
            np.stack([zeros, c, -s], -1),
            np.stack([zeros, s, c], -1),
            np.stack([ones, zeros, zeros], -1)], axis=-2)
    else:
        raise ValueError("axis must be in 0/1/2")
    return np.einsum("nij,njk->nik", points, rot)


def corners_nd(dims, origin=0.5):
    """(N, k) dims -> (N, 2**k, k) axis-aligned corners around origin."""
    ndim = dims.shape[1]
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.asarray(origin, dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, -1, ndim)


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 1.0, 0.5),
                           axis=1):
    """(N,3),(N,3),(N,) -> (N,8,3). box_np_ops.py:496-530."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape(-1, 1, 3)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """(N,2),(N,2),(N,) -> (N,4,2). box_np_ops.py:477-494."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        c, s = np.cos(angles), np.sin(angles)
        out_x = corners[..., 0] * c[:, None] + corners[..., 1] * s[:, None]
        out_y = -corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
        corners = np.stack([out_x, out_y], axis=-1)
    return corners + centers.reshape(-1, 1, 2)


def corner_to_standup_nd(corners):
    """(N, 2**k, k) -> (N, 2k) [mins, maxes]."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)


def project_to_image(points_3d, proj_mat):
    """(..., 3) camera-frame -> (..., 2) pixels. box_np_ops.py:900-906."""
    shape = list(points_3d.shape)
    shape[-1] = 1
    pts4 = np.concatenate([points_3d, np.zeros(shape)], axis=-1)
    pts4[..., 3] = 1.0
    pt2 = pts4 @ proj_mat.T
    return pt2[..., :2] / pt2[..., 2:3]


def camera_to_lidar(points, r_rect, velo2cam):
    shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(shape + [1])], axis=-1)
    return (points @ np.linalg.inv((r_rect @ velo2cam).T))[..., :3]


def lidar_to_camera(points, r_rect, velo2cam):
    shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(shape + [1])], axis=-1)
    return (points @ (r_rect @ velo2cam).T)[..., :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """(N, 7) camera [xyz, l, h, w, ry] -> lidar [xyz, w, l, h, r]."""
    xyz = camera_to_lidar(data[:, 0:3], r_rect, velo2cam)
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    return np.concatenate([xyz, w, l, h, data[:, 6:7]], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    """(N, 7) lidar [xyz, w, l, h, r] -> camera [xyz, l, h, w, ry]."""
    xyz = lidar_to_camera(data[:, 0:3], r_rect, velo2cam)
    w, l, h = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    return np.concatenate([xyz, l, h, w, data[:, 6:7]], axis=1)


def change_box3d_center_(box3d, src, dst):
    """In-place origin change (e.g. KITTI bottom-center -> true center)."""
    dst = np.asarray(dst, box3d.dtype)
    src = np.asarray(src, box3d.dtype)
    box3d[..., :3] += box3d[..., 3:6] * (dst - src)


def iou_2d(boxes, qboxes, eps=0.0):
    """Axis-aligned pairwise 2D IoU on [x1,y1,x2,y2]. box_np_ops.py:1056."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    lt = np.maximum(boxes[:, None, :2], qboxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:4], qboxes[None, :, 2:4])
    wh = np.clip(rb - lt + eps, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))[:, None]
    area_b = ((qboxes[:, 2] - qboxes[:, 0] + eps)
              * (qboxes[:, 3] - qboxes[:, 1] + eps))[None, :]
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
