"""Host-side (numpy) augmentation kernels for the data pipeline.

Port of det3d_tpu/core/augment.py. The reference implements these with
numba JIT kernels (det3d/core/sampler/preprocess.py: ``noise_per_object_v3_``
:587, ``random_flip`` :816, ``random_flip_both`` :829, ``global_rotation``
:796, ``global_scaling_v2`` :857, ``global_translate_`` :962,
``box_collision_test`` :877). They run in the data loader's workers on raw
variable-length clouds before padding, so they stay on the host, in numpy,
and draw from ``rng`` (``np.random`` when None) in the JAX package's order:
one seed gives the same examples in both packages. Box and corner
conventions match core/box_ops.py (corner = R(-theta) @ local + center).

The geometry hot paths run the C++ of csrc/pointops.cc (``points_in_rbbox``,
``box_collision``, ``intersection_area``), built with g++ at first use
(csrc/__init__.py; ``pointops_lib``); a failed build raises, and nothing
falls back to numpy. The numpy versions stay beside them as the plain
versions (``*_ref``; ``intersection_area_corners`` keeps the JAX package's
name, which the KITTI evaluation calls): the tests and chip_smoke.py hold
the native code to them, nothing on the data path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from det3d_tpu_torch import csrc

_EPS = 1e-8


# ---------------------------------------------------------------------------
# the native kernels (csrc/pointops.cc)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pointops_lib() -> ctypes.CDLL:
    """pointops.cc's library, its functions' argument types declared. A
    data loader calls it in the parent before it forks its workers, so
    that they do not each build it."""
    lib = csrc.load("pointops")
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.points_in_rbbox.argtypes = [f32p, i64, i64, f32p, i64, u8p]
    lib.box_collision.argtypes = [f32p, i64, f32p, i64, u8p]
    lib.intersection_area.argtypes = [f64p, f64p, i64, f64p]
    return lib


def _center_boxes(boxes, origin):
    """(N, >=7) boxes -> (N, 7) float32 [x y z w l h r] about their true
    centers, as pointops.cc's points_in_rbbox takes them."""
    boxes = np.asarray(boxes, np.float64)
    adj = boxes[:, :7].copy()
    adj[:, :3] += (0.5 - np.asarray(origin)) * boxes[:, 3:6]
    adj[:, 6] = boxes[:, -1]
    return np.ascontiguousarray(adj, np.float32)


def points_in_rbbox(points, boxes, origin=(0.5, 0.5, 0.5)):
    """(P, >=3) x (N, >=7) -> (P, N) bool: which points lie in which
    rotated box (pointops.cc). Twin: ``points_in_rbbox_ref``."""
    if boxes.shape[0] == 0:
        return np.zeros((points.shape[0], 0), bool)
    pts = np.ascontiguousarray(points, np.float32)
    bxs = _center_boxes(boxes, origin)
    out = np.empty((pts.shape[0], bxs.shape[0]), np.uint8)
    pointops_lib().points_in_rbbox(pts, pts.shape[0], pts.shape[1], bxs,
                                   bxs.shape[0], out)
    return out.astype(bool)


def points_in_rbbox_ref(points, boxes, origin=(0.5, 0.5, 0.5)):
    """numpy twin of ``points_in_rbbox``, in its arithmetic: float32 boxes
    and offsets, the rotation and the half sizes in float64."""
    if boxes.shape[0] == 0:
        return np.zeros((points.shape[0], 0), bool)
    b32 = _center_boxes(boxes, origin)
    b = b32.astype(np.float64)
    pts = np.asarray(points, np.float32)[:, :3]
    d = (pts[:, None, :] - b32[None, :, :3]).astype(np.float64)
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    return ((np.abs(lx) <= b[:, 3] / 2.0) & (np.abs(ly) <= b[:, 4] / 2.0)
            & (np.abs(d[..., 2]) <= b[:, 5] / 2.0))


def box_collision(boxes_a, boxes_b):
    """(N, 5), (K, 5) BEV [x y w l r] -> (N, K) bool: which pairs overlap
    (pointops.cc). Twin: ``box_collision_ref``."""
    a = np.ascontiguousarray(boxes_a, np.float32)
    b = np.ascontiguousarray(boxes_b, np.float32)
    out = np.empty((a.shape[0], b.shape[0]), np.uint8)
    pointops_lib().box_collision(a, a.shape[0], b, b.shape[0], out)
    return out.astype(bool)


def _corners_f64(boxes):
    """(N, 5) BEV boxes, rounded to float32 -> (N, 4, 2) float64 corners
    in pointops.cc's arithmetic (box_corners)."""
    b = np.asarray(boxes, np.float32).astype(np.float64)
    c, s = np.cos(b[:, 4]), np.sin(b[:, 4])
    dx, dy = b[:, 2] / 2.0, b[:, 3] / 2.0
    lx = np.stack([-dx, -dx, dx, dx], 1)
    ly = np.stack([-dy, dy, dy, -dy], 1)
    x = lx * c[:, None] + ly * s[:, None] + b[:, :1]
    y = -lx * s[:, None] + ly * c[:, None] + b[:, 1:2]
    return np.stack([x, y], -1)


def box_collision_ref(boxes_a, boxes_b):
    """numpy twin of ``box_collision``: the pairs whose intersection area
    exceeds 1e-8."""
    n, k = len(boxes_a), len(boxes_b)
    if n == 0 or k == 0:
        return np.zeros((n, k), bool)
    ca, cb = _corners_f64(boxes_a), _corners_f64(boxes_b)
    return intersection_area_corners(
        np.broadcast_to(ca[:, None], (n, k, 4, 2)),
        np.broadcast_to(cb[None, :], (n, k, 4, 2))) > 1e-8


def intersection_area(corners_a, corners_b):
    """Paired rotated intersection areas, (N, 4, 2) x 2 -> (N,) float64
    (pointops.cc). Twin: ``intersection_area_corners``."""
    a = np.ascontiguousarray(corners_a, np.float64)
    b = np.ascontiguousarray(corners_b, np.float64)
    out = np.empty((a.shape[0],), np.float64)
    pointops_lib().intersection_area(a, b, a.shape[0], out)
    return out


# ---------------------------------------------------------------------------
# geometry helpers (numpy mirrors of core/geometry.py)
# ---------------------------------------------------------------------------

def rotation_points_single_angle(points, angle):
    """Rotate (N, 3) points about z. Parity: box_np_ops.py:393-417 axis=2."""
    c, s = np.cos(angle), np.sin(angle)
    rot_t = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=points.dtype)
    return points @ rot_t


def corners_bev(boxes):
    """(N, 5) [x, y, w, l, r] -> (N, 4, 2) BEV corners."""
    x, y, w, l, r = (boxes[:, i] for i in range(5))
    dx, dy = w / 2, l / 2
    local = np.stack([
        np.stack([-dx, -dy], -1), np.stack([-dx, dy], -1),
        np.stack([dx, dy], -1), np.stack([dx, -dy], -1)], axis=1)  # (N,4,2)
    c, s = np.cos(r), np.sin(r)
    out_x = local[..., 0] * c[:, None] + local[..., 1] * s[:, None]
    out_y = -local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([out_x + x[:, None], out_y + y[:, None]], axis=-1)


def _cross2d(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _ccw_np(corners):
    area2 = _cross2d(corners[..., 1, :] - corners[..., 0, :],
                     corners[..., 2, :] - corners[..., 0, :]) \
        + _cross2d(corners[..., 2, :] - corners[..., 0, :],
                   corners[..., 3, :] - corners[..., 0, :])
    return np.where((area2 >= 0)[..., None, None], corners,
                    corners[..., ::-1, :])


def _clip_contrib_np(px, py, qx, qy, open_side):
    total = 0.0
    for i in range(4):
        x1, y1 = px[i], py[i]
        x2, y2 = px[(i + 1) % 4], py[(i + 1) % 4]
        dx, dy = x2 - x1, y2 - y1
        t_lo = np.zeros_like(x1)
        t_hi = np.ones_like(x1)
        ok = np.ones(x1.shape, bool)
        for j in range(4):
            ex = qx[(j + 1) % 4] - qx[j]
            ey = qy[(j + 1) % 4] - qy[j]
            a = ex * (y1 - qy[j]) - ey * (x1 - qx[j])
            b = ex * dy - ey * dx
            b_safe = np.where(np.abs(b) > _EPS, b, 1.0)
            tj = -a / b_safe
            moving = np.abs(b) > _EPS
            t_lo = np.where(moving & (b > 0), np.maximum(t_lo, tj), t_lo)
            t_hi = np.where(moving & (b < 0), np.minimum(t_hi, tj), t_hi)
            border_ok = (a > _EPS) if open_side else (a >= -_EPS)
            ok = ok & (moving | border_ok)
        valid = ok & (t_lo < t_hi)
        sx1 = x1 + t_lo * dx
        sy1 = y1 + t_lo * dy
        sx2 = x1 + t_hi * dx
        sy2 = y1 + t_hi * dy
        total = total + np.where(valid, sx1 * sy2 - sx2 * sy1, 0.0)
    return total


def intersection_area_corners(corners_a, corners_b):
    """numpy twin of geometry.rotated_intersection_area and of
    ``intersection_area``: (...,4,2)x2 -> (...)."""
    a = _ccw_np(np.asarray(corners_a, np.float64))
    b = _ccw_np(np.asarray(corners_b, np.float64))
    ax = [a[..., i, 0] for i in range(4)]
    ay = [a[..., i, 1] for i in range(4)]
    bx = [b[..., i, 0] for i in range(4)]
    by = [b[..., i, 1] for i in range(4)]
    total = (_clip_contrib_np(ax, ay, bx, by, False)
             + _clip_contrib_np(bx, by, ax, ay, True))
    return np.maximum(0.5 * total, 0.0)


def box_collision_test(corners_a, corners_b):
    """(N,4,2) x (K,4,2) -> (N,K) bool any-overlap (parity:
    preprocess.py:877 ``box_collision_test``, via the native intersection
    area of every pair)."""
    n, k = corners_a.shape[0], corners_b.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), bool)
    ca = np.broadcast_to(corners_a[:, None], (n, k, 4, 2))
    cb = np.broadcast_to(corners_b[None, :], (n, k, 4, 2))
    return (intersection_area(ca.reshape(-1, 4, 2), cb.reshape(-1, 4, 2))
            > 1e-8).reshape(n, k)


# ---------------------------------------------------------------------------
# global augmentations (in-place semantics like the reference)
# ---------------------------------------------------------------------------

def random_flip(gt_boxes, points, probability=0.5, rng=None):
    """y-flip. Parity: preprocess.py:816-827."""
    rng = rng or np.random
    if rng.uniform() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:       # velocity vy
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def random_flip_both(gt_boxes, points, probability=0.5, rng=None):
    """Independent y-flip then x-flip (nuScenes). Parity: :829-855."""
    rng = rng or np.random
    gt_boxes, points = random_flip(gt_boxes, points, probability, rng)
    if rng.uniform() < probability:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        points[:, 0] = -points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:       # velocity vx
            gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=np.pi / 4, rng=None):
    """Uniform global z-rotation. Parity: :796-813 (incl. velocity rot)."""
    rng = rng or np.random
    if not isinstance(rotation, (list, tuple, np.ndarray)):
        rotation = [-rotation, rotation]
    noise = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = rotation_points_single_angle(points[:, :3], noise)
    gt_boxes[:, :3] = rotation_points_single_angle(gt_boxes[:, :3], noise)
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate(
            [gt_boxes[:, 6:8], np.zeros((gt_boxes.shape[0], 1))], axis=1)
        gt_boxes[:, 6:8] = rotation_points_single_angle(vel, noise)[:, :2]
    gt_boxes[:, -1] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, min_scale=0.95, max_scale=1.05,
                   rng=None):
    """Uniform scale of points and box geometry (v2). Parity: :857-861."""
    rng = rng or np.random
    noise = rng.uniform(min_scale, max_scale)
    points[:, :3] *= noise
    gt_boxes[:, :-1] *= noise
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_translate_std, rng=None):
    """Gaussian global translation. Parity: :962-984."""
    rng = rng or np.random
    std = np.asarray(noise_translate_std, np.float64)
    if std.ndim == 0:
        std = np.full((3,), float(std))
    if np.all(std == 0):
        return gt_boxes, points
    t = np.array([rng.normal(0, std[0]), rng.normal(0, std[1]),
                  rng.normal(0, std[2])])
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


# ---------------------------------------------------------------------------
# per-object noise with collision rejection
# ---------------------------------------------------------------------------

def noise_per_object(gt_boxes, points=None, valid_mask=None,
                     rotation_perturb=np.pi / 4, center_noise_std=1.0,
                     num_try=100, rng=None):
    """Per-GT random rotation+translation, first non-colliding try wins.

    Parity: preprocess.py:587-766 ``noise_per_object_v3_`` without group ids
    or global-rot-per-object (unused by the shipped configs). Boxes are
    processed sequentially (like the reference numba scan): box i's accepted
    transform updates the collision set seen by box i+1. Points inside each
    box move rigidly with it.
    """
    rng = rng or np.random
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return gt_boxes, points
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones((num_boxes,), bool)

    loc_noises = rng.normal(
        scale=center_noise_std, size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(
        rotation_perturb[0], rotation_perturb[1], size=[num_boxes, num_try])

    current = gt_boxes[:, [0, 1, 3, 4, 6]].copy()      # BEV view
    cur_corners = corners_bev(current)
    sel_loc = np.zeros((num_boxes, 3))
    sel_rot = np.zeros((num_boxes,))
    accepted = np.zeros((num_boxes,), bool)

    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        # candidate corners for all tries at once
        cand = np.tile(current[i][None], (num_try, 1))
        cand[:, 4] += rot_noises[i]
        cand_corners = corners_bev(cand)
        cand_corners += loc_noises[i][:, None, :2]
        others = np.delete(cur_corners, i, axis=0)
        coll = box_collision_test(cand_corners, others).any(axis=1)
        ok = np.nonzero(~coll)[0]
        if len(ok) == 0:
            continue
        t = ok[0]
        accepted[i] = True
        sel_loc[i] = loc_noises[i, t]
        sel_rot[i] = rot_noises[i, t]
        cur_corners[i] = cand_corners[t]
        current[i, :2] += loc_noises[i, t, :2]
        current[i, 4] += rot_noises[i, t]

    if points is not None and accepted.any():
        masks = points_in_rbbox(points, gt_boxes)       # (P, N)
        for i in np.nonzero(accepted)[0]:
            sel = masks[:, i]
            if not sel.any():
                continue
            pts = points[sel]
            center = gt_boxes[i, :3]
            local = pts[:, :3] - center
            pts[:, :3] = rotation_points_single_angle(
                local, sel_rot[i]) + center + sel_loc[i]
            points[sel] = pts

    gt_boxes[accepted, :3] += sel_loc[accepted]
    gt_boxes[accepted, -1] += sel_rot[accepted]
    return gt_boxes, points
