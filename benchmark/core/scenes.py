"""The scan and scene generators the traffic mixes draw from, frozen.

``structured_scan`` is a verbatim copy of det3d_tpu_torch/utils/synth.py::
structured_scan (KITTI-like structure: ground rings, car-sized clusters,
walls, clutter). ``class_scene`` is chip_smoke.py::train_scene (point
clusters inside boxes at random yaws, a third of the points, clutter
elsewhere, the gt padded), one scan at a time and over a configuration's
classes: each box takes a class drawn by the caller and that class's
anchor size and height (train_scene's car box and point extents are its
case of the KITTI car anchor). Copied so that a change to the program
cannot change the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np

def structured_scan(n_points: int, pc_range, n_objects: int = 12,
                    seed: int = 0) -> np.ndarray:
    """One (n_points, 4) float32 synthetic scan inside pc_range.

    Composition (KITTI-like fractions):
      ~55% ground plane with 1/r^2 radial density falloff (ring structure),
      ~25% object clusters (car-sized boxes at random yaw),
      ~15% vertical structures (walls / poles),
      ~5%  uniform clutter.
    """
    rng = np.random.RandomState(seed)
    x0, y0, z0, x1, y1, z1 = [float(v) for v in pc_range]

    n_ground = int(n_points * 0.55)
    n_obj = int(n_points * 0.25)
    n_wall = int(n_points * 0.15)
    n_clutter = n_points - n_ground - n_obj - n_wall

    # ground: sample range with density ~ 1/r (beam geometry), azimuth
    # limited to the sensor FOV implied by pc_range
    r_lo, r_hi = max(1.0, x0 + 1.0), np.hypot(x1, max(abs(y0), abs(y1)))
    u = rng.uniform(np.log(r_lo), np.log(r_hi), n_ground)
    r = np.exp(u)
    az = rng.uniform(np.arctan2(y0, x1), np.arctan2(y1, x1), n_ground)
    gx = r * np.cos(az)
    gy = r * np.sin(az)
    gz = np.full(n_ground, -1.73) + rng.normal(0, 0.03, n_ground)
    ground = np.stack([gx, gy, gz, rng.uniform(0, 1, n_ground)], -1)

    # objects: car-sized clusters, surface-biased (points on the hull)
    per = max(1, n_obj // max(1, n_objects))
    objs = []
    for i in range(n_objects):
        cx = rng.uniform(x0 + 5, x1 - 5)
        cy = rng.uniform(y0 + 3, y1 - 3)
        yaw = rng.uniform(-np.pi, np.pi)
        dims = np.array([1.6, 3.9, 1.56]) * rng.uniform(0.85, 1.15, 3)
        local = rng.uniform(-0.5, 0.5, (per, 3))
        # push points toward the faces (lidar sees surfaces, not volumes)
        face = np.argmax(np.abs(local), 1)
        local[np.arange(per), face] = np.sign(
            local[np.arange(per), face]) * 0.5
        local *= dims
        c, s = np.cos(yaw), np.sin(yaw)
        ox = local[:, 0] * c - local[:, 1] * s + cx
        oy = local[:, 0] * s + local[:, 1] * c + cy
        oz = local[:, 2] + (-1.73 + dims[2] / 2)
        objs.append(np.stack([ox, oy, oz, rng.uniform(0, 1, per)], -1))
    obj = np.concatenate(objs)[:n_obj]
    if obj.shape[0] < n_obj:  # rounding
        obj = np.concatenate([obj, ground[: n_obj - obj.shape[0]]])

    # vertical structures: a few wall segments + poles
    walls = []
    for _ in range(6):
        ax = rng.uniform(x0 + 2, x1 - 2)
        ay = rng.uniform(y0 + 1, y1 - 1)
        ang = rng.uniform(-np.pi, np.pi)
        t = rng.uniform(0, rng.uniform(2, 12), n_wall // 6)
        wx = ax + t * np.cos(ang) + rng.normal(0, 0.02, t.shape)
        wy = ay + t * np.sin(ang) + rng.normal(0, 0.02, t.shape)
        wz = rng.uniform(-1.7, min(z1, 1.0), t.shape)
        walls.append(np.stack([wx, wy, wz, rng.uniform(0, 1, t.shape)], -1))
    wall = np.concatenate(walls)[:n_wall]
    if wall.shape[0] < n_wall:
        wall = np.concatenate([wall, ground[: n_wall - wall.shape[0]]])

    clutter = np.stack([
        rng.uniform(x0, x1, n_clutter), rng.uniform(y0, y1, n_clutter),
        rng.uniform(z0, z1, n_clutter), rng.uniform(0, 1, n_clutter)], -1)

    pts = np.concatenate([ground, obj, wall, clutter]).astype(np.float32)
    # clip into range (walls/objects may poke out)
    lo = np.array([x0, y0, z0], np.float32)
    hi = np.array([x1, y1, z1], np.float32)
    pts[:, :3] = np.clip(pts[:, :3], lo + 1e-3, hi - 1e-3)
    return rng.permutation(pts)[:n_points]


def class_scene(points, pc_range, kinds, max_gt, nd, seed):
    """One training scan as ``train_scene`` builds it, over the boxes of
    ``kinds``: (class id, w, l, h, z) a box, each at a random center and
    yaw with a third of the points (together) inside the boxes, the rest
    uniform clutter; gt (max_gt, nd) padded, velocities zero. Returns
    (points (points, 4), gt_boxes, gt_classes, gt_valid)."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = (float(v) for v in pc_range)
    pts = np.zeros((points, 4), np.float32)
    gt = np.zeros((max_gt, nd), np.float32)
    cls = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    k = points // (3 * max(len(kinds), 1))
    cursor = 0
    for g, (cid, w, l, h, z) in enumerate(kinds):
        cx = rng.uniform(x0 + 3, x1 - 3)
        cy = rng.uniform(y0 + 3, y1 - 3)
        theta = rng.uniform(-np.pi, np.pi)
        gt[g, :6] = [cx, cy, z, w, l, h]
        gt[g, nd - 1] = theta
        cls[g] = cid
        valid[g] = True
        local = rng.uniform(-0.5, 0.5, (k, 3)) * [w * 0.94, l * 0.9,
                                                   h * 0.9]
        c, s = np.cos(theta), np.sin(theta)
        sl = slice(cursor, cursor + k)
        pts[sl, 0] = local[:, 0] * c + local[:, 1] * s + cx
        pts[sl, 1] = -local[:, 0] * s + local[:, 1] * c + cy
        pts[sl, 2] = z + local[:, 2]
        pts[sl, 3] = rng.uniform(0, 1, k)
        cursor += k
    rest = points - cursor
    pts[cursor:, 0] = rng.uniform(x0, x1, rest)
    pts[cursor:, 1] = rng.uniform(y0, y1, rest)
    pts[cursor:, 2] = rng.uniform(-2.5, 0.5, rest)
    pts[cursor:, 3] = rng.uniform(0, 1, rest)
    return pts, gt, cls, valid
