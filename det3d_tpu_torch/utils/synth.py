"""Structured synthetic Velodyne-like scans for benchmarks and profiling.

The port's own copy of det3d_tpu/utils/synth.py (numpy only; the port
imports nothing of the JAX package). tests/test_torch_imports.py holds its
``structured_batch`` array-equal to the JAX package's.

Real KITTI scans are nothing like uniform noise: most points lie on the
ground plane in range-dependent rings, the rest cluster on objects and
vertical structures. Voxel occupancy, pillar fill and NMS load all depend
on that structure, so benchmarks must model it (a uniform cloud touches
~P distinct voxels; a real scan touches far fewer, with much fuller
pillars). Mirrors the scan statistics of the reference's KITTI inputs
(reference: det3d/datasets/kitti/kitti.py reduced clouds, ~16k points in
the front-camera frustum).
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


def structured_batch(batch: int, n_points: int, pc_range,
                     seed: int = 0) -> dict:
    """Batch of structured scans in the train/predict step input layout."""
    pts = np.stack([
        structured_scan(n_points, pc_range, seed=seed + 17 * b)
        for b in range(batch)])
    return {
        "points": pts,
        "num_points": np.full((batch,), n_points, np.int32),
    }
