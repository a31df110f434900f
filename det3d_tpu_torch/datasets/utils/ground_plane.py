"""RANSAC ground-plane estimation.

The port's copy of det3d_tpu/datasets/utils/ground_plane.py, kept line for
line (host code in both packages, no torch), so that both give the same
results.

Parity: det3d/datasets/utils/ground_plane_detection.py (fit_plane_LSE :43,
get_point_dist :53, fit_plane_LSE_RANSAC :61) — least-squares plane fits
on random minimal samples, keep the consensus set, refit. Used by KITTI
prep when a ground-plane file is absent (the reference reads planes/*.txt
when present; so do we — this is the fallback estimator).

Planes are (a, b, c, d) with ||(a, b, c)|| = 1 and a*x + b*y + c*z + d = 0.
"""

from __future__ import annotations

import numpy as np


def fit_plane_lse(points: np.ndarray) -> np.ndarray:
    """Least-squares plane through (N, 3) points via SVD of [x y z 1];
    the right-singular vector of the smallest singular value, normalized
    so the normal is unit length and points +z."""
    a = np.hstack([points[:, :3], np.ones((points.shape[0], 1))])
    _, _, vt = np.linalg.svd(a, full_matrices=False)
    plane = vt[-1]
    n = np.linalg.norm(plane[:3])
    plane = plane / max(n, 1e-12)
    if plane[2] < 0:
        plane = -plane
    return plane.astype(np.float64)


def point_plane_distance(points: np.ndarray, plane: np.ndarray
                         ) -> np.ndarray:
    """Unsigned distances of (N, 3) points to a unit-normal plane."""
    return np.abs(points[:, :3] @ plane[:3] + plane[3])


def fit_plane_ransac(points: np.ndarray, n_iters: int = 100,
                     inlier_thresh: float = 0.05, sample_size: int = 10,
                     seed: int = 0):
    """RANSAC plane fit over (N, >=3) points.

    Each round fits an LSE plane to ``sample_size`` random points, counts
    inliers within ``inlier_thresh``, and the best consensus set is refit.
    Returns (plane (4,), inlier_indices (K,)).
    """
    pts = np.asarray(points, np.float64)[:, :3]
    n = pts.shape[0]
    if n < 3:
        raise ValueError("need >= 3 points to fit a plane")
    rng = np.random.RandomState(seed)
    best_inliers = np.zeros(0, np.int64)
    for _ in range(n_iters):
        sample = pts[rng.choice(n, min(sample_size, n), replace=False)]
        plane = fit_plane_lse(sample)
        d = point_plane_distance(pts, plane)
        inliers = np.nonzero(d < inlier_thresh)[0]
        if inliers.size > best_inliers.size:
            best_inliers = inliers
    if best_inliers.size < 3:
        best_inliers = np.arange(n)
    plane = fit_plane_lse(pts[best_inliers])
    return plane, best_inliers


def estimate_ground_plane(points: np.ndarray, z_band=(-2.5, -1.0),
                          **kw):
    """Convenience wrapper for lidar scans: RANSAC over the points in the
    expected ground z band (velodyne sits ~1.7 m above ground on KITTI)."""
    pts = np.asarray(points, np.float64)[:, :3]
    band = pts[(pts[:, 2] > z_band[0]) & (pts[:, 2] < z_band[1])]
    if band.shape[0] < 32:
        band = pts
    return fit_plane_ransac(band, **kw)
