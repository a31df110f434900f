"""3D point-cloud and box viewer for hosts without a display.

Port of det3d_tpu/visualization/viewer3d.py (reference det3d/
visualization/show_lidar_vtk.py and vtk_visualizer/):
``show_pointcloud`` draws points and box wireframes on matplotlib's 3D
axes (``save=`` writes a PNG), and ``export_ply`` writes the scene as an
ASCII PLY that MeshLab, CloudCompare or Open3D open. matplotlib is
imported only where it draws.

Boxes are lidar-frame (x, y, z, w, l, h, yaw) with a center origin; their
corners are core/box_np.py::center_to_corner_box3d's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from det3d_tpu_torch.core.box_np import center_to_corner_box3d

_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def box_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) lidar boxes -> (N, 8, 3) corners."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    return center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                                  origin=(0.5, 0.5, 0.5), axis=2)


def show_pointcloud(points, gt_boxes=None, det_boxes=None, save=None,
                    max_points: int = 60000, point_size: float = 0.3,
                    elev: float = 35.0, azim: float = -120.0):
    """Render a scene and return the matplotlib figure; ``save`` writes a
    PNG and closes it."""
    import matplotlib
    if save is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)[:, :3]
    if pts.shape[0] > max_points:
        pts = pts[np.random.RandomState(0).choice(pts.shape[0], max_points,
                                                  replace=False)]
    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=pts[:, 2],
               cmap="viridis", linewidths=0)
    for boxes, color in ((gt_boxes, "lime"), (det_boxes, "red")):
        if boxes is None or len(boxes) == 0:
            continue
        for corners in box_corners_3d(boxes):
            for a, b in _BOX_EDGES:
                ax.plot(*zip(corners[a], corners[b]), c=color, lw=1.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((np.ptp(pts[:, 0]) + 1e-3, np.ptp(pts[:, 1]) + 1e-3,
                       3 * (np.ptp(pts[:, 2]) + 1e-3)))
    ax.set_axis_off()
    if save is not None:
        fig.savefig(save, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def export_ply(path, points, gt_boxes=None, det_boxes=None,
               intensity=None):
    """Write the points (colored by intensity, the 4th column unless given)
    and the boxes' wireframes (edge elements) to an ASCII PLY."""
    pts = np.asarray(points)[:, :3].astype(np.float32)
    if intensity is None and np.asarray(points).shape[1] >= 4:
        intensity = np.asarray(points)[:, 3]
    col = np.full((pts.shape[0], 3), 180, np.uint8)
    if intensity is not None:
        it = np.asarray(intensity, np.float64)
        rng = np.ptp(it)
        it = (it - it.min()) / (rng if rng > 0 else 1.0)
        col = np.stack([(255 * it).astype(np.uint8),
                        np.full_like(it, 120, dtype=np.uint8),
                        (255 * (1 - it)).astype(np.uint8)], -1)
    verts, colors, edges = [pts], [col], []
    for boxes, c in ((gt_boxes, (0, 255, 0)), (det_boxes, (255, 0, 0))):
        if boxes is None or len(boxes) == 0:
            continue
        for cs in box_corners_3d(boxes):
            base = sum(v.shape[0] for v in verts)
            verts.append(cs.astype(np.float32))
            colors.append(np.tile(np.asarray(c, np.uint8), (8, 1)))
            edges.extend((base + a, base + b) for a, b in _BOX_EDGES)
    v = np.vstack(verts)
    cl = np.vstack(colors)
    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {v.shape[0]}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element edge {len(edges)}",
        "property int vertex1", "property int vertex2",
        "end_header",
    ]
    for p, c in zip(v, cl):
        lines.append(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                     f"{int(c[0])} {int(c[1])} {int(c[2])}")
    lines.extend(f"{a} {b}" for a, b in edges)
    Path(path).write_text("\n".join(lines) + "\n")
    return path
