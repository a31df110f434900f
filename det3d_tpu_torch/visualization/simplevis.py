"""BEV visualization on numpy canvases.

Port of det3d_tpu/visualization/simplevis.py (reference det3d/
visualization/simplevis.py): point-cloud BEV rasterization, rotated-box
drawing, ``kitti_vis`` / ``nuscene_vis``. Lines go through cv2 where it is
installed, else through a numpy rasterizer (``_line``), so the module needs
nothing beyond numpy. The box corners are core/augment.py::corners_bev.
"""

from __future__ import annotations

import numpy as np

from det3d_tpu_torch.core import augment

try:
    import cv2
    _HAS_CV2 = True
except Exception:                                    # pragma: no cover
    _HAS_CV2 = False


def bev_canvas(pc_range, resolution=0.1):
    """Blank (H, W, 3) uint8 canvas covering the BEV range."""
    w = int(round((pc_range[3] - pc_range[0]) / resolution))
    h = int(round((pc_range[4] - pc_range[1]) / resolution))
    return np.zeros((h, w, 3), np.uint8)


def _to_pixel(xy, pc_range, canvas_shape):
    h, w = canvas_shape[:2]
    px = (xy[..., 0] - pc_range[0]) / (pc_range[3] - pc_range[0]) * w
    py = (xy[..., 1] - pc_range[1]) / (pc_range[4] - pc_range[1]) * h
    return np.stack([px, h - 1 - py], axis=-1)       # image y down


def draw_points_bev(canvas, points, pc_range, color=(90, 90, 90)):
    pix = _to_pixel(points[:, :2], pc_range, canvas.shape).astype(np.int64)
    h, w = canvas.shape[:2]
    ok = (pix[:, 0] >= 0) & (pix[:, 0] < w) & (pix[:, 1] >= 0) & (pix[:, 1] < h)
    canvas[pix[ok, 1], pix[ok, 0]] = color
    return canvas


def _line(canvas, p0, p1, color):
    """A one-pixel line from p0 to p1 (pixel x, y), clipped to the canvas."""
    if _HAS_CV2:
        cv2.line(canvas, tuple(int(v) for v in p0), tuple(int(v) for v in p1),
                 color, 1)
        return
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).astype(np.int64)
    ys = np.linspace(p0[1], p1[1], n + 1).astype(np.int64)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def draw_boxes_bev(canvas, boxes, pc_range, color=(0, 255, 0), labels=None):
    """boxes: (N, >=7) lidar [x y z w l h (...) r]; each box's outline and
    a tick from its center to the middle of its front edge."""
    if len(boxes) == 0:
        return canvas
    boxes = np.asarray(boxes)
    bev = boxes[:, [0, 1, 3, 4, boxes.shape[1] - 1]]
    corners = augment.corners_bev(bev)               # (N, 4, 2)
    pix = _to_pixel(corners, pc_range, canvas.shape)
    for n in range(pix.shape[0]):
        for i in range(4):
            _line(canvas, pix[n, i], pix[n, (i + 1) % 4], color)
        front = (pix[n, 2] + pix[n, 3]) / 2
        center = pix[n].mean(axis=0)
        _line(canvas, center, front, color)
    return canvas


def kitti_vis(points, gt_boxes=None, det_boxes=None,
              pc_range=(0, -40, -3, 70.4, 40, 1), resolution=0.1):
    """A BEV canvas of the points, the ground truth (green) and the
    detections (orange)."""
    canvas = bev_canvas(pc_range, resolution)
    draw_points_bev(canvas, points, pc_range)
    if gt_boxes is not None:
        draw_boxes_bev(canvas, gt_boxes, pc_range, color=(0, 255, 0))
    if det_boxes is not None:
        draw_boxes_bev(canvas, det_boxes, pc_range, color=(0, 128, 255))
    return canvas


def nuscene_vis(points, gt_boxes=None, det_boxes=None,
                pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                resolution=0.1):
    return kitti_vis(points, gt_boxes, det_boxes, pc_range, resolution)
