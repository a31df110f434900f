"""KITTI image-domain viewer: project 3D boxes into the camera image.

Port of det3d_tpu/visualization/kitti_image.py (reference det3d/
visualization/kitti.py: Calibration :68, project_to_image :307,
compute_box_3d :329). Drawing is cv2 onto numpy arrays (imported where a
drawing function runs); the camera and box math is core/box_np.py's
(``project_to_image``, ``box_lidar_to_camera``).

Camera-frame boxes follow KITTI's labels: (x, y, z) the bottom center in
rectified camera coordinates, (h, w, l) the extents, ry the rotation about
the camera's y (down) axis.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from det3d_tpu_torch.core import box_np


class Calibration:
    """A KITTI calib file (kitti.py:68-244): P2, R0_rect and
    Tr_velo_to_cam, and the projections between lidar, rectified camera
    and image coordinates."""

    def __init__(self, calib_path_or_dict):
        if isinstance(calib_path_or_dict, dict):
            calibs = calib_path_or_dict
        else:
            calibs = self._read(calib_path_or_dict)
        self.P = np.asarray(calibs["P2"], np.float64).reshape(3, 4)
        self.V2C = np.asarray(calibs["Tr_velo_to_cam"],
                              np.float64).reshape(3, 4)
        self.R0 = np.asarray(calibs["R0_rect"], np.float64).reshape(3, 3)

    @staticmethod
    def _read(path):
        out = {}
        for line in Path(path).read_text().splitlines():
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = np.array(v.split(), np.float64)
        return out

    def _r_rect(self):
        r = np.eye(4)
        r[:3, :3] = self.R0
        return r

    def _v2c(self):
        v = np.eye(4)
        v[:3] = self.V2C
        return v

    def project_velo_to_rect(self, pts):
        """(N, 3) lidar -> (N, 3) rectified camera coordinates."""
        return box_np.lidar_to_camera(np.asarray(pts, np.float64),
                                      self._r_rect(), self._v2c())

    def project_rect_to_image(self, pts):
        """(N, 3) rectified camera coordinates -> (N, 2) pixels."""
        return box_np.project_to_image(np.asarray(pts, np.float64), self.P)

    def project_velo_to_image(self, pts):
        return self.project_rect_to_image(self.project_velo_to_rect(pts))


def compute_box_3d(box_camera, calib: Calibration):
    """KITTI camera box (x, y, z, h, w, l, ry) -> ((8, 2) pixel corners, or
    None when a corner lies behind the camera, (8, 3) rectified corners);
    kitti.py:329-361's corner order: four at the bottom, then four at the
    top."""
    x, y, z, h, w, l, ry = (float(v) for v in box_camera[:7])
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    xs = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    zs = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    corners = (rot @ np.stack([xs, ys, zs])).T + np.array([x, y, z])
    if np.any(corners[:, 2] < 0.1):
        return None, corners
    return calib.project_rect_to_image(corners), corners


_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),          # bottom ring
          (4, 5), (5, 6), (6, 7), (7, 4),          # top ring
          (0, 4), (1, 5), (2, 6), (3, 7)]          # verticals


def draw_projected_box3d(image, corners2d, color=(0, 255, 0), thickness=2):
    """Draw a projected wireframe onto an HxWx3 uint8 image (in place)."""
    import cv2
    if corners2d is None:
        return image
    pts = np.round(corners2d).astype(int)
    for a, b in _EDGES:
        cv2.line(image, tuple(pts[a]), tuple(pts[b]), color, thickness,
                 cv2.LINE_AA)
    return image


def draw_box2d(image, bbox, color=(255, 200, 0), thickness=2, label=None):
    import cv2
    x1, y1, x2, y2 = (int(round(v)) for v in bbox[:4])
    cv2.rectangle(image, (x1, y1), (x2, y2), color, thickness)
    if label:
        cv2.putText(image, str(label), (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return image


def show_image_with_boxes(image, boxes_camera, calib, labels=None,
                          color=(0, 255, 0), scores=None):
    """Draw camera-frame 3D boxes (N, 7) on a copy of the image and return
    it."""
    img = np.ascontiguousarray(image).copy()
    for i, box in enumerate(np.asarray(boxes_camera).reshape(-1, 7)):
        corners2d, _ = compute_box_3d(box, calib)
        draw_projected_box3d(img, corners2d, color=color)
        if corners2d is not None and labels is not None:
            import cv2
            tag = str(labels[i])
            if scores is not None:
                tag += f" {float(scores[i]):.2f}"
            anchor = (int(corners2d[:, 0].min()),
                      max(int(corners2d[:, 1].min()) - 4, 10))
            cv2.putText(img, tag, anchor, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        color, 1, cv2.LINE_AA)
    return img


def lidar_boxes_to_kitti_camera(boxes_lidar, calib):
    """Lidar (x, y, z, w, l, h, yaw) center boxes -> KITTI camera boxes
    (bottom-center x, y, z, h, w, l, ry), through box_np's
    ``box_lidar_to_camera`` (center x, y, z, l, h, w, ry)."""
    cam = box_np.box_lidar_to_camera(
        np.asarray(boxes_lidar, np.float64).reshape(-1, 7),
        calib._r_rect(), calib._v2c())
    out = np.zeros_like(cam)
    out[:, 0] = cam[:, 0]
    out[:, 1] = cam[:, 1] + cam[:, 4] / 2.0      # bottom y
    out[:, 2] = cam[:, 2]
    out[:, 3] = cam[:, 4]                        # h
    out[:, 4] = cam[:, 5]                        # w
    out[:, 5] = cam[:, 3]                        # l
    out[:, 6] = cam[:, 6]
    return out


def show_lidar_boxes_on_image(image, boxes_lidar, calib, **kw):
    """Lidar-frame (x, y, z, w, l, h, yaw) boxes drawn on the image."""
    return show_image_with_boxes(
        image, lidar_boxes_to_kitti_camera(boxes_lidar, calib), calib, **kw)
