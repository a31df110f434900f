"""Visualization on the host, numpy only: BEV canvases (simplevis), camera
projections of KITTI boxes (kitti_image), a 3D viewer and PLY export
(viewer3d) and the module tree of a model (netviz). Port of
det3d_tpu/visualization; cv2, matplotlib and graphviz are optional."""

from det3d_tpu_torch.visualization.simplevis import (bev_canvas,
                                                     draw_boxes_bev,
                                                     draw_points_bev,
                                                     kitti_vis, nuscene_vis)

__all__ = ["bev_canvas", "draw_points_bev", "draw_boxes_bev", "kitti_vis",
           "nuscene_vis"]
