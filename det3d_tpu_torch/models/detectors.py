"""Detector composition: reader -> backbone -> neck -> bbox_head.

Port of det3d_tpu/models/detectors.py::PointPillars and ``VoxelNet``.
``forward`` returns the head's raw predictions; ``loss`` scores them
against an example's targets, ``predict`` decodes them, as in the
reference, and ``predict_tta`` merges a double-flip batch. The JAX
package's ``train=True`` is ``model.train()``: BatchNorm on batch
statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

from torch import nn

from det3d_tpu_torch.models.registry import DETECTORS


@DETECTORS.register_module
class PointPillars(nn.Module):

    def __init__(self, reader, backbone, neck, bbox_head,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 grid_size: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        self.reader = reader
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.grid_size = grid_size          # (nx, ny, nz)

    def forward(self, voxels, num_points, coors):
        feats = self.reader(voxels, num_points, coors)         # (B, V, U)
        x = self.backbone(feats, coors, self.grid_size)        # (B, ny, nx, U)
        if self.neck is not None:
            x = self.neck(x)
        return self.bbox_head(x)

    def loss(self, example, preds):
        return self.bbox_head.loss(example, preds)

    def predict(self, example, preds, test_cfg=None):
        return self.bbox_head.predict(example, preds,
                                      test_cfg or self.test_cfg)

    def predict_tta(self, example, preds, test_cfg=None):
        return self.bbox_head.predict_tta(example, preds,
                                          test_cfg or self.test_cfg)


@DETECTORS.register_module
class VoxelNet(PointPillars):
    """SECOND family: voxel reader -> sparse middle -> RPN -> head.
    ``plan``: the host-built packed rulebooks of the sparse middle
    (ops/sparse_host.py), keys without their ``plan_`` prefix; None builds
    them on the device."""

    def forward(self, voxels, num_points, coors, plan=None):
        feats = self.reader(voxels, num_points)                 # (B, V, C)
        x = self.backbone(feats, coors, self.grid_size, plan=plan)
        if self.neck is not None:
            x = self.neck(x)
        return self.bbox_head(x)
