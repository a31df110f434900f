"""Pillar scatter onto the BEV canvas.

Port of det3d_tpu/models/backbones.py::PointPillarsScatter. The canvas
keeps the reference's NHWC layout, (B, ny, nx, C). Padded pillar rows
(coords -1) are dropped before the scatter, where the reference sends them
to an out-of-bounds index that XLA drops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from det3d_tpu_torch.core.voxelize import scatter_rows
from det3d_tpu_torch.models.registry import BACKBONES


@BACKBONES.register_module
class PointPillarsScatter(nn.Module):

    def __init__(self, num_input_features: int = 64,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 1,
                 name_str: str = "PointPillarsScatter"):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxel_features, coords, input_shape):
        """voxel_features (B, V, C); coords (B, V, 3) zyx, -1 rows padded;
        input_shape (nx, ny, nz). Returns the (B, ny, nx, C) canvas."""
        nx, ny = int(input_shape[0]), int(input_shape[1])
        b, _, c = voxel_features.shape
        y = coords[..., 1].long()
        x = coords[..., 2].long()
        valid = (y >= 0) & (x >= 0)
        base = torch.arange(b, device=y.device)[:, None] * (ny * nx)
        canvas = scatter_rows(voxel_features, base + y * nx + x, valid,
                              b * ny * nx)
        return canvas.view(b, ny, nx, c)
