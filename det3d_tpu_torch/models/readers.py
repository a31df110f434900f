"""Voxel feature readers: the voxel mean, and the pillar reader
(decorated points, linear + BN + ReLU, pillar max).

Port of det3d_tpu/models/readers.py (``paddings_indicator``,
``VoxelFeatureExtractorV3``, ``PFNLayer``, ``PillarFeatureNet``, and the
readers no shipped config names: ``VFELayer``, ``VoxelFeatureExtractor``
(the original VoxelNet reader), ``VFEV3_ablation``, ``SimpleVoxel``). Inputs
keep the reference's batched, padded layout: voxels (B, V, T, C),
per-voxel point counts (B, V), zyx coords (B, V, 3). With
``precision="bf16"`` the decorations are computed in the voxels' fp32 and
every PFN layer runs in bf16, as the JAX package serves it: the linear's
input and its fp32 weight are cast to bf16 for the call, the BN rounds its
output to bf16, and the ReLU, the pillar max and the empty-pillar mask
stay in bf16. In training mode each PFN layer's BN takes its batch
statistics over the real pillars' rows, their padded point slots
included, as the reference's BN1d over its ragged collate does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.models.norm import build_norm
from det3d_tpu_torch.models.precision import act_dtype
from det3d_tpu_torch.models.registry import READERS


def paddings_indicator(num_points, max_points: int):
    """(B, V) counts -> (B, V, T) bool mask of the real point slots."""
    ids = torch.arange(max_points, device=num_points.device)
    return ids[None, None, :] < num_points[..., None]


@READERS.register_module
class VoxelFeatureExtractorV3(nn.Module):
    """Mean of the valid points of each voxel. A (B, V, C) input is the
    fused-mean voxelizer's output, already the means: it passes through."""

    def __init__(self, num_input_features: int = 4,
                 norm_cfg: Optional[dict] = None,
                 name_str: str = "VoxelFeatureExtractorV3"):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points, coors=None):
        if voxels.dim() == 3:
            return voxels
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mask = paddings_indicator(num_points, voxels.shape[2])
        pts = voxels * mask[..., None].to(voxels.dtype)
        return pts.sum(dim=2) / denom                       # (B, V, C)


class PFNLayer(nn.Module):
    """Linear (no bias) + BN + ReLU, then the max over the pillar's points;
    all but the last layer concatenate that max back onto every point."""

    def __init__(self, in_channels: int, units: int, last_layer: bool = False,
                 norm_cfg: Optional[dict] = None, precision: str = "fp32"):
        super().__init__()
        self.last_layer = last_layer
        self.dtype = act_dtype(precision)
        out = units if last_layer else units // 2
        self.linear = nn.Linear(in_channels, out, bias=False)
        self.norm = build_norm(norm_cfg, out, dtype=self.dtype)

    def forward(self, x, pillar_mask):
        """x: (B, V, T, C_in); pillar_mask: (B, V) bool, the real pillars
        (the BN's rows in training)."""
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        mask = pillar_mask[..., None].expand(x.shape[:-1])
        x = torch.relu(self.norm(x, mask))                   # (B, V, T, U)
        x_max = x.amax(dim=2, keepdim=True)                  # (B, V, 1, U)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


@READERS.register_module
class PillarFeatureNet(nn.Module):
    """Decorate points with cluster and pillar-center offsets, run the PFN
    layers, and return one feature row per pillar (B, V, U)."""

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (64,),
                 with_distance: bool = False,
                 voxel_size: Tuple[float, ...] = (0.2, 0.2, 4.0),
                 pc_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4, 40.0,
                                                1.0),
                 norm_cfg: Optional[dict] = None, precision: str = "fp32",
                 name_str: str = "PillarFeatureNet"):
        super().__init__()
        self.num_input_features = num_input_features
        self.with_distance = with_distance
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        in_ch = num_input_features + 5 + (1 if with_distance else 0)
        filters = list(num_filters)
        self.num_layers = len(filters)
        for i, units in enumerate(filters):
            last = i == len(filters) - 1
            self.add_module(f"pfn_{i}", PFNLayer(in_ch, units, last, norm_cfg,
                                                 precision))
            in_ch = units

    def forward(self, voxels, num_points, coors):
        dtype = voxels.dtype
        t = voxels.shape[2]
        mask = paddings_indicator(num_points, t)            # (B, V, T)
        maskf = mask[..., None].to(dtype)
        denom = torch.clamp(num_points, min=1).to(dtype)[..., None, None]

        # f_cluster: offsets from the mean of the pillar's real points
        xyz = voxels[..., :3]
        points_mean = (xyz * maskf).sum(dim=2, keepdim=True) / denom
        f_cluster = xyz - points_mean

        # f_center: offsets from the pillar's grid-cell center
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]
        cx = coors[..., 2].to(dtype)[..., None] * vx + x_offset  # (B, V, 1)
        cy = coors[..., 1].to(dtype)[..., None] * vy + y_offset
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy],
                               dim=-1)

        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(feats, dim=-1) * maskf

        pillar_mask = num_points > 0                         # (B, V)
        for i in range(self.num_layers):
            features = getattr(self, f"pfn_{i}")(features, pillar_mask)
        out = features.squeeze(2)                            # (B, V, U)
        # empty pillar rows stay zero for the scatter
        return out * pillar_mask[..., None].to(out.dtype)


class VFELayer(nn.Module):
    """The original VoxelNet VFE layer: linear (no bias) + BN + ReLU per
    point, the voxel's max, concatenated back onto every point
    (reference voxel_encoder.py:14-42). The BN's batch statistics cover
    the real voxels' rows, padded point slots included: the JAX package's
    masked BN, where the reference's runs over every slot."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[dict] = None, precision: str = "fp32"):
        super().__init__()
        self.dtype = act_dtype(precision)
        units = out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = build_norm(norm_cfg, units, dtype=self.dtype)

    def forward(self, x, voxel_mask):
        """x: (B, V, T, C); voxel_mask: (B, V) bool, the real voxels."""
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        x = torch.relu(self.norm(x, voxel_mask[..., None].expand(
            x.shape[:-1])))
        return torch.cat([x, x.amax(dim=2, keepdim=True).expand_as(x)],
                         dim=-1)


@READERS.register_module
class VoxelFeatureExtractor(nn.Module):
    """The original VoxelNet reader (reference voxel_encoder.py:46-176):
    points decorated with their offsets from the voxel's mean (and their
    distance), two VFELayers, each output zeroed at the padded slots, a
    final linear (no bias) + BN + ReLU, the voxel's max. Returns (B, V,
    num_filters[1]) fp32, empty voxels zero."""

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (32, 128),
                 with_distance: bool = False,
                 norm_cfg: Optional[dict] = None, precision: str = "fp32",
                 name_str: str = "VoxelFeatureExtractor"):
        super().__init__()
        assert len(num_filters) == 2
        self.num_input_features = num_input_features
        self.with_distance = with_distance
        self.dtype = act_dtype(precision)
        in_ch = num_input_features + 3 + (1 if with_distance else 0)
        self.vfe1 = VFELayer(in_ch, num_filters[0], norm_cfg, precision)
        self.vfe2 = VFELayer(num_filters[0], num_filters[1], norm_cfg,
                             precision)
        self.linear = nn.Linear(num_filters[1], num_filters[1], bias=False)
        self.norm = build_norm(norm_cfg, num_filters[1], dtype=self.dtype)

    def forward(self, voxels, num_points, coors=None):
        dtype = voxels.dtype
        denom = torch.clamp(num_points, min=1).to(dtype)[..., None, None]
        maskf = paddings_indicator(num_points, voxels.shape[2])[
            ..., None].to(dtype)
        xyz = voxels[..., :3]
        feats = [voxels, xyz - (xyz * maskf).sum(dim=2, keepdim=True) / denom]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1) * maskf
        voxel_mask = num_points > 0
        x = self.vfe1(x, voxel_mask) * maskf.to(self.dtype)
        x = self.vfe2(x, voxel_mask) * maskf.to(self.dtype)
        x = F.linear(x, self.linear.weight.to(self.dtype))
        x = torch.relu(self.norm(x, voxel_mask[..., None].expand(
            x.shape[:-1])))
        out = x.amax(dim=2)                                  # (B, V, U)
        return (out * voxel_mask[..., None].to(out.dtype)).float()


@READERS.register_module
class VFEV3_ablation(nn.Module):
    """The VFEv3 ablation reader (reference voxel_encoder.py:180-196): the
    mean of each voxel's (x, y, intensity) and the inverse point count,
    (B, V, 4)."""

    def __init__(self, num_input_features: int = 4,
                 norm_cfg: Optional[dict] = None,
                 name_str: str = "VFEV3_ablation"):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points, coors=None):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mask = paddings_indicator(num_points, voxels.shape[2])
        pts = voxels * mask[..., None].to(voxels.dtype)
        mean = pts[..., [0, 1, 3]].sum(dim=2) / denom
        return torch.cat([mean, 1.0 / denom], dim=-1)


@READERS.register_module
class SimpleVoxel(nn.Module):
    """The voxel's mean reduced to (xy range, z, reflectance...) (reference
    voxel_encoder.py:215-235): (B, V, num_input_features - 1)."""

    def __init__(self, num_input_features: int = 4,
                 norm_cfg: Optional[dict] = None,
                 name_str: str = "SimpleVoxel"):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points, coors=None):
        c = self.num_input_features
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mask = paddings_indicator(num_points, voxels.shape[2])
        mean = (voxels[..., :c] * mask[..., None].to(voxels.dtype)).sum(
            dim=2) / denom
        rng = torch.linalg.norm(mean[..., :2], dim=-1, keepdim=True)
        return torch.cat([rng, mean[..., 2:c]], dim=-1)
