"""PointNet++ set-abstraction and feature-propagation modules.

Port of det3d_tpu/models/point_modules.py (reference det3d/ops/pointnet2/
pointnet2_modules.py: PointnetSAModuleMSG :80, PointnetSAModule :132,
PointnetFPModule :389; pytorch_utils.SharedMLP), on the ops of
ops/pointnet2.py. Layout is channels-last: features are (B, N, C).

As in the JAX package, an ``mlp`` list holds output widths only
(``[9, 16]`` over a 9-wide group is two layers); the reference's lists
start with the input width. Flax infers a layer's input width at its
first call, so each module here takes it: ``in_channels``, the width of
the point features (0 without), to which the set abstraction adds 3 with
``use_xyz``. BatchNorm is ``models/norm.py::MaskedBatchNorm`` with the
ball query's ``found`` as its mask and statistics from the module's
training mode. Layers keep flax's call-order names (``SharedMLP_<n>``,
``Dense_<n>``, ``MaskedBatchNorm_<n>``), so ``utils/convert.py::
from_jax`` carries the JAX package's weights over.

These serve point-based experiment families (PointRCNN- or VoteNet-style
models); no shipped config uses them, and, as in the reference, no
registry names them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.models.norm import build_norm
from det3d_tpu_torch.ops import pointnet2 as p2


class SharedMLP(nn.Module):
    """Per-point MLP: Linear + BN + ReLU per layer (a 1x1 conv over the
    reference's (B, C, M, S) is a Linear over channels-last)."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 norm_cfg: Optional[dict] = None, use_bn: bool = True):
        super().__init__()
        self.num_layers = len(features)
        self.use_bn = use_bn
        cin = in_channels
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(cin, f, bias=not use_bn))
            if use_bn:
                self.add_module(f"MaskedBatchNorm_{i}",
                                build_norm(norm_cfg, f))
            cin = f

    def forward(self, x, mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask=mask)
            x = F.relu(x)
        return x


def query_and_group(xyz, new_xyz, features, radius, nsample, valid=None,
                    use_xyz=True, normalize_xyz=False):
    """Ball-query grouping (pointnet2_utils.QueryAndGroup:292).

    xyz (B, N, 3), new_xyz (B, M, 3), features (B, N, C) or None ->
    (grouped (B, M, S, 3+C or C or 3), found (B, M, S) bool); grouped xyz
    are centered on their query point."""
    idx, found = p2.ball_query(xyz, new_xyz, radius, nsample, valid=valid)
    grouped_xyz = p2.group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        return grouped_xyz, found
    grouped = p2.group_points(features, idx)
    if use_xyz:
        grouped = torch.cat([grouped_xyz, grouped], -1)
    return grouped, found


def group_all(xyz, features, valid=None, use_xyz=True):
    """GroupAll (pointnet2_utils.py:387): one group holding every point."""
    grouped = xyz[:, None]                                   # (B, 1, N, 3)
    if features is not None:
        feats = features[:, None]
        grouped = torch.cat([grouped, feats], -1) if use_xyz else feats
    b, n = xyz.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    return grouped, valid[:, None, :]


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (pointnet2_modules.py:80).

    ``npoint=None`` takes the GroupAll path. The max-pool over a group
    skips the ball query's padded slots (``found``), and a group with no
    point gives zeros. forward(xyz, features=None, valid=None) ->
    (new_xyz, new_features, new_valid)."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int = 0, use_xyz: bool = True,
                 norm_cfg: Optional[dict] = None, use_bn: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps differ in length")
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        cin = in_channels + (3 if use_xyz or not in_channels else 0)
        for i, mlp in enumerate(mlps):
            self.add_module(f"SharedMLP_{i}",
                            SharedMLP(cin, mlp, norm_cfg, use_bn))

    def forward(self, xyz, features=None, valid=None):
        if self.npoint is not None:
            fps_idx = p2.furthest_point_sample(xyz, self.npoint, valid=valid)
            new_xyz = p2.gather_points(xyz, fps_idx)
            new_valid = (torch.gather(valid, 1, fps_idx)
                         if valid is not None else None)
        else:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            new_valid = None
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            if self.npoint is not None:
                grouped, found = query_and_group(
                    xyz, new_xyz, features, radius, nsample, valid=valid,
                    use_xyz=self.use_xyz)
            else:
                grouped, found = group_all(xyz, features, valid=valid,
                                           use_xyz=self.use_xyz)
            h = getattr(self, f"SharedMLP_{i}")(grouped, mask=found)
            # amax splits the gradient over ties, as jnp.max does
            h = torch.amax(h.masked_fill(~found[..., None], float("-inf")),
                           dim=2)
            h = torch.where(found.any(2)[..., None], h, 0.0)
            outs.append(h)
        return new_xyz, torch.cat(outs, -1), new_valid


def PointnetSAModule(mlp, npoint=None, radius=None, nsample=None,
                     in_channels: int = 0, use_xyz=True, norm_cfg=None,
                     use_bn=True):
    """Single-scale set abstraction (pointnet2_modules.py:132): a
    PointnetSAModuleMSG of one scale, as in the JAX package."""
    return PointnetSAModuleMSG(npoint=npoint, radii=[radius],
                               nsamples=[nsample], mlps=[mlp],
                               in_channels=in_channels, use_xyz=use_xyz,
                               norm_cfg=norm_cfg, use_bn=use_bn)


class PointnetFPModule(nn.Module):
    """Feature propagation (pointnet2_modules.py:389): 3-NN inverse-distance
    interpolation of the coarse features onto the dense set (or the
    broadcast of one global feature when ``known`` is None), concatenated
    with the skip features, then a shared MLP. ``in_channels``: the coarse
    features' width plus the skip features'."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 norm_cfg: Optional[dict] = None, use_bn: bool = True):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_channels, mlp, norm_cfg, use_bn)

    def forward(self, unknown, known, unknown_feats, known_feats,
                known_valid=None):
        if known is not None:
            dist, idx = p2.three_nn(unknown, known, valid=known_valid)
            w = p2.interpolation_weights(dist)
            interp = p2.three_interpolate(known_feats, idx, w)
        else:                       # global feature broadcast (:421-424)
            interp = known_feats.expand(known_feats.shape[0],
                                        unknown.shape[1],
                                        known_feats.shape[-1])
        x = (torch.cat([interp, unknown_feats], -1)
             if unknown_feats is not None else interp)
        return self.SharedMLP_0(x)
