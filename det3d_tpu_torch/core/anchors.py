"""Anchor grids (numpy, built once) and the box coder (torch).

Port of det3d_tpu/core/anchors.py: ``_mesh_anchors``,
``create_anchors_3d_range``, ``create_anchors_3d_stride``,
``create_anchors_bev_range``, the generators ``AnchorGeneratorRange``,
``AnchorGeneratorStride`` and ``BevAnchorGeneratorRange`` (registered
under the JAX registry's names), the coders ``GroundBox3dCoder`` and
``BevBoxCoder``, and ``build_box_coder``. Anchors depend only on the
config and the feature-map size, so they are numpy arrays made at build
time; the steps move them to the device once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from det3d_tpu_torch.utils.registry import Registry
from det3d_tpu_torch.core import box_ops

ANCHOR_GENERATORS = Registry("anchor_generator")
BOX_CODERS = Registry("box_coder")


def _mesh_anchors(x_centers, y_centers, z_centers, sizes, rotations,
                  velocities, dtype):
    """Meshgrid assembly: (*feature_size_zyx, num_sizes, num_rots, ndim)
    anchors in the reference's transpose([2, 1, 0, 3, 4, 5]) layout."""
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype=dtype)
    if velocities is not None:
        velocities = np.asarray(velocities, dtype=dtype).reshape([-1, 2])
        combines = np.hstack([sizes, velocities]).reshape([-1, 5])
    else:
        combines = sizes
    rets = list(np.meshgrid(x_centers, y_centers, z_centers, rotations,
                            indexing="ij"))
    tile_shape = [1] * 5
    tile_shape[-2] = sizes.shape[0]
    for i in range(len(rets)):
        rets[i] = np.tile(rets[i][..., np.newaxis, :],
                          tile_shape)[..., np.newaxis]
    combines = np.reshape(combines, [1, 1, 1, -1, 1, combines.shape[-1]])
    tile_size_shape = list(rets[0].shape)
    tile_size_shape[3] = 1
    combines = np.tile(combines, tile_size_shape)
    rets.insert(3, combines)
    ret = np.concatenate(rets, axis=-1)
    return np.transpose(ret, [2, 1, 0, 3, 4, 5])


def create_anchors_3d_range(feature_size, anchor_range,
                            sizes=(1.6, 3.9, 1.56), rotations=(0, np.pi / 2),
                            velocities=None, dtype=np.float32):
    """feature_size is [D, H, W] (zyx). z spans the range inclusive; x/y
    centers sit at stride/2 offsets, with the stride taken from the x
    extent for both axes, as the reference does."""
    anchor_range = np.asarray(anchor_range, dtype)
    stride = (anchor_range[3] - anchor_range[0]) / feature_size[2]
    z_centers = np.linspace(anchor_range[2], anchor_range[5], feature_size[0],
                            dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], feature_size[1],
                            endpoint=False, dtype=dtype) + stride / 2
    x_centers = np.linspace(anchor_range[0], anchor_range[3], feature_size[2],
                            endpoint=False, dtype=dtype) + stride / 2
    return _mesh_anchors(x_centers, y_centers, z_centers, sizes, rotations,
                         velocities, dtype)


@ANCHOR_GENERATORS.register_module(name="anchor_generator_range")
@dataclass
class AnchorGeneratorRange:
    sizes: Sequence[float] = (1.6, 3.9, 1.56)
    rotations: Sequence[float] = (0, np.pi / 2)
    velocities: Optional[Sequence[float]] = None
    class_name: Optional[str] = None
    match_threshold: float = -1.0
    unmatch_threshold: float = -1.0
    dtype: type = np.float32
    anchor_ranges: Sequence[float] = field(default_factory=list)

    def generate(self, feature_map_size):
        return create_anchors_3d_range(
            feature_map_size, self.anchor_ranges, self.sizes, self.rotations,
            self.velocities, self.dtype)


def create_anchors_3d_stride(feature_size, sizes=(1.6, 3.9, 1.56),
                             anchor_strides=(0.4, 0.4, 0.0),
                             anchor_offsets=(0.2, -39.8, -1.78),
                             rotations=(0, np.pi / 2), velocities=(),
                             dtype=np.float32):
    """feature_size is [D, H, W] (zyx); centers at offset + i * stride.
    Without velocities the anchors are 7 wide (the JAX package's
    hstack of the sizes with an empty (0, 2) velocity array raises)."""
    x_stride, y_stride, z_stride = anchor_strides
    x_offset, y_offset, z_offset = anchor_offsets
    z_centers = np.arange(feature_size[0], dtype=dtype) * z_stride + z_offset
    y_centers = np.arange(feature_size[1], dtype=dtype) * y_stride + y_offset
    x_centers = np.arange(feature_size[2], dtype=dtype) * x_stride + x_offset
    velocities = np.asarray(velocities, dtype=dtype).reshape([-1, 2])
    return _mesh_anchors(x_centers, y_centers, z_centers, sizes, rotations,
                         velocities if velocities.size else None, dtype)


def create_anchors_bev_range(feature_size, anchor_range, sizes=(1.6, 3.9),
                             rotations=(0, np.pi / 2), velocities=None,
                             dtype=np.float32):
    """BEV anchors [x, y, w, l, (vx, vy,) rot] per cell: feature_size is
    [H, W], anchor_range [xmin, ymin, xmax, ymax]; x/y centers at stride/2
    offsets with the stride of the x extent for both axes, as the
    reference does. Returns (H, W, num_sizes, num_rots, ndim)."""
    anchor_range = np.asarray(anchor_range, dtype)
    stride = (anchor_range[2] - anchor_range[0]) / feature_size[1]
    y_centers = np.linspace(anchor_range[1], anchor_range[3], feature_size[0],
                            endpoint=False, dtype=dtype) + stride / 2
    x_centers = np.linspace(anchor_range[0], anchor_range[2], feature_size[1],
                            endpoint=False, dtype=dtype) + stride / 2
    rotations = np.asarray(rotations, dtype=dtype)
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 2])
    if velocities is not None:
        velocities = np.asarray(velocities, dtype=dtype).reshape([-1, 2])
        combines = np.hstack([sizes, velocities]).reshape([-1, 4])
    else:
        combines = sizes
    rets = list(np.meshgrid(x_centers, y_centers, rotations, indexing="ij"))
    n_size = sizes.shape[0]
    for i in range(len(rets)):
        rets[i] = np.tile(rets[i][:, :, np.newaxis, :, np.newaxis],
                          [1, 1, n_size, 1, 1])
    combines = np.tile(
        np.reshape(combines, [1, 1, -1, 1, combines.shape[-1]]),
        [rets[0].shape[0], rets[0].shape[1], 1, rets[0].shape[3], 1])
    rets.insert(2, combines)
    return np.transpose(np.concatenate(rets, axis=-1), [1, 0, 2, 3, 4])


@ANCHOR_GENERATORS.register_module(name="bev_anchor_generator_range")
@dataclass
class BevAnchorGeneratorRange:
    """2D BEV anchors (w, l sizes, no z or h) for BevBoxCoder configs."""
    sizes: Sequence[float] = (1.6, 3.9)
    rotations: Sequence[float] = (0, np.pi / 2)
    velocities: Optional[Sequence[float]] = None
    class_name: Optional[str] = None
    match_threshold: float = -1.0
    unmatch_threshold: float = -1.0
    dtype: type = np.float32
    anchor_ranges: Sequence[float] = field(default_factory=list)

    @property
    def num_anchors_per_localization(self) -> int:
        return len(self.rotations) * np.asarray(self.sizes).reshape(
            [-1, 2]).shape[0]

    @property
    def ndim(self) -> int:
        return 5 if self.velocities is None else 7

    def generate(self, feature_map_size):
        fm = list(feature_map_size)       # [D (=1), H, W]: D is ignored
        if len(fm) == 3:
            fm = fm[1:]
        return create_anchors_bev_range(fm, self.anchor_ranges, self.sizes,
                                        self.rotations, self.velocities,
                                        self.dtype)


@ANCHOR_GENERATORS.register_module(name="anchor_generator_stride")
@dataclass
class AnchorGeneratorStride:
    sizes: Sequence[float] = (1.6, 3.9, 1.56)
    rotations: Sequence[float] = (0, np.pi / 2)
    velocities: Optional[Sequence[float]] = None
    class_name: Optional[str] = None
    match_threshold: float = -1.0
    unmatch_threshold: float = -1.0
    dtype: type = np.float32
    anchor_strides: Sequence[float] = (0.4, 0.4, 1.0)
    anchor_offsets: Sequence[float] = (0.2, -39.8, -1.78)

    @property
    def num_anchors_per_localization(self) -> int:
        return len(self.rotations) * np.asarray(self.sizes).reshape(
            [-1, 3]).shape[0]

    @property
    def ndim(self) -> int:
        return 7 if not self.velocities else 9

    def generate(self, feature_map_size):
        velocities = self.velocities if self.velocities is not None else ()
        return create_anchors_3d_stride(
            feature_map_size, self.sizes, self.anchor_strides,
            self.anchor_offsets, self.rotations, velocities, self.dtype)


@BOX_CODERS.register_module(name="ground_box3d_coder")
@dataclass
class GroundBox3dCoder:
    """SECOND ground-plane 3D box coder (torch)."""
    linear_dim: bool = False
    vec_encode: bool = False
    n_dim: int = 7
    norm_velo: bool = False

    @property
    def code_size(self) -> int:
        return self.n_dim + 1 if self.vec_encode else self.n_dim

    def encode(self, boxes, anchors):
        return box_ops.second_box_encode(
            boxes, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim, norm_velo=self.norm_velo)

    def decode(self, encodings, anchors):
        return box_ops.second_box_decode(
            encodings, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim, norm_velo=self.norm_velo)


def build_box_coder(cfg: dict):
    """Box coder from its config dict (reference config schema)."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind == "ground_box3d_coder":
        return GroundBox3dCoder(
            linear_dim=cfg.get("linear_dim", False),
            vec_encode=cfg.get("encode_angle_vector", False),
            n_dim=cfg.get("n_dim", 7),
            norm_velo=cfg.get("norm_velo", False))
    if kind == "bev_box_coder":
        return BevBoxCoder(
            linear_dim=cfg.get("linear_dim", False),
            vec_encode=cfg.get("encode_angle_vector", False),
            z_fixed=cfg.get("z_fixed", -1.0),
            h_fixed=cfg.get("h_fixed", 2.0))
    raise KeyError(f"unknown box coder type {kind}")


@BOX_CODERS.register_module(name="bev_box_coder")
@dataclass
class BevBoxCoder:
    """BEV-only coder with fixed z and h (reference box_coders.py:100-134):
    encodes [x y w l r] against the anchor's BEV view and puts the
    configured z_fixed / h_fixed back at decode (torch)."""
    linear_dim: bool = False
    vec_encode: bool = False
    z_fixed: float = -1.0
    h_fixed: float = 2.0
    n_dim: int = 7

    @property
    def code_size(self) -> int:
        return 6 if self.vec_encode else 5

    @staticmethod
    def _bev_view(arr):
        """[x y w l r]: 5-wide arrays pass; 3D boxes give their BEV dims."""
        if arr.shape[-1] == 5:
            return arr
        return arr[..., [0, 1, 3, 4, arr.shape[-1] - 1]]

    def encode(self, boxes, anchors):
        b, a = self._bev_view(boxes), self._bev_view(anchors)
        diag = torch.sqrt(a[..., 2] ** 2 + a[..., 3] ** 2)
        xt = (b[..., 0] - a[..., 0]) / diag
        yt = (b[..., 1] - a[..., 1]) / diag
        if self.linear_dim:
            wt = b[..., 2] / a[..., 2] - 1
            lt = b[..., 3] / a[..., 3] - 1
        else:
            wt = torch.log(b[..., 2] / a[..., 2])
            lt = torch.log(b[..., 3] / a[..., 3])
        if self.vec_encode:
            rtx = torch.cos(b[..., 4]) - torch.cos(a[..., 4])
            rty = torch.sin(b[..., 4]) - torch.sin(a[..., 4])
            return torch.stack([xt, yt, wt, lt, rtx, rty], dim=-1)
        return torch.stack([xt, yt, wt, lt, b[..., 4] - a[..., 4]], dim=-1)

    def decode(self, encodings, anchors):
        a = self._bev_view(anchors)
        diag = torch.sqrt(a[..., 2] ** 2 + a[..., 3] ** 2)
        x = encodings[..., 0] * diag + a[..., 0]
        y = encodings[..., 1] * diag + a[..., 1]
        if self.linear_dim:
            w = (encodings[..., 2] + 1) * a[..., 2]
            l = (encodings[..., 3] + 1) * a[..., 3]
        else:
            w = torch.exp(encodings[..., 2]) * a[..., 2]
            l = torch.exp(encodings[..., 3]) * a[..., 3]
        if self.vec_encode:
            r = torch.atan2(encodings[..., 5] + torch.sin(a[..., 4]),
                            encodings[..., 4] + torch.cos(a[..., 4]))
        else:
            r = encodings[..., 4] + a[..., 4]
        z = torch.full_like(x, self.z_fixed)
        h = torch.full_like(x, self.h_fixed)
        return torch.stack([x, y, z, w, l, h, r], dim=-1)
