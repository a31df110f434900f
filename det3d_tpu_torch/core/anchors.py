"""Anchor grids (numpy, built once) and the box coder (torch).

Port of det3d_tpu/core/anchors.py: ``_mesh_anchors``,
``create_anchors_3d_range``, ``AnchorGeneratorRange``,
``GroundBox3dCoder`` and ``build_box_coder``. Anchors depend only on the
config and the feature-map size, so they are numpy arrays made at build
time; the steps move them to the device once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

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
    raise NotImplementedError(f"box coder {kind!r} is not ported yet")
