"""Build models from reference-schema config dicts; random weights.

Port of det3d_tpu/models/builder.py over the port's own registries:
``build_reader``, ``build_backbone``, ``build_neck``, ``build_head`` and
``build_loss`` build one part from its config, and ``build_detector``
builds a detector through them. Importing this module registers every
part, the image backbones and FPN included.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from det3d_tpu_torch.utils.registry import build_from_cfg
from det3d_tpu_torch.core.anchors import build_box_coder
from det3d_tpu_torch.models import backbones as _backbones  # noqa: F401
from det3d_tpu_torch.models import detectors as _detectors  # noqa: F401
from det3d_tpu_torch.models import heads as _heads  # noqa: F401
from det3d_tpu_torch.models import image_backbones as _img  # noqa: F401
from det3d_tpu_torch.models import necks as _necks  # noqa: F401
from det3d_tpu_torch.models import readers as _readers  # noqa: F401
from det3d_tpu_torch.models import second_stage as _second  # noqa: F401
from det3d_tpu_torch.models.backbones import DenseConvBN, SparseConvBN
from det3d_tpu_torch.models.losses import build_loss  # noqa: F401
from det3d_tpu_torch.models.norm import MaskedBatchNorm
from det3d_tpu_torch.models.registry import (BACKBONES, DETECTORS, HEADS,
                                             NECKS, READERS)


def _clean(cfg: dict) -> dict:
    """Drop config keys with no meaning here and rename ``name``."""
    cfg = dict(cfg)
    cfg.pop("logger", None)
    if "name" in cfg:
        cfg["name_str"] = cfg.pop("name")
    return cfg


def build_reader(cfg, **default_args):
    return build_from_cfg(_clean(cfg), READERS, default_args or None)


def build_backbone(cfg, **default_args):
    return build_from_cfg(_clean(cfg), BACKBONES, default_args or None)


def build_neck(cfg, **default_args):
    return build_from_cfg(_clean(cfg), NECKS, default_args or None)


def build_head(cfg, **default_args):
    cfg = _clean(cfg)
    if isinstance(cfg.get("box_coder"), dict):
        cfg["box_coder"] = build_box_coder(cfg["box_coder"])
    return build_from_cfg(cfg, HEADS, default_args or None)


def build_detector(cfg, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None, grid_size=None):
    """Build a detector from a reference-schema model config. grid_size is
    the voxel grid (nx, ny, nz) the canvas is sized by."""
    cfg = dict(cfg)
    det_type = cfg.pop("type")
    cfg.pop("pretrained", None)
    reader = build_reader(cfg.pop("reader"))
    backbone = build_backbone(cfg.pop("backbone"))
    neck = build_neck(cfg.pop("neck")) if "neck" in cfg else None
    head = build_head(cfg.pop("bbox_head"))

    det_cls = DETECTORS.get(det_type)
    if det_cls is None:
        raise NotImplementedError(f"detector {det_type!r} is not ported yet")
    if grid_size is not None:
        grid_size = tuple(int(g) for g in grid_size)
    return det_cls(reader=reader, backbone=backbone, neck=neck,
                   bbox_head=head, train_cfg=train_cfg, test_cfg=test_cfg,
                   grid_size=grid_size)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator``, a CPU generator, and copied
    to the model's device, so one seed gives the same weights on every
    device: convolution and linear weights from a normal with std
    1/sqrt(fan_in), as flax's default LeCun init, biases zero, BatchNorm
    at identity statistics."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                          DenseConvBN, SparseConvBN)):
            w = m.weight
            fan_in = w.shape[1] * w[0, 0].numel()
            if isinstance(m, nn.ConvTranspose2d):       # (in, out, kh, kw)
                fan_in = w.shape[0] * w[0, 0].numel()
            if isinstance(m, SparseConvBN):             # (kvol, in, out)
                fan_in = w.shape[0] * w.shape[1]
            w.copy_(torch.randn(w.shape, generator=generator).to(w.device)
                    / math.sqrt(fan_in))
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, MaskedBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return model
