"""Image backbones (ResNet, SENet, SSDVGG) and the FPN neck.

Port of det3d_tpu/models/image_backbones.py (reference det3d/models/
backbones/{resnet.py, senet.py, ssd_vgg.py} and necks/fpn.py): the
reference's image backbones, registered but used by no shipped lidar
config. The JAX package writes them as plain flax, so plain PyTorch is
their port. Config knobs kept: ResNet depth / num_stages / strides /
dilations / out_indices / style / frozen_stages / norm_eval / groups, SENet
groups / reduction, SSDVGG input_size / l2_norm_scale, FPN's levels and
extra levels.

Inputs and outputs are NHWC, as in the JAX package; inside, the tensors
are NCHW views of channels-last memory (a permute, no copy), as
models/necks.py's are. Every module takes its input width (``in_channels``,
3 for an image). BatchNorm is models/norm.py::MaskedBatchNorm. Modules keep
flax's call-order names (``Conv_<n>``, ``MaskedBatchNorm_<n>``,
``Dense_<n>``, ``BasicBlock_<n>``, ``Bottleneck_<n>``, ``L2Norm_<n>``,
``ResNet_0``; FPN's ``lateral<i>``, ``fpn<i>``, ``extra<i>``), so
utils/convert.py::from_jax carries the JAX package's weights over.

Frozen stages and ``norm_eval``: a stage's BatchNorms take batch
statistics only in training mode, past ``frozen_stages`` and without
``norm_eval`` (the stem's only when nothing is frozen); ``train(mode)``
puts the others in eval mode, so they use and keep their running
statistics. The features leave a frozen stage detached, where the JAX
package stops their gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.models.norm import build_norm
from det3d_tpu_torch.models.registry import BACKBONES, NECKS


def _conv(cin, f, k, s=1, d=1, bias=False, groups=1, pad=None):
    """A k x k convolution, padded as the JAX package pads it."""
    if pad is None:
        pad = ((k - 1) * d + 1) // 2
    return nn.Conv2d(cin, f, k, stride=s, padding=pad, dilation=d,
                     groups=groups, bias=bias)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _bn(norm, x):
    """A MaskedBatchNorm over the channels of an NCHW tensor."""
    return _nchw(norm(_nhwc(x)))


class BasicBlock(nn.Module):
    """resnet.py:14-89. expansion = 1. Works on NCHW."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.downsample = downsample
        self.Conv_0 = _conv(inplanes, planes, 3, stride, dilation)
        self.MaskedBatchNorm_0 = build_norm(norm_cfg, planes)
        self.Conv_1 = _conv(planes, planes, 3, 1, dilation)
        self.MaskedBatchNorm_1 = build_norm(norm_cfg, planes)
        if downsample:
            self.Conv_2 = nn.Conv2d(inplanes, planes, 1, stride=stride,
                                    bias=False)
            self.MaskedBatchNorm_2 = build_norm(norm_cfg, planes)

    def forward(self, x):
        out = F.relu(_bn(self.MaskedBatchNorm_0, self.Conv_0(x)))
        out = _bn(self.MaskedBatchNorm_1, self.Conv_1(out))
        identity = (_bn(self.MaskedBatchNorm_2, self.Conv_2(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """resnet.py:91-250. expansion = 4; ``style`` puts the stride on the
    first conv (caffe) or the 3x3 (pytorch); ``groups`` > 1 gives ResNeXt;
    ``se_reduction`` > 0 adds the squeeze-excitation branch (senet.py).
    Works on NCHW."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "pytorch", groups: int = 1,
                 se_reduction: int = 0, norm_cfg: Optional[dict] = None):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.downsample = downsample
        self.se_reduction = se_reduction
        out = planes * 4
        self.Conv_0 = nn.Conv2d(inplanes, planes, 1, stride=s1, bias=False)
        self.MaskedBatchNorm_0 = build_norm(norm_cfg, planes)
        self.Conv_1 = _conv(planes, planes, 3, s2, dilation, groups=groups,
                            pad=dilation)
        self.MaskedBatchNorm_1 = build_norm(norm_cfg, planes)
        self.Conv_2 = nn.Conv2d(planes, out, 1, bias=False)
        self.MaskedBatchNorm_2 = build_norm(norm_cfg, out)
        if se_reduction:
            self.Dense_0 = nn.Linear(out, out // se_reduction)
            self.Dense_1 = nn.Linear(out // se_reduction, out)
        if downsample:
            self.Conv_3 = nn.Conv2d(inplanes, out, 1, stride=stride,
                                    bias=False)
            self.MaskedBatchNorm_3 = build_norm(norm_cfg, out)

    def forward(self, x):
        out = F.relu(_bn(self.MaskedBatchNorm_0, self.Conv_0(x)))
        out = F.relu(_bn(self.MaskedBatchNorm_1, self.Conv_1(out)))
        out = _bn(self.MaskedBatchNorm_2, self.Conv_2(out))
        if self.se_reduction:
            squeeze = out.mean((2, 3))                       # (B, C)
            e = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(squeeze))))
            out = out * e[:, :, None, None]
        identity = (_bn(self.MaskedBatchNorm_3, self.Conv_3(x))
                    if self.downsample else x)
        return F.relu(out + identity)


_ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module
class ResNet(nn.Module):
    """resnet.py:344-521: stem (7x7/2 conv, BN, ReLU, 3x3/2 max-pool) and
    ``num_stages`` stages; forward(x NHWC) returns the NHWC maps of the
    stages in ``out_indices``."""

    def __init__(self, depth: int, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = "pytorch", frozen_stages: int = -1,
                 norm_cfg: Optional[dict] = None, norm_eval: bool = True,
                 groups: int = 1, se_reduction: int = 0,
                 in_channels: int = 3, name_str: str = "ResNet"):
        super().__init__()
        if depth not in _ARCH:
            raise KeyError(f"invalid depth {depth} for resnet")
        block, blocks = _ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.Conv_0 = _conv(in_channels, 64, 7, 2)
        self.MaskedBatchNorm_0 = build_norm(norm_cfg, 64)
        self.stages = []                 # per stage, its blocks' names
        inplanes, planes, n = 64, 64, 0
        for i, count in enumerate(blocks[:num_stages]):
            names = []
            for j in range(count):
                kw = dict(stride=strides[i] if j == 0 else 1,
                          dilation=dilations[i], downsample=(j == 0),
                          norm_cfg=norm_cfg)
                if block is Bottleneck:
                    kw.update(style=style, groups=groups,
                              se_reduction=se_reduction)
                name = f"{block.__name__}_{n}"
                self.add_module(name, block(inplanes, planes, **kw))
                names.append(name)
                inplanes, n = planes * block.expansion, n + 1
            self.stages.append(names)
            planes *= 2
        self.train(self.training)

    def train(self, mode: bool = True):
        """Training mode, where BatchNorms outside the frozen stages and
        without ``norm_eval`` take batch statistics; the rest stay in eval
        mode (resnet.py:498-516)."""
        super().train(mode)
        self.MaskedBatchNorm_0.train(mode and self.frozen_stages < 0
                                     and not self.norm_eval)
        for i, names in enumerate(self.stages):
            on = mode and i + 1 > self.frozen_stages and not self.norm_eval
            for name in names:
                getattr(self, name).train(on)
        return self

    def forward(self, x):
        x = F.relu(_bn(self.MaskedBatchNorm_0, self.Conv_0(_nchw(x))))
        if self.frozen_stages >= 0:
            x = x.detach()
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i + 1 <= self.frozen_stages:
                x = x.detach()
            if i in self.out_indices:
                outs.append(_nhwc(x))
        return tuple(outs)


@BACKBONES.register_module
class SENet(nn.Module):
    """senet.py: the squeeze-excitation ResNet (ResNeXt with ``groups`` >
    1), the JAX package's ResNet with its SE branch, held as
    ``ResNet_0``; its BatchNorms follow the training mode (no frozen
    stage, no ``norm_eval``)."""

    def __init__(self, depth: int = 50, groups: int = 1, reduction: int = 16,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_cfg: Optional[dict] = None, in_channels: int = 3,
                 name_str: str = "SENet"):
        super().__init__()
        self.ResNet_0 = ResNet(depth=depth, num_stages=num_stages,
                               strides=strides, dilations=dilations,
                               out_indices=out_indices, norm_cfg=norm_cfg,
                               norm_eval=False, groups=groups,
                               se_reduction=reduction, frozen_stages=-1,
                               in_channels=in_channels)

    def forward(self, x):
        return self.ResNet_0(x)


_VGG_CFG = {  # channels per conv layer, "M" = pool (vgg.py, depth 16)
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512),
}

_SSD_EXTRA = {  # ssd_vgg.py:14-17
    300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
    512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256, 128),
}


class L2Norm(nn.Module):
    """ssd_vgg.py:120-135: L2 normalization over channels, scaled per
    channel by ``gamma`` (initialized to ``scale``). Works on NCHW."""

    def __init__(self, channels: int, scale: float = 20.0,
                 eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True)) + self.eps
        return self.gamma[:, None, None] * x / norm


def _ssd_extra_specs(input_size):
    """(outplanes, kernel, stride, pad) of the SSD extra layers
    (_make_extra_layers, ssd_vgg.py:95-117): kernels alternate 1 and 3;
    "S" marks a stride-2 pad-1 layer whose width is the next entry; the
    others are stride 1 without padding; SSD512 ends with a 4x4 pad-1
    conv."""
    cfg = _SSD_EXTRA[input_size]
    specs, i = [], 0
    while i < len(cfg):
        k = 1 if len(specs) % 2 == 0 else 3
        if cfg[i] == "S":
            specs.append((cfg[i + 1], k, 2, 1))
            i += 2
        else:
            specs.append((cfg[i], k, 1, 0))
            i += 1
    if input_size == 512:
        specs.append((256, 4, 1, 1))
    return specs


@BACKBONES.register_module
class SSDVGG(nn.Module):
    """ssd_vgg.py:13-118: the VGG-16 trunk (ceil-mode 2x2 pools, a
    stride-1 3x3 pool5, fc6 / fc7 as a dilated and a 1x1 conv) and the SSD
    extra pyramid; returns conv4_3 through L2Norm, fc7, and every second
    extra layer, NHWC."""

    def __init__(self, input_size: int = 300, depth: int = 16,
                 l2_norm_scale: float = 20.0, in_channels: int = 3,
                 name_str: str = "SSDVGG"):
        super().__init__()
        if input_size not in _SSD_EXTRA:
            raise ValueError(f"SSDVGG input_size {input_size}")
        self.trunk = []                  # ("pool", 1..5) or ("conv", name)
        cin, n, pools = in_channels, 0, 0
        for v in _VGG_CFG[depth]:
            if v == "M":
                pools += 1
                self.trunk.append(("pool", pools))
                continue
            self.add_module(f"Conv_{n}", _conv(cin, v, 3, bias=True))
            self.trunk.append(("conv", f"Conv_{n}"))
            cin, n = v, n + 1
            if n == 10:                                    # conv4_3 tap
                self.L2Norm_0 = L2Norm(v, l2_norm_scale)
                self.trunk.append(("l2norm", "L2Norm_0"))
        if pools == 4:                                     # pool5
            self.trunk.append(("pool", 5))
        self.add_module(f"Conv_{n}", _conv(cin, 1024, 3, d=6, bias=True))
        self.add_module(f"Conv_{n + 1}", nn.Conv2d(1024, 1024, 1))
        self.fc = (f"Conv_{n}", f"Conv_{n + 1}")
        cin, n = 1024, n + 2
        self.extra = []
        for f, k, s, p in _ssd_extra_specs(input_size):
            self.add_module(f"Conv_{n}", nn.Conv2d(cin, f, k, stride=s,
                                                   padding=p))
            self.extra.append(f"Conv_{n}")
            cin, n = f, n + 1

    def forward(self, x):
        x = _nchw(x)
        outs = []
        for kind, what in self.trunk:
            if kind == "pool":
                x = (F.max_pool2d(x, 3, 1, 1) if what == 5
                     else F.max_pool2d(x, 2, 2, ceil_mode=True))
            elif kind == "conv":
                x = F.relu(getattr(self, what)(x))
            else:
                outs.append(_nhwc(getattr(self, what)(x)))
        for name in self.fc:
            x = F.relu(getattr(self, name)(x))
        outs.append(_nhwc(x))
        for li, name in enumerate(self.extra):
            x = F.relu(getattr(self, name)(x))
            if li % 2 == 1:
                outs.append(_nhwc(x))
        return tuple(outs)


@NECKS.register_module
class FPN(nn.Module):
    """necks/fpn.py:11-144: lateral 1x1 convs, a nearest top-down pathway,
    3x3 output convs, and extra levels: 1x1 stride-2 max-pools, or
    stride-2 3x3 convs on the last used input or output. forward(list of
    NHWC maps) -> tuple of NHWC maps.

    The top-down upsampling is ``jax.image.resize``'s "nearest", which is
    torch's "nearest-exact" (pixel centers), not "nearest"; the two differ
    where a size is not an exact multiple of the other."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 num_outs: int, start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool = False,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False,
                 name_str: str = "FPN"):
        super().__init__()
        self.in_channels = list(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = len(in_channels) if end_level == -1 else end_level
        self.add_extra_convs = add_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:self.end]
        for i, c in enumerate(used):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels,
                                                 3, padding=1))
        self.num_extra = max(num_outs - len(used), 0)
        if add_extra_convs:
            cin = (self.in_channels[self.end - 1] if extra_convs_on_inputs
                   else out_channels)
            for i in range(self.num_extra):
                self.add_module(f"extra{i}", nn.Conv2d(
                    cin if i == 0 else out_channels, out_channels, 3,
                    stride=2, padding=1))

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN takes {len(self.in_channels)} maps, got "
                             f"{len(inputs)}")
        used = [_nchw(x) for x in inputs[self.start_level:self.end]]
        laterals = [getattr(self, f"lateral{i}")(x)
                    for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:],
                mode="nearest-exact")
        outs = [getattr(self, f"fpn{i}")(x) for i, x in enumerate(laterals)]
        if self.num_extra and not self.add_extra_convs:
            for _ in range(self.num_extra):
                outs.append(F.max_pool2d(outs[-1], 1, 2))
        elif self.num_extra:
            src = (_nchw(inputs[self.end - 1]) if self.extra_convs_on_inputs
                   else outs[-1])
            for i in range(self.num_extra):
                if i > 0 and self.relu_before_extra_convs:
                    src = F.relu(src)
                src = getattr(self, f"extra{i}")(src)
                outs.append(src)
        return tuple(_nhwc(x) for x in outs)
