"""RPN neck: strided conv stages with upsampling branches.

Port of det3d_tpu/models/necks.py::RPN. Per stage, a stride-s 3x3 conv,
then ``layer_num`` 3x3 convs, each conv + BN + ReLU; each stage from
``upsample_start_idx`` feeds a transposed-conv (stride > 1) or conv
(stride <= 1) branch, and the branch outputs concatenate on channels.

Input and output keep the reference's NHWC layout. Inside, the tensors are
NCHW views of channels-last memory (a permute, no copy), which is the
layout the convolutions take natively. Two cuDNN faults shape the stage
convs (``stage_conv``): a 3x3 conv that narrows a map of more than
CIN_CHUNK channels runs as a sum of convs over CIN_CHUNK-channel slices of
its input, and an fp32 stride-1 conv over a batch of maps of SPLIT_PIXELS
or more runs one map at a time.

The trunk runs in the activation dtype of ``precision``, as the JAX
package's does: the input is cast to it, every conv and transposed conv
takes its fp32 weight cast to it for the call, every BN rounds its output
to it, and the branches concatenate in it. In fp32 the casts are no-ops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.models.norm import build_norm
from det3d_tpu_torch.models.precision import act_dtype
from det3d_tpu_torch.models.registry import NECKS


# cuDNN 9.22 (PyTorch 2.11) on the H100 takes ~344 ms for CBGS's first RPN
# conv, fp32 3x3 from 256 to 128 channels at B=2 on 128 x 128 with TF32
# off; the same conv over two 128-channel input halves, summed, ~0.84 ms
# (chip_smoke.py phase 18 times both).
CIN_CHUNK = 128
# The same cuDNN, fp32 with TF32 off, takes 12.5 ms for a 3x3 conv from 128
# to 128 channels over B=2 maps of 252 x 252 (Lyft's RPN, 3 TFLOP/s), and
# 1.2 ms as one call per map; at B=2 on 200 x 176 (KITTI-all) and at B=1
# on 252 x 252 one call runs at 31-34 TFLOP/s (chip_smoke.py phases 30
# and 35 time both ways).
SPLIT_PIXELS = 252 * 252


def stage_conv(conv: nn.Conv2d, x):
    """``conv(x)`` in x's dtype (the weight cast to it). In fp32, a
    stride-1 conv over more than one map of SPLIT_PIXELS or more runs one
    map at a time; when the conv narrows a map of more than CIN_CHUNK
    channels, it is the sum of the convs of CIN_CHUNK-channel input
    slices."""
    if (x.dtype == torch.float32 and x.shape[0] > 1
            and tuple(conv.stride) == (1, 1)
            and x.shape[2] * x.shape[3] >= SPLIT_PIXELS):
        return torch.cat([stage_conv(conv, x[i:i + 1])
                          for i in range(x.shape[0])])
    cin = conv.in_channels
    w = conv.weight.to(x.dtype)
    if cin <= max(CIN_CHUNK, conv.out_channels):
        return F.conv2d(x, w, stride=conv.stride, padding=conv.padding)
    return sum(F.conv2d(x[:, i:i + CIN_CHUNK], w[:, i:i + CIN_CHUNK],
                        stride=conv.stride, padding=conv.padding)
               for i in range(0, cin, CIN_CHUNK))


@NECKS.register_module
class RPN(nn.Module):

    def __init__(self, layer_nums: Sequence[int] = (3, 5, 5),
                 ds_layer_strides: Sequence[int] = (2, 2, 2),
                 ds_num_filters: Sequence[int] = (64, 128, 256),
                 us_layer_strides: Sequence[int] = (1, 2, 4),
                 us_num_filters: Sequence[int] = (128, 128, 128),
                 num_input_features: int = 64,
                 norm_cfg: Optional[dict] = None, precision: str = "fp32",
                 name_str: str = "rpn"):
        super().__init__()
        self.dtype = act_dtype(precision)
        us_start = len(layer_nums) - len(us_layer_strides)
        # (conv, bn) name pairs in call order, per stage, then the branch
        self.stages = []
        self.branches = []
        in_ch = num_input_features
        for i, num_blocks in enumerate(layer_nums):
            out_ch = ds_num_filters[i]
            names = [f"block{i}_down"] + [f"block{i}_conv{j}"
                                          for j in range(num_blocks)]
            for j, name in enumerate(names):
                stride = ds_layer_strides[i] if j == 0 else 1
                self.add_module(f"{name}_conv", nn.Conv2d(
                    in_ch if j == 0 else out_ch, out_ch, 3, stride=stride,
                    padding=1, bias=False))
                self.add_module(f"{name}_bn",
                                build_norm(norm_cfg, out_ch, self.dtype))
            self.stages.append(names)
            in_ch = out_ch
            k = i - us_start
            if k < 0:
                self.branches.append(None)
                continue
            stride = us_layer_strides[k]
            if stride > 1:
                name = f"deblock{k}_deconv"
                conv = nn.ConvTranspose2d(out_ch, us_num_filters[k], stride,
                                          stride=stride, bias=False)
            else:
                s = int(np.round(1 / stride))
                name = f"deblock{k}_conv"
                conv = nn.Conv2d(out_ch, us_num_filters[k], s, stride=s,
                                 bias=False)
            self.add_module(name, conv)
            self.add_module(f"deblock{k}_bn", build_norm(
                norm_cfg, us_num_filters[k], self.dtype))
            self.branches.append((name, f"deblock{k}_bn"))

    def _bn_relu(self, bn_name, x):
        # BN normalizes the last axis: run it on the NHWC view
        y = getattr(self, bn_name)(x.permute(0, 2, 3, 1))
        return torch.relu(y).permute(0, 3, 1, 2)

    def _branch(self, name, x):
        conv = getattr(self, name)
        w = conv.weight.to(x.dtype)
        if isinstance(conv, nn.ConvTranspose2d):
            return F.conv_transpose2d(x, w, stride=conv.stride)
        return F.conv2d(x, w, stride=conv.stride)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H', W', sum(us_num_filters)), in the
        activation dtype (the input is cast to it: a bf16 middle may feed
        an fp32 RPN, a bf16 canvas a bf16 one)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        ups = []
        for names, branch in zip(self.stages, self.branches):
            for name in names:
                x = self._bn_relu(f"{name}_bn",
                                  stage_conv(getattr(self, f"{name}_conv"), x))
            if branch is not None:
                conv_name, bn_name = branch
                ups.append(self._bn_relu(bn_name, self._branch(conv_name, x)))
        if ups:
            x = torch.cat(ups, dim=1)
        return x.permute(0, 2, 3, 1)


@NECKS.register_module
class PointModule(nn.Module):
    """The per-crop pointnet of the two-stage refine path (reference
    rpn.py:163-201): flatten, two Linear (no bias) + BN + ReLU blocks,
    then a width-3 max filter over the feature vector with -inf padding
    (the reference's MaxPool1d(3, 1, 1)). (N, ...) -> (N, 1, 1, F). Port
    of det3d_tpu/models/necks.py::PointModule; modules keep flax's names
    (``Dense_<n>``, ``MaskedBatchNorm_<n>``)."""

    def __init__(self, num_input_features: int,
                 layers: Sequence[int] = (1024, 128),
                 norm_cfg: Optional[dict] = None,
                 name_str: str = "PointModule"):
        super().__init__()
        self.num_layers = len(layers)
        cin = num_input_features
        for i, f in enumerate(layers):
            self.add_module(f"Dense_{i}", nn.Linear(cin, f, bias=False))
            self.add_module(f"MaskedBatchNorm_{i}", build_norm(norm_cfg, f))
            cin = f

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = F.linear(x, getattr(self, f"Dense_{i}").weight)
            x = torch.relu(getattr(self, f"MaskedBatchNorm_{i}")(x))
        pad = F.pad(x, (1, 1), value=float("-inf"))
        x = torch.maximum(torch.maximum(pad[:, :-2], pad[:, 1:-1]),
                          pad[:, 2:])
        return x[:, None, None, :]
