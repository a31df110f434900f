"""Temporal feature alignment and aggregation.

Port of det3d_tpu/models/temporal.py (reference det3d/ops/align_aggregation:
the Correlation and AlignFeature CUDA ops and the Aggregation /
Align_Feature_and_Aggregation modules, align_feature_and_aggregation.py:
7-59), which warp a keyframe's BEV features onto the current frame. The
JAX package writes both ops with an im2col of the window; they are plain
XLA, not Pallas kernels, so plain PyTorch is their port.

Layout NHWC, as in the JAX package. Displacement k of a patch_size p
window is ``(dy + p//2) * p + (dx + p//2)`` (the JAX package's
channel-major patch order), with zeros outside the frame. Both ops loop
over the p^2 shifted slices of one zero-padded map and accumulate: the
(B, H, W, C, p^2) patch tensor is never made (13.3 GB at 384 channels and
p = 9 on a (2, 248, 216) map). The sums run in another order than the JAX
package's einsum, which moves the results by rounding only.

The convolutions run on NCHW views of channels-last memory (a permute, no
copy), as models/necks.py's do; every module takes its input width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _shifts(x: torch.Tensor, patch: int):
    """Yield (k, x shifted by displacement k) for the patch x patch window:
    slices of x zero-padded by patch // 2 on H and W."""
    h, w = x.shape[1:3]
    r = patch // 2
    pad = F.pad(x, (0, 0, r, r, r, r))
    for k in range(patch * patch):
        ky, kx = divmod(k, patch)
        yield k, pad[:, ky:ky + h, kx:kx + w]


def correlation(a: torch.Tensor, b: torch.Tensor, patch_size: int = 9
                ) -> torch.Tensor:
    """(B, H, W, C) x (B, H, W, C) -> (B, H, W, patch_size^2) cost volume:
    corr[..., k] = <a[y, x, :], b[y + dy_k, x + dx_k, :]> (kernel size 1,
    stride 1)."""
    return torch.stack([(a * bk).sum(-1) for _, bk in _shifts(b, patch_size)],
                       -1)


def align_feature(feat: torch.Tensor, weights: torch.Tensor,
                  patch_size: int = 9) -> torch.Tensor:
    """(B, H, W, C) x (B, H, W, patch_size^2) -> (B, H, W, C):
    out[y, x, c] = sum_k w[y, x, k] * feat[y + dy_k, x + dx_k, c]."""
    out = torch.zeros_like(feat)
    for k, fk in _shifts(feat, patch_size):
        out = torch.addcmul(out, weights[..., k:k + 1], fk)
    return out


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An NCHW convolution over an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Aggregation(nn.Module):
    """Quality-weighted blend of the aligned keyframe and the current
    features (align_feature_and_aggregation.py:7-27): one conv tower,
    shared by both inputs, scores each; the two scores softmax into the
    blend weights."""

    def __init__(self, num_channel: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(num_channel, 64, 1)
        self.Conv_1 = nn.Conv2d(64, 32, 3, padding=1)
        self.Conv_2 = nn.Conv2d(32, 1, 1)

    def tower(self, x):
        return _conv(self.Conv_2, _conv(self.Conv_1, _conv(self.Conv_0, x)))

    def forward(self, align_feat, feat):
        logits = torch.cat([self.tower(align_feat), self.tower(feat)], -1)
        w = torch.softmax(logits, -1)                     # (B, H, W, 2)
        return w[..., :1] * align_feat + w[..., 1:] * feat


class AlignFeatureAndAggregation(nn.Module):
    """The temporal block (align_feature_and_aggregation.py:30-59): embed
    both frames with 1x1 convs, correlate them over a neighbor x neighbor
    window, softmax the cost volume, warp the keyframe by it, blend."""

    def __init__(self, num_channel: int, neighbor: int = 9):
        super().__init__()
        self.neighbor = neighbor
        self.embed_keyframe_conv = nn.Conv2d(num_channel, 64, 1)
        self.embed_current_conv = nn.Conv2d(num_channel, 64, 1)
        self.Aggregation_0 = Aggregation(num_channel)

    def forward(self, feature_select, feature_current):
        w = correlation(_conv(self.embed_current_conv, feature_current),
                        _conv(self.embed_keyframe_conv, feature_select),
                        self.neighbor)
        w = torch.softmax(w, -1)
        aligned = align_feature(feature_select, w, self.neighbor)
        return self.Aggregation_0(aligned, feature_current)
