"""BatchNorm with the reference's parameter names and masked batch
statistics.

Port of det3d_tpu/models/norm.py::MaskedBatchNorm and ``build_norm``. It
normalizes the last axis: ``y = (x - mean) * (rsqrt(var + eps) * scale) +
bias``, in the reference's order of operations, in fp32, and returns
``dtype``: the layer's activation dtype (bf16 in a bf16 reader, neck or
dense epilogue), or the one a call passes.

In eval (``module.eval()``) mean and var are the running statistics and
the mask plays no part. In training (``module.train()``) they are the
statistics of the rows that ``mask`` selects (all rows without one),
from sums: ``mean = s1 / cnt``, ``var = max(s2 / cnt - mean², 0)`` with
``cnt = max(cnt, 1)``; gradients flow through them, as in flax. The
running statistics are then updated outside autograd, ``running = (1 -
momentum) * running + momentum * batch``, the variance with its unbiased
estimate ``var * cnt / max(cnt - 1, 1)``. ``nn.BatchNorm`` takes no mask
and computes its variance otherwise.

Synced statistics: while a process group is up (parallel/dist_utils.py),
every training-mode ``MaskedBatchNorm`` sums ``cnt``, ``s1`` and ``s2``
over the ranks before it forms the mean and variance, as one flat
tensor (one collective a layer forward, one backward: the gradient of a
rank's sums is the sum of every rank's), the JAX package's ``psum``
(det3d_tpu/models/norm.py:66-71). Every layer syncs, not only those a
config calls ``SyncBN``: every shipped config says SyncBN, and under the
JAX package's mesh step every BN's sums are global anyway (one program
over the whole batch, det3d_tpu/parallel/train.py:19-21). So the
statistics, the running statistics and the gradients are the global
batch's, the same on every rank. Eval mode does not communicate.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from det3d_tpu_torch.parallel.dist_utils import active as dist_active
from det3d_tpu_torch.parallel.dist_utils import all_reduce_sum


class MaskedBatchNorm(nn.Module):
    """Normalizes (..., C) over C; batch statistics over the rows where
    ``mask`` (broadcastable to x.shape[:-1]) is True in training mode."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def batch_stats(self, xf, mask=None):
        """(mean, var, count) of the fp32 input's selected rows, over every
        rank's rows while a process group is up."""
        dims = tuple(range(xf.dim() - 1))
        if mask is None:
            cnt = xf.new_full((), float(xf.numel() // xf.shape[-1]))
            s1 = xf.sum(dims)
            s2 = (xf * xf).sum(dims)
        else:
            m = mask.to(torch.float32)[..., None].expand(xf.shape)
            cnt = m[..., 0].sum()
            s1 = (xf * m).sum(dims)
            s2 = (xf * xf * m).sum(dims)
        if dist_active():
            c = s1.shape[0]
            sums = all_reduce_sum(torch.cat([cnt.reshape(1), s1, s2]))
            cnt, s1, s2 = sums[0], sums[1:c + 1], sums[c + 1:]
        cnt = torch.clamp(cnt, min=1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        return mean, var, cnt

    def forward(self, x, mask=None, dtype=None):
        xf = x.float()
        if self.training:
            mean, var, cnt = self.batch_stats(xf, mask)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.mean.copy_((1.0 - self.momentum) * self.mean
                                + self.momentum * mean)
                self.var.copy_((1.0 - self.momentum) * self.var
                               + self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean) * inv + self.bias
        return y.to(dtype or self.dtype)


def build_norm(norm_cfg: Optional[dict], num_features: int,
               dtype: torch.dtype = torch.float32) -> MaskedBatchNorm:
    """BN / BN1d / SyncBN configs all map to MaskedBatchNorm, with the
    config's eps and momentum (1e-3 and 0.01 by default, as in every
    shipped config)."""
    cfg = dict(norm_cfg or {})
    return MaskedBatchNorm(num_features, eps=float(cfg.get("eps", 1e-3)),
                           momentum=float(cfg.get("momentum", 0.01)),
                           dtype=dtype)
