"""BatchNorm with the reference's parameter names, evaluation path.

Port of det3d_tpu/models/norm.py::MaskedBatchNorm for serving: it
normalizes the last axis with the running statistics,
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, in the reference's
order of operations, in fp32, and returns ``dtype``: the layer's
activation dtype (bf16 in a bf16 reader, neck or dense epilogue), or the
one a call passes. In eval
the mask plays no part. Batch statistics, the mask and the synced variant
wait for the training port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Normalizes (..., C) over C with running ``mean`` and ``var``."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = float(eps)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, dtype=None):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics are not ported yet; call "
                "model.eval()")
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        y = (x.float() - self.mean) * inv + self.bias
        return y.to(dtype or self.dtype)


def build_norm(norm_cfg: Optional[dict], num_features: int,
               dtype: torch.dtype = torch.float32) -> MaskedBatchNorm:
    """BN / BN1d / SyncBN configs all map to MaskedBatchNorm (eval is the
    same for all of them)."""
    cfg = dict(norm_cfg or {})
    return MaskedBatchNorm(num_features, eps=float(cfg.get("eps", 1e-3)),
                           dtype=dtype)

