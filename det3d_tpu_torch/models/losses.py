"""The weighted detection losses of the shipped configs.

Port of det3d_tpu/models/losses.py: ``WeightedSmoothL1Loss``,
``WeightedL2LocalizationLoss``, ``SigmoidFocalLoss``,
``WeightedSigmoidClassificationLoss``,
``WeightedSoftmaxClassificationLoss`` and ``build_loss``, plain functions
on tensors in the JAX package's order of operations; autograd gives
their backward. The rest of the JAX package's loss zoo (GHM, balanced
L1, IoU, bootstrapped) is ROADMAP queue 1, item 11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from det3d_tpu_torch.models.registry import LOSSES
from det3d_tpu_torch.utils.registry import build_from_cfg


def _sigmoid_cross_entropy_with_logits(labels, logits):
    """Elementwise sigmoid cross entropy, numerically stable (TF's)."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _softmax_cross_entropy_with_logits(labels, logits):
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


@LOSSES.register_module
@dataclass
class WeightedSmoothL1Loss:
    """Per-element smooth L1 with the sigma transition; ``code_weights``
    is accepted and ignored, as the reference's constructor does."""
    sigma: float = 3.0
    reduction: str = "mean"
    code_weights: Optional[Sequence[float]] = None
    codewise: bool = True
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        abs_diff = torch.abs(pred - target)
        k = 1.0 / (self.sigma ** 2)
        lt = (abs_diff <= k).to(abs_diff.dtype)
        loss = (lt * 0.5 * (abs_diff * self.sigma) ** 2
                + (abs_diff - 0.5 * k) * (1.0 - lt))
        if self.codewise:
            if weights is not None:
                loss = loss * weights[..., None]
        else:
            loss = torch.sum(loss, dim=2)
            if weights is not None:
                loss = loss * weights
        return loss


@LOSSES.register_module
@dataclass
class WeightedL2LocalizationLoss:
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        diff = pred - target
        if weights is not None:
            diff = diff * weights[..., None]
        return 0.5 * diff * diff


@LOSSES.register_module
@dataclass
class SigmoidFocalLoss:
    """Sigmoid focal cross entropy."""
    gamma: float = 2.0
    alpha: float = 0.25
    reduction: str = "mean"
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        ce = _sigmoid_cross_entropy_with_logits(labels=target, logits=pred)
        p = torch.sigmoid(pred)
        p_t = target * p + (1.0 - target) * (1.0 - p)
        modulating = torch.pow(1.0 - p_t, self.gamma) if self.gamma else 1.0
        if self.alpha is not None:
            alpha_w = target * self.alpha + (1.0 - target) * (1.0 - self.alpha)
        else:
            alpha_w = 1.0
        loss = modulating * alpha_w * ce
        if weights is not None:
            loss = (loss * weights[..., None] if weights.dim() == loss.dim() - 1
                    else loss * weights)
        return loss


@LOSSES.register_module
@dataclass
class WeightedSigmoidClassificationLoss:
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        loss = _sigmoid_cross_entropy_with_logits(labels=target, logits=pred)
        if weights is not None:
            loss = loss * weights[..., None]
        return loss


@LOSSES.register_module
@dataclass
class WeightedSoftmaxClassificationLoss:
    """Softmax cross entropy over one-hot targets (B, A, num_classes),
    weighted per anchor: the direction classifier's loss."""
    logit_scale: float = 1.0
    loss_weight: float = 1.0
    name: str = ""

    def __call__(self, pred, target, weights):
        ce = _softmax_cross_entropy_with_logits(
            labels=target, logits=pred / self.logit_scale)
        return ce * weights


def build_loss(cfg: dict):
    """A loss from its config dict (``type`` a LOSSES name)."""
    return build_from_cfg(dict(cfg), LOSSES)
