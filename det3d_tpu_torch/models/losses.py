"""The weighted detection losses.

Port of det3d_tpu/models/losses.py: ``WeightedSmoothL1Loss``,
``WeightedL2LocalizationLoss``, ``SigmoidFocalLoss``,
``WeightedSigmoidClassificationLoss``,
``WeightedSoftmaxClassificationLoss`` and ``build_loss``, and the losses
no shipped config names: ``GHMCLoss``, ``GHMRLoss``, ``BalancedL1Loss``,
``IoULoss`` (with ``bbox_overlaps_aligned``), ``BoundedIoULoss`` and
``BootstrappedSigmoidClassificationLoss``. Plain functions on tensors in
the JAX package's order of operations; autograd gives their backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
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


def _ghm_weights(g, valid, bins: int):
    """Per-element GHM weights and the histogram (bins,) of the valid
    elements' gradient norms ``g`` in [0, 1], on g's device: each valid
    element weighs num_valid / (its bin's count * non-empty bins)."""
    vf = valid.to(g.dtype)
    num_examples = torch.clamp(vf.sum(), min=1.0)
    bin_idx = torch.clamp((g * bins).to(torch.int64), 0, bins - 1)
    hist = torch.zeros(bins, dtype=g.dtype, device=g.device).index_add_(
        0, bin_idx.reshape(-1), vf.reshape(-1))
    nonempty = hist > 0
    num_valid_bins = torch.clamp(nonempty.sum().to(g.dtype), min=1.0)
    per_bin = torch.where(nonempty, num_examples
                          / torch.where(nonempty, hist, 1.0), 0.0)
    return per_bin[bin_idx] * vf / num_valid_bins, hist


@LOSSES.register_module
@dataclass
class GHMCLoss:
    """Gradient-harmonized classification loss (arXiv:1811.05181;
    reference ghm_loss.py:17-83). The histogram of the gradient norms is
    counted on the inputs' device at every call (``histogram`` returns
    it); ``momentum`` > 0 uses those counts as they are, as the JAX
    package's pure loss does (every reference config sets 0)."""
    bins: int = 10
    momentum: float = 0.0
    loss_weight: float = 1.0

    def histogram(self, pred, target, weights=None):
        """(per-element weights, histogram (bins,)) of this batch."""
        g = torch.abs(torch.sigmoid(pred).detach() - target)
        valid = ((weights >= 0) if weights is not None
                 else torch.ones(pred.shape[:-1], dtype=torch.bool,
                                 device=pred.device))
        return _ghm_weights(g, valid[..., None].expand(pred.shape),
                            self.bins)

    def __call__(self, pred, target, weights=None):
        ce = _sigmoid_cross_entropy_with_logits(labels=target, logits=pred)
        return ce * self.histogram(pred, target, weights)[0]


@LOSSES.register_module
@dataclass
class GHMRLoss:
    """Gradient-harmonized regression loss on the authentic smooth L1
    (reference ghm_loss.py:86-152); histogram and momentum as GHMCLoss."""
    mu: float = 0.02
    bins: int = 10
    momentum: float = 0.0
    code_weights: Optional[Sequence[float]] = None
    loss_weight: float = 1.0

    def histogram(self, pred, target, weights=None):
        diff = pred - target
        g = torch.abs(diff / torch.sqrt(self.mu * self.mu + diff * diff)
                      ).detach()
        valid = ((weights > 0) if weights is not None
                 else torch.ones(pred.shape[:-1], dtype=torch.bool,
                                 device=pred.device))
        return _ghm_weights(g, valid[..., None].expand(pred.shape),
                            self.bins)

    def __call__(self, pred, target, weights=None):
        diff = pred - target
        asl1 = torch.sqrt(diff * diff + self.mu * self.mu) - self.mu
        return asl1 * self.histogram(pred, target, weights)[0]


def _weighted(loss, weights):
    if weights is None:
        return loss
    return loss * (weights[..., None] if weights.dim() == loss.dim() - 1
                   else weights)


@LOSSES.register_module
@dataclass
class BalancedL1Loss:
    """Balanced L1 (Libra R-CNN, arXiv:1904.02701; reference
    balanced_l1_loss.py:10-62)."""
    alpha: float = 0.5
    gamma: float = 1.5
    beta: float = 1.0
    reduction: str = "mean"
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        diff = torch.abs(pred - target)
        b = np.e ** (self.gamma / self.alpha) - 1
        loss = torch.where(
            diff < self.beta,
            self.alpha / b * (b * diff + 1) * torch.log(b * diff / self.beta
                                                        + 1)
            - self.alpha * diff,
            self.gamma * diff + self.gamma / b - self.alpha * self.beta)
        return _weighted(loss, weights)


def bbox_overlaps_aligned(pred, target, eps=1e-6):
    """IoU of aligned (..., 4) [x1 y1 x2 y2] pixel boxes (+1 extents)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = torch.clamp(rb - lt + 1, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = ((pred[..., 2] - pred[..., 0] + 1)
              * (pred[..., 3] - pred[..., 1] + 1))
    area_t = ((target[..., 2] - target[..., 0] + 1)
              * (target[..., 3] - target[..., 1] + 1))
    return inter / torch.clamp(area_p + area_t - inter, min=eps)


@LOSSES.register_module
@dataclass
class IoULoss:
    """-log(IoU) of aligned boxes (reference iou_loss.py:9-25, :72-105)."""
    eps: float = 1e-6
    reduction: str = "mean"
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        loss = -torch.log(torch.clamp(bbox_overlaps_aligned(pred, target),
                                      min=self.eps))
        return loss * weights if weights is not None else loss


@LOSSES.register_module
@dataclass
class BoundedIoULoss:
    """Bounded IoU loss (arXiv:1711.00164; reference iou_loss.py:28-69);
    no gradient reaches the target."""
    beta: float = 0.2
    eps: float = 1e-3
    loss_weight: float = 1.0

    def __call__(self, pred, target, weights=None):
        pred_ctrx = (pred[..., 0] + pred[..., 2]) * 0.5
        pred_ctry = (pred[..., 1] + pred[..., 3]) * 0.5
        pred_w = pred[..., 2] - pred[..., 0] + 1
        pred_h = pred[..., 3] - pred[..., 1] + 1
        t = target.detach()
        t_ctrx = (t[..., 0] + t[..., 2]) * 0.5
        t_ctry = (t[..., 1] + t[..., 3]) * 0.5
        t_w = t[..., 2] - t[..., 0] + 1
        t_h = t[..., 3] - t[..., 1] + 1
        dx = t_ctrx - pred_ctrx
        dy = t_ctry - pred_ctry
        loss_dx = 1 - torch.clamp(
            (t_w - 2 * torch.abs(dx)) / (t_w + 2 * torch.abs(dx) + self.eps),
            min=0.0)
        loss_dy = 1 - torch.clamp(
            (t_h - 2 * torch.abs(dy)) / (t_h + 2 * torch.abs(dy) + self.eps),
            min=0.0)
        loss_dw = 1 - torch.minimum(t_w / (pred_w + self.eps),
                                    pred_w / (t_w + self.eps))
        loss_dh = 1 - torch.minimum(t_h / (pred_h + self.eps),
                                    pred_h / (t_h + self.eps))
        comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
        loss = torch.where(comb < self.beta, 0.5 * comb * comb / self.beta,
                           comb - 0.5 * self.beta)
        return _weighted(loss, weights)


@LOSSES.register_module
@dataclass
class BootstrappedSigmoidClassificationLoss:
    """Sigmoid cross entropy against a convex combination of the labels
    and the model's predictions (Reed et al., ICLR 2015; reference
    losses.py:450-511), ``bootstrap_type`` "soft" or "hard"."""
    alpha: float = 0.5
    bootstrap_type: str = "soft"
    loss_weight: float = 1.0

    def __post_init__(self):
        if self.bootstrap_type not in ("hard", "soft"):
            raise ValueError("bootstrap_type must be 'hard' or 'soft'")

    def __call__(self, pred, target, weights=None):
        p = torch.sigmoid(pred)
        if self.bootstrap_type == "hard":
            p = (p > 0.5).to(pred.dtype)
        boot = self.alpha * target + (1.0 - self.alpha) * p
        loss = _sigmoid_cross_entropy_with_logits(labels=boot, logits=pred)
        return loss * weights[..., None] if weights is not None else loss


def build_loss(cfg: dict):
    """A loss from its config dict (``type`` a LOSSES name)."""
    return build_from_cfg(dict(cfg), LOSSES)
