"""Streaming classification metrics over explicit state.

Port of det3d_tpu/models/metrics.py (reference det3d/models/losses/
metrics.py: Scalar :7, Accuracy :27, Precision :79, Recall :129,
PrecisionRecall :197). Each metric is ``init(device) -> state`` and
``update(state, labels, preds, weights) -> (state, value)`` on tensors
(``Scalar.update(state, scalar)``), the state a dict of tensors on the
device, so a step can carry it. While a process group is up
(parallel/dist_utils.py) each update's counts are summed over the ranks
before they join the state, as the JAX package's states psum over its
mesh: every rank holds the global totals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from det3d_tpu_torch.parallel.dist_utils import active as dist_active
from det3d_tpu_torch.parallel.dist_utils import all_reduce_sum


def _zeros(device, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _add(state, increments):
    """state + increments (one dict of tensors), the increments summed
    over the ranks first while a group is up (one collective)."""
    keys = list(increments)
    if dist_active():
        flat = all_reduce_sum(torch.cat(
            [increments[k].reshape(-1) for k in keys]))
        off = 0
        for k in keys:
            n = increments[k].numel()
            increments[k] = flat[off:off + n].view(increments[k].shape)
            off += n
    return {k: state[k] + increments[k] for k in keys}


def _ratio(state):
    return state["total"] / torch.clamp(state["count"], min=1.0)


def _flatten(labels, pred_labels):
    n = labels.shape[0]
    return labels.reshape(n, -1), pred_labels.reshape(n, -1)


def _weights_or_default(labels, weights, ignore_idx):
    if weights is None:
        return (labels != ignore_idx).to(torch.float32)
    return weights.to(torch.float32)


def _binary_counts(labels, pred_labels, w):
    trues, falses = labels > 0, labels == 0
    p_trues, p_falses = pred_labels > 0, pred_labels == 0
    return ((w * (trues & p_trues)).sum(), (w * (falses & p_falses)).sum(),
            (w * (falses & p_trues)).sum(), (w * (trues & p_falses)).sum())


def _binary_pred_labels(preds, threshold):
    if preds.shape[-1] == 1:
        return (torch.sigmoid(preds) > threshold).to(torch.int32)[..., 0]
    assert preds.shape[-1] == 2, "precision/recall support 2 classes"
    return torch.argmax(preds, dim=-1)


@dataclass(frozen=True)
class Scalar:
    """Running mean of the nonzero scalars."""

    def init(self, device="cpu"):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, scalar):
        hit = (scalar != 0.0).to(torch.float32)
        state = _add(state, {"total": scalar * hit, "count": hit})
        return state, self.value(state)

    def value(self, state):
        return _ratio(state)


@dataclass(frozen=True)
class Accuracy:
    """preds (N, ..., C) logits, labels (N, ...); background as zeros: a
    row predicts argmax + 1 when any class scores above the threshold."""
    ignore_idx: int = -1
    threshold: float = 0.5
    encode_background_as_zeros: bool = True

    def init(self, device="cpu"):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, labels, preds, weights=None):
        if self.encode_background_as_zeros:
            pred_labels = torch.where(
                (torch.sigmoid(preds) > self.threshold).any(-1),
                torch.argmax(preds, dim=-1) + 1, 0)
        else:
            pred_labels = torch.argmax(preds, dim=-1)
        labels_f, pred_f = _flatten(labels, pred_labels)
        w = _weights_or_default(labels_f, weights, self.ignore_idx)
        state = _add(state, {
            "total": (pred_f == labels_f).to(torch.float32).sum(),
            "count": torch.clamp(w.sum(), min=1.0)})
        return state, self.value(state)

    def value(self, state):
        return _ratio(state)


@dataclass(frozen=True)
class Precision:
    """tp / (tp + fp), streamed; batches with no positive prediction add
    nothing."""
    ignore_idx: int = -1
    threshold: float = 0.5

    def init(self, device="cpu"):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, labels, preds, weights=None):
        labels_f, pred_f = _flatten(
            labels, _binary_pred_labels(preds, self.threshold))
        w = _weights_or_default(labels_f, weights, self.ignore_idx)
        tp, _, fp, _ = _binary_counts(labels_f, pred_f, w)
        count = tp + fp
        hit = (count > 0).to(torch.float32)
        state = _add(state, {"total": tp * hit, "count": count * hit})
        return state, self.value(state)

    def value(self, state):
        return _ratio(state)


@dataclass(frozen=True)
class Recall:
    """tp / (tp + fn), streamed; batches with no positive label add
    nothing."""
    ignore_idx: int = -1
    threshold: float = 0.5

    def init(self, device="cpu"):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, labels, preds, weights=None):
        labels_f, pred_f = _flatten(
            labels, _binary_pred_labels(preds, self.threshold))
        w = _weights_or_default(labels_f, weights, self.ignore_idx)
        tp, _, _, fn = _binary_counts(labels_f, pred_f, w)
        count = tp + fn
        hit = (count > 0).to(torch.float32)
        state = _add(state, {"total": tp * hit, "count": count * hit})
        return state, self.value(state)

    def value(self, state):
        return _ratio(state)


@dataclass(frozen=True)
class PrecisionRecall:
    """Streaming precision and recall at several thresholds of the
    highest class score."""
    thresholds: Sequence[float] = (0.5,)
    ignore_idx: int = -1
    use_sigmoid_score: bool = True
    encode_background_as_zeros: bool = True

    def init(self, device="cpu"):
        t = len(tuple(self.thresholds))
        return {k: _zeros(device, t) for k in
                ("prec_total", "prec_count", "rec_total", "rec_count")}

    def update(self, state, labels, preds, weights=None):
        if self.encode_background_as_zeros:
            assert self.use_sigmoid_score
            total_scores = torch.sigmoid(preds)
        elif self.use_sigmoid_score:
            total_scores = torch.sigmoid(preds)[..., 1:]
        else:
            total_scores = torch.softmax(preds, dim=-1)[..., 1:]
        scores = total_scores.amax(dim=-1)
        labels_f = labels.reshape(labels.shape[0], -1)
        scores_f = scores.reshape(labels.shape[0], -1)
        w = _weights_or_default(labels_f, weights, self.ignore_idx)
        inc = {k: [] for k in state}
        for thresh in tuple(self.thresholds):
            tp, _, fp, fn = _binary_counts(
                labels_f, (scores_f > thresh).to(torch.int32), w)
            rc, pc = tp + fn, tp + fp
            rhit = (rc > 0).to(torch.float32)
            phit = (pc > 0).to(torch.float32)
            inc["rec_total"].append(tp * rhit)
            inc["rec_count"].append(rc * rhit)
            inc["prec_total"].append(tp * phit)
            inc["prec_count"].append(pc * phit)
        state = _add(state, {k: torch.stack(v) for k, v in inc.items()})
        return state, self.value(state)

    def value(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        prec = state["prec_total"] / torch.clamp(state["prec_count"], min=1.0)
        rec = state["rec_total"] / torch.clamp(state["rec_count"], min=1.0)
        return prec, rec
