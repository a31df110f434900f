"""Multi-group anchor head: forward, loss and fixed-shape prediction.

Port of det3d_tpu/models/heads.py: ``TaskHead``, the ``MultiGroupHead``
forward, the loss (``add_sin_difference``, ``get_direction_target``,
``prepare_loss_weights``, ``create_loss``, ``MultiGroupHead.loss``),
``_task_candidates`` (decode, sigmoid scores, score threshold),
``_nms_select`` (rotated NMS, direction fix, post-center range filter),
``predict``, the double-flip merge ``predict_tta`` and ``_merge_tasks``
(the ``max_per_img`` cap).

Head outputs keep the reference's NHWC layout (B, H, W, A_loc * code), so
they flatten to (B, H*W*A_loc, code) in the anchors' (fz, fy, fx, loc)
order. Predictions are per-sample padded arrays with a validity mask.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.models.losses import build_loss
from det3d_tpu_torch.models.registry import HEADS
from det3d_tpu_torch.ops import nms as nms_ops
from det3d_tpu_torch.core import box_ops
from det3d_tpu_torch.core.voxelize import filled


def conv1x1(conv: nn.Conv2d, x):
    """A head's 1x1 conv in x's dtype, its fp32 output. fp32 runs the
    module's own conv (the bias inside the one call). In bf16 the weight
    and the bias are cast for the call and the bias adds to the conv's
    bf16-rounded output, as flax's Conv does; the sum is rounded to bf16,
    then cast to fp32."""
    if x.dtype == torch.float32:
        return conv(x)
    y = F.conv2d(x, conv.weight.to(x.dtype)) + conv.bias.to(x.dtype)[:, None,
                                                                    None]
    return y.float()


def one_hot_f(labels, depth, dtype=torch.float32):
    """(...) int labels -> (..., depth) one-hot; a label outside [0,
    depth) gives a zero row, as jax.nn.one_hot does (F.one_hot checks its
    range on the host)."""
    ids = torch.arange(depth, device=labels.device)
    return (labels[..., None] == ids).to(dtype)


def add_sin_difference(boxes1, boxes2):
    """The angle channels become sin(a) cos(b) and cos(a) sin(b), whose
    difference is sin(a - b)."""
    rad_pred = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad_tg = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad_pred], dim=-1),
            torch.cat([boxes2[..., :-1], rad_tg], dim=-1))


def get_direction_target(anchors, reg_targets, dir_offset=0.0, one_hot=True):
    """The direction class (the target's yaw in [0, pi) or not, after
    ``dir_offset``), one-hot unless ``one_hot`` is False."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    dir_cls = (box_ops.limit_period(rot_gt - dir_offset, 0.5, 2 * math.pi)
               > 0).long()
    if one_hot:
        return one_hot_f(dir_cls, 2, dtype=reg_targets.dtype)
    return dir_cls


def prepare_loss_weights(labels, loss_norm, dtype=torch.float32):
    """Class and box-regression weights of (B, A) labels under
    ``loss_norm``'s normalization (NormByNumPositives, NormByNumExamples,
    NormByNumPosNeg, DontNorm); returns (cls_weights, reg_weights,
    cared)."""
    norm_type = loss_norm.get("type", "NormByNumPositives")
    pos_w = loss_norm.get("pos_cls_weight", 1.0)
    neg_w = loss_norm.get("neg_cls_weight", 1.0)

    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = negatives.to(dtype) * neg_w + positives.to(dtype) * pos_w
    reg_weights = positives.to(dtype)

    if norm_type == "NormByNumExamples":
        num_examples = torch.clamp(cared.to(dtype).sum(1, keepdim=True),
                                   min=1.0)
        cls_weights = cls_weights / num_examples
        bbox_norm = positives.sum(1, keepdim=True).to(dtype)
        reg_weights = reg_weights / torch.clamp(bbox_norm, min=1.0)
    elif norm_type == "NormByNumPositives":
        pos_norm = positives.sum(1, keepdim=True).to(dtype)
        reg_weights = reg_weights / torch.clamp(pos_norm, min=1.0)
        cls_weights = cls_weights / torch.clamp(pos_norm, min=1.0)
    elif norm_type == "NormByNumPosNeg":
        pos_neg = torch.stack([positives, negatives], dim=-1).to(dtype)
        normalizer = pos_neg.sum(1, keepdim=True)               # (B, 1, 2)
        cls_normalizer = torch.clamp((pos_neg * normalizer).sum(-1), min=1.0)
        normalizer = torch.clamp(normalizer, min=1.0)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    elif norm_type == "DontNorm":
        pos_norm = positives.sum(1, keepdim=True).to(dtype)
        reg_weights = reg_weights / torch.clamp(pos_norm, min=1.0)
    else:
        raise ValueError(f"unknown loss norm {norm_type}")
    return cls_weights, reg_weights, cared


def create_loss(loc_loss_ftor, cls_loss_ftor, box_preds, cls_preds,
                cls_targets, cls_weights, reg_targets, reg_weights,
                num_class, encode_background_as_zeros=True,
                encode_rad_error_by_sin=True, box_code_size=7):
    """Elementwise box and class losses of one task's NHWC predictions."""
    batch = box_preds.shape[0]
    box_preds = box_preds.reshape(batch, -1, box_code_size)
    cls_preds = cls_preds.reshape(
        batch, -1, num_class if encode_background_as_zeros else num_class + 1)
    one_hot_targets = one_hot_f(cls_targets, num_class + 1,
                              dtype=box_preds.dtype)
    if encode_background_as_zeros:
        one_hot_targets = one_hot_targets[..., 1:]
    if encode_rad_error_by_sin:
        box_preds, reg_targets = add_sin_difference(box_preds, reg_targets)
    loc_losses = loc_loss_ftor(box_preds, reg_targets, weights=reg_weights)
    cls_losses = cls_loss_ftor(cls_preds, one_hot_targets,
                               weights=cls_weights)
    return loc_losses, cls_losses


class TaskHead(nn.Module):
    """Per-task 1x1 convs for box, class and direction predictions. The
    convs run in the input's dtype and every prediction leaves in fp32
    (decode and NMS run in fp32, whatever precision the trunk ran in)."""

    def __init__(self, in_channels: int, num_pred: int, num_cls: int,
                 num_dir: int = 0):
        super().__init__()
        self.conv_box = nn.Conv2d(in_channels, num_pred, 1)
        self.conv_cls = nn.Conv2d(in_channels, num_cls, 1)
        self.conv_dir = nn.Conv2d(in_channels, num_dir, 1) if num_dir else None

    def forward(self, x):
        """x: NCHW view -> dict of NHWC fp32 predictions."""
        ret = {"box_preds": conv1x1(self.conv_box, x).permute(0, 2, 3, 1),
               "cls_preds": conv1x1(self.conv_cls, x).permute(0, 2, 3, 1)}
        if self.conv_dir is not None:
            ret["dir_cls_preds"] = conv1x1(self.conv_dir,
                                           x).permute(0, 2, 3, 1)
        return ret


@HEADS.register_module
class MultiGroupHead(nn.Module):
    """One TaskHead per task over a shared BEV feature map. Takes the
    reference config's keys: the loss settings (``loss_norm``,
    ``loss_cls``, ``loss_bbox``, ``loss_aux``, ``encode_rad_error_by_sin``)
    build the losses of ``loss``."""

    def __init__(self, mode: str = "3d", in_channels: int = 128,
                 norm_cfg: Optional[dict] = None, tasks: Sequence[dict] = (),
                 weights: Sequence[float] = (), box_coder: Any = None,
                 with_cls: bool = True, with_reg: bool = True,
                 encode_background_as_zeros: bool = True,
                 loss_norm: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 use_sigmoid_score: bool = True,
                 loss_bbox: Optional[dict] = None,
                 encode_rad_error_by_sin: bool = True,
                 loss_aux: Optional[dict] = None,
                 direction_offset: float = 0.0, name_str: str = "rpn"):
        super().__init__()
        self.tasks = list(tasks)
        self.box_coder = box_coder
        self.encode_background_as_zeros = encode_background_as_zeros
        self.use_direction_classifier = loss_aux is not None
        self.direction_offset = float(direction_offset)
        self.encode_rad_error_by_sin = encode_rad_error_by_sin
        self.loss_norm = dict(loss_norm or dict(
            type="NormByNumPositives", pos_cls_weight=1.0,
            neg_cls_weight=1.0))
        self.loss_cls = build_loss(loss_cls or dict(
            type="SigmoidFocalLoss", alpha=0.25, gamma=2.0, loss_weight=1.0))
        self.loss_bbox = build_loss(loss_bbox or dict(
            type="WeightedSmoothL1Loss", sigma=3.0, codewise=True,
            loss_weight=1.0))
        self.loss_aux = build_loss(loss_aux) if loss_aux else None
        code_size = box_coder.code_size
        for t, (num_c, num_a) in enumerate(zip(self.num_classes,
                                               self.num_anchor_per_locs)):
            num_cls = num_a * (num_c if encode_background_as_zeros
                               else num_c + 1)
            num_dir = num_a * 2 if self.use_direction_classifier else 0
            self.add_module(f"task_{t}", TaskHead(
                in_channels, num_a * code_size, num_cls, num_dir))

    @property
    def num_classes(self) -> List[int]:
        return [len(t["class_names"]) for t in self.tasks]

    @property
    def num_anchor_per_locs(self) -> List[int]:
        return [2 * n for n in self.num_classes]

    @property
    def box_n_dim(self) -> int:
        return self.box_coder.code_size

    @property
    def anchor_dim(self) -> int:
        return self.box_coder.n_dim

    def forward(self, x):
        """x: (B, H, W, C) -> one dict of NHWC predictions per task."""
        x = x.permute(0, 3, 1, 2)
        return [getattr(self, f"task_{t}")(x) for t in range(len(self.tasks))]

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def loss(self, example: Dict[str, Any],
             preds_dicts: List[dict]) -> Dict[str, list]:
        """Each task's losses from the example's targets (``labels``,
        ``reg_targets``, ``anchors``) and the head's predictions: a dict of
        per-task lists with the keys ``loss``, ``cls_pos_loss``,
        ``cls_neg_loss``, ``dir_loss_reduced``, ``cls_loss_reduced``,
        ``loc_loss_reduced``, ``loc_loss_elem``, ``num_pos`` and
        ``num_neg`` (the last two of the first sample)."""
        batch_size = example["anchors"][0].shape[0]
        pos_w = self.loss_norm.get("pos_cls_weight", 1.0)
        neg_w = self.loss_norm.get("neg_cls_weight", 1.0)
        rets = []
        for task_id, preds in enumerate(preds_dicts):
            num_class = self.num_classes[task_id]
            labels = example["labels"][task_id]               # (B, A)
            reg_targets = example["reg_targets"][task_id]     # (B, A, code)
            cls_weights, reg_weights, cared = prepare_loss_weights(
                labels, self.loss_norm)
            cls_targets = labels * cared.to(labels.dtype)

            loc_loss, cls_loss = create_loss(
                self.loss_bbox, self.loss_cls, preds["box_preds"],
                preds["cls_preds"], cls_targets, cls_weights, reg_targets,
                reg_weights, num_class, self.encode_background_as_zeros,
                self.encode_rad_error_by_sin, box_code_size=self.box_n_dim)

            loc_loss_reduced = (loc_loss.sum() / batch_size
                                * self.loss_bbox.loss_weight)
            cls_loss_sum = cls_loss.sum() / batch_size
            # the pos/neg split for logging
            if cls_loss.dim() == 2 or cls_loss.shape[-1] == 1:
                flat = cls_loss.reshape(batch_size, -1)
                cls_pos_loss = ((labels > 0) * flat).sum() / batch_size
                cls_neg_loss = ((labels == 0) * flat).sum() / batch_size
            else:
                cls_pos_loss = cls_loss[..., 1:].sum() / batch_size
                cls_neg_loss = cls_loss[..., 0].sum() / batch_size
            cls_pos_loss = cls_pos_loss / pos_w
            cls_neg_loss = cls_neg_loss / neg_w
            cls_loss_reduced = cls_loss_sum * self.loss_cls.loss_weight
            loss = loc_loss_reduced + cls_loss_reduced

            dir_loss_reduced = loc_loss_reduced.new_zeros(())
            if self.use_direction_classifier:
                anchors = example["anchors"][task_id].reshape(
                    batch_size, -1, self.anchor_dim)
                dir_targets = get_direction_target(
                    anchors, reg_targets, dir_offset=self.direction_offset)
                dir_logits = preds["dir_cls_preds"].reshape(batch_size, -1, 2)
                weights = (labels > 0).to(dir_logits.dtype)
                weights = weights / torch.clamp(
                    weights.sum(-1, keepdim=True), min=1.0)
                dir_loss = self.loss_aux(dir_logits, dir_targets,
                                         weights=weights)
                dir_loss_reduced = dir_loss.sum() / batch_size
                loss = loss + dir_loss_reduced * self.loss_aux.loss_weight

            rets.append({
                "loss": loss,
                "cls_pos_loss": cls_pos_loss,
                "cls_neg_loss": cls_neg_loss,
                "dir_loss_reduced": dir_loss_reduced,
                "cls_loss_reduced": cls_loss_reduced,
                "loc_loss_reduced": loc_loss_reduced,
                "loc_loss_elem": loc_loss.sum(dim=(0, 1)) / batch_size,
                "num_pos": (labels[0] > 0).sum(),
                "num_neg": (labels[0] == 0).sum(),
            })
        return {k: [r[k] for r in rets] for k in rets[0]}

    # ------------------------------------------------------------------
    # prediction (fixed shape)
    # ------------------------------------------------------------------
    def _task_candidates(self, example, preds, task_id, test_cfg):
        """Decode one task's head output into NMS candidates: (reg,
        nms_scores, top_labels, dir_labels, offsets), each (B, A', ...)."""
        use_multi_class = test_cfg["nms"].get("use_multi_class_nms", False)
        score_threshold = float(test_cfg["score_threshold"])

        batch = preds["box_preds"].shape[0]
        anchors = example["anchors"][task_id].reshape(batch, -1,
                                                      self.anchor_dim)
        num_class = self.num_classes[task_id]
        box_preds = preds["box_preds"].reshape(batch, -1, self.box_n_dim)
        cls_preds = preds["cls_preds"].reshape(batch, -1, num_class)
        reg = self.box_coder.decode(box_preds, anchors)
        if self.use_direction_classifier:
            dir_preds = preds["dir_cls_preds"].reshape(batch, -1, 2)
            dir_labels = torch.argmax(dir_preds, dim=-1)
        else:
            dir_labels = torch.zeros(cls_preds.shape[:2], dtype=torch.int64,
                                     device=cls_preds.device)

        total_scores = torch.sigmoid(cls_preds)
        amask = example.get("anchors_mask")
        if amask is not None and amask[task_id] is not None:
            # predictions outside the anchor-area mask are pruned before NMS
            total_scores = torch.where(
                amask[task_id].reshape(batch, -1)[..., None], total_scores,
                0.0)
        if use_multi_class and num_class > 1:
            # per-class NMS in one pass: each class is shifted to its own
            # far-away region so NMS cannot suppress across classes
            per_cls = torch.where(total_scores >= score_threshold,
                                  total_scores, -1.0)
            nms_scores = torch.cat([per_cls[..., c] for c in range(num_class)],
                                   dim=1)
            top_labels = torch.cat(
                [torch.full(per_cls.shape[:2], c, dtype=torch.int64,
                            device=per_cls.device) for c in range(num_class)],
                dim=1)
            reg = reg.repeat(1, num_class, 1)
            dir_labels = dir_labels.repeat(1, num_class)
            offsets = (top_labels.to(torch.float32) * 1e4)[..., None]
        else:
            if num_class == 1:
                top_scores = total_scores[..., 0]
                top_labels = torch.zeros_like(top_scores, dtype=torch.int64)
            else:
                top_scores, top_labels = torch.max(total_scores, dim=-1)
            nms_scores = torch.where(top_scores >= score_threshold,
                                     top_scores, -1.0)
            offsets = torch.zeros(reg.shape[:2] + (1,), dtype=reg.dtype,
                                  device=reg.device)
        return reg, nms_scores, top_labels, dir_labels, offsets

    def _nms_select(self, reg, nms_scores, top_labels, dir_labels, offsets,
                    test_cfg, apply_dir: bool):
        """Fixed-shape NMS over each sample's candidates (N leading)."""
        nms_cfg = test_cfg["nms"]
        use_rotate = nms_cfg["use_rotate_nms"]
        pre_max = int(nms_cfg["nms_pre_max_size"])
        post_max = int(nms_cfg["nms_post_max_size"])
        iou_th = float(nms_cfg["nms_iou_threshold"])
        post_center_range = test_cfg.get("post_center_limit_range")

        reg_nms = torch.cat([reg[..., :1] + offsets[..., :1], reg[..., 1:]],
                            dim=-1)
        if use_rotate:
            # x, y, w, l, yaw (slices: an index list is copied from host
            # memory, which a CUDA graph cannot capture)
            boxes_for_nms = torch.cat([reg_nms[..., 0:2], reg_nms[..., 3:5],
                                       reg_nms[..., -1:]], dim=-1)
        else:
            n, a = reg.shape[:2]
            corners = box_ops.center_to_corner_box2d(
                reg_nms[..., :2].reshape(-1, 2),
                reg_nms[..., 3:5].reshape(-1, 2), reg_nms[..., -1].reshape(-1))
            boxes_for_nms = box_ops.corner_to_standup_nd(corners).reshape(
                n, a, 4)
        idx, valid = nms_ops.nms(boxes_for_nms, nms_scores,
                                 pre_max_size=pre_max, post_max_size=post_max,
                                 iou_threshold=iou_th, rotated=bool(use_rotate))

        sel_boxes = torch.gather(
            reg, 1, idx[..., None].expand(-1, -1, reg.shape[-1]))
        sel_scores = torch.gather(nms_scores, 1, idx)
        sel_labels = torch.gather(top_labels, 1, idx)
        if apply_dir and self.use_direction_classifier:
            sel_dir = torch.gather(dir_labels, 1, idx)
            yaw = sel_boxes[..., -1]
            opp = ((yaw - self.direction_offset) > 0) ^ sel_dir.bool()
            yaw = yaw + torch.where(opp, math.pi, 0.0)
            sel_boxes = torch.cat([sel_boxes[..., :-1], yaw[..., None]], -1)
        if post_center_range is not None and len(post_center_range) > 0:
            pcr = filled(post_center_range, sel_boxes)
            inside = ((sel_boxes[..., :3] >= pcr[:3]).all(dim=-1)
                      & (sel_boxes[..., :3] <= pcr[3:]).all(dim=-1))
            valid = valid & inside
        return sel_boxes, sel_scores, sel_labels, valid

    def predict(self, example: Dict[str, Any], preds_dicts: List[dict],
                test_cfg) -> Dict[str, torch.Tensor]:
        """Decode + NMS all tasks; padded per-sample detections:
        box3d_lidar (B, D, anchor_dim), scores (B, D), label_preds (B, D)
        global label ids, valid (B, D) bool."""
        cands = [self._task_candidates(example, preds, t, test_cfg)
                 for t, preds in enumerate(preds_dicts)]
        return self._select_tasks(cands, test_cfg, apply_dir=True)

    def predict_tta(self, example: Dict[str, Any], preds_dicts: List[dict],
                    test_cfg) -> Dict[str, torch.Tensor]:
        """Double-flip test-time augmentation merge; ``predict``'s output.

        ``example`` and ``preds_dicts`` come from a forward over the 4B
        scans [identity, y-flip, x-flip, xy-flip] (parallel/predict.py
        stacks them). Each variant's candidates are mapped back into the
        original frame: x, y (and vx, vy) negated as flipped, the yaw
        reflected (y-flip -yaw, x-flip pi - yaw), with the direction
        classifier folded into the yaw in the variant's own frame first.
        One NMS per task then runs over the union of the four candidate
        sets of each scan, without the direction fix. Port of
        heads.py::MultiGroupHead.predict_tta; the tasks share one NMS
        launch, folded into its sample dimension as in ``predict``."""
        nv = 4
        cands = []
        for t, preds in enumerate(preds_dicts):
            reg, scores, labels, dirs, offs = self._task_candidates(
                example, preds, t, test_cfg)
            yaw = reg[..., -1]
            if self.use_direction_classifier:
                opp = ((yaw - self.direction_offset) > 0) ^ dirs.bool()
                yaw = yaw + torch.where(opp, math.pi, 0.0)
            bsz = reg.shape[0] // nv
            cols = [reg[..., i] for i in range(reg.shape[-1] - 1)] + [yaw]
            variants = []
            for v, (sx, sy) in enumerate(((1, 1), (1, -1), (-1, 1),
                                          (-1, -1))):
                c = [x[v * bsz:(v + 1) * bsz] for x in cols]
                c[0], c[1] = c[0] * sx, c[1] * sy
                if self.anchor_dim >= 9:                # [.., vx, vy, yaw]
                    c[6], c[7] = c[6] * sx, c[7] * sy
                if sy < 0:
                    c[-1] = -c[-1]
                if sx < 0:
                    c[-1] = math.pi - c[-1]
                variants.append(torch.stack(c, dim=-1))
            reg = torch.stack(variants, dim=1)              # (B, nv, A, D)

            def merge(x):
                x = x.reshape((nv, bsz) + x.shape[1:]).transpose(0, 1)
                return x.reshape((bsz, -1) + x.shape[3:])

            cands.append((reg.reshape((bsz, -1) + reg.shape[3:]),
                          merge(scores), merge(labels), merge(dirs),
                          merge(offs)))
        return self._select_tasks(cands, test_cfg, apply_dir=False)

    def _select_tasks(self, cands, test_cfg, apply_dir: bool):
        """NMS over each task's candidates, then the merge of the tasks.
        Tasks are independent NMS problems: more than one are folded into
        the sample dimension, candidate counts padded with invalid
        entries, so one NMS launch serves them all."""
        n_tasks = len(cands)
        if n_tasks == 1:
            sel = [self._nms_select(*cands[0], test_cfg, apply_dir)]
        else:
            amax = max(c[0].shape[1] for c in cands)

            def padto(x, fill):
                pad = [0, 0] * (x.dim() - 2) + [0, amax - x.shape[1]]
                return nn.functional.pad(x, pad, value=fill)

            fused = []
            for i, fill in enumerate((0.0, -1.0, 0, 0, 0.0)):
                st = torch.stack([padto(c[i], fill) for c in cands], dim=1)
                fused.append(st.reshape((-1,) + st.shape[2:]))
            outs = self._nms_select(*fused, test_cfg, apply_dir)
            bsz = cands[0][0].shape[0]
            sel = [tuple(x.reshape((bsz, n_tasks) + x.shape[1:])[:, t]
                         for x in outs) for t in range(n_tasks)]

        boxes_all, scores_all, labels_all, valid_all = [], [], [], []
        label_offset = 0
        for t, (b, s, l, v) in enumerate(sel):
            boxes_all.append(b)
            scores_all.append(s)
            labels_all.append(torch.where(v, l + label_offset, 0))
            valid_all.append(v)
            label_offset += self.num_classes[t]
        return self._merge_tasks(boxes_all, scores_all, labels_all,
                                 valid_all, test_cfg)

    def _merge_tasks(self, boxes_all, scores_all, labels_all, valid_all,
                     test_cfg):
        """Concatenate per-task detections and keep the ``max_per_img``
        best valid ones (ties: lower index first, as jax.lax.top_k)."""
        out = {
            "box3d_lidar": torch.cat(boxes_all, dim=1),
            "scores": torch.cat(scores_all, dim=1),
            "label_preds": torch.cat(labels_all, dim=1),
            "valid": torch.cat(valid_all, dim=1),
        }
        mpi = int(test_cfg.get("max_per_img", 0) or 0)
        d = out["scores"].shape[1]
        if 0 < mpi < d:
            masked = torch.where(out["valid"], out["scores"], -math.inf)
            idx = nms_ops.sort_desc(masked, dim=1).indices[:, :mpi]
            out = {
                "box3d_lidar": torch.gather(
                    out["box3d_lidar"], 1,
                    idx[..., None].expand(-1, -1,
                                          out["box3d_lidar"].shape[-1])),
                "scores": torch.gather(out["scores"], 1, idx),
                "label_preds": torch.gather(out["label_preds"], 1, idx),
                "valid": torch.gather(out["valid"], 1, idx),
            }
        return out
