"""The two-stage refinement: the crop of each first-stage detection's
points, and the z / height RegHead.

Port of det3d_tpu/models/second_stage.py (reference mg_head.py:233-383,
RegHead; cropped_voxel_encoder.py, crop2assign): the crop is the
fixed-budget ops/roi.py::roipool3d, so the second stage runs on the
device after the first, with no host loop over detections.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from det3d_tpu_torch.models.registry import HEADS
from det3d_tpu_torch.ops.roi import roipool3d


def crop_detections(points, feats, det_boxes, pool_extra_width=1.0,
                    sampled_pt_num=512, valid=None):
    """First-stage boxes -> canonical per-RoI point crops: points (B, N,
    3), feats (B, N, C) or None, det_boxes (B, M, 7) -> (crops (B, M, S, 3
    [+ C]), empty (B, M))."""
    px, pf, empty = roipool3d(points, feats, det_boxes,
                              extra_width=pool_extra_width,
                              sampled_pt_num=sampled_pt_num,
                              canonical=True, valid=valid)
    crops = px if pf is None else torch.cat([px, pf], dim=-1)
    return crops, empty


def _smooth_l1(pred, target, sigma=3.0):
    d = torch.abs(pred - target)
    s2 = sigma * sigma
    return torch.where(d < 1.0 / s2, 0.5 * s2 * d * d, d - 0.5 / s2)


@HEADS.register_module
class RegHead(nn.Module):
    """The z / height refinement head: per task a Linear (the reference's
    1x1 conv) predicting (z, h) residuals against the crop's anchor, then
    the max over the map. forward takes (N, H, W, C) or (N, C) and returns
    one (N, 1, 1, 2) prediction a task. Modules ``Dense_<n>``, flax's
    names."""

    def __init__(self, tasks: Sequence[dict], in_channels: int = 128,
                 mode: str = "z", z_type: str = "top",
                 iou_loss: bool = False, anchor_height: float = 1.56,
                 anchor_center: float = -1.0,
                 norm_cfg: Optional[dict] = None, name_str: str = "RegHead"):
        super().__init__()
        self.num_tasks = len(tasks)
        self.z_type = z_type
        self.iou_loss = iou_loss
        self.anchor_height = anchor_height
        self.anchor_center = anchor_center
        for i in range(self.num_tasks):
            self.add_module(f"Dense_{i}", nn.Linear(in_channels, 2))

    def forward(self, x):
        if x.dim() == 2:
            x = x[:, None, None, :]
        return [getattr(self, f"Dense_{i}")(x).amax(dim=(1, 2), keepdim=True)
                for i in range(self.num_tasks)]

    def loss(self, example, preds):
        """example: targets (N, >= 5: [_, _, z, h, gp residual]) and
        ground_plane (N,). Returns a dict a task: the z, height and
        ground-plane smooth-L1 losses (and the height-IoU term with
        ``iou_loss``), summed over the crops / N."""
        n = example["targets"].shape[0]
        zg = example["targets"][:, 2:3]
        hg = example["targets"][:, 3:4]
        gg = example["targets"][:, 4:5]
        gp = example["ground_plane"].reshape(-1, 1)
        h_a, z_a = self.anchor_height, self.anchor_center
        rets = []
        for pred in preds:
            zt = pred[..., 0].reshape(-1, 1)
            ht = pred[..., 1].reshape(-1, 1)
            if self.z_type == "top":
                z_top = z_a + h_a / 2
                gt = z_top + zt - (h_a + ht) - gp
                yg_t, yg_d = zg + z_top, zg + z_top - (hg + h_a)
                yp_t, yp_d = zt + z_top, zt + z_top - (ht + h_a)
            else:                                         # "center"
                gt = z_a + zt - (h_a + ht) / 2.0 - gp
                yg_t = zg + z_a + (hg + h_a) / 2.0
                yg_d = zg + z_a - (hg + h_a) / 2.0
                yp_t = zt + z_a + (ht + h_a) / 2.0
                yp_d = zt + z_a - (ht + h_a) / 2.0
            z_loss = _smooth_l1(zt, zg).sum() / n
            h_loss = _smooth_l1(ht, hg).sum() / n
            gp_loss = _smooth_l1(gt, gg).sum() / n
            ret = dict(z_loss=z_loss, height_loss=h_loss, gp_loss=gp_loss,
                       loss=z_loss + h_loss + gp_loss)
            if self.iou_loss:
                inter = torch.minimum(yp_t, yg_t) - torch.maximum(yp_d, yg_d)
                union = (hg + h_a) + (ht + h_a) - inter
                iou = torch.clamp(inter / union, 0.0, 1.0)
                ret["iou_loss"] = (1.0 - iou).sum() / n
                ret["loss"] = ret["loss"] + ret["iou_loss"]
            rets.append(ret)
        return rets
