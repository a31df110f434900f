"""Per-task anchors and anchor target assignment on the device.

Port of det3d_tpu/core/target.py: the region similarity functions,
``create_target`` (the reference's create_target_np over padded gt, with
force matching of ties, the empty-gt rule and the optional
``positive_fraction`` subsampling), ``TargetAssigner`` (anchors, the
anchor-area mask, ``assign``) and ``build_target_assigners``.

The JAX package assigns one sample at a time under ``vmap``; here the
batch dimension is written out: gt is (B, G, ...) and the results are
(B, A, ...). Every shape is fixed by the anchors and the gt padding, and
no operation reads a device value on the host, so the train step that
assigns targets can be captured as a CUDA graph. Labels: -1 ignore, 0
background, > 0 the global 1-based class id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from det3d_tpu_torch.utils.registry import build_from_cfg
from det3d_tpu_torch.core import box_ops
from det3d_tpu_torch.core.anchors import ANCHOR_GENERATORS
from det3d_tpu_torch.core.geometry import rotated_iou_matrix
from det3d_tpu_torch.parallel.dist_utils import get_dist_info


# ---------------------------------------------------------------------------
# region similarity: anchors (A, 5) x gt (B, G, 5) -> (B, A, G)
# ---------------------------------------------------------------------------

def nearest_iou_similarity(anchors_rbv, gt_rbv):
    """Axis-aligned IoU of the nearest standup boxes of rotated BEV boxes."""
    a = box_ops.rbbox2d_to_near_bbox(anchors_rbv)
    g = box_ops.rbbox2d_to_near_bbox(gt_rbv)
    return box_ops.iou_matrix(a, g)


def rotate_iou_similarity(anchors_rbv, gt_rbv):
    return rotated_iou_matrix(anchors_rbv, gt_rbv, criterion=-1)


def distance_similarity(anchors_rbv, gt_rbv, distance_norm=2.0,
                        with_rotation=False, rotation_alpha=0.5):
    """Negative normalized center distance."""
    diff = anchors_rbv[..., :, None, :2] - gt_rbv[..., None, :, :2]
    dist = torch.linalg.norm(diff, dim=-1) / distance_norm
    if with_rotation:
        rot_diff = torch.abs(torch.sin(anchors_rbv[..., :, None, 4]
                                       - gt_rbv[..., None, :, 4]))
        dist = (1 - rotation_alpha) * dist + rotation_alpha * rot_diff
    return -dist


SIMILARITY_FNS = {
    "nearest_iou_similarity": nearest_iou_similarity,
    "rotate_iou_similarity": rotate_iou_similarity,
    "distance_similarity": distance_similarity,
}



def _bev(boxes):
    """(..., nd) boxes -> (..., 5) [x, y, w, l, yaw] by slices (indexing by
    a list would copy the list to the device)."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., -1:]],
                     dim=-1)


def create_target(anchors, gt_boxes, gt_valid, gt_classes, similarity_fn,
                  box_encode_fn, matched_threshold, unmatched_threshold,
                  positive_fraction=None, sample_size=512, generator=None,
                  anchors_mask=None):
    """Targets of one anchor group for a batch of padded gt.

    anchors: (A, nd). gt_boxes: (B, G, nd); gt_valid: (B, G) bool;
    gt_classes: (B, G) global 1-based ids. ``positive_fraction``: keep at
    most ``positive_fraction * sample_size`` positives (the rest ignored)
    and enable ``sample_size - n_fg`` negatives drawn with replacement
    from the background, the rest of which stays ignored; the draws come
    from ``generator`` (torch.Generator on the anchors' device, or None
    for the device's default). ``anchors_mask``: (B, A) bool, pruned
    anchors take part in nothing and are labelled -1.

    Returns labels (B, A) int64, bbox_targets (B, A, code), reg_weights
    (B, A)."""
    b, a = gt_boxes.shape[0], anchors.shape[0]
    sim = similarity_fn(_bev(anchors), _bev(gt_boxes))          # (B, A, G)
    sim = torch.where(gt_valid[:, None, :], sim, -1.0)
    if anchors_mask is not None:
        sim = torch.where(anchors_mask[..., None], sim, -1.0)

    anchor_to_gt_max, anchor_to_gt_argmax = sim.max(dim=2)        # (B, A)
    gt_to_anchor_max = sim.amax(dim=1)                            # (B, G)

    # a gt whose best anchor overlap is exactly 0 must not force-match
    force_eligible = gt_valid & (gt_to_anchor_max > 0)
    force_anchor = ((sim == gt_to_anchor_max[:, None, :])
                    & force_eligible[:, None, :]).any(dim=2)      # (B, A)

    cls_of_argmax = torch.gather(gt_classes.long(), 1, anchor_to_gt_argmax)
    pos = anchor_to_gt_max >= matched_threshold
    bg = anchor_to_gt_max < unmatched_threshold
    fg0 = force_anchor | pos
    any_gt = gt_valid.any(dim=1, keepdim=True)                    # (B, 1)
    if positive_fraction is None:
        labels = torch.where(fg0, cls_of_argmax,
                             torch.where(bg, 0, -1))
        labels = torch.where(any_gt, labels, 0)
    else:
        labels = _subsample(fg0, bg, any_gt, cls_of_argmax,
                            positive_fraction, sample_size, generator)
    if anchors_mask is not None:
        labels = torch.where(anchors_mask, labels, -1)

    fg = labels > 0
    # guard padded gt dims against log(0) in the encoder
    safe_gt = torch.cat([gt_boxes[..., :3],
                         torch.clamp(gt_boxes[..., 3:6], min=1e-3),
                         gt_boxes[..., 6:]], dim=-1)
    nd = safe_gt.shape[-1]
    matched_gt = torch.gather(
        safe_gt, 1, anchor_to_gt_argmax[..., None].expand(b, a, nd))
    encoded = box_encode_fn(matched_gt, anchors[None].expand(b, a, nd))
    bbox_targets = torch.where(fg[..., None], encoded, 0.0)
    reg_weights = fg.to(anchors.dtype)
    return labels, bbox_targets, reg_weights


def _subsample(fg0, bg, any_gt, cls_of_argmax, positive_fraction,
               sample_size, generator):
    """create_target's RPN-style minibatch labels: a random num_fg of the
    foreground kept, ``sample_size - n_fg`` background anchors enabled,
    drawn with replacement (with no gt every anchor is background). Under
    ranks (parallel/dist_utils.py) example i of rank r draws what the
    global batch's example r * B + i draws (every rank takes the global
    batch's draws from its generator and keeps its own rows)."""
    b, a = fg0.shape
    dev = fg0.device
    rank, world = get_dist_info()

    def draw_rows(n):
        # the rows of this rank's examples among the global batch's draws
        u = torch.rand((world * b, n), generator=generator, device=dev)
        return u[rank * b:(rank + 1) * b]

    labels = torch.where(fg0 & any_gt, cls_of_argmax, -1)
    num_fg = int(positive_fraction * sample_size)
    fg = labels > 0
    u = draw_rows(a)
    fg_order = torch.argsort(torch.where(fg, u, 2.0), dim=1)
    fg_rank = torch.empty_like(fg_order).scatter_(
        1, fg_order, torch.arange(a, device=dev).expand(b, a).contiguous())
    labels = torch.where(fg & (fg_rank >= num_fg), -1, labels)

    bg_pool = bg | ~any_gt
    n_fg = (labels > 0).sum(dim=1, keepdim=True)
    num_bg = torch.clamp(sample_size - n_fg, min=0)
    n_bg = bg_pool.sum(dim=1, keepdim=True)
    bg_order = torch.argsort((~bg_pool).to(torch.int8), dim=1, stable=True)
    draw = draw_rows(sample_size)
    u_bg = torch.minimum((draw * torch.clamp(n_bg, min=1)).long(),
                         torch.clamp(n_bg - 1, min=0))
    chosen = torch.gather(bg_order, 1, u_bg)
    enable = ((torch.arange(sample_size, device=dev)[None] < num_bg)
              & (n_bg > num_bg))
    # dropped draws scatter to a spare slot past the end
    padded = torch.cat([labels, labels.new_zeros((b, 1))], dim=1)
    padded.scatter_(1, torch.where(enable, chosen, a), 0)
    return padded[:, :a]


@dataclass
class TargetAssigner:
    """One task's anchor generators, their anchors in the reference's
    (fz, fy, fx, loc, nd) layout concatenated on loc, and the assignment
    of padded gt to them."""
    box_coder: object
    anchor_generators: List
    similarity: str = "nearest_iou_similarity"
    positive_fraction: Optional[float] = None
    sample_size: int = 512
    anchor_area_threshold: float = -1.0

    def __post_init__(self):
        if self.positive_fraction is not None and self.positive_fraction < 0:
            self.positive_fraction = None
        self._feature_map_size = None
        self._anchors_by_class = None
        self._thresholds = None
        self._mask_cells = None
        self._on_device = {}

    def generate_anchors(self, feature_map_size):
        """feature_map_size: [D, H, W] zyx. Caches per-class anchors and
        returns them flattened to (A, nd)."""
        per_class = []
        for gen in self.anchor_generators:
            a = gen.generate(feature_map_size)
            a = a.reshape([*a.shape[:3], -1, a.shape[-1]])
            per_class.append(a.astype(np.float32))
        self._feature_map_size = tuple(int(s) for s in feature_map_size)
        self._anchors_by_class = per_class
        self._thresholds = [(float(g.match_threshold),
                             float(g.unmatch_threshold))
                            for g in self.anchor_generators]
        self._on_device = {}
        return self.anchors_flat

    @property
    def anchors_flat(self) -> np.ndarray:
        full = np.concatenate(self._anchors_by_class, axis=-2)
        return full.reshape(-1, full.shape[-1])

    def _cached(self, key, device, make):
        """``make()`` (a numpy array) as a tensor on ``device``, copied
        there once: a captured step must not copy from the host."""
        k = (key, str(torch.device(device)))
        if k not in self._on_device:
            self._on_device[k] = torch.as_tensor(make(), device=device)
        return self._on_device[k]

    def anchors_on(self, device) -> torch.Tensor:
        """``anchors_flat`` as a tensor on ``device``, copied there once."""
        return self._cached("anchors", device, lambda: self.anchors_flat)

    # -- the anchor-area mask (anchor_area_threshold >= 0) -----------------
    # The BEV occupancy's integral image is built on the device per sample;
    # the 4 summed-area corner cells of each anchor are static (the anchors
    # are), precomputed here in numpy.

    def prepare_anchors_mask(self, voxel_size, pc_range, grid_size):
        """Per-generator integral-image corner cells (A_g, 4) int64
        [x0, y0, x1, y1], floored and clipped as the reference does."""
        vx, vy = float(voxel_size[0]), float(voxel_size[1])
        ox, oy = float(pc_range[0]), float(pc_range[1])
        gx, gy = int(grid_size[0]), int(grid_size[1])
        cells = []
        for a in self._anchors_by_class:
            flat = torch.from_numpy(a.reshape(-1, a.shape[-1]))
            bv = box_ops.rbbox2d_to_near_bbox(_bev(flat)).numpy()
            c = np.stack([np.floor((bv[:, 0] - ox) / vx),
                          np.floor((bv[:, 1] - oy) / vy),
                          np.floor((bv[:, 2] - ox) / vx),
                          np.floor((bv[:, 3] - oy) / vy)], -1).astype(
                              np.int64)
            c[:, 0] = np.clip(c[:, 0], 0, None)
            c[:, 1] = np.clip(c[:, 1], 0, None)
            c[:, 2] = np.clip(c[:, 2], None, gx - 1)
            c[:, 3] = np.clip(c[:, 3], None, gy - 1)
            cells.append(c)
        self._mask_cells = cells
        self._on_device = {}

    def anchors_mask(self, coords, grid_size):
        """(B, V, 3) zyx coords (padding -1) -> (B, A) bool: anchors whose
        standup box holds more than ``anchor_area_threshold`` occupied
        pillars. The occupancy's inclusive double cumsum and 4 corner
        lookups, as the numba kernels count it (the window (y0, y1] x
        (x0, x1])."""
        assert self._mask_cells is not None, "call prepare_anchors_mask first"
        gx, gy = int(grid_size[0]), int(grid_size[1])
        b = coords.shape[0]
        valid = coords[..., 0] >= 0
        cell = torch.where(valid, coords[..., 1].long() * gx
                           + coords[..., 2].long(), gy * gx)
        # padding counts into a spare cell past the end
        occ = torch.zeros((b, gy * gx + 1), dtype=torch.float32,
                          device=coords.device)
        occ.scatter_add_(1, cell, torch.ones_like(cell, dtype=torch.float32))
        integral = occ[:, :gy * gx].reshape(b, gy, gx).cumsum(1).cumsum(2)
        flat = integral.reshape(b, gy * gx)

        def at(y, x):
            return flat[:, y * gx + x]

        fz, fy, fx = self._feature_map_size
        masks = []
        for g, (a, cells) in enumerate(zip(self._anchors_by_class,
                                           self._mask_cells)):
            c = self._cached(("cells", g), coords.device, lambda: cells)
            lookup = (at(c[:, 3], c[:, 2]) - at(c[:, 3], c[:, 0])
                      - at(c[:, 1], c[:, 2]) + at(c[:, 1], c[:, 0]))
            masks.append((lookup > self.anchor_area_threshold).reshape(
                b, fz, fy, fx, a.shape[-2]))
        return torch.cat(masks, dim=-1).reshape(b, -1)

    def assign(self, gt_boxes, gt_classes, gt_valid,
               class_ids: Sequence[int], generator=None, anchors_mask=None):
        """Assign padded gt (B, G, ...) to this task's anchors.

        class_ids: each generator's global id, in the generators' order.
        ``generator``: the draws of ``positive_fraction`` subsampling.
        Returns labels (B, A), bbox_targets (B, A, code) and reg_weights
        (B, A) in the concatenated-per-location layout of the anchors."""
        assert self._anchors_by_class is not None, \
            "call generate_anchors first"
        sim_fn = SIMILARITY_FNS[self.similarity]
        fz, fy, fx = self._feature_map_size
        b = gt_boxes.shape[0]
        code = self.box_coder.code_size
        dev = gt_boxes.device
        total_loc = sum(a.shape[-2] for a in self._anchors_by_class)
        if anchors_mask is not None:
            mask_by_loc = anchors_mask.reshape(b, fz, fy, fx, total_loc)

        labels_list, targets_list, weights_list = [], [], []
        loc_offset = 0
        for g, (gen_anchors, (mt, ut), cid) in enumerate(zip(
                self._anchors_by_class, self._thresholds, class_ids)):
            num_loc = gen_anchors.shape[-2]
            flat_anchors = self._cached(
                ("class", g), dev,
                lambda: gen_anchors.reshape(-1, gen_anchors.shape[-1]))
            cls_mask = gt_valid & (gt_classes == cid)
            gen_amask = None
            if anchors_mask is not None:
                gen_amask = mask_by_loc[
                    ..., loc_offset:loc_offset + num_loc].reshape(b, -1)
            loc_offset += num_loc
            labels, targets, weights = create_target(
                flat_anchors, gt_boxes, cls_mask, gt_classes, sim_fn,
                self.box_coder.encode, mt, ut,
                positive_fraction=self.positive_fraction,
                sample_size=self.sample_size, generator=generator,
                anchors_mask=gen_amask)
            labels_list.append(labels.reshape(b, fz, fy, fx, num_loc))
            targets_list.append(targets.reshape(b, fz, fy, fx, num_loc, code))
            weights_list.append(weights.reshape(b, fz, fy, fx, num_loc))

        labels = torch.cat(labels_list, dim=-1).reshape(b, -1)
        bbox_targets = torch.cat(targets_list, dim=-2).reshape(b, -1, code)
        reg_weights = torch.cat(weights_list, dim=-1).reshape(b, -1)
        return labels, bbox_targets, reg_weights


def build_target_assigners(target_assigner_cfg, box_coder,
                           tasks) -> List[TargetAssigner]:
    """One TargetAssigner per task from the reference config schema: the
    flat anchor_generators list is split across tasks by each task's
    class_names; the similarity, subsampling and anchor-area settings
    apply to every task."""
    flat = []
    for g in target_assigner_cfg["anchor_generators"]:
        cfg = dict(g)
        if "matched_threshold" in cfg:
            cfg["match_threshold"] = cfg.pop("matched_threshold")
        if "unmatched_threshold" in cfg:
            cfg["unmatch_threshold"] = cfg.pop("unmatched_threshold")
        flat.append(build_from_cfg(cfg, ANCHOR_GENERATORS))
    sim_type = target_assigner_cfg["region_similarity_calculator"]["type"]
    pos_fraction = target_assigner_cfg.get("sample_positive_fraction", None)
    sample_size = target_assigner_cfg.get("sample_size", 512)
    area_threshold = target_assigner_cfg.get("pos_area_threshold", -1)
    assigners, idx = [], 0
    for task in tasks:
        n = len(task["class_names"])
        assigners.append(TargetAssigner(
            box_coder=box_coder, anchor_generators=flat[idx:idx + n],
            similarity=sim_type, positive_fraction=pos_fraction,
            sample_size=sample_size,
            anchor_area_threshold=float(area_threshold
                                        if area_threshold is not None
                                        else -1)))
        idx += n
    return assigners
