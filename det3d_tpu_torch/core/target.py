"""Per-task anchor sets: the anchor half of the reference's TargetAssigner.

Port of det3d_tpu/core/target.py::TargetAssigner (``generate_anchors``,
``anchors_flat``) and ``build_target_assigners``. Target assignment itself
and the anchor-area mask wait for the training port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from det3d_tpu_torch.utils.registry import build_from_cfg
from det3d_tpu_torch.core.anchors import ANCHOR_GENERATORS


@dataclass
class TargetAssigner:
    """One task's anchor generators and their anchors, in the reference's
    (fz, fy, fx, loc, nd) layout concatenated on loc."""
    box_coder: object
    anchor_generators: List

    def __post_init__(self):
        self._anchors_by_class = None
        self._on_device = {}

    def generate_anchors(self, feature_map_size):
        """feature_map_size: [D, H, W] zyx. Caches per-class anchors and
        returns them flattened to (A, nd)."""
        per_class = []
        for gen in self.anchor_generators:
            a = gen.generate(feature_map_size)
            a = a.reshape([*a.shape[:3], -1, a.shape[-1]])
            per_class.append(a.astype(np.float32))
        self._anchors_by_class = per_class
        self._on_device = {}
        return self.anchors_flat

    @property
    def anchors_flat(self) -> np.ndarray:
        full = np.concatenate(self._anchors_by_class, axis=-2)
        return full.reshape(-1, full.shape[-1])

    def anchors_on(self, device) -> torch.Tensor:
        """``anchors_flat`` as a tensor on ``device``, copied there once."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self.anchors_flat,
                                                   device=device)
        return self._on_device[key]


def build_target_assigners(target_assigner_cfg, box_coder,
                           tasks) -> List[TargetAssigner]:
    """One TargetAssigner per task: the flat anchor_generators list is
    split across tasks by each task's class_names."""
    area_threshold = target_assigner_cfg.get("pos_area_threshold")
    if area_threshold is not None and area_threshold >= 0:
        raise NotImplementedError("the anchor-area mask is not ported yet")
    flat = []
    for g in target_assigner_cfg["anchor_generators"]:
        cfg = dict(g)
        if "matched_threshold" in cfg:
            cfg["match_threshold"] = cfg.pop("matched_threshold")
        if "unmatched_threshold" in cfg:
            cfg["unmatch_threshold"] = cfg.pop("unmatched_threshold")
        flat.append(build_from_cfg(cfg, ANCHOR_GENERATORS))
    assigners, idx = [], 0
    for task in tasks:
        n = len(task["class_names"])
        assigners.append(TargetAssigner(box_coder=box_coder,
                                        anchor_generators=flat[idx:idx + n]))
        idx += n
    return assigners
