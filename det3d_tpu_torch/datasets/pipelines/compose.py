"""Sequential (res, info) pipeline. Parity: pipelines/compose.py:8-34."""

from __future__ import annotations

from det3d_tpu_torch.datasets.registry import PIPELINES
from det3d_tpu_torch.utils.registry import build_from_cfg


class Compose:
    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(t, PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be dict or callable: {t}")

    def __call__(self, res, info):
        for t in self.transforms:
            res, info = t(res, info)
            if res is None:
                return None
        return res, info
