"""Abstract point-cloud dataset; port of det3d_tpu/datasets/custom.py.
Parity: det3d/datasets/custom.py:12-190.

Contract: ``get_sensor_data(idx)`` -> (res, info) seed dict run through the
pipeline; ``evaluation(detections, output_dir)`` -> (result_dict, extra).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from det3d_tpu_torch.datasets.pipelines.compose import Compose


class PointCloudDataset:
    NumPointFeatures = -1
    CLASSES: Optional[Sequence[str]] = None

    def __init__(self, root_path, info_path, pipeline=None, test_mode=False,
                 class_names=None, **kwargs):
        self._root_path = Path(root_path)
        self._info_path = info_path
        self._class_names = class_names
        self.test_mode = test_mode
        self.pipeline = Compose(pipeline) if pipeline is not None else None

    def __len__(self):
        raise NotImplementedError

    def get_sensor_data(self, idx):
        raise NotImplementedError

    def evaluation(self, detections, output_dir):
        raise NotImplementedError

    def __getitem__(self, idx):
        res, info = self.get_sensor_data(idx)
        if self.pipeline is not None:
            out = self.pipeline(res, info)
            if out is None:
                return None
            res, info = out
        return res

    @property
    def ground_truth_annotations(self):
        return None

    def group_flag(self):
        """Aspect-ratio-style grouping for the group sampler; lidar datasets
        are one group (reference custom.py sets flag by image aspect)."""
        return np.zeros(len(self), np.uint8)
