"""Dataset builder; port of det3d_tpu/datasets/builder.py. Parity:
det3d/datasets/builder.py:32."""

from __future__ import annotations

from det3d_tpu_torch.datasets.registry import DATASETS
from det3d_tpu_torch.utils.registry import build_from_cfg


def build_dataset(cfg, default_args=None):
    if isinstance(cfg, (list, tuple)):
        from det3d_tpu_torch.datasets.dataset_wrappers import ConcatDataset
        return ConcatDataset([build_dataset(c, default_args) for c in cfg])
    return build_from_cfg(cfg, DATASETS, default_args)
