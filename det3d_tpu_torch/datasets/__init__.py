"""The data pipeline: datasets, pipeline stages, the loader.

Port of det3d_tpu/datasets/ for KITTI: the registries, ``build_dataset``,
the dataset wrappers, the pipeline stages (loading, ``Preprocess``,
``Reformat``, ``HostPlan``), ``KittiDataset`` with the official KITTI
evaluation, the gt database, and the loader with its samplers. It runs on
the host in numpy (and the C++ of csrc/pointops.cc and csrc/hostplan.cc),
in the loader's worker processes, and imports no torch. nuScenes and Lyft
wait (ROADMAP queue 1, item 7).
"""

from det3d_tpu_torch.datasets import pipelines  # noqa: F401 (register stages)
from det3d_tpu_torch.datasets.builder import build_dataset
from det3d_tpu_torch.datasets.custom import PointCloudDataset
from det3d_tpu_torch.datasets.dataset_wrappers import (ConcatDataset,
                                                       RepeatDataset)
from det3d_tpu_torch.datasets.kitti.kitti import KittiDataset
from det3d_tpu_torch.datasets.loader import DataLoader, build_dataloader
from det3d_tpu_torch.datasets.registry import DATASETS, PIPELINES

__all__ = [
    "build_dataset", "PointCloudDataset", "ConcatDataset", "RepeatDataset",
    "KittiDataset", "DataLoader", "build_dataloader", "DATASETS",
    "PIPELINES",
]
