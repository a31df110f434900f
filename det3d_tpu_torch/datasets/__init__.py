"""The data pipeline: datasets, pipeline stages, the loader.

Port of det3d_tpu/datasets/: the registries, ``build_dataset``, the
dataset wrappers, the pipeline stages (loading with nuScenes' and Lyft's
multi-sweep concat, ``Preprocess``, ``Reformat``, ``HostPlan``),
``KittiDataset`` with the official KITTI evaluation, ``NuScenesDataset``
with CBGS resampling and the native NDS evaluation, ``LyftDataset`` with
the 3D-IoU mAP evaluation, the gt database, and the loader with its
samplers. It runs on the host in numpy (and the C++ of csrc/pointops.cc
and csrc/hostplan.cc), in the loader's worker processes, and imports no
torch.
"""

from det3d_tpu_torch.datasets import pipelines  # noqa: F401 (register stages)
from det3d_tpu_torch.datasets.builder import build_dataset
from det3d_tpu_torch.datasets.custom import PointCloudDataset
from det3d_tpu_torch.datasets.dataset_wrappers import (ConcatDataset,
                                                       RepeatDataset)
from det3d_tpu_torch.datasets.kitti.kitti import KittiDataset
from det3d_tpu_torch.datasets.lyft.lyft import LyftDataset
from det3d_tpu_torch.datasets.nuscenes.nuscenes import NuScenesDataset
from det3d_tpu_torch.datasets.loader import DataLoader, build_dataloader
from det3d_tpu_torch.datasets.registry import DATASETS, PIPELINES

__all__ = [
    "build_dataset", "PointCloudDataset", "ConcatDataset", "RepeatDataset",
    "KittiDataset", "NuScenesDataset", "LyftDataset", "DataLoader",
    "build_dataloader", "DATASETS", "PIPELINES",
]
