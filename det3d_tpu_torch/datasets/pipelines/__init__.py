from det3d_tpu_torch.datasets.pipelines.compose import Compose
from det3d_tpu_torch.datasets.pipelines.host_plan import HostPlan
from det3d_tpu_torch.datasets.pipelines.loading import (
    LoadPointCloudAnnotations, LoadPointCloudFromFile)
from det3d_tpu_torch.datasets.pipelines.preprocess import (AssignTarget,
                                                           Preprocess,
                                                           Reformat,
                                                           Voxelization)

__all__ = [
    "Compose", "LoadPointCloudFromFile", "LoadPointCloudAnnotations",
    "Preprocess", "Voxelization", "AssignTarget", "Reformat", "HostPlan",
]
