from det3d_tpu_torch.datasets.nuscenes.nuscenes import NuScenesDataset

__all__ = ["NuScenesDataset"]
