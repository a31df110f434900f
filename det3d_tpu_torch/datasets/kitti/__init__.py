from det3d_tpu_torch.datasets.kitti.kitti import KittiDataset

__all__ = ["KittiDataset"]
