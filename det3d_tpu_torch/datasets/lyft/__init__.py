from det3d_tpu_torch.datasets.lyft.lyft import LyftDataset

__all__ = ["LyftDataset"]
