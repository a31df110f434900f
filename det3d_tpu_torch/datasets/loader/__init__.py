from det3d_tpu_torch.datasets.loader.loader import (DataLoader,
                                                    build_dataloader,
                                                    collate, replay)
from det3d_tpu_torch.datasets.loader.sampler import GroupSampler

__all__ = ["DataLoader", "build_dataloader", "collate", "replay",
           "GroupSampler"]
