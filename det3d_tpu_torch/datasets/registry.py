"""Dataset / pipeline registries; port of det3d_tpu/datasets/registry.py.
Parity: det3d/datasets/registry.py:3-4."""

from det3d_tpu_torch.utils.registry import Registry

DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
