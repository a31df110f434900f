"""The port's model registries (the JAX package's own stay separate)."""

from det3d_tpu_torch.utils.registry import Registry

READERS = Registry("reader")
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
DETECTORS = Registry("detector")
LOSSES = Registry("loss")
