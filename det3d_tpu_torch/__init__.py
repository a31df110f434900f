"""det3d_tpu_torch: the PyTorch / CUDA port of det3d_tpu.

The JAX package ``det3d_tpu`` is the reference; this package mirrors its
layout module for module, runs eagerly in PyTorch, and replaces each Pallas
kernel on the ported path with a kernel written by hand for NVIDIA Hopper
(``csrc/``). Covered so far: the PointPillars serving path (voxelize ->
pillar features -> scatter -> RPN -> head -> decode -> rotated NMS), fp32.

It imports torch and numpy, and from ``det3d_tpu`` only the jax-free
``utils.registry``, ``utils.config`` and ``utils.synth``.
"""

__version__ = "0.1.0"
