"""det3d_tpu_torch: the PyTorch / CUDA port of det3d_tpu.

The JAX package ``det3d_tpu`` is the reference; this package mirrors its
layout module for module, runs eagerly in PyTorch, and replaces each Pallas
kernel on the ported path with a kernel written by hand for NVIDIA Hopper
(``csrc/``). Covered so far: the PointPillars serving path (voxelize ->
pillar features -> scatter -> RPN -> head -> decode -> rotated NMS), in
fp32 or with the shipped configs' bf16 reader and neck, the voxels in
hashed or first-come order, on the card or the host; and SECOND and CBGS
serving from host plans (host voxels and rulebooks -> voxel mean ->
sparse middle on the window-conv kernel, bf16 or fp32 -> RPN -> head ->
decode -> rotated NMS).

It imports torch and numpy and nothing of ``det3d_tpu``: the framework-free
modules it needs (registry, config, synth) are its own copies. Entry
points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
