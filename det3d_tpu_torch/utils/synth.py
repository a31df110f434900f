"""Structured synthetic lidar scans, shared with det3d_tpu (numpy only).

The generator is framework-free, so the port uses the JAX package's module
as it is rather than a copy; this module only gives it a place in the
port's namespace.
"""

from det3d_tpu.utils.synth import structured_batch, structured_scan

__all__ = ["structured_batch", "structured_scan"]
