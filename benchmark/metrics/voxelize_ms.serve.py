"""voxelize_ms.serve: the device voxelizer (points to voxels and their
means), in device ms a served call of the ``--trace 1`` stretch: the
busy time between the segment's markers (no segment nests in it)
(core/trace.py::segments), from the program's segment ``voxelize``
(parallel/train.py::build_example)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "voxelize")
