"""head_ms.serve: the detection head's convs, in device ms a served call
of the ``--trace 1`` stretch: the busy time between the segment's
markers (no segment nests in it) (core/trace.py::segments), from the
program's segment ``bbox_head`` (the bbox_head's forward,
utils/trace.py::stage_hooks)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "bbox_head")
