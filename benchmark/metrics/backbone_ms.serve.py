"""backbone_ms.serve: the sparse middle less its plan and dense tail
(the sparse stages' window convs, BN, gathers), in device ms a served
call of the ``--trace 1`` stretch: the busy time between the segment's
markers, less its nested segments' (core/trace.py::segments), from the
program's segment ``backbone`` (the backbone's forward,
utils/trace.py::stage_hooks)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "backbone")
